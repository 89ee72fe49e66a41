"""Hybrid rewriting for equivalence-space expansion (paper §5.3).

Two rewrite families applied iteratively to the same e-graph until saturation:

* **Internal rewrites** — dataflow/algebraic rules beneath anchors, expressed
  as fixed egglog-style patterns.  They never touch anchor e-nodes, so control
  flow and side effects are preserved by construction.

* **External rewrites** — control-flow restructurings (loop unrolling, tiling,
  coalescing, re-rolling) that are impractical as local patterns.  Following
  §5.2 ("Reuse MLIR Passes in E-graph"), each is implemented as: extract a
  variant from the e-graph with a cost model, run a conventional AST pass on
  it, re-insert the result, and union it with the original e-class — so pass
  results accumulate non-destructively.

External rewrites are *ISAX-guided*: we compare the software loop structure
with the target ISAX skeleton's loop structure and only trigger transforms
that plausibly converge the two, suppressing e-graph blowup.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import expr
from repro_torch.core.egraph import EGraph, Rewrite, run_rewrites
from repro_torch.core.expr import Term, const, var


# ---------------------------------------------------------------------------
# Internal rewrites (egglog-style fixed rules)
# ---------------------------------------------------------------------------

def _const_of(eg: EGraph, cid: int):
    for node in eg.nodes_of(cid):
        if node[0].startswith("const:"):
            return expr.leaf_value(node[0])
    return None


def _shift_to_mul(eg: EGraph, sub):
    c = _const_of(eg, sub["?c"])
    if isinstance(c, int) and 0 <= c < 31:
        k = eg.add_node(f"const:{2 ** c}", [])
        return eg.add_node("*", [eg.find(sub["?x"]), k])
    return None


def _shr_to_div(eg: EGraph, sub):
    c = _const_of(eg, sub["?c"])
    if isinstance(c, int) and 0 <= c < 31:
        k = eg.add_node(f"const:{2 ** c}", [])
        return eg.add_node("/", [eg.find(sub["?x"]), k])
    return None


def _fold(fn):
    def compute(eg: EGraph, sub):
        a, b = _const_of(eg, sub["?a"]), _const_of(eg, sub["?b"])
        if a is None or b is None:
            return None
        try:
            v = fn(a, b)
        except ZeroDivisionError:
            return None
        if isinstance(v, float) and v.is_integer():
            v = int(v)
        return eg.add_node(f"const:{v}", [])
    return compute


def _div_to_mul_recip(eg: EGraph, sub):
    c = _const_of(eg, sub["?c"])
    if isinstance(c, (int, float)) and c != 0:
        k = eg.add_node(f"const:{1.0 / c}", [])
        return eg.add_node("*", [eg.find(sub["?x"]), k])
    return None


def internal_rules() -> list[Rewrite]:
    a, b, c, x, s = ("?a",), ("?b",), ("?c",), ("?x",), ("?s",)
    R = Rewrite
    return [
        # strength/representation form (RF in Table 3)
        R("shl-to-mul", ("<<", x, c), compute=_shift_to_mul),
        R("shr-to-div", (">>", x, c), compute=_shr_to_div),
        R("div-to-mul-recip", ("/", x, c), compute=_div_to_mul_recip),
        R("sub-to-addneg", ("-", a, b), ("+", a, ("neg", b)),
          bidirectional=True),
        R("relu-to-max", ("relu", x), ("max0", x), bidirectional=True),
        # algebraic form (AF)
        R("add-comm", ("+", a, b), ("+", b, a)),
        R("mul-comm", ("*", a, b), ("*", b, a)),
        R("add-assoc", ("+", ("+", a, b), c), ("+", a, ("+", b, c)),
          bidirectional=True),
        R("mul-assoc", ("*", ("*", a, b), c), ("*", a, ("*", b, c)),
          bidirectional=True),
        R("mul-distrib", ("*", a, ("+", b, c)),
          ("+", ("*", a, b), ("*", a, c)), bidirectional=True),
        # overflow-safe average (paper §6.2: "representation transformations
        # like overflow-safe average")
        R("avg-overflow-safe",
          ("/", ("+", a, b), ("const:2",)),
          ("+", a, ("/", ("-", b, a), ("const:2",))), bidirectional=True),
        # constant folding + identities
        R("fold-add", ("+", a, b), compute=_fold(lambda p, q: p + q)),
        R("fold-mul", ("*", a, b), compute=_fold(lambda p, q: p * q)),
        R("mul-one", ("*", a, ("const:1",)), a),
        R("add-zero", ("+", a, ("const:0",)), a),
        # linear-algebra scaling moves (attention scale placement variants)
        R("matvec-scale-right", ("matvec", a, ("*", s, b)),
          ("*", s, ("matvec", a, b)), bidirectional=True),
        R("matmul-scale-left", ("matmul", ("*", s, a), b),
          ("*", s, ("matmul", a, b)), bidirectional=True),
        # softmax max-shift invariance:
        #   exp(s - rowmax(s)) / rowsum(exp(s - rowmax(s)))
        #     == exp(s) / rowsum(exp(s))
        R("softmax-shift",
          ("/", ("exp", ("-", s, ("rowmax", s))),
                ("rowsum", ("exp", ("-", s, ("rowmax", s))))),
          ("/", ("exp", s), ("rowsum", ("exp", s))), bidirectional=True),
        # squared-distance form: rowsum((a-b)²) == ‖a‖² + (‖b‖² − 2·a·b)
        # (point-cloud software spells the expanded form, the fps/ball_query
        # ISAXes the compact one — this rule is the bridge)
        R("sqdist-expand",
          ("rowsum", ("*", ("-", a, b), ("-", a, b))),
          ("+", ("rowsum", ("*", a, a)),
           ("-", ("rowsum", ("*", b, b)),
            ("*", ("const:2",), ("rowsum", ("*", a, b))))),
          bidirectional=True),
        # max-pool as negated min-pool (representation form: the group_agg
        # software variant spells colmax via neg∘colmin∘neg)
        R("colmax-neg-colmin", ("colmax", x),
          ("neg", ("colmin", ("neg", x))), bidirectional=True),
        # rsqrt form
        R("rsqrt-form", ("rsqrt", x), ("recip", ("sqrt", x)),
          bidirectional=True),
        R("div-as-recip-mul", ("/", a, b), ("*", a, ("recip", b)),
          bidirectional=True),
    ]


def saturate_internal(eg: EGraph, max_iters: int = 6) -> int:
    return run_rewrites(eg, internal_rules(), max_iters=max_iters)


# ---------------------------------------------------------------------------
# External rewrites: loop transformations on extracted terms
# ---------------------------------------------------------------------------

def affine_cost(op: str, child_costs: list[float]) -> float:
    """Extraction cost model of §5.3: a heuristic that penalizes non-affine
    operations (e.g. prefers ``i*4`` over ``i<<2``) so extracted variants are
    oriented toward aggressive loop optimization."""
    if op.startswith("comp:") or op.startswith("isax:"):
        return float("inf")  # markers never appear in a plain variant
    base = 1.0
    if op in ("<<", ">>"):
        base = 50.0  # non-affine in the polyhedral sense
    if op == "while":
        base = 100.0
    return base + sum(child_costs)


def unroll_loop(t: Term, factor: int) -> Optional[Term]:
    """for:i(0,N,s){A} → for:i(0,N,s*f){A[i], A[i+s], …, A[i+(f-1)s]}"""
    if not expr.is_for(t) or factor < 2:
        return None
    idx = expr.for_index(t)
    start, end, step, body = expr.children(t)
    s0, e0, st0 = (expr.const_value(start), expr.const_value(end),
                   expr.const_value(step))
    if None in (s0, e0, st0) or st0 == 0:
        return None
    trip = (e0 - s0) // st0
    if trip % factor != 0:
        return None
    anchors = expr.children(body) if expr.op(body) == "tuple" else (body,)
    new_anchors = []
    for k in range(factor):
        for anc in anchors:
            if k == 0:
                new_anchors.append(anc)
            else:
                new_anchors.append(expr.substitute_var(
                    anc, idx, ("+", var(idx), const(k * st0))))
    return (f"for:{idx}", start, end, const(st0 * factor),
            ("tuple",) + tuple(new_anchors))


def _norm(t: Term) -> Term:
    """Normalization for structural compares: drops +0, folds constant adds,
    and sorts commutative operands so e-graph-generated commuted variants
    compare equal."""
    if expr.is_leaf(t):
        return t
    ch = tuple(_norm(c) for c in expr.children(t))
    o = expr.op(t)
    if o == "+":
        if ch[1] == ("const:0",):
            return ch[0]
        if ch[0] == ("const:0",):
            return ch[1]
        a, b = expr.const_value(ch[0]), expr.const_value(ch[1])
        if a is not None and b is not None:
            return (f"const:{a + b}",)
    if o in expr.COMMUTATIVE:
        ch = tuple(sorted(ch, key=repr))
    return (o,) + ch


def _default_eq(a: Term, b: Term) -> bool:
    return _norm(a) == _norm(b)


def reroll_loop(t: Term, eq=None) -> Optional[Term]:
    """Inverse of unroll: detect f shifted anchor copies, collapse them.

    ``eq(a, b)`` is the term-equality oracle; the external-rewrite driver
    passes equality-modulo-e-graph (two anchors are "the same" if their terms
    land in the same e-class), which tolerates any algebraic divergence the
    internal rules have already proven equivalent.
    """
    eq = eq or _default_eq
    if not expr.is_for(t):
        return None
    idx = expr.for_index(t)
    start, end, step, body = expr.children(t)
    st0 = expr.const_value(step)
    if st0 is None or expr.op(body) != "tuple":
        return None
    anchors = expr.children(body)
    n = len(anchors)
    for f in (8, 4, 2):
        if f > n or n % f or st0 % f:
            continue
        base_step = st0 // f
        group = n // f
        ok = True
        for k in range(1, f):
            for g in range(group):
                expected = expr.substitute_var(
                    anchors[g], idx, ("+", var(idx), const(k * base_step)))
                if not eq(expected, anchors[k * group + g]):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return (f"for:{idx}", start, end, const(base_step),
                    ("tuple",) + tuple(anchors[:group]))
    return None


def tile_loop(t: Term, factor: int) -> Optional[Term]:
    """for:i(0,N,1){A} → for:i_t(0,N,f){ for:i(i_t, i_t+f, 1){A} }"""
    if not expr.is_for(t) or factor < 2:
        return None
    idx = expr.for_index(t)
    start, end, step, body = expr.children(t)
    s0, e0, st0 = (expr.const_value(start), expr.const_value(end),
                   expr.const_value(step))
    if None in (s0, e0, st0) or st0 != 1 or (e0 - s0) % factor:
        return None
    it = f"{idx}_t"
    inner = (f"for:{idx}", var(it), ("+", var(it), const(factor)),
             const(1), body)
    return (f"for:{it}", start, end, const(factor), ("tuple", inner))


def coalesce_loops(t: Term, eq=None) -> Optional[Term]:
    """Inverse of tile: for:it(0,N,f){ for:i(it, it+f, 1){A} } → for:i(0,N,1){A}"""
    eq = eq or _default_eq
    if not expr.is_for(t):
        return None
    it = expr.for_index(t)
    start, end, step, body = expr.children(t)
    if expr.op(body) != "tuple" or len(expr.children(body)) != 1:
        return None
    inner = expr.children(body)[0]
    if not expr.is_for(inner):
        return None
    i_start, i_end, i_step, i_body = expr.children(inner)
    f = expr.const_value(step)
    if f is None or expr.const_value(i_step) != 1:
        return None
    if not eq(i_start, var(it)):
        return None
    if not eq(i_end, ("+", var(it), const(f))):
        return None
    return (f"for:{expr.for_index(inner)}", start, end, const(1), i_body)


# ---------------------------------------------------------------------------
# ISAX-guided external rewriting driver (§5.3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExternalStats:
    attempted: int = 0
    applied: int = 0
    transforms: list[str] = dataclasses.field(default_factory=list)


def _loops_with_paths(t: Term, path=()) -> list[tuple[tuple, Term]]:
    out = []
    if expr.is_for(t):
        out.append((path, t))
    for i, c in enumerate(expr.children(t)):
        if isinstance(c, tuple):
            out.extend(_loops_with_paths(c, path + (i + 1,)))
    return out


def _replace_at(t: Term, path: tuple, new: Term) -> Term:
    if not path:
        return new
    i = path[0]
    ch = list(t)
    ch[i] = _replace_at(t[i], path[1:], new)
    return tuple(ch)


def structure_distance(sw: tuple | None, hw: tuple | None) -> float:
    """Crude distance between two loop_structure() summaries."""
    if sw is None or hw is None:
        return 0.0 if sw is hw else float("inf")
    d = 0.0
    _, sw_step, sw_nested = sw
    _, hw_step, hw_nested = hw
    if sw_step is not None and hw_step is not None and sw_step != hw_step:
        d += 1.0
    d += 2.0 * abs(len(sw_nested) - len(hw_nested))
    for a2, b2 in zip(sw_nested, hw_nested):
        d += structure_distance(a2, b2)
    return d


def external_rewrite_pass(
    eg: EGraph,
    root: int,
    isax_loop_structure: tuple | None,
    max_rounds: int = 4,
) -> ExternalStats:
    """Extract an affine-friendly variant, apply ISAX-guided loop transforms,
    union results back (non-destructive accumulation per §5.2)."""
    stats = ExternalStats()

    def eg_eq(a: Term, b: Term) -> bool:
        """Equality modulo the e-graph: terms are equal if their classes are
        (or if plain normalization already says so)."""
        if _default_eq(a, b):
            return True
        ia = eg.add_term(expr.normalize_indices(a))
        ib = eg.add_term(expr.normalize_indices(b))
        eg.rebuild()
        return eg.find(ia) == eg.find(ib)

    for _ in range(max_rounds):
        try:
            prog = eg.extract(root, affine_cost)
        except ValueError:
            return stats
        prog = expr.normalize_indices(prog)
        changed = False
        for path, loop in _loops_with_paths(prog):
            sw_struct = expr.loop_structure(loop)
            dist0 = structure_distance(sw_struct, isax_loop_structure)
            if dist0 == 0 or dist0 == float("inf"):
                continue
            candidates: list[tuple[str, Optional[Term]]] = [
                ("coalesce", coalesce_loops(loop, eg_eq)),
                ("reroll", reroll_loop(loop, eg_eq)),
            ]
            if isax_loop_structure is not None:
                _, hw_step, hw_nested = isax_loop_structure
                if hw_nested and hw_nested[0] is not None:
                    # ISAX side is tiled: mirror its tile factor if derivable
                    inner_trip = hw_nested[0][0]
                    if inner_trip:
                        candidates.append(
                            ("tile", tile_loop(loop, inner_trip)))
                if hw_step and hw_step > 1:
                    candidates.append(("unroll", unroll_loop(loop, hw_step)))
            for name, new_loop in candidates:
                stats.attempted += 1
                if new_loop is None:
                    continue
                # NOTE: new_loop keeps in-context index names (outer indices
                # are free vars); alpha-renaming happens on the whole program
                # so nesting-depth names stay collision-free.
                new_struct = expr.loop_structure(new_loop)
                if structure_distance(new_struct, isax_loop_structure) < dist0:
                    new_prog = expr.normalize_indices(
                        _replace_at(prog, path, new_loop))
                    new_root = eg.add_term(new_prog)
                    eg.union(new_root, root)
                    eg.rebuild()
                    stats.applied += 1
                    stats.transforms.append(name)
                    changed = True
                    break
            if changed:
                break
        if not changed:
            break
    return stats
