"""Skeleton-components pattern matching (paper §5.4).

Each ISAX is decomposed into a *skeleton* — the loop/anchor control structure
with ordering constraints — and *components* — the dataflow subtrees beneath
each anchor.  Matching proceeds in two phases:

  1. **Component tagging**: for every component we generate a tagging rule
     (the egglog-rule analogue).  When the component's subtree e-matches, the
     rule unions a unique marker e-node ``comp:<isax>:<i>`` — whose children
     record the bindings of the component's free variables in declared order —
     into the matched e-class.

  2. **Skeleton matching**: a dedicated engine walks candidate loop e-classes
     whose enclosing block satisfies the required region structure and
     contains the complete component set, then validates ordering,
     dominance/visibility, loop-carried dependences, and effect constraints.
     On success an ``isax:<name>`` e-node (children = parameter bindings in
     signature order) is unioned into the matched e-class.

Extraction with a cost model that prioritizes ISAX e-nodes then yields the
offloaded program; ``isax:<name>`` anchors become intrinsic calls (here:
``kernels/ops.py`` entry points).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import expr
from repro_torch.core.egraph import EGraph
from repro_torch.core.expr import Term


@dataclasses.dataclass(frozen=True)
class ISAX:
    """An ISAX definition: semantics written in the same mini-IR as software
    (the §5.1 "common abstraction level"), plus call metadata."""

    name: str
    params: tuple[str, ...]       # argument order for the intrinsic call
    term: Term                    # full semantic description (program form)
    kernel: str                   # key into the kernel/intrinsic registry
    outputs: tuple[str, ...] = () # param names written by the ISAX

    def normalized(self) -> Term:
        return expr.normalize_indices(self.term)


@dataclasses.dataclass
class Component:
    comp_id: int
    pattern: Term                 # leaves '?<name>' bind params/loop indices
    freevars: tuple[str, ...]     # marker child order
    self_dep_array: Optional[str] = None  # loop-carried accumulator array


@dataclasses.dataclass
class Skeleton:
    """Control structure of the ISAX with component placeholders.

    ``pattern`` mirrors the ISAX term but every store-value dataflow subtree
    is replaced by ``('__comp__<i>',)``.
    """

    pattern: Term
    components: list[Component]
    loop_struct: tuple | None


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

def _pattern_of(t: Term, bindable: set[str]) -> tuple[Term, list[str]]:
    """Replace var/arr leaves whose names are bindable with pattern vars."""
    order: list[str] = []

    def rec(u: Term) -> Term:
        o = expr.op(u)
        kind = expr.leaf_kind(o)
        if kind in ("var", "arr"):
            nm = o.split(":", 1)[1]
            if nm in bindable:
                if nm not in order:
                    order.append(nm)
                return (f"?{nm}",)
            return u
        if expr.is_leaf(u):
            return u
        return (o,) + tuple(rec(c) for c in expr.children(u))

    return rec(t), order


def _arrays_read(t: Term) -> set[str]:
    out = set()
    for u in expr.walk(t):
        if expr.op(u) == "load" and len(u) > 1:
            tgt = u[1]
            if expr.op(tgt).startswith("arr:"):
                out.add(expr.op(tgt).split(":", 1)[1])
    return out


def decompose(isax: ISAX) -> Skeleton:
    """Split the ISAX term into skeleton + components (§5.4)."""
    term = isax.normalized()
    components: list[Component] = []
    bindable = set(isax.params)

    def rec(t: Term, loop_vars: tuple[str, ...]) -> Term:
        o = expr.op(t)
        if expr.is_for(t):
            idx = expr.for_index(t)
            start, end, step, body = expr.children(t)
            return (o, _skeleton_leafify(start, bindable | set(loop_vars)),
                    _skeleton_leafify(end, bindable | set(loop_vars)),
                    _skeleton_leafify(step, bindable | set(loop_vars)),
                    rec(body, loop_vars + (idx,)))
        if o == "tuple":
            return ("tuple",) + tuple(rec(c, loop_vars)
                                      for c in expr.children(t))
        if o == "store":
            arr_t = t[1]
            idx_terms = t[2:-1]
            value = t[-1]
            cid = len(components)
            free = bindable | set(loop_vars)
            pat, order = _pattern_of(value, free)
            stored_arr = (expr.op(arr_t).split(":", 1)[1]
                          if expr.op(arr_t).startswith("arr:") else None)
            self_dep = stored_arr if stored_arr in _arrays_read(value) else None
            components.append(Component(cid, pat, tuple(order), self_dep))
            arr_pat = _skeleton_leafify(arr_t, free)
            idx_pats = tuple(_skeleton_leafify(i, free) for i in idx_terms)
            return ("store", arr_pat) + idx_pats + ((f"__comp__{cid}",),)
        # other anchors (yield) — leafify dataflow beneath
        return _skeleton_leafify(t, bindable | set(loop_vars))

    pattern = rec(term, ())
    return Skeleton(pattern, components, expr.loop_structure(term))


def _skeleton_leafify(t: Term, bindable: set[str]) -> Term:
    pat, _ = _pattern_of(t, bindable)
    return pat


# ---------------------------------------------------------------------------
# Phase 1: component tagging
# ---------------------------------------------------------------------------

def tag_components(eg: EGraph, isax: ISAX, skel: Skeleton) -> int:
    """Union ``comp:<isax>:<i>`` markers into every e-class matching a
    component pattern.  Returns the number of tags inserted."""
    tags = 0
    for comp in skel.components:
        for sub, cid in eg.ematch(comp.pattern):
            child_ids = [eg.find(sub[f"?{v}"]) for v in comp.freevars]
            marker = eg.add_node(f"comp:{isax.name}:{comp.comp_id}", child_ids)
            if eg.find(marker) != eg.find(cid):
                eg.union(marker, cid)
                tags += 1
    eg.rebuild()
    return tags


# ---------------------------------------------------------------------------
# Phase 2: skeleton matching engine
# ---------------------------------------------------------------------------

class _MatchFail(Exception):
    pass


def _match_skeleton(eg: EGraph, isax: ISAX, pat: Term, cid: int,
                    sub: dict[str, int]):
    """Yield substitutions matching the skeleton pattern against e-class cid.

    Like EGraph._match_class but with component placeholders: a placeholder
    matches a class iff the class contains the corresponding marker e-node
    whose children are consistent with (or extend) the current binding.
    """
    cid = eg.find(cid)
    o = expr.op(pat)
    if o.startswith("?"):
        bound = sub.get(o)
        if bound is None:
            s2 = dict(sub)
            s2[o] = cid
            yield s2
        elif eg.find(bound) == cid:
            yield sub
        return
    if o.startswith("__comp__"):
        comp_id = int(o[len("__comp__"):])
        comp = _COMP_CACHE[(isax.name, comp_id)]
        marker_op = f"comp:{isax.name}:{comp_id}"
        for node in eg.nodes_of(cid):
            if node[0] != marker_op:
                continue
            s2 = dict(sub)
            ok = True
            for v, child in zip(comp.freevars, node[1:]):
                key = f"?{v}"
                child = eg.find(child)
                if key in s2 and eg.find(s2[key]) != child:
                    ok = False
                    break
                s2[key] = child
            if ok:
                yield s2
        return
    for node in list(eg.nodes_of(cid)):
        if node[0] != o or len(node) - 1 != len(expr.children(pat)):
            continue
        yield from _match_children(eg, isax, expr.children(pat), node[1:], sub)


def _match_children(eg, isax, pats, cids, sub):
    if not pats:
        yield sub
        return
    for s in _match_skeleton(eg, isax, pats[0], cids[0], sub):
        yield from _match_children(eg, isax, pats[1:], cids[1:], s)


_COMP_CACHE: dict[tuple[str, int], Component] = {}


def _reachable(eg: EGraph, src: int, dst: int, limit: int = 10_000) -> bool:
    """Is class dst reachable from src through e-node children?"""
    src, dst = eg.find(src), eg.find(dst)
    seen = {src}
    stack = [src]
    steps = 0
    while stack:
        steps += 1
        if steps > limit:
            return True  # conservative
        c = stack.pop()
        if c == dst:
            return True
        for node in eg.nodes_of(c):
            for ch in node[1:]:
                ch = eg.find(ch)
                if ch not in seen:
                    seen.add(ch)
                    stack.append(ch)
    return False


def _validate(eg: EGraph, isax: ISAX, skel: Skeleton, sub: dict[str, int],
              root_cid: int) -> None:
    """§5.4 checks: ordering, dominance/visibility, loop-carried deps, effects.

    Ordering and effect constraints are structural: the skeleton pattern pins
    the anchor sequence and arity of every tuple e-node, so any match already
    satisfies them.  The remaining semantic checks:
    """
    # Dominance/visibility: no bound argument may contain the matched region
    # itself (a binding that cycles back into the loop is not a valid operand).
    for name, cid in sub.items():
        if eg.find(cid) == eg.find(root_cid):
            raise _MatchFail(f"binding {name} is the matched region itself")
        for node in eg.nodes_of(cid):
            if node[0].startswith("isax:"):
                continue
            # arguments must not structurally contain the candidate loop
        if _reachable_via_anchors(eg, cid, root_cid):
            raise _MatchFail(f"binding {name} not visible before the region")
    # Loop-carried dependences: accumulator arrays must match the skeleton's
    # self-dependence shape — the bound class for a self-dep array must be
    # read inside its own component marker (checked during decompose) and the
    # same binding must be used for the store target (already enforced by
    # shared pattern vars).  Distinct non-self-dep stores must bind distinct
    # arrays (no accidental aliasing).
    outs = [f"?{c}" for c in isax.outputs if f"?{c}" in sub]
    if len({eg.find(sub[o]) for o in outs}) != len(outs):
        raise _MatchFail("aliased output bindings")


def _reachable_via_anchors(eg: EGraph, src: int, dst: int) -> bool:
    """True if src's dataflow *requires* the candidate region (dst) — i.e. the
    region stores into something src loads and src is only producible after
    it.  Conservative approximation: src reaches dst through child edges."""
    return _reachable(eg, src, dst) and eg.find(src) != eg.find(dst)


@dataclasses.dataclass
class MatchResult:
    isax: str
    root_class: int
    bindings: dict[str, int]


def match_isax(eg: EGraph, isax: ISAX,
               skel: Skeleton | None = None) -> list[MatchResult]:
    """Run both phases for one ISAX over the whole e-graph; insert ``isax:``
    markers for every validated match."""
    skel = skel or decompose(isax)
    for comp in skel.components:
        _COMP_CACHE[(isax.name, comp.comp_id)] = comp
    tag_components(eg, isax, skel)

    results: list[MatchResult] = []
    seen_roots: set[int] = set()
    # candidate roots: classes containing a loop e-node of the right op
    root_op = expr.op(skel.pattern)
    for cid, nodes in list(eg.iter_classes()):
        if not any(n[0] == root_op for n in nodes):
            continue
        for sub in _match_skeleton(eg, isax, skel.pattern, cid, {}):
            try:
                _validate(eg, isax, skel, sub, cid)
            except _MatchFail:
                continue
            missing = [p for p in isax.params if f"?{p}" not in sub]
            if missing:
                continue
            root = eg.find(cid)
            if root in seen_roots:
                break
            seen_roots.add(root)
            child_ids = [eg.find(sub[f"?{p}"]) for p in isax.params]
            marker = eg.add_node(f"isax:{isax.name}", child_ids)
            eg.union(marker, cid)
            eg.rebuild()
            results.append(MatchResult(isax.name, root, dict(sub)))
            break
    return results
