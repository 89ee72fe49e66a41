"""Mini functional IR for model-graph fragments (the "software side").

Aquas canonicalizes software (via Polygeist → MLIR) and ISAX descriptions
(Aquas-IR functional level) to a common abstraction in base MLIR dialects
(§5.1).  We do not embed MLIR; instead both sides are written in this small
term IR, which plays the role of the base dialects.

A term is an immutable nested tuple ``(op, *children)``:

  dataflow ops : '+', '-', '*', '/', '<<', '>>', 'min', 'max', 'exp', 'neg',
                 'matmul', 'dot', 'select', 'sqrt', 'rsqrt', 'relu', 'sum',
                 'rowmax', 'rowsum', 'recip', 'load' (array, *index)
  leaves       : ('var:<name>',), ('const:<int-or-float>',), ('arr:<name>',)
  anchors      : ('store', arr, *index, value)        — side-effecting
                 ('for:<idx>', start, end, step, body) — structured control
                 ('yield', *values)                   — terminator
  block        : ('tuple', *anchors)                  — §5.2 block encoding

The loop induction variable is carried in the op string (``for:i``) and
referenced in the body as ``('var:i',)``.  ``normalize_indices`` renames all
induction variables to canonical depth-based names (``i0``, ``i1``, …) so
alpha-equivalent loops share e-nodes and skeleton matching is name-stable.

Programs written here are *descriptions* of layer computations used by the
retargetable compiler; execution for validation happens in
``core/offload.py``'s evaluator (numpy/jnp semantics).
"""

from __future__ import annotations

from typing import Iterator

Term = tuple  # (op: str, *children: Term)

ANCHOR_OPS = {"store", "yield", "while", "isax_call"}  # plus any 'for:*'


def is_anchor_op(o: str) -> bool:
    return o in ANCHOR_OPS or o.startswith("for:") or o.startswith("isax:")
COMMUTATIVE = {"+", "*", "min", "max", "and", "or"}
SIDE_EFFECT = {"store", "isax_call"}

# Ops whose cost is "heavy" (matrix unit) vs "light" (vector unit):
HEAVY_OPS = {"matmul", "dot"}


def is_leaf(t: Term) -> bool:
    return len(t) == 1


def op(t: Term) -> str:
    return t[0]


def children(t: Term) -> tuple:
    return tuple(t[1:])


def var(name: str) -> Term:
    return (f"var:{name}",)


def const(v) -> Term:
    return (f"const:{v}",)


def arr(name: str) -> Term:
    return (f"arr:{name}",)


def leaf_kind(o: str) -> str | None:
    for k in ("var", "const", "arr"):
        if o.startswith(k + ":"):
            return k
    return None


def leaf_value(o: str):
    kind = leaf_kind(o)
    if kind is None:
        return None
    payload = o.split(":", 1)[1]
    if kind == "const":
        try:
            return int(payload)
        except ValueError:
            return float(payload)
    return payload


def const_value(t: Term):
    if is_leaf(t) and op(t).startswith("const:"):
        return leaf_value(op(t))
    return None


def walk(t: Term) -> Iterator[Term]:
    yield t
    for c in children(t):
        yield from walk(c)


def count_nodes(t: Term) -> int:
    return sum(1 for _ in walk(t))


def rename_var(t: Term, old: str, new: str) -> Term:
    if is_leaf(t):
        return var(new) if op(t) == f"var:{old}" else t
    return (op(t),) + tuple(rename_var(c, old, new) for c in children(t))


def substitute_var(t: Term, name: str, replacement: Term) -> Term:
    if is_leaf(t):
        return replacement if op(t) == f"var:{name}" else t
    return (op(t),) + tuple(substitute_var(c, name, replacement)
                            for c in children(t))


def is_for(t: Term) -> bool:
    return op(t).startswith("for:")


def for_index(t: Term) -> str:
    assert is_for(t)
    return op(t).split(":", 1)[1]


def for_(idx: str, start: Term, end: Term, step: Term, *anchors: Term) -> Term:
    body = anchors[0] if len(anchors) == 1 and op(anchors[0]) == "tuple" \
        else ("tuple",) + tuple(anchors)
    return (f"for:{idx}", start, end, step, body)


def loop_structure(t: Term) -> tuple | None:
    """Structural summary of a loop nest: (trip_count_or_None, step, [nested])
    used by ISAX-guided external rewriting (§5.3: "The decision here only
    depends on the loop structure, not the specific operations within")."""
    if not is_for(t):
        return None
    start, end, step, body = children(t)
    s, e, st = const_value(start), const_value(end), const_value(step)
    trip = None
    if s is not None and e is not None and st not in (None, 0):
        trip = max(0, -(-(e - s) // st))
    nested = []
    if op(body) == "tuple":
        for anchor in children(body):
            if is_for(anchor):
                nested.append(loop_structure(anchor))
    return (trip, st, tuple(nested))


def normalize_indices(t: Term, depth: int = 0, mapping=None) -> Term:
    """Alpha-rename induction variables to i0, i1, … by nesting depth."""
    mapping = mapping or {}
    o = op(t)
    if is_leaf(t):
        if o.startswith("var:"):
            nm = o.split(":", 1)[1]
            if nm in mapping:
                return var(mapping[nm])
        return t
    if is_for(t):
        idx = for_index(t)
        new_idx = f"i{depth}"
        m2 = dict(mapping)
        m2[idx] = new_idx
        start, end, step, body = children(t)
        return (f"for:{new_idx}",
                normalize_indices(start, depth, mapping),
                normalize_indices(end, depth, mapping),
                normalize_indices(step, depth, mapping),
                normalize_indices(body, depth + 1, m2))
    return (o,) + tuple(normalize_indices(c, depth, mapping)
                        for c in children(t))
