"""End-to-end retargetable compilation (paper §5, Figure 5).

``compile_program`` runs the full flow over a software term:

  (1) semantic alignment — programs and ISAXes are both written in the
      ``core/expr.py`` mini-IR (the "base dialect" level of §5.1), with loop
      indices alpha-normalized;
  (2) e-graph encoding (anchors/tuple, §5.2);
  (3) hybrid rewriting — internal algebraic saturation interleaved with
      ISAX-guided external loop transforms (§5.3);
  (4) skeleton-components matching, inserting ``isax:`` markers (§5.4);
  (5) extraction with an ISAX-prioritizing cost model → offloaded program.

``evaluate`` executes programs (numpy semantics) so tests can assert that the
offloaded program is bit-compatible (allclose) with the original — with ISAX
intrinsics derived from the ``repro_torch.targets`` registry (every registered
``IsaxSpec.evaluator``), optionally overridden by the kernels' intrinsics
(``kernels/ops.py``, ``pointcloud/ops.py``) via ``register_intrinsic``.

The ISAX *definitions* themselves live on the domain packages
(``targets/llm.py``, ``targets/pointcloud.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import expr
from repro_torch.core.egraph import EGraph
from repro_torch.core.expr import Term
from repro_torch.core.matching import ISAX, decompose, match_isax
from repro_torch.core.rewrites import (
    external_rewrite_pass,
    saturate_internal,
)


# ---------------------------------------------------------------------------
# Compilation statistics (paper Table 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompileStats:
    case: str
    internal_rewrites: int = 0
    external_rewrites: int = 0
    initial_enodes: int = 0
    saturated_enodes: int = 0
    matched_isaxes: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class OffloadResult:
    program: Term
    stats: CompileStats
    egraph: EGraph


def offload_cost(op: str, child_costs: list[float]) -> float:
    """Extraction cost model that prioritizes ISAX e-nodes (§5.4)."""
    if op.startswith("comp:"):
        return float("inf")
    if op.startswith("isax:"):
        return 1.0 + sum(child_costs)
    if op in ("matmul", "matvec", "outer", "gather", "ballsel"):
        return 200.0 + sum(child_costs)
    if op in ("exp", "sqrt", "rsqrt", "recip", "rowmax", "rowsum", "sum",
              "argmax", "colmax", "colmin", "rowmean"):
        return 20.0 + sum(child_costs)
    if op.startswith("for:"):
        return 50.0 + sum(child_costs)
    return 2.0 + sum(child_costs)


def compile_program(
    program: Term,
    isaxes: list[ISAX],
    case: str = "case",
    max_hybrid_rounds: int = 3,
    node_limit: int = 60_000,
) -> OffloadResult:
    program = expr.normalize_indices(program)
    eg = EGraph(node_limit=node_limit)
    root = eg.add_term(program)
    stats = CompileStats(case=case, initial_enodes=eg.n_nodes())

    skels = {ix.name: decompose(ix) for ix in isaxes}

    # Hybrid rewriting until saturation (or rounds exhausted): internal
    # algebraic saturation, then ISAX-guided external loop restructuring.
    for _ in range(max_hybrid_rounds):
        stats.internal_rewrites += saturate_internal(eg)
        ext_applied = 0
        for ix in isaxes:
            st = external_rewrite_pass(eg, root, skels[ix.name].loop_struct)
            ext_applied += st.applied
        stats.external_rewrites += ext_applied
        if ext_applied == 0:
            break
    stats.internal_rewrites += saturate_internal(eg, max_iters=2)

    # Skeleton-components matching per ISAX.
    for ix in isaxes:
        for m in match_isax(eg, ix, skels[ix.name]):
            stats.matched_isaxes.append(m.isax)

    stats.saturated_enodes = eg.n_nodes()
    out = eg.extract(eg.find(root), offload_cost)
    return OffloadResult(out, stats, eg)


# ---------------------------------------------------------------------------
# Evaluator (numpy semantics) — correctness oracle for offloaded programs
# ---------------------------------------------------------------------------

IntrinsicFn = Callable[..., None]  # mutates output array arguments in place

_INTRINSICS: dict[str, IntrinsicFn] = {}


def register_intrinsic(name: str, fn: IntrinsicFn) -> None:
    """Override the intrinsic bound to ``isax:<name>`` e-nodes (used by
    ``kernels/ops.py`` / ``pointcloud/ops.py`` to swap the registry's numpy
    semantics for the kernel-backed datapaths)."""
    _INTRINSICS[name] = fn


def _registry_intrinsics() -> dict[str, IntrinsicFn]:
    """Evaluator semantics derived from the ``repro_torch.targets`` registry
    (imported lazily: targets depends on core, not the other way around)."""
    from repro_torch import targets
    return targets.evaluators()


def evaluate(t: Term, env: dict, intrinsics: dict[str, IntrinsicFn] | None = None):
    """Execute a program term.  ``env`` maps array/var names to numpy arrays /
    scalars; stores mutate arrays in place.  Returns the last value.

    Intrinsic resolution order: registry evaluator semantics (every
    registered ``IsaxSpec.evaluator``), then ``register_intrinsic``
    overrides, then the per-call ``intrinsics`` table."""
    table = _registry_intrinsics()
    table.update(_INTRINSICS)
    if intrinsics:
        table.update(intrinsics)
    return _eval(t, env, table)


def _eval(t: Term, env: dict, intr) -> object:
    o = expr.op(t)
    kind = expr.leaf_kind(o)
    if kind == "const":
        return expr.leaf_value(o)
    if kind in ("var", "arr"):
        return env[o.split(":", 1)[1]]
    ch = expr.children(t)

    if o == "tuple":
        out = None
        for c in ch:
            out = _eval(c, env, intr)
        return out
    if expr.is_for(t):
        idx = expr.for_index(t)
        start = int(_eval(ch[0], env, intr))
        end = int(_eval(ch[1], env, intr))
        step = int(_eval(ch[2], env, intr))
        saved = env.get(idx, _MISSING)
        for v in range(start, end, step):
            env[idx] = v
            _eval(ch[3], env, intr)
        if saved is _MISSING:
            env.pop(idx, None)
        else:
            env[idx] = saved
        return None
    if o == "store":
        a = _eval(ch[0], env, intr)
        idxs = tuple(int(_eval(c, env, intr)) for c in ch[1:-1])
        val = _eval(ch[-1], env, intr)
        a[idxs] = val
        return None
    if o == "load":
        a = _eval(ch[0], env, intr)
        idxs = tuple(int(_eval(c, env, intr)) for c in ch[1:])
        return a[idxs]
    if o.startswith("isax:"):
        name = o.split(":", 1)[1]
        args = [_eval(c, env, intr) for c in ch]
        intr[name](*args)
        return None

    args = [_eval(c, env, intr) for c in ch]
    return _apply(o, args)


_MISSING = object()


def _apply(o: str, a: list):
    import numpy as np
    if o == "+":
        return a[0] + a[1]
    if o == "-":
        return a[0] - a[1]
    if o == "*":
        return a[0] * a[1]
    if o == "/":
        return a[0] / a[1]
    if o == "<<":
        return a[0] << a[1]
    if o == ">>":
        return a[0] >> a[1]
    if o == "neg":
        return -a[0]
    if o == "exp":
        return np.exp(a[0])
    if o == "sqrt":
        return np.sqrt(a[0])
    if o == "rsqrt":
        return 1.0 / np.sqrt(a[0])
    if o == "recip":
        return 1.0 / a[0]
    if o in ("relu", "max0"):
        return np.maximum(a[0], 0)
    if o == "max":
        return np.maximum(a[0], a[1])
    if o == "min":
        return np.minimum(a[0], a[1])
    if o == "rowmax":
        return np.max(a[0], axis=-1)
    if o == "argmax":
        return int(np.argmax(a[0]))
    if o == "colmax":
        return np.max(a[0], axis=0)
    if o == "colmin":
        return np.min(a[0], axis=0)
    if o == "gather":
        return a[0][np.asarray(a[1], np.int64)]
    if o == "ballsel":
        # first-K in-radius indices (ascending), padded with the first hit;
        # no point in radius → the nearest point (see pointcloud/ref.py)
        d, r2, k = np.asarray(a[0]), float(a[1]), int(a[2])
        hits = np.nonzero(d <= r2)[0][:k]
        if hits.size == 0:
            return np.full((k,), int(np.argmin(d)), np.int64)
        return np.concatenate(
            [hits, np.full((k - hits.size,), hits[0], np.int64)])
    if o == "rowsum":
        return np.sum(a[0], axis=-1)
    if o == "rowmean":
        return np.mean(a[0], axis=-1)
    if o == "sum":
        return np.sum(a[0])
    if o == "matmul":
        return a[0] @ a[1]
    if o == "matvec":
        return a[0] @ a[1]
    if o == "outer":
        return np.outer(a[0], a[1])
    if o == "transpose":
        return np.transpose(a[0])
    if o == "dot":
        return np.dot(a[0], a[1])
    if o == "select":
        return np.where(a[0], a[1], a[2])
    raise NotImplementedError(f"evaluator op {o}")
