"""The point-cloud domain package (the paper's second application domain).

The port of ``repro/targets/pointcloud.py``: farthest-point sampling,
ball-query grouping and grouped feature aggregation, a PointNet++-style
set-abstraction stage.  Trace programs, ISAX definitions and numpy
evaluator semantics are the reference's, copied; the kernels are the
port's routes (``pointcloud/ops.py``, ``pointcloud/kernels.py``) and the
schedulers return the H100 schedule of ``kernels/schedule.py``, or
``(None, why)`` where the reference keeps the plain version
(``pointcloud.ops.fallback``).  The reference also sends FPS to its plain
version when the cloud exceeds the TPU's VMEM; the port's FPS kernel has
no such ceiling.  Registered by ``repro_torch.targets`` after the ``llm``
domain.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.expr import Term, arr, const, for_, var
from repro_torch.core.matching import ISAX
from repro_torch.core.tiling import dtype_itemsize
from repro_torch.kernels import schedule as ks
from repro_torch.kernels.pipeline import current_sm_count
from repro_torch.pointcloud import ops as pcops
from repro_torch.pointcloud.kernels import (ball_query_pipelined,
                                            group_aggregate_pipelined)
from repro_torch.targets.llm import KERNEL_DTYPES
from repro_torch.targets.registry import DomainPackage, IsaxSpec

if TYPE_CHECKING:
    from repro_torch.compile.trace import OpKey


# ---------------------------------------------------------------------------
# Trace programs (software-side spellings, AF/RF-divergent from the ISAXes)
# ---------------------------------------------------------------------------

def _sqdist_expanded(a, b):
    """Row-wise squared distance in the *expanded* spelling
    ‖a‖² + (‖b‖² − 2·a·b): AF-divergent from the ISAXes' compact
    rowsum((a−b)²) form — ``rewrites.sqdist-expand`` must bridge the gap."""
    return ("+", ("rowsum", ("*", a, a)),
            ("-", ("rowsum", ("*", b, b)),
             ("*", ("const:2",), ("rowsum", ("*", a, b)))))


def _fps_program() -> Term:
    """Farthest-point sampling with the distance spelled expanded; the
    loop-carried dependences (S feeds the same iteration's distance update,
    D feeds the next iteration's argmax) must survive saturation."""
    s = var("s")
    picked = ("load", arr("Xp"), ("load", arr("Sp"), s))
    return for_("s", const(0), var("n_s"), const(1),
                ("store", arr("Sp"), s,
                 ("argmax", ("load", arr("Dp"), const(0)))),
                ("store", arr("Dp"), const(0),
                 ("min", ("load", arr("Dp"), const(0)),
                  _sqdist_expanded(arr("Xp"), picked))))


def _ball_query_program() -> Term:
    """Ball query with the expanded distance spelling (same AF divergence
    as fps, exercised under a different skeleton)."""
    j = var("j")
    return for_("j", const(0), var("n_c"), const(1),
                ("store", arr("Gq"), j,
                 ("ballsel",
                  _sqdist_expanded(arr("Xp"), ("load", arr("Cn"), j)),
                  var("r2"), var("kk"))))


def _group_agg_program() -> Term:
    """Grouped aggregation with max-pool spelled as neg∘colmin∘neg
    (RF-divergent; ``rewrites.colmax-neg-colmin`` recovers the ISAX form)."""
    j = var("j")
    gathered = ("gather", arr("Fg"), ("load", arr("Gq"), j))
    return for_("j", const(0), var("n_c"), const(1),
                ("store", arr("Ag"), j,
                 ("neg", ("colmin", ("neg", gathered)))))


# ---------------------------------------------------------------------------
# ISAX definitions
# ---------------------------------------------------------------------------

def _sqdist(a: Term, b: Term) -> Term:
    """Compact row-wise squared distance ‖a − b‖² (the ISAX-side spelling)."""
    return ("rowsum", ("*", ("-", a, b), ("-", a, b)))


def isax_fps() -> ISAX:
    """Farthest-point sampling: S[s] = argmax of the running min-distance,
    D ← min(D, ‖X − X[S[s]]‖²).  Loop-carried dependences through *both*
    outputs (S feeds the distance update of the same iteration, D feeds the
    argmax of the next) — the point-cloud stress test for the §5.4
    loop-carried checks."""
    s = var("s")
    term = for_("s", const(0), var("n_s"), const(1),
                ("store", arr("Sp"), s,
                 ("argmax", ("load", arr("Dp"), const(0)))),
                ("store", arr("Dp"), const(0),
                 ("min", ("load", arr("Dp"), const(0)),
                  _sqdist(arr("Xp"),
                          ("load", arr("Xp"), ("load", arr("Sp"), s))))))
    return ISAX(
        name="fps",
        params=("Xp", "n_s", "Dp", "Sp"),
        term=term,
        kernel="fps",
        outputs=("Dp", "Sp"),
    )


def isax_ball_query() -> ISAX:
    """Ball query / kNN grouping: G[j] = first-kk indices of X within
    radius² of center j (padded; nearest point when the ball is empty).
    The irregular-gather front half of PointNet++ set abstraction."""
    j = var("j")
    term = for_("j", const(0), var("n_c"), const(1),
                ("store", arr("Gq"), j,
                 ("ballsel",
                  _sqdist(arr("Xp"), ("load", arr("Cn"), j)),
                  var("r2"), var("kk"))))
    return ISAX(
        name="ball_query",
        params=("Xp", "Cn", "r2", "kk", "n_c", "Gq"),
        term=term,
        kernel="ball_query",
        outputs=("Gq",),
    )


def isax_group_agg() -> ISAX:
    """Grouped feature aggregation: A[j] = max-pool over the rows of F
    gathered by neighbor list G[j] (the fused PointNet++ set-abstraction
    datapath: gather + reduce in one pass over the feature array)."""
    j = var("j")
    term = for_("j", const(0), var("n_c"), const(1),
                ("store", arr("Ag"), j,
                 ("colmax", ("gather", arr("Fg"),
                             ("load", arr("Gq"), j)))))
    return ISAX(
        name="group_agg",
        params=("Fg", "Gq", "n_c", "Ag"),
        term=term,
        kernel="group_aggregate",
        outputs=("Ag",),
    )


# ---------------------------------------------------------------------------
# Evaluator semantics (numpy oracles; pointcloud/ops.py's
# pointcloud_intrinsics replaces them with the kernel routes)
# ---------------------------------------------------------------------------

def _np_fps(Xp, n_s, Dp, Sp):
    d = Dp[0]
    for s in range(int(n_s)):
        Sp[s] = int(np.argmax(d))
        diff = Xp - Xp[Sp[s]]
        d = np.minimum(d, (diff * diff).sum(-1))
    Dp[0] = d


def _np_ball_query(Xp, Cn, r2, kk, n_c, Gq):
    k = int(kk)
    for j in range(int(n_c)):
        diff = Xp - Cn[j]
        d = (diff * diff).sum(-1)
        hits = np.nonzero(d <= float(r2))[0][:k]
        if hits.size == 0:
            Gq[j] = int(np.argmin(d))
        else:
            Gq[j, :hits.size] = hits
            Gq[j, hits.size:] = hits[0]


def _np_group_agg(Fg, Gq, n_c, Ag):
    for j in range(int(n_c)):
        Ag[j] = Fg[np.asarray(Gq[j], np.int64)].max(axis=0)


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------

def _fallback(key: "OpKey", target: str):
    """Why this key takes the plain version, or None."""
    if key.dtype not in KERNEL_DTYPES:
        return f"no {target} kernel for {key.dtype}"
    return pcops.fallback(key.op, key.shape)


def _fps_schedule(key: "OpKey"):
    B, N, S = key.shape
    why = _fallback(key, "fps")
    if why:
        return None, why
    return ks.fps_schedule(B, N, S, current_sm_count()), "ok"


def _ball_schedule(key: "OpKey"):
    B, N, M, K = key.shape
    why = _fallback(key, "ball_query")
    if why:
        return None, why
    return ks.ball_schedule(B, N, M, K, dtype_itemsize(key.dtype),
                            current_sm_count()), "ok"


def _group_schedule(key: "OpKey"):
    B, N, M, K, C = key.shape
    why = _fallback(key, "group_agg")
    if why:
        return None, why
    return ks.group_schedule(B, N, M, K, C, dtype_itemsize(key.dtype),
                             current_sm_count()), "ok"


# ---------------------------------------------------------------------------
# The domain package
# ---------------------------------------------------------------------------

DOMAIN = DomainPackage(
    name="pointcloud",
    description="Point-cloud set abstraction (FPS → ball query → grouped "
                "aggregation), the second application domain.",
    specs=(
        IsaxSpec(
            name="fps",
            isax=isax_fps,
            evaluator=_np_fps,
            trace_kind="fps",
            trace_program=_fps_program,
            ops=("fps",),
            rewrites=("sqdist-expand",),
            scheduler=_fps_schedule,
            kernel=pcops.kernel_fps,
            op_notes=(("fps", "loop-carried argmax; never pipelined"),),
            description="Farthest-point sampling (the cloud split over a "
                        "cluster's registers).",
        ),
        IsaxSpec(
            name="ball_query",
            isax=isax_ball_query,
            evaluator=_np_ball_query,
            trace_kind="ball_query",
            trace_program=_ball_query_program,
            ops=("ball_query",),
            rewrites=("sqdist-expand",),
            scheduler=_ball_schedule,
            kernel=pcops.kernel_ball_query,
            kernel_pipelined=ball_query_pipelined,
            description="Radius neighbor grouping over streamed X tiles.",
        ),
        IsaxSpec(
            name="group_agg",
            isax=isax_group_agg,
            evaluator=_np_group_agg,
            trace_kind="group_aggregate",
            trace_program=_group_agg_program,
            ops=("group_aggregate",),
            rewrites=("colmax-neg-colmin",),
            scheduler=_group_schedule,
            kernel=pcops.kernel_group_aggregate,
            kernel_pipelined=group_aggregate_pipelined,
            description="Grouped max-pool aggregation (rows gathered "
                        "from L2, or from the cloud's slice in shared "
                        "memory).",
        ),
    ),
)
