"""Public point-cloud entry points: route between the kernels and their
plain versions, and the e-graph evaluator's point-cloud intrinsics.

The port of ``repro/pointcloud/ops.py``.  ``fallback`` holds the
reference's fallbacks, which the dispatcher's schedulers
(``targets/pointcloud.py``) and the wrappers below read:

* FPS takes the plain version when asked for more samples than points;
* ball query and grouped aggregation take it on shapes the reference cannot
  tile (``tileable``, the counterpart of ``pc_tiles``).

Everything else goes to a kernel route (``kernel_*``), which runs the
kernel its schedule names — the record's, or where none is passed the one
``kernels/schedule.py`` computes (K10 or K11, K12 or K13, each at its
plan; the cost model's choice, ``core/kernel_synth.decide_hopper``) — and
raises on CUDA tensors the kernel does not take (points other than 3-d,
dtypes other than fp32/bf16/fp16).  ``pipelined`` overrides the choice
between the two kernels of a pair, for tests and sweeps only.  Each
kernel route raises under autograd (``kernels.ops.no_grad_guard``).

``pointcloud_intrinsics`` / ``register_pointcloud_intrinsics`` bind the
routes to the ``isax:`` e-nodes of ``core/offload.evaluate``: the kernels
on the card unless the caller asks for the CPU (``device="cpu"``, the
plain versions); with no CUDA device and no ``device`` they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tiling import down_pow2
from repro_torch.kernels import schedule as ks
from repro_torch.kernels.ops import chosen, no_grad_guard, resolve_device
from repro_torch.kernels.pipeline import sm_count
from repro_torch.pointcloud import kernels as pck
from repro_torch.pointcloud import ref

#: Least power-of-two tiles the reference accepts: 8 centers, 128 points
#: (or the whole axis when it is shorter).
MIN_CENTER_TILE = 8
MIN_POINT_TILE = 128


def tileable(M: int, N: int) -> bool:
    """The reference's tiling test (``pc_tiles``): the power-of-two tiles of
    M centers and N points must not degrade below 8 centers and 128 points
    (or the whole axis when it is shorter)."""
    return (down_pow2(M, MIN_CENTER_TILE) >= min(M, MIN_CENTER_TILE)
            and down_pow2(N, MIN_POINT_TILE) >= min(N, MIN_POINT_TILE))


def fallback(op: str, shape) -> str | None:
    """Why the reference sends one point-cloud op instance to its plain
    version, or None where the kernel runs.  Shapes are ``lower``'s keys:
    ``fps`` (B, N, S), ``ball_query`` (B, N, M, k), ``group_aggregate``
    (B, N, M, k, C)."""
    if op == "fps":
        B, N, S = shape
        return (f"more samples than points (S={S} > N={N})" if S > N
                else None)
    N, M = shape[1], shape[2]
    return (None if tileable(M, N)
            else f"untileable shape M={M} N={N} (pow2 tiles degrade)")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte-aligned address (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_fps(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """K9 at ``pipeline.fps_plan``'s plan (the one its schedule records),
    with no fallback."""
    no_grad_guard("kernel_fps", xyz)
    return pck.fps(_aligned(xyz), n_samples)


def farthest_point_sample(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS: xyz (B, N, 3) → indices (B, n_samples) i32 (K9)."""
    B, N, _ = xyz.shape
    if fallback("fps", (B, N, n_samples)):
        return ref.fps_ref(xyz, n_samples)
    return kernel_fps(xyz, n_samples)


def kernel_ball_query(xyz, centers, radius: float, k: int, *,
                      schedule: dict | None = None,
                      pipelined: bool | None = None,
                      radius_sq: float | None = None) -> torch.Tensor:
    """K10 or K11 (and its ring depth) at its plan, as the schedule says;
    no fallback."""
    no_grad_guard("kernel_ball_query", xyz, centers)
    xyz, centers = _aligned(xyz), _aligned(centers)
    B, N, _ = xyz.shape
    if schedule is None:
        schedule = ks.ball_schedule(B, N, centers.shape[1], k,
                                    xyz.element_size(), sm_count(xyz.device))
    run = chosen(schedule, pipelined)
    if run["depth"]:
        return pck.ball_query_pipelined(xyz, centers, radius, k,
                                        depth=run["depth"],
                                        radius_sq=radius_sq, plan=run["plan"])
    return pck.ball_query(xyz, centers, radius, k, radius_sq=radius_sq,
                          plan=run["plan"])


def ball_query(xyz, centers, radius: float, k: int, *,
               pipelined: bool | None = None,
               radius_sq: float | None = None) -> torch.Tensor:
    """Ball query: xyz (B, N, 3), centers (B, M, 3) → (B, M, k) i32.

    ``radius_sq`` gives r² exactly where the caller holds it.
    """
    B, N, _ = xyz.shape
    if fallback("ball_query", (B, N, centers.shape[1], k)):
        return ref.ball_query_ref(xyz, centers, radius, k, radius_sq=radius_sq)
    return kernel_ball_query(xyz, centers, radius, k, pipelined=pipelined,
                             radius_sq=radius_sq)


def kernel_group_aggregate(features, idx, *, schedule: dict | None = None,
                           pipelined: bool | None = None) -> torch.Tensor:
    """K12 or K13 at its plan, as the schedule says (K12 where no slice of
    the cloud fits a K13 block); no fallback."""
    no_grad_guard("kernel_group_aggregate", features)
    features = _aligned(features)
    idx = _aligned(idx.to(torch.int32))
    B, N, C = features.shape
    if schedule is None:
        schedule = ks.group_schedule(B, N, idx.shape[1], idx.shape[2], C,
                                     features.element_size(),
                                     sm_count(features.device))
    run = chosen(schedule, pipelined)
    if run["depth"]:
        return pck.group_aggregate_pipelined(features, idx, plan=run["plan"])
    return pck.group_aggregate(features, idx, plan=run["plan"])


def group_aggregate(features, idx, *,
                    pipelined: bool | None = None) -> torch.Tensor:
    """Grouped max-pool: features (B, N, C), idx (B, M, k) → (B, M, C)."""
    B, N, C = features.shape
    if fallback("group_aggregate", (B, N, *idx.shape[1:], C)):
        return ref.group_aggregate_ref(features, idx)
    return kernel_group_aggregate(features, idx, pipelined=pipelined)


# ---------------------------------------------------------------------------
# E-graph intrinsics: the isax: e-nodes of core/offload.evaluate run the
# kernel routes on float32 tensors of ``device``
# ---------------------------------------------------------------------------

def pointcloud_intrinsics(device=None) -> dict:
    """Intrinsics for fps, ball_query and group_agg that compute through
    the kernel routes on ``device`` (default the card; plain versions on
    the CPU)."""
    device = resolve_device(device)

    def points(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)[None]

    def fps(Xp, n_s, Dp, Sp):
        """Valid for the canonical start (Dp uniform → start at point 0)."""
        sel = kernel_fps(points(Xp), int(n_s))
        Sp[:] = sel[0].cpu().numpy().astype(Sp.dtype)
        # D (the running min-distance) is ISAX-internal state; materialize
        # it for evaluator parity with the software program
        d = np.asarray(Dp[0], np.float64)
        X = np.asarray(Xp, np.float64)
        for s in np.asarray(Sp, np.int64):
            diff = X - X[s]
            d = np.minimum(d, (diff * diff).sum(-1))
        Dp[0] = d.astype(Dp.dtype)

    def ball(Xp, Cn, r2, kk, n_c, Gq):
        # the ISAX contract is in r²: pass it exactly (radius_sq)
        sel = kernel_ball_query(points(Xp), points(Cn), float(np.sqrt(r2)),
                                int(kk), radius_sq=float(r2))
        Gq[:] = sel[0].cpu().numpy().astype(Gq.dtype)

    def group(Fg, Gq, n_c, Ag):
        idx = torch.as_tensor(np.asarray(Gq), dtype=torch.int32,
                              device=device)[None]
        Ag[:] = kernel_group_aggregate(points(Fg), idx)[0].cpu().numpy()

    return {"fps": fps, "ball_query": ball, "group_agg": group}


def register_pointcloud_intrinsics(device=None) -> None:
    """Register ``pointcloud_intrinsics(device)`` as the e-graph
    evaluator's overrides (``core.offload.register_intrinsic``)."""
    from repro_torch.core import offload
    for name, fn in pointcloud_intrinsics(device).items():
        offload.register_intrinsic(name, fn)
