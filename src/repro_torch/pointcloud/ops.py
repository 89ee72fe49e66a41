"""Public point-cloud entry points: route between the kernels and their
plain versions.

The port of ``repro/pointcloud/ops.py`` (its wrappers; the e-graph
intrinsics wait for the port of the dispatch engine).  ``fallback`` holds
the reference's fallbacks, and ``LoweringConfig.lower`` reads it too:

* FPS takes the plain version when asked for more samples than points;
* ball query and grouped aggregation take it on shapes the reference cannot
  tile (``tileable``, the counterpart of ``pc_tiles``).

Everything else goes to a kernel wrapper (``kernel_*``), which raises on
CUDA tensors the kernel does not take (points other than 3-d, dtypes other
than fp32/bf16/fp16).  Baseline or pipelined follows the port's rule
(``kernels.pipeline.use_pipeline``): pipeline from two streamed tiles up,
or as ``pipelined`` says.  The streamed tiles are K11's 256-point X tiles
and the feature tiles of K13's plan (``kernels.pipeline.group_plan``).
"""

from __future__ import annotations

import torch

from repro_torch.core.tiling import down_pow2
from repro_torch.kernels.pipeline import (group_plan, group_tiles, sm_count,
                                          use_pipeline)
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
    """K9, with no fallback."""
    return pck.fps(_aligned(xyz), n_samples)


def farthest_point_sample(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS: xyz (B, N, 3) → indices (B, n_samples) i32 (K9)."""
    B, N, _ = xyz.shape
    if fallback("fps", (B, N, n_samples)):
        return ref.fps_ref(xyz, n_samples)
    return kernel_fps(xyz, n_samples)


def ball_steps(N: int) -> int:
    """X tiles of one ball-query sweep."""
    return -(-N // pck.BALL_TILE)


def kernel_ball_query(xyz, centers, radius: float, k: int, *,
                      pipelined: bool | None = None,
                      radius_sq: float | None = None) -> torch.Tensor:
    """K11 when the sweep has two X tiles or more (``pipelined``
    overrides), else K10; no fallback."""
    xyz, centers = _aligned(xyz), _aligned(centers)
    n_steps = ball_steps(xyz.shape[1])
    if use_pipeline(n_steps, pipelined):
        return pck.ball_query_pipelined(xyz, centers, radius, k,
                                        depth=min(max(pck.DEPTHS), n_steps),
                                        radius_sq=radius_sq)
    return pck.ball_query(xyz, centers, radius, k, radius_sq=radius_sq)


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


def group_steps(features, idx) -> int:
    """Feature tiles K13 copies under its plan (``group_plan``): the
    reference's ``N // bn``; 0 where K13 takes no plan."""
    B, N, C = features.shape
    M, k = idx.shape[1], idx.shape[2]
    plan = group_plan(B, N, M, k, C, features.element_size(), None,
                      sm_count(features.device))
    return 0 if plan is None else group_tiles(N, plan[0])


def kernel_group_aggregate(features, idx, *,
                           pipelined: bool | None = None) -> torch.Tensor:
    """K13 when its plan copies two feature tiles or more (``pipelined``
    overrides), else K12 (also where no slice of the cloud fits a K13
    block); no fallback."""
    features = _aligned(features)
    idx = _aligned(idx.to(torch.int32))
    if use_pipeline(group_steps(features, idx), pipelined):
        return pck.group_aggregate_pipelined(features, idx)
    return pck.group_aggregate(features, idx)


def group_aggregate(features, idx, *,
                    pipelined: bool | None = None) -> torch.Tensor:
    """Grouped max-pool: features (B, N, C), idx (B, M, k) → (B, M, C)."""
    B, N, C = features.shape
    if fallback("group_aggregate", (B, N, *idx.shape[1:], C)):
        return ref.group_aggregate_ref(features, idx)
    return kernel_group_aggregate(features, idx, pipelined=pipelined)
