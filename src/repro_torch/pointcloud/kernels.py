"""Wrappers of the point-cloud kernels K9–K13 (``kernels/csrc``).

The port of ``repro/pointcloud/kernels.py``:

* K9 ``fps`` (``csrc/fps.cu``): one cloud per thread-block cluster, one
  barrier an argmax step, the plan from ``kernels.pipeline.fps_plan``;
* K10 ``ball_query`` (``csrc/ball_query.cu``, the cloud held in shared
  memory as fp32) and K11 ``ball_query_pipelined``
  (``csrc/ball_query_pipelined.cu``, X tiles through a ring of TMA bulk
  copies): several centers a warp, the cloud split over a cluster where
  the centers leave SMs idle, the plan from
  ``kernels.pipeline.ball_plan``;
* K12 ``group_aggregate`` (``csrc/group_aggregate.cu``: a direct row
  gather, a center's row loads all in flight at once) and K13
  ``group_aggregate_pipelined`` (``csrc/group_aggregate_pipelined.cu``: a
  channel slice of the cloud copied whole into shared memory in feature
  tiles by TMA, each row read from device memory once, a cluster's blocks
  sharing each tile by multicast, the gather from shared memory), the plan
  from ``kernels.pipeline.group_plan``.

Points are 3-d, fp32, bf16 or fp16 (distances in fp32 either way);
indices are int32.  On CPU tensors each
wrapper computes the plain version (``pointcloud/ref.py``); on CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPE_CODES
from repro_torch.kernels import pipeline as _pl
from repro_torch.kernels.pipeline import (DEPTHS, FPS_CAPACITY, fps_plan,
                                          fps_plan_legal)
from repro_torch.pointcloud import ref

#: Largest cloud whose points K9 keeps in registers (csrc/fps.cu: 16 blocks
#: of 1024 threads, 8 points a thread); above it the running distances live
#: in a global scratch array.
FPS_REGISTER_POINTS = FPS_CAPACITY
#: Points per X tile of K11 and per part of a split cloud
#: (csrc/ball_tile.cuh).
BALL_TILE = _pl.BALL_TILE

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PC = "src/repro/pointcloud/kernels.py"

FPS = _build.CudaKernel(
    "fps", lib="fps", symbol="fps_launch",
    argtypes=[_P] * 4 + [_I] * 8 + [_P], replaces=f"{_PC}:61")
BALL_QUERY = _build.CudaKernel(
    "ball_query", lib="ball_query", symbol="ball_query_launch",
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    replaces=f"{_PC}:130")
BALL_QUERY_PIPELINED = _build.CudaKernel(
    "ball_query_pipelined", lib="ball_query_pipelined",
    symbol="ball_query_pipelined_launch",
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P],
    replaces=f"{_PC}:180")
GROUP_AGGREGATE = _build.CudaKernel(
    "group_aggregate", lib="group_aggregate", symbol="group_aggregate_launch",
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    replaces=f"{_PC}:253")
GROUP_AGGREGATE_PIPELINED = _build.CudaKernel(
    "group_aggregate_pipelined", lib="group_aggregate_pipelined",
    symbol="group_aggregate_pipelined_launch",
    argtypes=[_P, _P, _P] + [_I] * 11 + [_P],
    replaces=f"{_PC}:287")


def _check(name: str, *tensors) -> None:
    """Raise unless the tensors are contiguous, 16-byte aligned and on one
    CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _check_points(name: str, *clouds) -> None:
    """Raise unless every cloud is (B, n, 3) of one fp32/bf16/fp16 dtype."""
    for c in clouds:
        if c.dim() != 3 or c.shape[-1] != 3 or c.shape[0] != clouds[0].shape[0]:
            raise ValueError(f"{name}: want (B, n, 3) points, got "
                             f"{tuple(c.shape)}")
        if c.dtype not in DTYPE_CODES or c.dtype != clouds[0].dtype:
            raise ValueError(f"{name}: points must share fp32, bf16 or fp16, got "
                             f"{c.dtype}")


def _check_depth(name: str, depth: int) -> None:
    if depth not in DEPTHS:
        raise ValueError(f"{name}: depth {depth} not in {DEPTHS}")


def fps_scratch_floats(B: int, N: int, plan) -> int:
    """Floats of global scratch K9 needs under ``plan``: B·N running
    distances on the scratch path (ppt 0), else none."""
    return B * N if plan[2] == 0 else 0


def fps(xyz: torch.Tensor, n_samples: int, *, sm_ids=None,
        _plan=None) -> torch.Tensor:
    """K9: xyz (B, N, 3) → sampled indices (B, n_samples) i32.

    The plan is ``fps_plan(B, N)``; ``_plan`` forces another (cluster,
    threads, ppt), for tests only.  Given ``sm_ids`` (int32 on xyz's CUDA
    device, at least B·cluster of them), the kernel writes there the SM
    each of its blocks ran on (cloud b's block rank r at b·cluster + r)."""
    if xyz.device.type == "cpu":
        if sm_ids is not None:
            raise ValueError("fps: sm_ids is written only by the kernel")
        return ref.fps_ref(xyz, n_samples)
    _check("fps", xyz)
    _check_points("fps", xyz)
    B, N, _ = xyz.shape
    if not 0 <= n_samples <= N:
        raise ValueError(f"fps: {n_samples} samples of {N} points")
    out = torch.empty((B, n_samples), dtype=torch.int32, device=xyz.device)
    if B == 0 or n_samples == 0:
        return out
    plan = fps_plan(B, N) if _plan is None else tuple(_plan)
    if not fps_plan_legal(plan, N):
        raise ValueError(f"fps: no kernel for plan {plan} at N={N}")
    if sm_ids is not None and (sm_ids.dtype != torch.int32
                               or sm_ids.device != xyz.device
                               or not sm_ids.is_contiguous()
                               or sm_ids.numel() < B * plan[0]):
        raise ValueError(f"fps: sm_ids must be {B * plan[0]} contiguous "
                         f"int32 on xyz's device")
    n = fps_scratch_floats(B, N, plan)
    scratch = (torch.empty((n,), dtype=torch.float32, device=xyz.device)
               if n else None)
    FPS.launch(_build.ptr(xyz), _build.ptr(out),
               None if scratch is None else _build.ptr(scratch),
               None if sm_ids is None else _build.ptr(sm_ids), B, N,
               n_samples, *plan, DTYPE_CODES[xyz.dtype], xyz.device.index,
               _build.stream_of(xyz))
    return out


def _ball_args(name, xyz, centers, k, plan, forced, depth):
    """Check the inputs; return (B, N, M, out, plan): ``plan`` (a
    schedule's, checked when the schedule was made) as given; else
    ``forced`` if the kernel takes it (else raise); else ``ball_plan``'s at
    ring ``depth`` (0: K10)."""
    _check(name, xyz, centers)
    _check_points(name, xyz, centers)
    if k < 1:
        raise ValueError(f"{name}: k must be at least 1, got {k}")
    B, N, _ = xyz.shape
    M = centers.shape[1]
    itemsize = xyz.element_size()
    if forced is not None:
        plan = tuple(forced)
        if (plan[3] == 0) != (depth == 0) or not (
                B * N * M == 0
                or _pl.ball_plan_legal(plan, B, N, M, k, itemsize)):
            raise ValueError(f"{name}: no kernel for plan {plan} at B={B}, "
                             f"N={N}, M={M}, k={k}, {xyz.dtype}")
    elif plan is None:
        plan = _pl.ball_plan(B, N, M, k, itemsize, depth,
                             _pl.sm_count(xyz.device))
    out = torch.empty((B, M, k), dtype=torch.int32, device=xyz.device)
    return B, N, M, out, plan


def ball_query(xyz, centers, radius: float, k: int, *,
               radius_sq: float | None = None, plan=None,
               _plan=None) -> torch.Tensor:
    """K10: xyz (B, N, 3), centers (B, M, 3) → indices (B, M, k) i32.

    ``plan`` (cpw, warps, split, 0) is a schedule's (``kernels/schedule.py``
    checked it), run as given; without it, ``ball_plan(B, N, M, k,
    itemsize)``.  ``_plan`` forces another, for the sweep and tests only."""
    if xyz.device.type == "cpu":
        return ref.ball_query_ref(xyz, centers, radius, k, radius_sq=radius_sq)
    B, N, M, out, plan = _ball_args("ball_query", xyz, centers, k, plan,
                                    _plan, 0)
    if out.numel():
        BALL_QUERY.launch(
            _build.ptr(xyz), _build.ptr(centers), _build.ptr(out), B, N, M, k,
            ref.squared_radius(radius, radius_sq), *plan[:3],
            DTYPE_CODES[xyz.dtype], xyz.device.index, _build.stream_of(xyz))
    return out


def ball_query_pipelined(xyz, centers, radius: float, k: int, *,
                         depth: int = 2, radius_sq: float | None = None,
                         plan=None, _plan=None) -> torch.Tensor:
    """K11: K10 with the X tiles streamed through a ``depth``-stage ring.

    ``plan`` (cpw, warps, split, depth) is a schedule's
    (``kernels/schedule.py`` checked it), run as given; without it,
    ``ball_plan(B, N, M, k, itemsize, depth)``.  ``_plan`` forces another,
    whose depth then replaces ``depth``, for the sweep and tests only."""
    if xyz.device.type == "cpu":
        return ref.ball_query_ref(xyz, centers, radius, k, radius_sq=radius_sq)
    _check_depth("ball_query_pipelined", depth)
    B, N, M, out, plan = _ball_args("ball_query_pipelined", xyz, centers, k,
                                    plan, _plan, depth)
    if out.numel():
        BALL_QUERY_PIPELINED.launch(
            _build.ptr(xyz), _build.ptr(centers), _build.ptr(out), B, N, M, k,
            ref.squared_radius(radius, radius_sq), *plan,
            DTYPE_CODES[xyz.dtype], xyz.device.index, _build.stream_of(xyz))
    return out


def group_ptxas(kernel: str, dtype: str, C: int, plan) -> tuple[int, int]:
    """(registers a thread, spill-store bytes) of the K12 or K13
    instantiation that ``plan`` launches for rows of C channels of
    ``dtype`` (a name), as ptxas reported them when the kernel's library
    was built (``_build.ptxas_report``; builds it if needed)."""
    t = _build.MANGLED_T[dtype]
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    if kernel == "group_aggregate":
        vec = (C * itemsize) % 16 == 0
        tag = (f"group_kernelI{t}Lb{int(vec)}E"
               f"Li{_pl.group_lanes(C, itemsize)}EE")
    else:
        tag = f"group_tiled_kernelI{t}Li{plan[1] * itemsize // 16}EE"
    hits = [v for name, v in _build.ptxas_report(kernel).items()
            if tag in name]
    if len(hits) != 1:
        raise RuntimeError(f"{tag}: {len(hits)} kernels in the build log")
    return hits[0]


def _group_args(name, features, idx):
    _check(name, features, idx)
    if features.dim() != 3 or idx.dim() != 3 or idx.shape[0] != features.shape[0]:
        raise ValueError(f"{name}: want features (B, N, C) and idx (B, M, k), "
                         f"got {tuple(features.shape)} and {tuple(idx.shape)}")
    if features.dtype not in DTYPE_CODES or idx.dtype != torch.int32:
        raise ValueError(f"{name}: features must be fp32, bf16 or fp16 and idx "
                         f"int32, got {features.dtype} and {idx.dtype}")
    B, N, C = features.shape
    M, k = idx.shape[1], idx.shape[2]
    if k < 1 or N < 1:
        raise ValueError(f"{name}: need k >= 1 and N >= 1, got {k}, {N}")
    out = torch.empty((B, M, C), dtype=features.dtype, device=features.device)
    return B, N, M, k, C, out


def _group_plan(name, features, shape, plan, forced, depth):
    """``plan`` (a schedule's, checked when the schedule was made) as
    given; else ``forced``, or where that is None ``group_plan``'s on
    features' card, if the kernel (K12 at ``depth`` 0, else K13) takes it
    at ``shape`` = (B, N, M, k, C), else raise."""
    if plan is not None:
        return plan
    itemsize = features.element_size()
    plan = forced
    if plan is None:
        plan = _pl.group_plan(*shape, itemsize, depth,
                              _pl.sm_count(features.device))
    plan = None if plan is None else tuple(plan)
    if (plan is None or (plan[3] == 0) != (depth == 0)
            or not _pl.group_plan_legal(plan, *shape, itemsize)):
        raise ValueError(f"{name}: no kernel for plan {plan} at "
                         f"(B, N, M, k, C) = {shape}, {features.dtype}")
    return plan


def group_aggregate(features, idx, *, plan=None, _plan=None) -> torch.Tensor:
    """K12: features (B, N, C), idx (B, M, k) i32 → max-pooled (B, M, C).

    ``plan`` (cpw, 0, 0, 0) is a schedule's (``kernels/schedule.py``
    checked it), run as given; without it, ``group_plan(B, N, M, k, C,
    itemsize, 0)``.  ``_plan`` forces another, for the sweep and tests
    only."""
    if features.device.type == "cpu":
        return ref.group_aggregate_ref(features, idx)
    B, N, M, k, C, out = _group_args("group_aggregate", features, idx)
    if out.numel():
        plan = _group_plan("group_aggregate", features, (B, N, M, k, C),
                           plan, _plan, 0)
        GROUP_AGGREGATE.launch(
            _build.ptr(features), _build.ptr(idx), _build.ptr(out), B, N, M, k,
            C, plan[0], DTYPE_CODES[features.dtype], features.device.index,
            _build.stream_of(features))
    return out


def group_aggregate_pipelined(features, idx, *, plan=None,
                              _plan=None) -> torch.Tensor:
    """K13: K12 with a channel slice of the cloud copied whole into shared
    memory, one slot a feature tile.

    ``plan`` (bn, cs, split, depth = tiles) is a schedule's
    (``kernels/schedule.py`` checked it), run as given; without it,
    ``group_plan(B, N, M, k, C, itemsize)``.  ``_plan`` forces another,
    for the sweep and tests only.
    Rows that are not whole 16-byte chunks, a cloud whose narrowest slice
    does not fit a block, and a plan the kernel is not built for or whose
    block does not fit, raise."""
    if features.device.type == "cpu":
        return ref.group_aggregate_ref(features, idx)
    B, N, M, k, C, out = _group_args("group_aggregate_pipelined", features,
                                     idx)
    if out.numel():
        plan = _group_plan("group_aggregate_pipelined", features,
                           (B, N, M, k, C), plan, _plan, None)
        GROUP_AGGREGATE_PIPELINED.launch(
            _build.ptr(features), _build.ptr(idx), _build.ptr(out), B, N, M, k,
            C, *plan, DTYPE_CODES[features.dtype], features.device.index,
            _build.stream_of(features))
    return out
