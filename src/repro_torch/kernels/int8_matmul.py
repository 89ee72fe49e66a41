"""Wrapper of kernel K4, the int8-weight GEMM (``csrc/int8_matmul.cu``).

The port of ``repro/kernels/int8_matmul.py::int8_matmul``: x (M, K) fp32,
bf16 or fp16, wq (N, K) int8, scale (N,) fp32 → (x @ f32(wq)ᵀ) ·
scale[None] in x's dtype, accumulated in fp32.  The CUDA kernel runs on
the tensor cores (``wgmma``): wq widened to bf16 (fp16 for fp16 x), fp32 x
cut into three exact bf16 terms, so every product is exact.  Its plan
(tile_m, tile_n, split, depth) is ``pipeline.int8_plan``'s; ragged edges
are zero-filled by the kernel, so any M, N and K are taken.  On CPU
tensors the wrapper computes the plain version (``ref.int8_matmul_ref``);
on CUDA tensors it launches K4 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import pipeline as _pl

#: k-values a step of the reference's tiles and of the routing rule
#: (``ops.int8_matmul``); K4's stage is as wide.
BLOCK_K = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

INT8_MATMUL = _build.CudaKernel(
    "int8_matmul", lib="int8_matmul", symbol="int8_matmul_launch",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    replaces="src/repro/kernels/int8_matmul.py:46")


def check_int8_args(name: str, x, wq, scale) -> int:
    """Raise on anything the CUDA int8 GEMMs do not take; return x's CUDA
    device index.  Devices are compared as indices (``get_device``), which
    costs a fraction of comparing ``torch.device`` objects on every call."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2 or wq.dim() != 2 or wq.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: want x (M, K) and wq (N, K), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if scale.shape != (wq.shape[0],):
        raise ValueError(f"{name}: want scale (N,) = ({wq.shape[0]},), got "
                         f"{tuple(scale.shape)}")
    if (x.dtype not in DTYPE_CODES or wq.dtype != torch.int8
            or scale.dtype != torch.float32):
        raise ValueError(f"{name}: want x fp32, bf16 or fp16, wq int8 and "
                         f"scale fp32, got {x.dtype}, {wq.dtype}, {scale.dtype}")
    if min(x.shape[0], x.shape[1], wq.shape[0]) < 1:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)} x "
                         f"{tuple(wq.shape)}")
    device = x.get_device()
    if (wq.get_device() != device or scale.get_device() != device
            or not (x.is_contiguous() and wq.is_contiguous()
                    and scale.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous on one device")
    return device


def current_stream(device: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``device``
    (the raw handle, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(device)


def int8_matmul(x, wq, scale, *, _plan=None):
    """K4 on CUDA tensors, the plain version on CPU tensors.

    ``_plan`` (tile_m, tile_n, split, depth) replaces ``int8_plan``'s pick;
    for the plan sweep and the card's tests only, and a plan the kernel
    does not take raises."""
    if x.device.type == "cpu":
        return ref.int8_matmul_ref(x, wq, scale)
    device = check_int8_args("int8_matmul", x, wq, scale)
    M, K = x.shape
    N = wq.shape[0]
    if _plan is None:
        plan = _pl.int8_plan(M, N, K, x.element_size(), pipelined=False)
    elif _pl.int8_plan_legal(_plan, M, N, K, x.element_size(),
                             pipelined=False):
        plan = tuple(_plan)
    else:
        raise ValueError(f"int8_matmul: plan {_plan} is not built or does "
                         f"not fit for M={M}, N={N}, K={K}, {x.dtype}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    INT8_MATMUL.launch(x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                       out.data_ptr(), M, N, K, *plan, DTYPE_CODES[x.dtype],
                       device, current_stream(device))
    return out


def k4_blocks_per_sm(plan, dtype: torch.dtype) -> int:
    """Blocks of K4 under ``plan`` (tile_m, tile_n, split, depth) resident
    on one SM of the current card with x of ``dtype``, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it at the
    plan's shared memory (0 for a plan the kernel is not built for)."""
    n = INT8_MATMUL.query("int8_matmul_occupancy", *plan, DTYPE_CODES[dtype])
    if n < 0:
        raise RuntimeError(f"int8_matmul: occupancy query failed (CUDA "
                           f"error {-n})")
    return n
