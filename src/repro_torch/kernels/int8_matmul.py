"""Wrapper of kernel K4, the int8-weight GEMM (``csrc/int8_matmul.cu``).

The port of ``repro/kernels/int8_matmul.py::int8_matmul``: x (M, K) fp32,
bf16 or fp16, wq (N, K) int8, scale (N,) fp32 → (x @ f32(wq)ᵀ) ·
scale[None] in x's dtype, accumulated in fp32.  The CUDA kernel tiles 64 x 64 outputs with
64-wide k steps and masks ragged edges itself, so any M, N and K are taken.
On CPU tensors the wrapper computes the plain version
(``ref.int8_matmul_ref``); on CUDA tensors it launches K4 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: k-values a tile step of K4 and K5 (csrc/int8_tile.cuh).
BLOCK_K = 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

INT8_MATMUL = _build.CudaKernel(
    "int8_matmul", lib="int8_matmul", symbol="int8_matmul_launch",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="src/repro/kernels/int8_matmul.py:46")


def check_int8_args(name: str, x, wq, scale) -> None:
    """Raise on anything the CUDA int8 GEMMs do not take."""
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
    for t in (x, wq, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")


def int8_matmul(x, wq, scale):
    """K4 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ref.int8_matmul_ref(x, wq, scale)
    check_int8_args("int8_matmul", x, wq, scale)
    M, K = x.shape
    N = wq.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    INT8_MATMUL.launch(_build.ptr(x), _build.ptr(wq), _build.ptr(scale),
                       _build.ptr(out), M, N, K, DTYPE_CODES[x.dtype],
                       x.device.index, _build.stream_of(x))
    return out
