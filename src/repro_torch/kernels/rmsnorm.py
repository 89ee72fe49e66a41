"""Wrapper of kernel K1, the fused RMSNorm (``csrc/rmsnorm.cu``).

The port of ``repro/kernels/rmsnorm.py::rmsnorm``: x (R, d) fp32 or bf16,
g (d,) fp32 → x · rsqrt(mean(x²) + eps) · g in x's dtype, statistics in
fp32.  On a CPU tensor the wrapper computes the plain version
(``ref.rmsnorm_ref``); on a CUDA tensor it launches K1 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

RMSNORM = _build.CudaKernel(
    "rmsnorm", lib="rmsnorm", symbol="rmsnorm_launch",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="src/repro/kernels/rmsnorm.py:20")


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6):
    """x: (R, d), g: (d,) fp32 → (R, d) of x.dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, g, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if x.dim() != 2 or g.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: want x (R, d) and g (d,), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in DTYPE_CODES or g.dtype != torch.float32:
        raise ValueError(f"rmsnorm: x must be fp32 or bf16 and g fp32, got "
                         f"{x.dtype} and {g.dtype}")
    if g.device != x.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("rmsnorm: x and g must be contiguous on one device")
    R, d = x.shape
    out = torch.empty_like(x)
    if R == 0:
        return out
    vec = int((d * x.element_size()) % 16 == 0
              and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    RMSNORM.launch(_build.ptr(x), _build.ptr(g), _build.ptr(out), R, d,
                   float(eps), DTYPE_CODES[x.dtype], vec, x.device.index,
                   _build.stream_of(x))
    return out
