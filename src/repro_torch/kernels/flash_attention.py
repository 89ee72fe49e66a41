"""Wrapper of kernel K2, GQA flash attention (``csrc/flash_attention.cu``).

The port of ``repro/kernels/flash_attention.py::flash_attention``: q
(B,S,H,hd), k/v (B,T,K,hd), mask (1|B,S,T) bool → (B,S,H,hd).  Masked
scores are -1e30 with p = 0, and a row with no valid key gives 0.  The
CUDA kernel tiles 64 query rows by 64 keys and masks ragged edges itself,
so any S and T are taken; hd must be one of ``HEAD_DIMS``.  On CPU tensors
the wrapper computes the plain version (``ref.flash_attention_ref``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: Tile of the CUDA kernels (query rows x keys); must match csrc/flash_tile.cuh.
BLOCK_Q = 64
BLOCK_K = 64
#: Head widths the kernels are instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

FLASH_ATTENTION = _build.CudaKernel(
    "flash_attention", lib="flash_attention", symbol="flash_attention_launch",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention.py:152")


def check_flash_args(name: str, q, k, v, mask) -> None:
    """Raise on anything the CUDA flash kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,S,H,hd) and k, v (B,T,K,hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (H % K must be 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share fp32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (mask.dtype != torch.bool or mask.dim() != 3
            or mask.shape[0] not in (1, B) or tuple(mask.shape[1:]) != (S, T)):
        raise ValueError(f"{name}: mask must be bool (1|B, S, T), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (q, k, v, mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def flash_attention(q, k, v, mask, *, sm_scale: float):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mask, sm_scale=sm_scale)
    check_flash_args("flash_attention", q, k, v, mask)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
        _build.ptr(out), B, S, T, H, K, hd, mask.shape[0], float(sm_scale),
        DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q))
    return out
