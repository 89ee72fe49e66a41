"""Wrapper of kernel K7, the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``).

The port of ``repro/kernels/ssd_scan.py::ssd_scan``: x (BT,H,S,P),
dt (BT,H,S), A (H,), B/C (BT,S,N) → y (BT,H,S,P).  x, dt, B and C are
fp32, bf16 or fp16 (one dtype), A fp32; the kernel computes in fp32 and
writes y in x's dtype, as the reference does.  One block per (batch,
head) walks chunks of ``SSD_CHUNK`` positions (32 where a 64-position
block does not fit shared memory, ``ssd_chunk``) with the (N,P) state in
shared memory; any P and N whose block fits are taken (padded to
multiples of 4 inside the block).  The reference needs S to be a multiple
of its chunk; the kernel takes any S (positions past S act as dt = 0 and
are never written).  On CPU tensors the wrapper computes the plain version
(``ref.ssd_scan_ref``); on CUDA tensors it launches K7 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: Positions per chunk of K7 (csrc/ssd_scan.cu), largest first.
SSD_CHUNK = 64
SSD_CHUNKS = (SSD_CHUNK, 32)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I = ctypes.c_void_p, ctypes.c_int

SSD_SCAN = _build.CudaKernel(
    "ssd_scan", lib="ssd_scan", symbol="ssd_scan_launch",
    argtypes=[_P] * 6 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/ssd_scan.py:77")


def pad4(n: int) -> int:
    """``n`` rounded up to a multiple of 4 (the block's padded widths)."""
    return -(-n // 4) * 4


def fixed_floats(Q: int, P: int, N: int) -> int:
    """Shared floats of a block besides its chunk buffers: state, B
    transposed, scores and four per-position vectors, at P and N padded to
    multiples of 4 (csrc/ssd_tile.cuh)."""
    P, N = pad4(P), pad4(N)
    return N * P + N * (Q + 4) + Q * (Q + 4) + 4 * Q


def chunk_floats(Q: int, P: int, N: int) -> int:
    """Shared floats of one chunk's x and (row-padded) C in fp32."""
    return Q * pad4(P) + Q * (pad4(N) + 4)


def smem_bytes(P: int, N: int, chunk: int = SSD_CHUNK) -> int:
    """Shared memory of one K7 block."""
    return 4 * (fixed_floats(chunk, P, N) + chunk_floats(chunk, P, N))


def ssd_chunk(P: int, N: int) -> int | None:
    """K7's chunk for head dim P and state size N: the largest of
    ``SSD_CHUNKS`` whose block fits shared memory; None if none does."""
    return next((Q for Q in SSD_CHUNKS
                 if smem_bytes(P, N, Q) <= _build.MAX_SMEM), None)


def ssd_tileable(P: int, N: int) -> bool:
    """True iff the SSD kernels take head dim P and state size N: K7's
    block fits at some chunk (the (N, P) fp32 state is the most of it)."""
    return P >= 1 and N >= 1 and ssd_chunk(P, N) is not None


def check_ssd_args(name: str, x, dt, A, B, C) -> None:
    """Raise on anything the CUDA SSD kernels do not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError(f"{name}: want x (BT,H,S,P), dt (BT,H,S), A (H,), "
                         f"B/C (BT,S,N)")
    BT, H, S, P = x.shape
    N = B.shape[-1]
    if (tuple(dt.shape) != (BT, H, S) or tuple(A.shape) != (H,)
            or tuple(B.shape) != (BT, S, N) or C.shape != B.shape):
        raise ValueError(f"{name}: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if not ssd_tileable(P, N):
        raise ValueError(f"{name}: no kernel for P={P}, N={N} (the block "
                         f"does not fit in shared memory)")
    if x.dtype not in DTYPE_CODES or A.dtype != torch.float32 or any(
            t.dtype != x.dtype for t in (dt, B, C)):
        raise ValueError(f"{name}: want x, dt, B, C of one dtype of "
                         f"fp32/bf16/fp16 and A fp32, got x {x.dtype}, "
                         f"dt {dt.dtype}, A {A.dtype}, B {B.dtype}, "
                         f"C {C.dtype}")
    for t in (x, dt, A, B, C):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one "
                             f"device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def ssd_scan(x, dt, A, B, C):
    """K7 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    check_ssd_args("ssd_scan", x, dt, A, B, C)
    BT, H, S, P = x.shape
    N = B.shape[-1]
    y = torch.empty_like(x)
    SSD_SCAN.launch(_build.ptr(x), _build.ptr(dt), _build.ptr(A),
                    _build.ptr(B), _build.ptr(C), _build.ptr(y), BT, H, S, P,
                    N, ssd_chunk(P, N), DTYPE_CODES[x.dtype], x.device.index,
                    _build.stream_of(x))
    return y
