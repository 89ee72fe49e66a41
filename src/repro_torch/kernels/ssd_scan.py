"""Wrapper of kernel K7, the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``).

The port of ``repro/kernels/ssd_scan.py::ssd_scan``: x (BT,H,S,P),
dt (BT,H,S), A (H,), B/C (BT,S,N) → y (BT,H,S,P), fp32.  One block per
(batch, head) walks chunks of ``SSD_CHUNK`` positions with the (N,P)
state in shared memory.  The reference needs S to be a multiple of its
chunk; the kernel takes any S (positions past S act as dt = 0 and are
never written).  On CPU tensors the wrapper computes the plain version
(``ref.ssd_scan_ref``); on CUDA tensors it launches K7 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: Positions per chunk of K7 (csrc/ssd_scan.cu).
SSD_CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int

SSD_SCAN = _build.CudaKernel(
    "ssd_scan", lib="ssd_scan", symbol="ssd_scan_launch",
    argtypes=[_P] * 6 + [_I] * 6 + [_P],
    replaces="src/repro/kernels/ssd_scan.py:77")


def fixed_floats(Q: int, P: int, N: int) -> int:
    """Shared floats of a block besides its chunk buffers: state, B
    transposed, scores and four per-position vectors (csrc/ssd_tile.cuh)."""
    return N * P + N * (Q + 4) + Q * (Q + 4) + 4 * Q


def chunk_floats(Q: int, P: int, N: int) -> int:
    """Shared floats of one chunk's x and (row-padded) C."""
    return Q * P + Q * (N + 4)


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of one K7 block."""
    return 4 * (fixed_floats(SSD_CHUNK, P, N) + chunk_floats(SSD_CHUNK, P, N))


def ssd_tileable(P: int, N: int) -> bool:
    """True iff the SSD kernels take head dim P and state size N."""
    return P % 4 == 0 and N % 4 == 0 and smem_bytes(P, N) <= _build.MAX_SMEM


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
        raise ValueError(f"{name}: no kernel for P={P}, N={N} (multiples of "
                         f"4 whose block fits in shared memory)")
    for t in (x, dt, A, B, C):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be fp32, got {t.dtype}")
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
    y = torch.empty_like(x)
    SSD_SCAN.launch(_build.ptr(x), _build.ptr(dt), _build.ptr(A),
                    _build.ptr(B), _build.ptr(C), _build.ptr(y), BT, H, S, P,
                    B.shape[-1], x.device.index, _build.stream_of(x))
    return y
