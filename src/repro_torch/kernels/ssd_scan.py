"""Wrapper of kernel K7, the Mamba2 SSD chunked scan (``csrc/ssd_scan.cu``).

The port of ``repro/kernels/ssd_scan.py::ssd_scan``: x (BT,H,S,P),
dt (BT,H,S), A (H,), B/C (BT,S,N) → y (BT,H,S,P).  x, dt, B and C are
fp32, bf16 or fp16 (one dtype), A fp32; the kernel computes in fp32 and
writes y in x's dtype, as the reference does.  Its four products run on
the tensor cores in 3xTF32 (``csrc/ssd_tile.cuh``), which keeps fp32
accuracy.  One block of a head of a batch row walks chunks of ``CHUNK``
positions with the (N,P) state in its warps' registers; every P and N in
the lowering's envelope is taken.  The reference needs S to be a multiple
of its chunk; the kernel takes any S (positions past S act as dt = 0 and
are never written).  On CPU tensors the wrapper computes the plain version
(``ref.ssd_scan_ref``); on CUDA tensors it launches K7 or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build, ref

#: The chunk of K7's first design: ``ops.ssd_scan`` sends a sweep of two
#: such chunks or more to K8, a rule kept as it is.
SSD_CHUNK = 64
#: Positions a chunk of K7 and K8 (csrc/ssd_tile.cuh ``Q``).
CHUNK = 16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Warps a block may have; head-dim rows and state n8 tiles one warp holds
#: (csrc/ssd_tile.cuh kMaxWarps, kWarpP, kWarpNT).
MAX_WARPS = 8
WARP_P = 16
WARP_NT = 16

_P, _I = ctypes.c_void_p, ctypes.c_int

SSD_SCAN = _build.CudaKernel(
    "ssd_scan", lib="ssd_scan", symbol="ssd_scan_launch",
    argtypes=[_P] * 6 + [_I] * 7 + [_P],
    replaces="src/repro/kernels/ssd_scan.py:77")


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class Geom:
    """How a scan is laid out over warps and blocks, and its shared-memory
    row strides in floats (csrc/ssd_tile.cuh ``geom``)."""
    npad: int    # N rounded up to whole n8 tiles
    nr: int      # warps across the state columns (128 each)
    pbw: int     # 16-row head-dim blocks of the head in one block; 0: none
    psplit: int  # blocks across the head dim
    warps: int   # pbw * nr
    xs: int      # row stride of x
    bs: int      # row stride of B and C


def geom(P: int, N: int) -> Geom:
    npad = _round_up(N, 8)
    nr = -(-npad // (8 * WARP_NT))
    pb = -(-P // WARP_P)
    pbw = min(MAX_WARPS // nr, pb)
    return Geom(npad=npad, nr=nr, pbw=pbw,
                psplit=-(-pb // pbw) if pbw else 0,
                warps=pbw * nr, xs=WARP_P * pbw + 8, bs=8 * WARP_NT * nr + 8)


def stage_floats(P: int, N: int) -> int:
    """Shared floats of one chunk's x, B and C."""
    g = geom(P, N)
    return CHUNK * g.xs + 2 * CHUNK * g.bs


def fixed_floats(P: int, N: int) -> int:
    """Shared floats of a block besides its chunk: each warp's partial
    scores and cumsum scratch and, where the state is split over warps,
    their partial outputs."""
    g, Q = geom(P, N), CHUNK
    return (g.warps * Q * (Q + 4) + g.warps * 2 * Q
            + g.pbw * (g.nr - 1) * WARP_P * Q)


def smem_bytes(P: int, N: int) -> int:
    """Shared memory of one K7 block."""
    return 4 * (stage_floats(P, N) + fixed_floats(P, N))


def block_fits(P: int, N: int, nbytes: int) -> bool:
    """True iff a block has warps and ``nbytes`` of shared memory fit."""
    return geom(P, N).pbw >= 1 and nbytes <= _build.MAX_SMEM


def state_in_envelope(P: int, N: int) -> bool:
    """The state sizes the lowering table sends to the SSD kernels: an fp32
    (N, P) state that, with one 32-position chunk's x, B, C and scores
    (rows padded to 4), fits one block's shared memory.  The tensor-core
    kernels keep the state in registers and could take more; the table's
    envelope, and its stated deviation at P = N = 256, stay as they are."""
    PP, NP = _round_up(P, 4), _round_up(N, 4)
    Q = 32
    words = (NP * PP + NP * (Q + 4) + Q * (Q + 4) + 4 * Q + Q * PP
             + Q * (NP + 4))
    return 4 * words <= _build.MAX_SMEM


def ssd_tileable(P: int, N: int) -> bool:
    """True iff the SSD kernels take head dim P and state size N: the state
    is in the lowering's envelope and K7's block fits."""
    return (P >= 1 and N >= 1 and state_in_envelope(P, N)
            and block_fits(P, N, smem_bytes(P, N)))


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
        raise ValueError(f"{name}: no kernel for P={P}, N={N} (the state "
                         f"is outside the lowering's envelope)")
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
                    N, DTYPE_CODES[x.dtype], x.device.index,
                    _build.stream_of(x))
    return y


def blocks_per_sm(kernel: str, dtype: torch.dtype, P: int, N: int,
                  depth: int | None = None) -> int:
    """Blocks of ``kernel`` ("ssd_scan", or "ssd_scan_pipelined" at ring
    ``depth``) resident on one SM of the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it."""
    kern = _build.KERNELS[kernel]
    args = [P, N] + ([depth] if depth is not None else [])
    n = kern.query(kern.symbol.replace("_launch", "_occupancy"), *args,
                   DTYPE_CODES[dtype], torch.cuda.current_device())
    if n < 0:
        raise RuntimeError(f"{kernel}: occupancy query failed (CUDA error "
                           f"{-n})")
    return n
