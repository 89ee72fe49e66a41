"""Wrapper of kernel K1, the fused RMSNorm (``csrc/rmsnorm.cu``).

The port of ``repro/kernels/rmsnorm.py::rmsnorm``: x (R, d) fp32, bf16 or
fp16, g (d,) fp32 → x · rsqrt(mean(x²) + eps) · g in x's dtype, statistics
in fp32.  On a CPU tensor the wrapper computes the plain version
(``ref.rmsnorm_ref``); on a CUDA tensor it launches K1 or raises.

``plan`` chooses the kernel's shape from the rows (csrc/rmsnorm.cu): one
block a row with two 16-byte vectors a thread held in registers; for 16-bit
rows of 512 to 1024 vectors, where fp32 g outweighs x, a resident grid
that walks the rows one ahead and reads g once a block; and the two-pass
loop where a row is not whole aligned vectors or is too wide for
registers.  The rules are measured ones (PERF.md §6).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel shapes of csrc/rmsnorm.cu.
LOOP, ROW, ROWS = 0, 1, 2
#: Most 16-byte vectors a thread holds (ROWS: in each of its two sets), and
#: most threads of a block.
MAX_VPT = 8
MAX_ROWS_VPT = 4
MAX_ROW_THREADS = 1024
#: Threads a row of the two-pass loop kernel.
LOOP_THREADS = 128
#: Threads an SM keeps resident, and the H100 SXM's SMs (``plan``'s default).
SM_THREADS = 2048
H100_SMS = 132

RMSNORM = _build.CudaKernel(
    "rmsnorm", lib="rmsnorm", symbol="rmsnorm_launch",
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="src/repro/kernels/rmsnorm.py:20")


class Plan(NamedTuple):
    """One launch shape of K1: ``mode`` (LOOP, ROW or ROWS), vectors a
    thread, threads a block."""

    mode: int
    vpt: int
    threads: int


def plan(R: int, d: int, itemsize: int, sms: int = H100_SMS) -> Plan:
    """K1's launch shape for R rows of ``d`` elements of ``itemsize`` bytes
    that start 16-byte aligned, on a card of ``sms`` SMs."""
    V = 16 // itemsize
    if d % V:
        return Plan(LOOP, 0, LOOP_THREADS)
    nv = d // V
    warps = lambda vpt: 32 * -(-nv // (32 * vpt))  # noqa: E731
    if itemsize == 2 and 512 <= nv <= MAX_ROW_THREADS:
        resident = sms * (SM_THREADS // warps(1))
        if R >= 2 * resident:           # every block walks two rows or more
            return Plan(ROWS, 1, warps(1))
    vpt = max(2, -(-nv // MAX_ROW_THREADS))
    if vpt > MAX_VPT:
        return Plan(LOOP, 0, LOOP_THREADS)
    return Plan(ROW, vpt, warps(vpt))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def rows_grid(R: int, threads: int, sms: int) -> int:
    """Blocks of the ROWS shape: as many as stay resident, evened out so
    that every block walks the same number of rows (give or take one)."""
    resident = sms * max(1, min(32, SM_THREADS // threads))
    per_block = -(-R // resident)
    return -(-R // per_block)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6,
            shape: Plan | None = None):
    """x: (R, d), g: (d,) fp32 → (R, d) of x.dtype.  ``shape`` overrides
    ``plan`` (for timing one shape against another)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, g, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if x.dim() != 2 or g.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: want x (R, d) and g (d,), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in DTYPE_CODES or g.dtype != torch.float32:
        raise ValueError(f"rmsnorm: x must be fp32, bf16 or fp16 and g fp32, "
                         f"got {x.dtype} and {g.dtype}")
    if g.device != x.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("rmsnorm: x and g must be contiguous on one device")
    R, d = x.shape
    out = torch.empty_like(x)
    if R == 0:
        return out
    sms = _sm_count(x.device.index)
    if shape is None:
        aligned = (x.data_ptr() | out.data_ptr() | g.data_ptr()) % 16 == 0
        shape = plan(R, d, x.element_size(), sms) if aligned \
            else Plan(LOOP, 0, LOOP_THREADS)
    blocks = rows_grid(R, shape.threads, sms) if shape.mode == ROWS else 0
    RMSNORM.launch(_build.ptr(x), _build.ptr(g), _build.ptr(out), R, d,
                   float(eps), DTYPE_CODES[x.dtype], *shape, blocks,
                   x.device.index, _build.stream_of(x))
    return out
