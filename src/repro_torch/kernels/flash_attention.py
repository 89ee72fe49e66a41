"""Wrappers of kernel K2, GQA flash attention (``csrc/flash_attention.cu``),
and K6, its int8-K/V variant (``csrc/flash_attention_int8kv.cu``).

The port of ``repro/kernels/flash_attention.py::flash_attention``: q
(B,S,H,hd), k/v (B,T,K,hd), mask (1|B,S,T) bool → (B,S,H,hd).  Masked
scores are -1e30 with p = 0, and a row with no valid key gives 0.  The
CUDA kernel tiles 64 query rows by ``block_k(hd)`` keys, skips the K/V
tiles its mask rows wholly mask and masks ragged edges itself, so any S
and T are taken.  Given ``live_count`` (one int32 on the card), the kernel
adds to it the K/V tiles it computed; ``live_tiles`` says from the mask
alone how many that should be.  q, k and v are fp32 (fp32
math on the CUDA cores), bf16 or fp16 (tensor cores, fp32 accumulators);
any head dim up to ``MAX_HEAD_DIM`` is taken, run at the least of
``HEAD_WIDTHS`` that holds it (columns past hd zero-filled, never stored).
On CPU tensors the wrappers compute the plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_int8kv_ref``).

K6 is the port of ``flash_attention_int8kv``: k8/v8 (B,T,K,hd) int8 with
one fp32 scale a KV head, (K,) each; q and the output are fp32, bf16 or
fp16.  Its own kernel (``csrc/int8kv_tile.cuh``) keeps the tiles int8 in
shared memory, widens them exactly to 16 bits and runs on the tensor cores
in every dtype (fp32 q and p as three bf16 terms each), and splits a q
tile's keys over a cluster of blocks where q tiles alone leave SMs idle:
its plan (split, ring depth) is ``pipeline.int8kv_plan``'s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: Tile of the CUDA kernels (query rows x keys); must match csrc/flash_tile.cuh.
BLOCK_Q = 64
BLOCK_K = 64
#: Keys a tile at the padded width 256 (csrc/flash_tile.cuh Layout::BKT).
BLOCK_K_WIDE = 32
#: Head widths the kernels are instantiated for; a head dim runs at the
#: least that holds it.
HEAD_WIDTHS = (16, 32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_WIDTHS[-1]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def padded_head_dim(hd: int) -> int:
    """The instantiated width a head dim runs at (csrc/flash_tile.cuh)."""
    return next(w for w in HEAD_WIDTHS if hd <= w)


def block_k(hd: int) -> int:
    """Keys a K/V tile of K2, K3 and K6 at head dim ``hd``."""
    return BLOCK_K_WIDE if padded_head_dim(hd) > 128 else BLOCK_K


def live_tiles(mask: torch.Tensor, hd: int) -> tuple[int, int]:
    """(live, all) (64-row q tile, K/V tile) pairs of a (1|B, S, T) bool
    mask, summed over its first dim: the tiles the kernels should compute
    and the tiles a sweep without skipping would.  A tile is live where
    one of its entries is valid; a sweep of one K/V tile is not scanned,
    so its tile is computed whatever the mask."""
    mb, S, T = mask.shape
    bk = block_k(hd)
    nq, nt = -(-S // BLOCK_Q), -(-T // bk)
    if nt == 1:
        return mb * nq, mb * nq
    padded = torch.zeros((mb, nq * BLOCK_Q, nt * bk), dtype=torch.bool,
                         device=mask.device)
    padded[:, :S, :T] = mask
    live = padded.view(mb, nq, BLOCK_Q, nt, bk).any(dim=4).any(dim=2)
    return int(live.sum()), mb * nq * nt


FLASH_ATTENTION = _build.CudaKernel(
    "flash_attention", lib="flash_attention", symbol="flash_attention_launch",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention.py:152")


def check_flash_args(name: str, q, k, v, mask, kv_dtype=None) -> None:
    """Raise on anything the CUDA flash kernels do not take; k and v must
    share q's dtype, or be ``kv_dtype`` where it is given (K6's int8)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,S,H,hd) and k, v (B,T,K,hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (H % K must be 0)")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} not in 1..{MAX_HEAD_DIM}")
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    if q.dtype not in DTYPE_CODES or k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise ValueError(f"{name}: want q fp32, bf16 or fp16 and k, v "
                         f"{kv_dtype}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if (mask.dtype != torch.bool or mask.dim() != 3
            or mask.shape[0] not in (1, B) or tuple(mask.shape[1:]) != (S, T)):
        raise ValueError(f"{name}: mask must be bool (1|B, S, T), got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for t in (q, k, v, mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def live_count_ptr(name: str, live_count, q) -> ctypes.c_void_p | None:
    """Device address of a live-tile counter (None: not counted); only a
    kernel counts, so a CPU call takes none."""
    if live_count is None:
        return None
    if (q.device.type != "cuda" or live_count.dtype != torch.int32
            or live_count.device != q.device or live_count.numel() < 1):
        raise ValueError(f"{name}: live_count must be an int32 tensor on "
                         f"q's CUDA device")
    return _build.ptr(live_count)


def flash_attention(q, k, v, mask, *, sm_scale: float, live_count=None):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    live = live_count_ptr("flash_attention", live_count, q)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mask, sm_scale=sm_scale)
    check_flash_args("flash_attention", q, k, v, mask)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
        _build.ptr(out), B, S, T, H, K, hd, mask.shape[0], float(sm_scale),
        live, DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q))
    return out


FLASH_ATTENTION_INT8KV = _build.CudaKernel(
    "flash_attention_int8kv", lib="flash_attention_int8kv",
    symbol="flash_attention_int8kv_launch",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    replaces="src/repro/kernels/flash_attention.py:113")


def flash_attention_int8kv(q, k8, v8, k_scale, v_scale, mask, *,
                           sm_scale: float, live_count=None, _plan=None):
    """K6 on CUDA tensors, the plain version on CPU tensors.  q (B,S,H,hd)
    fp32/bf16/fp16, k8/v8 (B,T,K,hd) int8, k_scale/v_scale (K,) fp32, mask
    (1|B,S,T) bool → (B,S,H,hd) of q's dtype.

    ``_plan`` (split, depth) replaces ``pipeline.int8kv_plan``'s pick; for
    the plan sweep and the card's tests only, and a plan the kernel is not
    built for (``pipeline.int8kv_plan_legal``) raises."""
    from repro_torch.kernels import pipeline  # it imports this module
    live = live_count_ptr("flash_attention_int8kv", live_count, q)
    if q.device.type == "cpu":
        return ref.flash_attention_int8kv_ref(q, k8, v8, k_scale, v_scale,
                                              mask, sm_scale=sm_scale)
    check_flash_args("flash_attention_int8kv", q, k8, v8, mask,
                     kv_dtype=torch.int8)
    B, S, H, hd = q.shape
    T, K = k8.shape[1], k8.shape[2]
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (sc.shape != (K,) or sc.dtype != torch.float32
                or sc.device != q.device or not sc.is_contiguous()):
            raise ValueError(f"flash_attention_int8kv: {name} must be a "
                             f"contiguous fp32 ({K},) on {q.device}")
    if _plan is None:
        plan = pipeline.int8kv_plan(B, S, T, H, K, hd, q.dtype,
                                    pipeline.sm_count(q.device))
    elif pipeline.int8kv_plan_legal(_plan, B, S, T, H, K, hd, q.dtype):
        plan = tuple(_plan)
    else:
        raise ValueError(f"flash_attention_int8kv: K6 is not built for plan "
                         f"{_plan}")
    out = torch.empty_like(q)
    FLASH_ATTENTION_INT8KV.launch(
        _build.ptr(q), _build.ptr(k8), _build.ptr(v8), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(mask), _build.ptr(out), B, S, T, H, K,
        hd, mask.shape[0], float(sm_scale), live, plan[0], DTYPE_CODES[q.dtype],
        q.device.index, _build.stream_of(q))
    return out


def blocks_per_sm(kernel: str, dtype: torch.dtype, hd: int,
                  depth: int | None = None) -> int:
    """Blocks of ``kernel`` ("flash_attention", "flash_attention_int8kv",
    or "flash_attention_pipelined" at ring ``depth``) resident on one SM of
    the current card at head dim ``hd`` and q ``dtype``, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports it."""
    kern = _build.KERNELS[kernel]
    args = [hd] + ([depth] if depth is not None else [])
    n = kern.query(kern.symbol.replace("_launch", "_occupancy"), *args,
                   DTYPE_CODES[dtype], torch.cuda.current_device())
    if n < 0:
        raise RuntimeError(f"{kernel}: occupancy query failed (CUDA error "
                           f"{-n})")
    return n
