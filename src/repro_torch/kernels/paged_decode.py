"""Wrapper of kernel K14, paged decode attention
(``csrc/paged_decode_attention.cu``).

One query token a slot attends its own keys straight from the paged K/V
pools: q (B,1,H,hd), k_pages/v_pages (N+1, page, K, hd) in the pool's
layout, page_table (B,P) int32, seq_lens (B,) int32, active (B,) bool →
(B,1,H,hd) of q's dtype.  Slot b attends positions 0 .. min(seq_lens[b],
P·page − 1), the token just written at seq_lens[b] included; logical page
p lives in physical page ``page_table[b, p]``.  An inactive slot's rows are
zeros and no page of it is read (the engine reads only the active slots'
tokens).  Softmax and P·V in fp32, the output rounded once.

K14 ports no TPU kernel: the reference decodes a one-row query in XLA
(``targets/llm.py`` ``_attention_schedule``, golden key 5), and on CPU
tensors ``layers.attention_decode_paged`` keeps that plain path.  This
wrapper's own CPU version is ``ref.paged_decode_ref``.

``split_plan`` cuts each slot's key range into splits where one block a
(slot, KV head) would leave the card's SMs idle, a pure function of the
shapes; with more than one split a second small kernel merges them, from
fp32 scratch allocated here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.ops import no_grad_guard
from repro_torch.kernels.pipeline import SMS, sm_count

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Head dims K14 is built for, and the most query heads a KV head.
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 8
#: Bytes of a K (or V) tile of the kernel's ring: 512 16-byte vectors.
TILE_BYTES = 8192
#: Blocks an SM keeps resident (48 KB of shared memory each).
BLOCKS_PER_SM = 4
#: Fewest positions of the range a split covers, and the most splits.
MIN_SPLIT_KEYS = 256
MAX_SPLITS = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
PAGED_DECODE = _build.CudaKernel(
    "paged_decode", lib="paged_decode_attention",
    symbol="paged_decode_attention_launch",
    argtypes=[_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _I, _P],
    replaces=None)


def tile_keys(hd: int, itemsize: int) -> int:
    """Keys a tile of K14's ring at head dim ``hd``."""
    return TILE_BYTES // (hd * itemsize)


def split_plan(B: int, K: int, span: int, hd: int, itemsize: int,
               sms: int = SMS) -> tuple[int, int]:
    """(splits, chunk) for B slots of K KV heads over a key range of
    ``span`` = P·page positions: the splits double while the B·K·splits
    blocks fall short of the ``BLOCKS_PER_SM`` a card of ``sms`` SMs keeps
    resident and a split still covers ``MIN_SPLIT_KEYS`` positions (at most
    ``MAX_SPLITS``); ``chunk``, the positions a split, is a whole number of
    tiles, and the splits as many as cover the range."""
    s = 1
    while (s < MAX_SPLITS and B * K * s < BLOCKS_PER_SM * sms
           and span // (2 * s) >= MIN_SPLIT_KEYS):
        s *= 2
    tk = tile_keys(hd, itemsize)
    chunk = -(-(-(-span // s)) // tk) * tk
    return -(-span // chunk), chunk


def check_args(q, k_pages, v_pages, page_table, seq_lens, active):
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 4:
        raise ValueError(f"paged_decode: want q (B,1,H,hd) and pools "
                         f"(N+1,page,K,hd), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    B, _, H, hd = q.shape
    K = k_pages.shape[2]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != hd
            or page_table.dim() != 2 or page_table.shape[0] != B
            or seq_lens.shape != (B,) or active.shape != (B,)
            or H % K or H // K > MAX_GROUP):
        raise ValueError(
            f"paged_decode: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, seq_lens {tuple(seq_lens.shape)}, "
            f"active {tuple(active.shape)} (H a multiple of K, at most "
            f"{MAX_GROUP} query heads a KV head)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode: q and pools must share one of fp32, "
                         f"bf16, fp16, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32 \
            or active.dtype != torch.bool:
        raise ValueError(f"paged_decode: want int32 page_table and seq_lens "
                         f"and bool active, got {page_table.dtype}, "
                         f"{seq_lens.dtype}, {active.dtype}")
    ts = (q, k_pages, v_pages, page_table, seq_lens, active)
    if any(t.device != q.device for t in ts) or not all(
            t.is_contiguous() for t in ts):
        raise ValueError("paged_decode: inputs must be contiguous on one "
                         "device")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_decode: q and pools must be 16-byte aligned")


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, active,
                           *, sm_scale: float):
    """Decode attention over the paged pools (module docstring).  On CPU
    tensors the plain version; on CUDA tensors K14, or raises."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, k_pages, v_pages, page_table,
                                    seq_lens, active, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: no kernel for device {q.device}")
    check_args(q, k_pages, v_pages, page_table, seq_lens, active)
    no_grad_guard("paged_decode", q, k_pages, v_pages)
    B, _, H, hd = q.shape
    page, K = k_pages.shape[1], k_pages.shape[2]
    P = page_table.shape[1]
    span = P * page
    splits, chunk = split_plan(B, K, span, hd, q.element_size(),
                               sm_count(q.device))
    out = torch.empty_like(q)
    ml = acc = None
    if splits > 1:
        ml = torch.empty((B, H, splits, 2), dtype=torch.float32,
                         device=q.device)
        acc = torch.empty((B, H, splits, hd), dtype=torch.float32,
                          device=q.device)
    PAGED_DECODE.launch(
        *(_build.ptr(t) for t in (q, k_pages, v_pages, page_table, seq_lens,
                                  active, out)),
        _P(ml.data_ptr() if ml is not None else None),
        _P(acc.data_ptr() if acc is not None else None),
        B, H, K, hd, page, P, chunk, splits, float(sm_scale),
        DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q))
    return out
