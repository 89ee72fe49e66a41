"""Public kernel entry points the model layers call, each after
``LoweringConfig.lower`` has said ``isax``.

``flash_attention_gqa`` routes between K2 and K3; ``flash_tileable`` is the
test ``lower`` reads (H a multiple of K, a head dim up to 256, fp32, bf16
or fp16), and a shape it refuses raises on CUDA tensors rather than taking
the plain version.  Tiles are Hopper's (64 x 64, see
``flash_attention.py``), not the TPU schedule's.  ``rmsnorm`` is K1.
``ssd_scan`` routes between K7 and K8.  ``int8_matmul`` routes between K4
and K5.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (BLOCK_K, DTYPE_CODES,
                                                 MAX_HEAD_DIM, flash_attention)
from repro_torch.kernels.int8_matmul import BLOCK_K as INT8_BLOCK_K
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_matmul
from repro_torch.kernels.pipeline import (choose_depth,
                                          flash_attention_pipelined,
                                          int8_matmul_pipelined,
                                          int8_ring_takes, ssd_plan,
                                          ssd_scan_pipelined, use_pipeline)
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.ssd_scan import SSD_CHUNK
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan


def flash_tileable(H: int, K: int, hd: int, dtype) -> bool:
    """True iff the CUDA flash kernels take this head layout and dtype."""
    return H % K == 0 and 1 <= hd <= MAX_HEAD_DIM and dtype in DTYPE_CODES


def flash_attention_gqa(q, k, v, mask, *, sm_scale: float,
                        pipelined: bool | None = None):
    """q (B,S,H,hd), k/v (B,T,K,hd), mask (1|B,S,T) bool → (B,S,H,hd).

    K3 (``pipelined``) when the K/V sweep has two 64-key tiles or more,
    else K2; ``pipelined`` forces the choice where the sweep allows it.
    """
    S, T = q.shape[1], k.shape[1]
    hd = q.shape[3]
    mask = mask.expand(mask.shape[0], S, T).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n_steps = -(-T // BLOCK_K)
    if use_pipeline(n_steps, pipelined):
        depth = choose_depth(hd, q.element_size(), n_steps)
        return flash_attention_pipelined(q, k, v, mask, sm_scale=sm_scale,
                                         depth=depth)
    return flash_attention(q, k, v, mask, sm_scale=sm_scale)


#: Most rows that go to K5 by default: the decode regime, where the int8
#: weight stream, not the arithmetic, sets the pace.
INT8_PIPELINE_MAX_M = 64


def int8_matmul(x, wq, scale, *, pipelined: bool | None = None):
    """Quantized GEMM: x (M,K) fp32/bf16/fp16, wq (N,K) int8, scale (N,) fp32
    → (x @ f32(wq)ᵀ) · scale[None] in x's dtype.

    K5 (``pipelined``) when the k sweep has two of the kernels' 64-wide
    steps or more (``use_pipeline``), M ≤ ``INT8_PIPELINE_MAX_M`` and K5's
    TMA copies take the operands (``int8_ring_takes``), else K4; each at
    ``pipeline.int8_plan``'s plan; ``pipelined`` forces the choice where
    the sweep and the operands allow it.
    """
    x, wq, scale = x.contiguous(), wq.contiguous(), scale.contiguous()
    M, K = x.shape
    want = M <= INT8_PIPELINE_MAX_M if pipelined is None else pipelined
    if use_pipeline(-(-K // INT8_BLOCK_K), want) and int8_ring_takes(x, wq):
        return int8_matmul_pipelined(x, wq, scale)
    return _int8_matmul(x, wq, scale)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, *, eps: float = 1e-6):
    """Row RMSNorm through K1: x (R, d), g (d,) → (R, d)."""
    return _rmsnorm(x.contiguous(), g.float().contiguous(), eps=eps)


def ssd_scan(x, dt, A, B, C, *, pipelined: bool | None = None):
    """SSD chunked scan: x (BT,H,S,P), dt (BT,H,S), A (H,), B/C (BT,S,N)
    → y (BT,H,S,P) of x's dtype, computed in fp32.

    K8 (``pipelined``) when the sweep has two 64-position chunks
    (``SSD_CHUNK``) or more and a K8 ring fits (``ssd_plan``), else K7;
    ``pipelined`` forces the choice where the sweep and the ring allow it.
    x, dt, B and C share one dtype; A is taken in fp32, as the reference
    widens it.
    """
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A.float(), B, C))
    S, P, N = x.shape[2], x.shape[3], B.shape[-1]
    depth = ssd_plan(P, N, S, x.element_size())
    if depth is not None and use_pipeline(-(-S // SSD_CHUNK), pipelined):
        return ssd_scan_pipelined(x, dt, A, B, C, depth=depth)
    return _ssd_scan(x, dt, A, B, C)
