"""Plain PyTorch versions of the port's kernels (the allclose reference).

Each mirrors the reference oracle in ``repro.kernels.ref`` op for op; the
CPU tests hold them against the JAX kernels, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, mask, *, sm_scale: float):
    """q: (B,S,H,hd), k/v: (B,T,K,hd), mask: (1|B,S,T) bool → (B,S,H,hd).

    A row with no valid key gives 0 (the kernel's denominator clamp), not
    the uniform softmax that all -1e30 scores would give.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * sm_scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1)[:, None, None, :, None]
    p = torch.where(any_valid, p, 0.0)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def paged_decode_ref(q, k_pages, v_pages, page_table, seq_lens, active, *,
                     sm_scale: float):
    """q: (B,1,H,hd), k_pages/v_pages: (N+1,page,K,hd), page_table: (B,P),
    seq_lens/active: (B,) → (B,1,H,hd): slot b attends positions 0 ..
    min(seq_lens[b], P·page − 1) of its pages (logical page p at physical
    ``page_table[b, p]``), ``flash_attention_ref``'s fp32 math; an inactive
    slot's rows are 0."""
    B, P = page_table.shape
    page = k_pages.shape[1]
    pt = page_table.long()
    kg = k_pages[pt].reshape(B, P * page, *k_pages.shape[2:])
    vg = v_pages[pt].reshape(B, P * page, *v_pages.shape[2:])
    mask = (torch.arange(P * page, device=q.device)[None, None, :]
            <= seq_lens[:, None, None])
    out = flash_attention_ref(q, kg, vg, mask, sm_scale=sm_scale)
    return torch.where(active[:, None, None, None], out, 0)


def flash_attention_int8kv_ref(q, k8, v8, k_scale, v_scale, mask, *,
                               sm_scale: float):
    """q: (B,S,H,hd) float, k8/v8: (B,T,K,hd) int8, k_scale/v_scale: (K,)
    fp32 → (B,S,H,hd): K/V dequantized per KV head in fp32 (int8 · scale),
    then ``flash_attention_ref``."""
    kd = k8.float() * k_scale.float()[None, None, :, None]
    vd = v8.float() * v_scale.float()[None, None, :, None]
    return flash_attention_ref(q, kd, vd, mask, sm_scale=sm_scale)


def int8_matmul_ref(x, wq, scale):
    """x: (M,K) float, wq: (N,K) int8, scale: (N,) → (x @ f32(wq)ᵀ) ·
    scale[None] in x's dtype, computed in fp32."""
    y = x.float() @ wq.float().T
    return (y * scale.float()[None, :]).to(x.dtype)


def rmsnorm_ref(x, g, *, eps: float = 1e-6):
    """RMSNorm: x (R,d) · rsqrt(mean(x²) + eps) · g, statistics in fp32."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g.float()).to(x.dtype)


def ssd_scan_ref(x, dt, A, B, C):
    """Naive SSD recurrence.  x: (BT,H,S,P), dt: (BT,H,S), A: (H,),
    B/C: (BT,S,N) → y: (BT,H,S,P) of x's dtype; state and math in fp32."""
    BT, H, S, P = x.shape
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    h = torch.zeros((BT, H, B.shape[-1], P), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        dt_t = dtf[:, :, t]                                     # (BT,H)
        decay = torch.exp(dt_t * Af[None, :])
        h = (decay[..., None, None] * h
             + torch.einsum("bh,bn,bhp->bhnp", dt_t, Bf[:, t], xf[:, :, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=2).to(x.dtype)
