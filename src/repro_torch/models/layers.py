"""Shared layer substrate of the dense family: RMSNorm, RoPE, GQA attention,
SwiGLU MLP, embeddings.

Parameters are plain nested dicts of tensors with the reference's names,
shapes and layouts, so a ``repro`` param tree bridges over as it is
(``repro_torch.bridge``).  Kernel choice is a ``LoweringConfig`` decision:
RMSNorm and prefill attention run the hand-written kernels on the
``"cuda"`` backend; decode attention (a one-row query) and every GEMM stay
plain torch ops, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

_DEFAULT_LOWERING = LoweringConfig()
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std²) draws in fp32 from ``gen``, cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6, *,
            lowering: Optional[LoweringConfig] = None) -> torch.Tensor:
    lw = lowering or _DEFAULT_LOWERING
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    rec = lw.lower("rmsnorm", (rows, d), x.dtype)
    if rec.impl == "isax":
        out = kops.rmsnorm(x.reshape(rows, d), params["scale"], eps=eps)
        return out.reshape(x.shape)
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-halves form, angles in fp32)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..,S,hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    dt = dtype_of(cfg.param_dtype)
    scale = d ** -0.5
    p = {
        "wq": _normal(gen, (d, H, hd), scale, dt, device),
        "wk": _normal(gen, (d, K, hd), scale, dt, device),
        "wv": _normal(gen, (d, K, hd), scale, dt, device),
        "wo": _normal(gen, (H, hd, d), (H * hd) ** -0.5, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dt, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one GEMM over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _qkv(params, x, cfg: ModelConfig, positions):
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    q = _proj(x, params["wq"].to(cd))
    k = _proj(x, params["wk"].to(cd))
    v = _proj(x, params["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd')."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _sdpa_xla(q, k, v, mask, head_dim: int):
    """Plain scaled-dot-product attention with GQA head grouping.

    q: (B,S,H,hd), k/v: (B,T,K,hd), mask: (1|B, S, T) bool (True = attend).
    A fully-masked row gets a uniform softmax here, as in the reference's
    XLA path (decode rows always have position 0 valid).
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * (head_dim ** -0.5)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def sdpa(q, k, v, mask, head_dim: int, lowering: LoweringConfig,
         kind: str = "attention"):
    """Lowering-routed scaled-dot-product attention."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    rec = lowering.lower(kind, (B, S, H, K, T, hd), q.dtype)
    if rec.impl == "isax":
        return kops.flash_attention_gqa(q, k, v, mask,
                                        sm_scale=head_dim ** -0.5)
    return _sdpa_xla(q, k, v, mask, head_dim)


def attention(params, x, cfg: ModelConfig, mask, positions,
              lowering: Optional[LoweringConfig] = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    lw = lowering or _DEFAULT_LOWERING
    hd = cfg.resolved_head_dim()
    q, k, v = _qkv(params, x, cfg, positions)
    out = sdpa(q, k, v, mask, hd, lw, kind="attention")
    cd = dtype_of(cfg.compute_dtype)
    return _out_proj(out, params["wo"].to(cd)), (k, v)


def attention_decode(params, x, cfg: ModelConfig, k_cache, v_cache, pos: int,
                     lowering: Optional[LoweringConfig] = None):
    """One-token decode against a static-size KV cache.

    x: (B,1,d); k_cache/v_cache: (B,T,K,hd); pos: current position (int).
    The caches are updated in place at ``pos`` (the reference returns new
    ones).  Returns (out, k_cache, v_cache).
    """
    lw = lowering or _DEFAULT_LOWERING
    hd = cfg.resolved_head_dim()
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    T = k_cache.shape[1]
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, :]
    out = sdpa(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
               mask.expand(B, 1, T), hd, lw, kind="attention_decode")
    cd = dtype_of(cfg.compute_dtype)
    return _out_proj(out, params["wo"].to(cd)), k_cache, v_cache


def attention_decode_paged(params, x, cfg: ModelConfig, k_pages, v_pages,
                           page_table, seq_lens, active,
                           lowering: Optional[LoweringConfig] = None):
    """One-token decode against a block-paged KV pool (vLLM-style).

    x: (B,1,d) new-token activations for every batch slot (inactive slots
    carry dummy tokens so the batch shape stays fixed).
    k_pages/v_pages: (N + 1, page, K, hd) page pools of this layer: N pages
    a sequence may own and, last, a spare page that none owns.
    page_table: (B, P) int32 — logical page p of slot b lives in physical
    page ``page_table[b, p]``; unused entries may hold any valid index.
    seq_lens: (B,) int32 tokens already stored per slot; the new token is
    written at logical position ``seq_lens[b]``.
    active: (B,) bool — inactive slots write into no live page.  The
    reference drops their writes with an out-of-bounds index;
    ``index_put_`` has no drop mode, so their writes go to the spare page
    instead, an index chosen on the device with no host sync (reading the
    old values back under a mask instead would race: an inactive and an
    active row can name the same slot).  The spare page's contents are
    never read unmasked.
    The pools are updated in place.  Returns (out (B,1,d), k_pages, v_pages).
    """
    lw = lowering or _DEFAULT_LOWERING
    hd = cfg.resolved_head_dim()
    B = x.shape[0]
    page = k_pages.shape[1]
    P = page_table.shape[1]
    positions = seq_lens[:, None].to(torch.int32)
    q, k, v = _qkv(params, x, cfg, positions)
    sl = seq_lens.long()
    lp = torch.clamp(sl // page, max=P - 1)  # in range for an inactive slot
    phys = page_table.gather(1, lp[:, None])[:, 0].long()
    phys = torch.where(active, phys, k_pages.shape[0] - 1)
    slot = sl % page
    k_pages[phys, slot] = k[:, 0].to(k_pages.dtype)
    v_pages[phys, slot] = v[:, 0].to(v_pages.dtype)
    pt = page_table.long()
    kg = k_pages[pt].reshape(B, P * page, *k_pages.shape[2:])
    vg = v_pages[pt].reshape(B, P * page, *v_pages.shape[2:])
    mask = (torch.arange(P * page, device=x.device)[None, None, :]
            <= seq_lens[:, None, None])
    out = sdpa(q, kg.to(q.dtype), vg.to(q.dtype), mask, hd, lw,
               kind="attention_paged")
    cd = dtype_of(cfg.compute_dtype)
    return _out_proj(out, params["wo"].to(cd)), k_pages, v_pages


def make_mask(kind: str, S: int, T: Optional[int] = None,
              device=None) -> torch.Tensor:
    """(1, S, T) boolean attention mask; the dense family needs only
    ``"causal"`` (the vlm prefix mask arrives with that family)."""
    if kind != "causal":
        raise ValueError(f"mask kind {kind!r} is not ported")
    T = T or S
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(T, device=device)[None, :]
    return (cols <= rows)[None]


# ---------------------------------------------------------------------------
# SwiGLU MLP (GEMMs stay torch.matmul: the reference's negative control)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    return {
        "wi_gate": _normal(gen, (d, ff), d ** -0.5, dt, device),
        "wi_up": _normal(gen, (d, ff), d ** -0.5, dt, device),
        "wo": _normal(gen, (ff, d), ff ** -0.5, dt, device),
    }


def mlp(params, x, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    g = x @ params["wi_gate"].to(cd)
    u = x @ params["wi_up"].to(cd)
    return (F.silu(g) * u) @ params["wo"].to(cd)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def init_embedding(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    return {"table": _normal(gen, (cfg.vocab, cfg.d_model),
                             cfg.d_model ** -0.5, dt, device)}


def embed(params, tokens, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    return params["table"].to(cd)[tokens.long()]


def unembed(table_or_w, x, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    logits = x.to(cd) @ table_or_w.to(cd).T
    return logits.to(dtype_of(cfg.logit_dtype))
