"""Encoder–decoder transformer (the seamless-m4t-medium backbone), the port
of ``repro/models/encdec.py``.

n_layers encoder + n_layers decoder layers.  There is no audio frontend:
the encoder takes precomputed frame embeddings ``prefix_embeds`` (B, T, d)
under a full mask; the decoder is a causal stack with cross attention to
the encoder output.  ``prefill`` returns ``{"k", "v": (L, B, S', K, hd),
"enc_out": (B, T, d)}``; ``decode_step`` recomputes the cross attention's
K/V from ``enc_out`` at every step, as the reference does, and updates the
self-attention caches in place.  Cross attention at decode has a one-row
query, which the compile record keeps on the plain version (a degenerate
q tile), as the reference's does.  ``loss`` trains the decoder's
next-token prediction over the encoder's frames.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compile.config import LoweringConfig, default_lowering
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_ffn, _positions, block_fwd,
                                            layer_params, new_generator,
                                            pad_kv, stack_axes, unstack)


def _cross_attention(params, x, enc_out, cfg: ModelConfig, mask, lowering):
    """Queries from x, keys and values from the encoder output (no RoPE)."""
    cd = L.dtype_of(cfg.compute_dtype)
    hd = cfg.resolved_head_dim()
    e = enc_out.to(cd)
    q = L._proj(x.to(cd), params["wq"].to(cd))
    k = L._proj(e, params["wk"].to(cd))
    v = L._proj(e, params["wv"].to(cd))
    out = L.sdpa(q, k, v, mask, hd, lowering, kind="attention")
    return L._out_proj(out, params["wo"].to(cd))


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights with the reference's shapes and stacked layout from
    a ``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s)."""
    device = torch.device(device)
    gen = new_generator(seed, device)
    dt = L.dtype_of(cfg.param_dtype)
    d, lead = cfg.d_model, (cfg.n_layers,)
    enc = {"attn_norm": L.init_rmsnorm(d, dt, device, lead),
           "attn": L.init_attention(cfg, gen, device, lead),
           "mlp_norm": L.init_rmsnorm(d, dt, device, lead),
           "mlp": L.init_mlp(cfg, gen, device, lead=lead)}
    dec = {"attn_norm": L.init_rmsnorm(d, dt, device, lead),
           "attn": L.init_attention(cfg, gen, device, lead),
           "cross_norm": L.init_rmsnorm(d, dt, device, lead),
           "cross": L.init_attention(cfg, gen, device, lead),
           "mlp_norm": L.init_rmsnorm(d, dt, device, lead),
           "mlp": L.init_mlp(cfg, gen, device, lead=lead)}
    return {
        "embed": L.init_embedding(cfg, gen, device),
        "enc_blocks": enc,
        "enc_norm": L.init_rmsnorm(d, dt, device),
        "dec_blocks": dec,
        "final_norm": L.init_rmsnorm(d, dt, device),
        "unembed": {"w": L._normal(gen, (cfg.vocab, d), d ** -0.5, dt,
                                   device)},
    }


def param_axes(cfg: ModelConfig) -> dict:
    enc = {"attn_norm": L.rmsnorm_axes(), "attn": L.attention_axes(cfg),
           "mlp_norm": L.rmsnorm_axes(), "mlp": L.mlp_axes()}
    dec = {"attn_norm": L.rmsnorm_axes(), "attn": L.attention_axes(cfg),
           "cross_norm": L.rmsnorm_axes(), "cross": L.attention_axes(cfg),
           "mlp_norm": L.rmsnorm_axes(), "mlp": L.mlp_axes()}
    return {
        "embed": L.embedding_axes(),
        "enc_blocks": stack_axes(enc),
        "enc_norm": L.rmsnorm_axes(),
        "dec_blocks": stack_axes(dec),
        "final_norm": L.rmsnorm_axes(),
        "unembed": {"w": ("vocab", "embed")},
    }


def encode(params, frame_embeds, cfg: ModelConfig,
           lowering: Optional[LoweringConfig] = None):
    """frame_embeds (B, T, d) → the normed encoder output (B, T, d)."""
    lw = lowering or default_lowering()
    B, T, _ = frame_embeds.shape
    mask = L.make_mask("full", T, device=frame_embeds.device)
    positions = _positions(B, T, frame_embeds.device)
    h = frame_embeds.to(L.dtype_of(cfg.compute_dtype))

    def body(h, bp):
        return block_fwd(cfg, h, bp, mask, positions, lw)[0]

    body = L.remat_wrap(body, cfg.remat)
    for bp in unstack(params["enc_blocks"], cfg.n_layers):
        h = body(h, bp)
    return L.rmsnorm(params["enc_norm"], h, cfg.norm_eps, lowering=lw)


def _cross(bp, h, enc_out, cfg: ModelConfig, mask, lowering):
    return h + _cross_attention(
        bp["cross"], L.rmsnorm(bp["cross_norm"], h, cfg.norm_eps,
                               lowering=lowering),
        enc_out, cfg, mask, lowering)


def _decoder(params, x, enc_out, cfg: ModelConfig, self_mask, cross_mask,
             positions, lowering, collect_kv: bool = True):
    """Each layer under ``remat_wrap(cfg.remat)``.  Returns (normed
    hidden, (k, v) stacks (L, B, S, K, hd) | None)."""

    def body(h, bp):
        h = L.shard_act(h, "btd")
        a, kv = L.attention(bp["attn"],
                            L.rmsnorm(bp["attn_norm"], h, cfg.norm_eps,
                                      lowering=lowering),
                            cfg, self_mask, positions, lowering=lowering)
        h = _cross(bp, h + a, enc_out, cfg, cross_mask, lowering)
        return _ffn(bp, h, cfg, lowering)[0], kv

    body = L.remat_wrap(body, cfg.remat)
    ks, vs = [], []
    for bp in unstack(params["dec_blocks"], cfg.n_layers):
        x, (k, v) = body(x, bp)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lowering)
    return h, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def loss(params, batch, cfg: ModelConfig,
         lowering: Optional[LoweringConfig] = None):
    """Mean next-token cross-entropy of the decoder.  batch: prefix_embeds
    (B, T, d) (the encoder's frames), tokens (B, S), labels (B, S)."""
    lw = lowering or default_lowering()
    enc_out = encode(params, batch["prefix_embeds"], cfg, lowering=lw)
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    T = enc_out.shape[1]
    self_mask = L.make_mask("causal", S, device=x.device)
    cross_mask = L.make_mask("full", S, T, device=x.device)
    h, _ = _decoder(params, x, enc_out, cfg, self_mask, cross_mask,
                    _positions(B, S, x.device), lw, collect_kv=False)
    logits = L.unembed(params["unembed"]["w"], h, cfg, lowering=lw)
    logits = L.shard_act(logits, "btv")
    return L.cross_entropy(logits, batch["labels"].to(logits.device))


def prefill(params, batch, cfg: ModelConfig, pad_to=None,
            lowering: Optional[LoweringConfig] = None):
    """batch: ``prefix_embeds`` (B, T, d) frames, ``tokens`` (B, S).
    Returns (last-position logits (B, vocab), {'k', 'v', 'enc_out'})."""
    lw = lowering or default_lowering()
    enc_out = encode(params, batch["prefix_embeds"], cfg, lowering=lw)
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    T = enc_out.shape[1]
    self_mask = L.make_mask("causal", S, device=x.device)
    cross_mask = L.make_mask("full", S, T, device=x.device)
    h, (k_stack, v_stack) = _decoder(params, x, enc_out, cfg, self_mask,
                                     cross_mask, _positions(B, S, x.device),
                                     lw)
    k_stack, v_stack = pad_kv(k_stack, v_stack, pad_to)
    logits = L.unembed(params["unembed"]["w"], h[:, -1:, :], cfg,
                       lowering=lw)
    return logits[:, 0], {"k": k_stack, "v": v_stack, "enc_out": enc_out}


def decode_step(params, token, caches, pos: int, cfg: ModelConfig,
                lowering: Optional[LoweringConfig] = None):
    """One-token decode at ``pos``; the self-attention caches are updated
    in place.  Returns (logits (B, vocab), caches)."""
    lw = lowering or default_lowering()
    x = L.embed(params["embed"], token[:, None], cfg)
    enc_out = caches["enc_out"]
    B, T = x.shape[0], enc_out.shape[1]
    cross_mask = torch.ones((B, 1, T), dtype=torch.bool, device=x.device)
    for i in range(cfg.n_layers):
        bp = layer_params(params["dec_blocks"], i)
        a, _, _ = L.attention_decode(
            bp["attn"], L.rmsnorm(bp["attn_norm"], x, cfg.norm_eps,
                                  lowering=lw),
            cfg, caches["k"][i], caches["v"][i], int(pos), lowering=lw)
        x = _cross(bp, x + a, enc_out, cfg, cross_mask, lw)
        x, _ = _ffn(bp, x, cfg, lw)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lw)
    logits = L.unembed(params["unembed"]["w"], x, cfg, lowering=lw)
    return logits[:, 0], caches
