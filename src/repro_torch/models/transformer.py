"""Decoder-only transformer, dense branch.

Parameters carry a leading layer axis (``blocks[...]`` is ``(L, ...)``), as
in the reference, so a ``repro`` param tree bridges over unchanged; the
reference's ``jax.lax.scan`` over that axis is a Python loop here.

Entry points:
  init_params(cfg, seed, device)
  prefill(params, batch, cfg)              — last logits + KV stacks
  prefill_at(params, batch, length, cfg)   — logits at a bucketed length
  decode_step(params, token, caches, pos, cfg)
  decode_step_paged(params, tokens, k_pages, v_pages, page_table,
                    seq_lens, active, cfg)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (see ROADMAP.md)")


def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    dt = L.dtype_of(cfg.param_dtype)
    return {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(cfg, gen, device),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_mlp(cfg, gen, device),
    }


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights with the reference's shapes, scales and layout, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``'s; parity tests bridge the
    reference's own weights instead)."""
    _check_dense(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg.param_dtype)
    p = {
        "embed": L.init_embedding(cfg, gen, device),
        "blocks": _stack([init_block(cfg, gen, device)
                          for _ in range(cfg.n_layers)]),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": L._normal(gen, (cfg.vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, dt, device)}
    return p


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block params (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_fwd(cfg: ModelConfig, x, bp, mask, positions,
              lowering: Optional[LoweringConfig] = None):
    a, kv = L.attention(bp["attn"],
                        L.rmsnorm(bp["attn_norm"], x, cfg.norm_eps,
                                  lowering=lowering),
                        cfg, mask, positions, lowering=lowering)
    x = x + a
    y = L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], x, cfg.norm_eps,
                                   lowering=lowering), cfg)
    return x + y, kv


def backbone(params, x, cfg: ModelConfig, mask, positions,
             collect_kv: bool = False,
             lowering: Optional[LoweringConfig] = None):
    """Loop over the stacked blocks.  Returns (hidden, (k, v) stacks | None)
    with stacks shaped (L, B, S, K, hd)."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = block_fwd(cfg, x, layer_params(params["blocks"], i), mask,
                              positions, lowering)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lowering)
    return h, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def _unembed_table(params, cfg: ModelConfig):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["w"])


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def prefill(params, batch, cfg: ModelConfig, pad_to: Optional[int] = None,
            lowering: Optional[LoweringConfig] = None):
    """Returns (last-position logits (B, vocab), {'k','v'} (L,B,S',K,hd)),
    with S' = ``pad_to`` when it exceeds the prompt (zero padded)."""
    _check_dense(cfg)
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    mask = L.make_mask("causal", S, device=x.device)
    h, (k_stack, v_stack) = backbone(params, x, cfg, mask,
                                     _positions(B, S, x.device),
                                     collect_kv=True, lowering=lowering)
    if pad_to and pad_to > S:
        pad = (0, 0, 0, 0, 0, pad_to - S)
        k_stack = torch.nn.functional.pad(k_stack, pad)
        v_stack = torch.nn.functional.pad(v_stack, pad)
    logits = L.unembed(_unembed_table(params, cfg), h[:, -1:, :], cfg)
    return logits[:, 0], {"k": k_stack, "v": v_stack}


def prefill_at(params, batch, length: int, cfg: ModelConfig,
               lowering: Optional[LoweringConfig] = None):
    """Prefill a (possibly right-padded) prompt and read logits at position
    ``length - 1``.  Under a causal mask the hidden states and KV at
    positions < ``length`` do not see the padding, so this is exact for
    bucketed prompts.

    batch: {'tokens': (B, S_pad)}; length: true prompt length (int).
    Returns (logits (B, vocab), {'k','v'} (L, B, S_pad, K, hd)).
    """
    _check_dense(cfg)
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    mask = L.make_mask("causal", S, device=x.device)
    h, (k_stack, v_stack) = backbone(params, x, cfg, mask,
                                     _positions(B, S, x.device),
                                     collect_kv=True, lowering=lowering)
    length = int(length)
    logits = L.unembed(_unembed_table(params, cfg), h[:, length - 1:length],
                       cfg)
    return logits[:, 0], {"k": k_stack, "v": v_stack}


def _decode_mlp(bp, h, cfg, lowering):
    return h + L.mlp(bp["mlp"], L.rmsnorm(bp["mlp_norm"], h, cfg.norm_eps,
                                          lowering=lowering), cfg)


def decode_step_paged(params, tokens, k_pages, v_pages, page_table, seq_lens,
                      active, cfg: ModelConfig,
                      lowering: Optional[LoweringConfig] = None):
    """One-token decode through the paged KV pools (see
    ``layers.attention_decode_paged``).  tokens: (B,) int; pools carry a
    leading layer axis (L, N + 1, page, K, hd), the last page a spare that
    takes inactive slots' writes, and are updated in place (the
    reference donates them), so batch and pool shapes stay fixed across
    admissions and retirements.

    Returns (logits (B, vocab), k_pages, v_pages).
    """
    _check_dense(cfg)
    h = L.embed(params["embed"], tokens[:, None], cfg)  # (B,1,d)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        a, _, _ = L.attention_decode_paged(
            bp["attn"], L.rmsnorm(bp["attn_norm"], h, cfg.norm_eps,
                                  lowering=lowering),
            cfg, k_pages[i], v_pages[i], page_table, seq_lens, active,
            lowering=lowering)
        h = _decode_mlp(bp, h + a, cfg, lowering)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, lowering=lowering)
    logits = L.unembed(_unembed_table(params, cfg), h, cfg)
    return logits[:, 0], k_pages, v_pages


def decode_step(params, token, caches, pos: int, cfg: ModelConfig,
                lowering: Optional[LoweringConfig] = None):
    """One-token decode.  token: (B,) int; caches: {'k','v'} (L,B,T,K,hd),
    updated in place at ``pos``.  Returns (logits (B, vocab), caches)."""
    _check_dense(cfg)
    h = L.embed(params["embed"], token[:, None], cfg)  # (B,1,d)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        a, _, _ = L.attention_decode(
            bp["attn"], L.rmsnorm(bp["attn_norm"], h, cfg.norm_eps,
                                  lowering=lowering),
            cfg, caches["k"][i], caches["v"][i], int(pos), lowering=lowering)
        h = _decode_mlp(bp, h + a, cfg, lowering)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, lowering=lowering)
    logits = L.unembed(_unembed_table(params, cfg), h, cfg)
    return logits[:, 0], caches
