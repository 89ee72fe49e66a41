"""Decoder-only transformer covering the dense, moe and vlm families.

Parameters carry a leading layer axis (``blocks[...]`` is ``(L, ...)``), as
in the reference, so a ``repro`` param tree bridges over unchanged; the
reference's ``jax.lax.scan`` over that axis is a Python loop here.  A moe
config's blocks carry ``moe`` (``models/moe.py``) where the others carry
``mlp``; a vlm batch may carry ``prefix_embeds`` (B, P, d), prepended to
the token embeddings and attended under the prefix-LM mask.

Entry points:
  init_params(cfg, seed, device) / param_axes(cfg)
  loss(params, batch, cfg)                 — training (+ MoE aux loss)
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
from repro_torch.models.moe import init_moe, moe_axes, moe_mlp


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.moe is not None


def init_blocks(cfg: ModelConfig, gen: torch.Generator, device,
                n_layers: int) -> dict:
    """The blocks' params, each leaf one ``(n_layers, ...)`` tensor."""
    dt = L.dtype_of(cfg.param_dtype)
    lead = (n_layers,)
    p = {
        "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device, lead),
        "attn": L.init_attention(cfg, gen, device, lead),
        "mlp_norm": L.init_rmsnorm(cfg.d_model, dt, device, lead),
    }
    if _is_moe(cfg):
        p["moe"] = init_moe(cfg, gen, device, lead)
    else:
        p["mlp"] = L.init_mlp(cfg, gen, device, lead=lead)
    return p


def block_axes(cfg: ModelConfig) -> dict:
    p = {
        "attn_norm": L.rmsnorm_axes(),
        "attn": L.attention_axes(cfg),
        "mlp_norm": L.rmsnorm_axes(),
    }
    if _is_moe(cfg):
        p["moe"] = moe_axes(cfg)
    else:
        p["mlp"] = L.mlp_axes()
    return p


def stack_axes(tree):
    """``("layers",)`` put before every axes tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: stack_axes(v) for k, v in tree.items()}
    return ("layers",) + tree


def new_generator(seed: int, device) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (on the host for the
    ``meta`` device, whose draws allocate nothing)."""
    device = torch.device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights with the reference's shapes, scales and layout, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from ``jax.random``'s; parity tests bridge the
    reference's own weights instead)."""
    device = torch.device(device)
    gen = new_generator(seed, device)
    dt = L.dtype_of(cfg.param_dtype)
    p = {
        "embed": L.init_embedding(cfg, gen, device),
        "blocks": init_blocks(cfg, gen, device, cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": L._normal(gen, (cfg.vocab, cfg.d_model),
                                       cfg.d_model ** -0.5, dt, device)}
    return p


def param_axes(cfg: ModelConfig) -> dict:
    p = {
        "embed": L.embedding_axes(),
        "blocks": stack_axes(block_axes(cfg)),
        "final_norm": L.rmsnorm_axes(),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": ("vocab", "embed")}
    return p


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block params (views)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def unstack(blocks: dict, n: int) -> list[dict]:
    """Every layer's slice of the stacked block params (views), by one
    ``unbind`` a leaf: under autograd its backward stacks the layers'
    gradients once, where indexing each layer (``layer_params``) would
    scatter each into a zero tensor the size of the whole stack."""
    per = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in blocks.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def block_fwd(cfg: ModelConfig, x, bp, mask, positions,
              lowering: Optional[LoweringConfig] = None):
    """One block.  Returns (out, aux, (k, v)): ``aux`` is the MoE block's
    Switch auxiliary loss, None for a dense block."""
    x = L.shard_act(x, "btd")
    a, kv = L.attention(bp["attn"],
                        L.rmsnorm(bp["attn_norm"], x, cfg.norm_eps,
                                  lowering=lowering),
                        cfg, mask, positions, lowering=lowering)
    h, aux = _ffn(bp, x + a, cfg, lowering)
    return h, aux, kv


def _ffn(bp, h, cfg: ModelConfig, lowering):
    """(h + the block's MLP or MoE of the normed h, the MoE's auxiliary
    loss or None)."""
    hn = L.rmsnorm(bp["mlp_norm"], h, cfg.norm_eps, lowering=lowering)
    if _is_moe(cfg):
        y, aux = moe_mlp(bp["moe"], hn, cfg, lowering=lowering)
        return h + y, aux
    return h + L.mlp(bp["mlp"], hn, cfg, lowering=lowering), None


def backbone(params, x, cfg: ModelConfig, mask, positions,
             collect_kv: bool = False,
             lowering: Optional[LoweringConfig] = None):
    """Loop over the stacked blocks, each under ``remat_wrap(cfg.remat)``.
    Returns (hidden, aux, (k, v) stacks | None): ``aux`` the sum of the
    blocks' auxiliary losses (0-d fp32; 0 for dense), the stacks shaped
    (L, B, S, K, hd)."""

    def body(h, bp):
        return block_fwd(cfg, h, bp, mask, positions, lowering)

    body = L.remat_wrap(body, cfg.remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for bp in unstack(params["blocks"], cfg.n_layers):
        x, a, (k, v) = body(x, bp)
        if a is not None:
            aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lowering)
    return h, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def _unembed_table(params, cfg: ModelConfig):
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["w"])


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _inputs_to_x(params, batch, cfg: ModelConfig):
    """tokens (+ ``prefix_embeds`` for vlm) → embeddings (B, S, d)."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.n_prefix_tokens and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _prefill_mask(cfg: ModelConfig, S: int, device):
    """The prefix-LM mask over the first n_prefix_tokens for vlm, causal
    otherwise."""
    if cfg.family == "vlm":
        return L.make_mask("prefix", S, n_prefix=cfg.n_prefix_tokens,
                           device=device)
    return L.make_mask("causal", S, device=device)


def pad_kv(k_stack, v_stack, pad_to: Optional[int]):
    """Zero-pad (L, B, S, K, hd) stacks along S to ``pad_to``.  DTensor
    stacks pad their local shards, S gathered first where it is split
    (DTensor's sharding cache keys ``constant_pad_nd`` without its pad
    widths in some releases, and hands a second pad the first's shape)."""
    S = k_stack.shape[2]
    if pad_to and pad_to > S:
        pad = (0, 0, 0, 0, 0, pad_to - S)
        if L.is_dtensor(k_stack):
            pl = L._keep(k_stack.placements, (0, 1, 3, 4))
            k_stack, v_stack = (L._on_shards(
                lambda t: torch.nn.functional.pad(t, pad), (t,), (pl,), pl)
                for t in (k_stack, v_stack))
        else:
            k_stack = torch.nn.functional.pad(k_stack, pad)
            v_stack = torch.nn.functional.pad(v_stack, pad)
    return k_stack, v_stack


def loss(params, batch, cfg: ModelConfig, aux_weight: float = 0.01,
         lowering: Optional[LoweringConfig] = None):
    """Mean next-token cross-entropy plus ``aux_weight`` × the MoE blocks'
    auxiliary loss.  batch: tokens (B, S_text), labels (B, S_text)
    [, prefix_embeds (B, P, d): vlm's prefix, sliced off the logits]."""
    x = _inputs_to_x(params, batch, cfg)
    B, S, _ = x.shape
    h, aux, _ = backbone(params, x, cfg, _prefill_mask(cfg, S, x.device),
                         _positions(B, S, x.device), lowering=lowering)
    logits = L.unembed(_unembed_table(params, cfg), h, cfg,
                       lowering=lowering)
    logits = L.shard_act(logits, "btv")
    logits = logits[:, S - batch["tokens"].shape[1]:, :]
    labels = batch["labels"].to(logits.device)
    return L.cross_entropy(logits, labels) + aux_weight * aux


def prefill(params, batch, cfg: ModelConfig, pad_to: Optional[int] = None,
            lowering: Optional[LoweringConfig] = None):
    """Returns (last-position logits (B, vocab), {'k','v'} (L,B,S',K,hd)),
    with S' = ``pad_to`` when it exceeds the prompt (zero padded); a vlm
    prompt's S counts its prefix embeddings."""
    x = _inputs_to_x(params, batch, cfg)
    B, S, _ = x.shape
    mask = _prefill_mask(cfg, S, x.device)
    h, _, (k_stack, v_stack) = backbone(params, x, cfg, mask,
                                        _positions(B, S, x.device),
                                        collect_kv=True, lowering=lowering)
    k_stack, v_stack = pad_kv(k_stack, v_stack, pad_to)
    logits = L.unembed(_unembed_table(params, cfg), h[:, -1:, :], cfg,
                       lowering=lowering)
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
    x = _inputs_to_x(params, batch, cfg)
    B, S, _ = x.shape
    mask = L.make_mask("causal", S, device=x.device)
    h, _, (k_stack, v_stack) = backbone(params, x, cfg, mask,
                                        _positions(B, S, x.device),
                                        collect_kv=True, lowering=lowering)
    length = int(length)
    logits = L.unembed(_unembed_table(params, cfg), h[:, length - 1:length],
                       cfg, lowering=lowering)
    return logits[:, 0], {"k": k_stack, "v": v_stack}


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
    h = L.embed(params["embed"], tokens[:, None], cfg)  # (B,1,d)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        a, _, _ = L.attention_decode_paged(
            bp["attn"], L.rmsnorm(bp["attn_norm"], h, cfg.norm_eps,
                                  lowering=lowering),
            cfg, k_pages[i], v_pages[i], page_table, seq_lens, active,
            lowering=lowering)
        h, _ = _ffn(bp, h + a, cfg, lowering)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, lowering=lowering)
    logits = L.unembed(_unembed_table(params, cfg), h, cfg,
                       lowering=lowering)
    return logits[:, 0], k_pages, v_pages


def decode_step(params, token, caches, pos: int, cfg: ModelConfig,
                lowering: Optional[LoweringConfig] = None):
    """One-token decode.  token: (B,) int; caches: {'k','v'} (L,B,T,K,hd),
    updated in place at ``pos``.  Returns (logits (B, vocab), caches)."""
    h = L.embed(params["embed"], token[:, None], cfg)  # (B,1,d)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        a, _, _ = L.attention_decode(
            bp["attn"], L.rmsnorm(bp["attn_norm"], h, cfg.norm_eps,
                                  lowering=lowering),
            cfg, caches["k"][i], caches["v"][i], int(pos), lowering=lowering)
        h, _ = _ffn(bp, h + a, cfg, lowering)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, lowering=lowering)
    logits = L.unembed(_unembed_table(params, cfg), h, cfg,
                       lowering=lowering)
    return logits[:, 0], caches
