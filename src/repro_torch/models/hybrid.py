"""zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention + MLP
block (a single weight set) applied before every ``shared_attn_every``
Mamba2 layers [arXiv:2411.15242]; the port of ``repro/models/hybrid.py``.

KV caches exist only at the ``n_sites = ceil(L / every)`` attention sites:
caches are ``{"k", "v": (sites, B, T, K, hd), "ssm": {"conv", "state"}}``
with the SSM caches stacked over all L layers, as ``mamba2``'s.  The Mamba2
layers are ``mamba2.ssm_block`` / ``ssm_block_decode`` as they are (the
SSD kernels K7/K8 through ``ssm_block``'s lowering); ``decode_step``
updates the caches in place where the reference returns new ones.
``loss`` is the training entry point.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compile.config import LoweringConfig, default_lowering
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.transformer import (_ffn, _positions, block_fwd,
                                            layer_params, new_generator,
                                            pad_kv, unstack)


def n_sites(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.shared_attn_every)


def _sites(cfg: ModelConfig) -> list[tuple[int, int]]:
    """(group_start, group_end) a site: the Mamba2 layers that follow each
    application of the shared block."""
    every = cfg.shared_attn_every
    return [(s, min(s + every, cfg.n_layers))
            for s in range(0, cfg.n_layers, every)]


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights with the reference's shapes and layout from a
    ``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s)."""
    device = torch.device(device)
    gen = new_generator(seed, device)
    dt = L.dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(cfg, gen, device),
        "blocks": M.init_ssm_block(cfg, gen, device, cfg.n_layers),
        "shared_attn": {
            "attn_norm": L.init_rmsnorm(cfg.d_model, dt, device),
            "attn": L.init_attention(cfg, gen, device),
            "mlp_norm": L.init_rmsnorm(cfg.d_model, dt, device),
            "mlp": L.init_mlp(cfg, gen, device),
        },
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
    }


def _forward(params, x, cfg: ModelConfig, mask, positions,
             collect_caches: bool,
             lowering: Optional[LoweringConfig] = None):
    """The shared block at each site, then its group of Mamba2 layers.
    Returns (normed hidden, caches | None)."""
    lw = lowering or default_lowering()
    ks, vs, convs, states = [], [], [], []
    layers = unstack(params["blocks"], cfg.n_layers)
    for start, end in _sites(cfg):
        x, _, (k, v) = block_fwd(cfg, x, params["shared_attn"], mask,
                                 positions, lw)
        ks.append(k)
        vs.append(v)
        for i in range(start, end):
            x, cache = M.ssm_block(layers[i], x, cfg,
                                   collect_cache=collect_caches, lowering=lw)
            if collect_caches:
                convs.append(cache["conv"])
                states.append(cache["state"])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lw)
    if not collect_caches:
        return x, None
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "ssm": {"conv": torch.stack(convs),
                       "state": torch.stack(states)}}


def loss(params, batch, cfg: ModelConfig,
         lowering: Optional[LoweringConfig] = None):
    """Mean next-token cross-entropy; the whole forward runs under
    ``remat_wrap(cfg.remat)``, as in the reference."""
    lw = lowering or default_lowering()
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    mask = L.make_mask("causal", S, device=x.device)
    positions = _positions(B, S, x.device)

    def fwd(p, h):
        return _forward(p, h, cfg, mask, positions, False, lowering=lw)[0]

    h = L.remat_wrap(fwd, cfg.remat)(params, x)
    logits = L.unembed(params["embed"]["table"], h, cfg, lowering=lw)
    return L.cross_entropy(logits, batch["labels"].to(logits.device))


def prefill(params, batch, cfg: ModelConfig, pad_to=None,
            lowering: Optional[LoweringConfig] = None):
    """Returns (last-position logits (B, vocab), caches), the sites' K/V
    zero-padded to ``pad_to`` where it exceeds the prompt."""
    lw = lowering or default_lowering()
    x = L.embed(params["embed"], batch["tokens"], cfg)
    B, S, _ = x.shape
    mask = L.make_mask("causal", S, device=x.device)
    h, caches = _forward(params, x, cfg, mask, _positions(B, S, x.device),
                         True, lowering=lw)
    caches["k"], caches["v"] = pad_kv(caches["k"], caches["v"], pad_to)
    logits = L.unembed(params["embed"]["table"], h[:, -1:, :], cfg,
                       lowering=lw)
    return logits[:, 0], caches


def decode_step(params, token, caches, pos: int, cfg: ModelConfig,
                lowering: Optional[LoweringConfig] = None):
    """One-token decode at ``pos``; caches updated in place.  Returns
    (logits (B, vocab), caches)."""
    lw = lowering or default_lowering()
    x = L.embed(params["embed"], token[:, None], cfg)
    sp = params["shared_attn"]
    ssm = caches["ssm"]
    for site, (start, end) in enumerate(_sites(cfg)):
        a, _, _ = L.attention_decode(
            sp["attn"], L.rmsnorm(sp["attn_norm"], x, cfg.norm_eps,
                                  lowering=lw),
            cfg, caches["k"][site], caches["v"][site], int(pos), lowering=lw)
        x, _ = _ffn(sp, x + a, cfg, lw)
        for i in range(start, end):
            x, _ = M.ssm_block_decode(
                layer_params(params["blocks"], i), x, cfg,
                {"conv": ssm["conv"][i], "state": ssm["state"][i]},
                lowering=lw)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, lowering=lw)
    logits = L.unembed(params["embed"]["table"], x, cfg, lowering=lw)
    return logits[:, 0], caches
