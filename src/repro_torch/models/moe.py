"""Mixture-of-Experts layer: top-k token-choice routing with capacity
dispatch (GShard/Switch style), the port of ``repro/models/moe.py``.

Serves the two MoE configs:
  * arctic-480b — 128 experts, top-2, plus a parallel dense residual MLP
  * dbrx-132b   — 16 experts, top-4

Two dispatches, as in the reference, with its decisions:
  * ``moe_mlp_grouped`` (``dispatch="grouped"``, both configs): tokens in
    groups of ``GROUP_SIZE``, one-hot dispatch and combine tensors, the
    experts' GEMMs as einsums over (group, expert, capacity) buffers.  It
    runs at decode too (T = the batch's tokens, T > 1); a token count the
    group does not divide takes the sort dispatch directly.
  * ``_moe_mlp_sort``: a stable argsort of the (token, choice) pairs by
    expert, each pair's rank within its expert from ``searchsorted``, and
    a scatter-add (``index_put_(accumulate=True)``) into (E, C, d)
    buffers.  Every kept pair has its own slot and a dropped one adds
    zeros, so the result does not depend on the order of the adds.

Capacity is loss-free (a group's whole token count) where T ≤ 256, else
``int(k·Tg/E·capacity_factor)`` a group (``_capacity``).  Both return the
Switch load-balance auxiliary loss beside the output.  Routing is fp32;
``torch.topk`` may order exact ties differently from ``jax.lax.top_k``
(lower index first), which random router logits hardly ever produce.  The
expert GEMMs look up one ``matmul`` record over the buffers' rows, as the
reference does (no ISAX: they stay ``torch.einsum``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.compile.config import LoweringConfig, default_lowering
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

#: Tokens a group of the grouped dispatch (the reference's default).
GROUP_SIZE = 512
#: Token counts up to this route with no capacity limit.
LOSS_FREE_TOKENS = 256


def init_moe(cfg: ModelConfig, gen: torch.Generator, device,
             lead: tuple = ()) -> dict:
    m = cfg.moe
    d, ff, E = cfg.d_model, cfg.d_ff, m.n_experts
    dt = L.dtype_of(cfg.param_dtype)
    p = {
        "router": L._normal(gen, lead + (d, E), d ** -0.5, torch.float32,
                            device),
        "wi_gate": L._normal(gen, lead + (E, d, ff), d ** -0.5, dt, device),
        "wi_up": L._normal(gen, lead + (E, d, ff), d ** -0.5, dt, device),
        "wo": L._normal(gen, lead + (E, ff, d), ff ** -0.5, dt, device),
    }
    if m.dense_residual_ff:
        p["dense"] = L.init_mlp(cfg, gen, device, d_ff=m.dense_residual_ff,
                                lead=lead)
    return p


def _capacity(cfg: ModelConfig, T: int, Tg: int) -> int:
    """Slots an expert has in a group of ``Tg`` of ``T`` tokens."""
    m = cfg.moe
    if T <= LOSS_FREE_TOKENS:
        return Tg
    return max(1, int(m.top_k * Tg / m.n_experts * m.capacity_factor))


def _route(router, x2, k: int):
    """fp32 routing of tokens ``x2`` (..., d): (probs, normalized top-k
    gates, expert indices)."""
    probs = torch.softmax(x2.float() @ router.float(), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, idx


def _aux_loss(probs, top1, E: int):
    """Switch load-balance loss: E · Σ_e mean prob_e · share routed to e."""
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(top1.reshape(-1), E).float().mean(0)
    return E * torch.sum(me * ce)


def _experts(params, buf, cd, spec: str):
    """SwiGLU of every expert over its buffer rows (``spec`` names the
    buffer's leading axes, e.g. ``"gec"``)."""
    g = torch.einsum(f"{spec}d,edf->{spec}f", buf, params["wi_gate"].to(cd))
    u = torch.einsum(f"{spec}d,edf->{spec}f", buf, params["wi_up"].to(cd))
    h = F.silu(g) * u
    return torch.einsum(f"{spec}f,efd->{spec}d", h, params["wo"].to(cd))


def moe_mlp_grouped(params: dict, x: torch.Tensor, cfg: ModelConfig,
                    lowering: Optional[LoweringConfig] = None):
    """GShard grouped one-hot dispatch.  Tokens are split into G groups of
    ``Tg``; each expert takes at most C tokens a group, in slot-major
    priority (every token's first choice before any second choice).
    x: (B, S, d) → (y (B, S, d), aux loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    cd = L.dtype_of(cfg.compute_dtype)
    Tg = min(GROUP_SIZE, T)
    if T % Tg:
        return _moe_mlp_sort(params, x, cfg, lowering=lowering)
    G = T // Tg
    xg = x.reshape(G, Tg, d)
    probs, gate, idx = _route(params["router"], xg, k)     # (G,Tg,E|k)
    aux = _aux_loss(probs, idx[..., 0], E)
    capacity = _capacity(cfg, T, Tg)
    lw = lowering or default_lowering()
    lw.lower("matmul", (G * E * capacity, d, cfg.d_ff), x.dtype)

    disp = torch.zeros((G, Tg, E, capacity), dtype=torch.float32,
                       device=x.device)
    comb = torch.zeros_like(disp)
    cum = torch.zeros((G, 1, E), dtype=torch.float32, device=x.device)
    for s in range(k):
        oh = F.one_hot(idx[..., s], E).float()               # (G,Tg,E)
        pos = torch.cumsum(oh, dim=1) - oh + cum             # rank
        cum = cum + oh.sum(dim=1, keepdim=True)
        pos_t = torch.sum(pos * oh, dim=-1)                  # (G,Tg)
        keep = (pos_t < capacity).float()
        # a dropped token's slot is clamped in range and zeroed by keep
        pos_oh = F.one_hot(torch.clamp(pos_t.long(), max=capacity - 1),
                           capacity).float()                 # (G,Tg,C)
        d_s = oh[..., :, None] * pos_oh[..., None, :] * keep[..., None, None]
        disp = disp + d_s
        comb = comb + d_s * gate[..., s][..., None, None]
    disp, comb = disp.to(cd), comb.to(cd)

    buf = torch.einsum("gtd,gtec->gecd", xg.to(cd), disp)   # (G,E,C,d)
    out = _experts(params, buf, cd, "gec")
    y = torch.einsum("gecd,gtec->gtd", out, comb).reshape(B, S, d)
    if "dense" in params:
        y = y + L.mlp(params["dense"], x, cfg, lowering=lowering)
    return y.to(x.dtype), aux


def moe_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
            lowering: Optional[LoweringConfig] = None):
    """x: (B, S, d) → (y (B, S, d), aux loss): the grouped dispatch where
    the config asks for it and there is more than one token, else sort."""
    if cfg.moe.dispatch == "grouped" and x.shape[0] * x.shape[1] > 1:
        return moe_mlp_grouped(params, x, cfg, lowering=lowering)
    return _moe_mlp_sort(params, x, cfg, lowering=lowering)


def _moe_mlp_sort(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  lowering: Optional[LoweringConfig] = None):
    """Sort + scatter capacity dispatch: each expert keeps its first C
    (token, choice) pairs in token order.  Called directly by the grouped
    dispatch's fallback, so the two never route back into each other."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    cd = L.dtype_of(cfg.compute_dtype)
    xt = x.reshape(T, d)
    probs, gate, idx = _route(params["router"], xt, k)      # (T,E|k)
    aux = _aux_loss(probs, idx[:, 0], E)
    capacity = _capacity(cfg, T, T)
    lw = lowering or default_lowering()
    lw.lower("matmul", (E * capacity, d, cfg.d_ff), x.dtype)

    flat_e = idx.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=x.device))
    rank = torch.arange(T * k, device=x.device) - start[sorted_e]
    keep = rank < capacity
    dest = torch.clamp(rank, max=capacity - 1)

    x_sorted = xt[flat_t[order]].to(cd) * keep[:, None].to(cd)
    buf = torch.zeros((E, capacity, d), dtype=cd, device=x.device)
    buf.index_put_((sorted_e, dest), x_sorted, accumulate=True)
    out_buf = _experts(params, buf, cd, "ec")

    y_sorted = out_buf[sorted_e, dest] * keep[:, None].to(cd)
    inv = torch.argsort(order, stable=True)
    y_tk = y_sorted[inv].reshape(T, k, d)
    y = torch.einsum("tkd,tk->td", y_tk, gate.to(cd)).reshape(B, S, d)
    if "dense" in params:  # arctic's parallel dense residual branch
        y = y + L.mlp(params["dense"], x, cfg, lowering=lowering)
    return y.to(x.dtype), aux
