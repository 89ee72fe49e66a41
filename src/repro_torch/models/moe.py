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


def moe_axes(cfg: ModelConfig) -> dict:
    p = {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "ff"),
        "wi_up": ("experts", "embed", "ff"),
        "wo": ("experts", "ff", "embed"),
    }
    if cfg.moe.dense_residual_ff:
        # arctic's small parallel dense residual: replicated over 'model',
        # sharded over 'data' only, as in the reference
        p["dense"] = {"wi_gate": ("embed", None), "wi_up": ("embed", None),
                      "wo": (None, "embed")}
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


def _group_ranks(idx, E: int):
    """Each (token, choice) pair's rank within its expert in its group, in
    slot-major priority: idx (G, Tg, k) → ranks (G, Tg, k), fp32."""
    cum = torch.zeros((idx.shape[0], 1, E), dtype=torch.float32,
                      device=idx.device)
    ranks = []
    for s in range(idx.shape[-1]):
        oh = F.one_hot(idx[..., s], E).float()               # (G,Tg,E)
        pos = torch.cumsum(oh, dim=1) - oh + cum
        cum = cum + oh.sum(dim=1, keepdim=True)
        ranks.append(torch.sum(pos * oh, dim=-1))            # (G,Tg)
    return torch.stack(ranks, -1)


def _sort_ranks(idx, E: int):
    """The (token, choice) pairs of idx (T, k) in token order, stably
    sorted by expert: (order, sorted experts, each sorted pair's rank
    within its expert)."""
    flat_e = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=idx.device))
    rank = torch.arange(flat_e.numel(), device=idx.device) - start[sorted_e]
    return order, sorted_e, rank


def _grouped_applies(cfg: ModelConfig, T: int) -> bool:
    """Whether ``T`` tokens take the grouped dispatch (else the sort)."""
    return (cfg.moe.dispatch == "grouped" and T > 1
            and T % min(GROUP_SIZE, T) == 0)


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
    ranks = _group_ranks(idx, E)
    for s in range(k):
        oh = F.one_hot(idx[..., s], E).float()               # (G,Tg,E)
        pos_t = ranks[..., s]                                # (G,Tg)
        keep = (pos_t < capacity).float()
        # a dropped token's slot is clamped in range and zeroed by keep
        pos_oh = F.one_hot(torch.clamp(pos_t.long(), max=capacity - 1),
                           capacity).float()                 # (G,Tg,C)
        d_s = oh[..., :, None] * pos_oh[..., None, :] * keep[..., None, None]
        disp = disp + d_s
        comb = comb + d_s * gate[..., s][..., None, None]
    disp = L.shard_act(disp.to(cd), "gtec")
    comb = L.shard_act(comb.to(cd), "gtec")

    buf = torch.einsum("gtd,gtec->gecd", xg.to(cd), disp)   # (G,E,C,d)
    buf = L.shard_act(buf, "gecd")
    out = L.shard_act(_experts(params, buf, cd, "gec"), "gecd")
    y = torch.einsum("gecd,gtec->gtd", out, comb).reshape(B, S, d)
    if "dense" in params:
        y = y + L.mlp(params["dense"], x, cfg, lowering=lowering)
    return y.to(x.dtype), aux


def moe_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig,
            lowering: Optional[LoweringConfig] = None):
    """x: (B, S, d) → (y (B, S, d), aux loss): the grouped dispatch where
    the config asks for it and there is more than one token, else sort.
    A DTensor ``x`` takes ``_moe_on_shards``."""
    if L.is_dtensor(x):
        return _moe_on_shards(params, x, cfg, lowering)
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

    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    order, sorted_e, rank = _sort_ranks(idx, E)
    keep = rank < capacity
    dest = torch.clamp(rank, max=capacity - 1)

    x_sorted = xt[flat_t[order]].to(cd) * keep[:, None].to(cd)
    x_sorted = L.shard_act(x_sorted, "td")
    buf = torch.zeros((E, capacity, d), dtype=cd, device=x.device)
    buf.index_put_((sorted_e, dest), x_sorted, accumulate=True)
    buf = L.shard_act(buf, "ecd")  # experts→model, capacity→data
    out_buf = L.shard_act(_experts(params, buf, cd, "ec"), "ecd")

    y_sorted = out_buf[sorted_e, dest] * keep[:, None].to(cd)
    y_sorted = L.shard_act(y_sorted, "td")
    inv = torch.argsort(order, stable=True)
    y_tk = y_sorted[inv].reshape(T, k, d)
    y = torch.einsum("tkd,tk->td", y_tk, gate.to(cd)).reshape(B, S, d)
    if "dense" in params:  # arctic's parallel dense residual branch
        y = y + L.mlp(params["dense"], x, cfg, lowering=lowering)
    return y.to(x.dtype), aux


def _slot_ranks(idx, Tg: int, grouped: bool, E: int):
    """Each (token, choice) pair's rank in its expert in its group of
    ``Tg`` tokens, as the plain grouped (slot-major) or sort (token-major)
    dispatch gives it: idx (T, k), T a whole number of groups → (T, k)."""
    T, k = idx.shape
    if grouped:
        return _group_ranks(idx.reshape(T // Tg, Tg, k), E).reshape(
            T, k).long()
    order, _, rank = _sort_ranks(idx, E)
    return torch.empty_like(rank).index_put_((order,), rank).reshape(T, k)


def _moe_on_shards(params: dict, x, cfg: ModelConfig, lowering):
    """The MoE layer of a DTensor ``x``, by hand: DTensor has no sharding
    strategy for the dispatch's argsort, searchsorted and scatter, nor
    propagates the one-hot einsums cleanly.  Each batch shard routes its
    own tokens with the router replicated.  Where a group spans shards
    (the sort dispatch's one group of every token, or a grouped group
    larger than a shard), the top-k choices are all-gathered over the
    batch dims, so that every pair gets the group, rank and capacity the
    plain dispatch of the whole batch gives it (``_slot_ranks``): the
    pairs kept and dropped are the unsharded run's, by either dispatch.
    A shard scatters its own kept pairs into the slots of the groups it
    touches and gathers them back (the grouped dispatch's one-hot
    einsums, done as index ops).  Experts stay sharded where their
    weights are (expert parallelism): a shard runs its own experts on its
    slots, and the combine leaves ``y`` a partial sum over those mesh
    dims.  The arctic dense residual runs as DTensor matmuls outside.
    The Switch loss is formed from the router's summed probs and top-1
    counts, reduced over the batch shards.  Gradients of the replicated
    inputs (tokens over the expert dims, router everywhere) are summed
    over the dims that split the work (``layers._on_shards``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    c10d = torch.ops._c10d_functional
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    cd = L.dtype_of(cfg.compute_dtype)
    mesh = x.device_mesh
    B, S, d = x.shape
    T_all = B * S
    xpl = list(L._keep(x.placements, (0,)))
    b_dims = [j for j, p in enumerate(xpl) if p != Replicate()]
    epl = [Shard(0) if (type(p) is Shard and p.dim == 0
                        and xpl[j] == Replicate()) else Replicate()
           for j, p in enumerate(params["wi_gate"].placements)]
    e_dims = [j for j, p in enumerate(epl) if p != Replicate()]
    coord = mesh.get_coordinate() or [0] * mesh.ndim

    def index(dims):  # this rank's shard along ``dims``, mesh-dim order
        i = 0
        for j in dims:
            i = i * mesh.shape[j] + coord[j]
        return i

    n_b = T_all
    for j in b_dims:
        n_b //= mesh.shape[j]
    ne = E
    for j in e_dims:
        ne //= mesh.shape[j]
    t0, e0 = index(b_dims) * n_b, index(e_dims) * ne
    rep = [Replicate()] * mesh.ndim
    names = ("router", "wi_gate", "wi_up", "wo")
    first = float(all(coord[j] == 0 for j in e_dims))
    lw = lowering or default_lowering()

    grouped = _grouped_applies(cfg, T_all)
    Tg = min(GROUP_SIZE, T_all) if grouped else T_all
    C = _capacity(cfg, T_all, Tg)
    g0 = t0 // Tg
    Gl = (t0 + n_b - 1) // Tg - g0 + 1

    def local(xl, router, wg, wu, wo):
        Tl = xl.shape[0] * S
        if Tl != n_b:
            raise ValueError(f"MoE on shards: {Tl} tokens a batch shard, "
                             f"expected {n_b} (the batch does not divide)")
        xt = xl.reshape(Tl, d)
        probs, gate, idx = _route(router, xt, k)            # (Tl,E|k)
        if Tl % Tg:  # groups span shards: every shard's choices
            idx_all = idx
            for j in reversed(b_dims):   # inner dim first: mesh-dim order
                idx_all = c10d.wait_tensor(c10d.all_gather_into_tensor(
                    idx_all, mesh.shape[j], mesh.get_group(j).group_name))
            rank = _slot_ranks(idx_all, Tg, grouped, E)[t0:t0 + Tl]
        else:        # whole groups: their ranks are this shard's own
            rank = _slot_ranks(idx, Tg, grouped, E)
        tok = torch.arange(t0, t0 + Tl, device=xl.device)
        g = (tok // Tg - g0)[:, None].expand(Tl, k)
        e = idx - e0
        keep = (rank < C) & (e >= 0) & (e < ne)
        e = torch.clamp(e, 0, ne - 1)
        slot = torch.clamp(rank, max=C - 1)
        lw.lower("matmul", (Gl * ne * C, d, cfg.d_ff), xl.dtype)
        src = xt.to(cd)[:, None, :] * keep[..., None].to(cd)     # (Tl,k,d)
        buf = torch.zeros((Gl, ne, C, d), dtype=cd, device=xl.device)
        buf.index_put_((g, e, slot), src, accumulate=True)
        out = _experts({"wi_gate": wg, "wi_up": wu, "wo": wo}, buf, cd,
                       "gec")
        w = (gate * keep).to(cd)                                  # (Tl,k)
        y = torch.einsum("tkd,tk->td", out[g, e, slot], w)
        # the router stats leave as partial sums over the expert dims too,
        # counted by the first expert shard only: the others' routing is
        # the same, and its gradient is summed over those dims
        me = probs.sum(0) * first
        ce = F.one_hot(idx[:, 0], E).float().sum(0) * first
        return y.reshape(xl.shape), me, ce

    ypl = [Partial() if j in e_dims else xpl[j] for j in range(mesh.ndim)]
    spl = [Partial() if type(p) is Shard or j in e_dims else Replicate()
           for j, p in enumerate(xpl)]
    y, me, ce = L._on_shards(local, (x, *(params[n] for n in names)),
                             (xpl, rep, epl, epl, epl), (ypl, spl, spl),
                             n_out=3)
    aux = E * torch.sum((me / T_all) * (ce / T_all))
    if "dense" in params:
        y = y + L.mlp(params["dense"], x, cfg, lowering=lowering)
    return y.to(x.dtype), aux
