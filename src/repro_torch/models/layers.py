"""Shared layer substrate of every family: RMSNorm, RoPE, GQA attention,
masks, SwiGLU MLP, embeddings.

Parameters are plain nested dicts of tensors with the reference's names,
shapes and layouts, so a ``repro`` param tree bridges over as it is
(``repro_torch.bridge``).  Kernel choice is a ``LoweringConfig`` decision
(the compile cache's record): RMSNorm and prefill attention run the
hand-written kernels on the ``"cuda"`` backend, with the record's
schedule; ``"torch_chunked"`` runs attention as an online softmax over key
chunks; decode attention (a one-row query) and every GEMM stay plain torch
ops, as the reference leaves them to XLA.  The MLP and unembedding GEMMs
look up their ``matmul`` record all the same, as the reference does (the
recorded negative control: no ISAX matches a plain GEMM).

The init functions take ``lead``, a shape put before each leaf's own:
a stack of layers is drawn as one ``(L, ...)`` tensor a leaf, so a model
never holds its blocks twice.  Every init has an ``*_axes`` function that
returns the same tree with logical-axis tuples; ``sharding/policies.py``
maps logical axes to mesh axes.

Distribution: params may be DTensors (``torch.distributed.tensor``).
``shard_act`` is the counterpart of the reference's
``with_sharding_constraint`` at block boundaries: it redistributes a
DTensor activation to the spec set for its kind, and is the identity when
no specs are set or ``x`` is a plain tensor, so the plain paths never pay
DTensor dispatch.  The kernel routes take a DTensor's local shards
through ``local_map`` (``_on_shards``), with the placements each kernel
needs: K1 a replicated ``d``, K2/K3 replicated ``S``, ``T`` and ``hd``
with batch and heads free to stay sharded.
"""

from __future__ import annotations

import functools
import math
import sys
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.compile.config import LoweringConfig, default_lowering
from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Activation sharding constraints (opt-in, set by the launcher)
# ---------------------------------------------------------------------------

_ACT_SPECS: Optional[dict] = None


def set_activation_shardings(specs: Optional[dict]) -> None:
    """specs: {'btd': spec, 'btv': ..., the MoE kinds} (``policies.
    activation_specs``) or None, which turns every constraint off."""
    global _ACT_SPECS
    _ACT_SPECS = specs


def shard_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` redistributed to the spec set for ``kind``: a no-op without
    specs, for a kind with no spec and for a plain tensor."""
    if _ACT_SPECS is None or _ACT_SPECS.get(kind) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.policies import to_placements
    want = to_placements(_ACT_SPECS[kind], x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing
    ``torch.distributed.tensor`` (none exists before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


class _ShardGrad(torch.autograd.Function):
    """Identity forward.  Backward, the gradient made contiguous (DTensor's
    view ops take a local gradient as a view, which a transposed one
    refuses) and all-reduced over ``groups``: a replicated input used by
    shards of a split computation has a partial sum on each rank, which
    ``local_map`` would take for the whole."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.groups:
            g = g.clone()
            for group in ctx.groups:
                torch.distributed.all_reduce(g, group=group)
        return g, None


def _grad_sum_groups(mesh, in_placements) -> list:
    """For each input of a local computation, the groups of the mesh dims
    that split some other input while this one is replicated there."""
    split = {j for pl in in_placements for j, p in enumerate(pl)
             if p.is_shard()}
    return [[mesh.get_group(j) for j in sorted(split) if not pl[j].is_shard()]
            for pl in in_placements]


def _on_shards(fn, args: tuple, placements: tuple, out_placements,
               n_out: int = 1):
    """``fn`` on the local shards of ``args`` (DTensors or plain tensors,
    plain ones taken as replicated) after redistributing each to its
    entry of ``placements``; the result is a DTensor of ``out_placements``
    (``local_map``), the gradients as ``_ShardGrad`` makes them; with
    ``n_out`` > 1, a tuple of outputs, ``out_placements`` one entry
    each."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    rep = (Replicate(),) * mesh.ndim
    args = tuple(
        DTensor.from_local(a, mesh, rep, run_check=False)
        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
        else a for a in args)
    in_pl = tuple(list(p) for p in placements)
    groups = _grad_sum_groups(mesh, in_pl)

    def local(*xs):
        return fn(*(_ShardGrad.apply(x, g) if x.requires_grad else x
                    for x, g in zip(xs, groups)))

    outs = (list(out_placements) if n_out == 1
            else tuple(list(p) for p in out_placements))
    return local_map(local, out_placements=outs,
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _keep(pl, dims) -> tuple:
    """Placements ``pl`` with every ``Shard`` of a dim outside ``dims``
    (and every ``Partial``) made ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if type(p) is Shard and p.dim in dims
                 else Replicate() for p in pl)


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    """N(0, std²) draws from ``gen``, made in ``dtype`` in place (no fp32
    copy of a full-width leaf)."""
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=gen)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm_axes() -> dict:
    return {"scale": ("embed",)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6, *,
            lowering: Optional[LoweringConfig] = None) -> torch.Tensor:
    if is_dtensor(x):  # on the shards of the leading dims; d replicated
        pl = _keep(x.placements, range(x.ndim - 1))
        return _on_shards(
            lambda a, sc: rmsnorm({"scale": sc}, a, eps, lowering=lowering),
            (x, params["scale"]), (pl, _keep(pl, ())), pl)
    lw = lowering or default_lowering()
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    rec = lw.lower("rmsnorm", (rows, d), x.dtype)
    if rec.impl == "isax":
        out = rec.kernel_fn(x.reshape(rows, d), params["scale"], eps=eps,
                            schedule=rec.schedule)
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

def init_attention(cfg: ModelConfig, gen: torch.Generator, device,
                   lead: tuple = ()) -> dict:
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    dt = dtype_of(cfg.param_dtype)
    scale = d ** -0.5
    p = {
        "wq": _normal(gen, lead + (d, H, hd), scale, dt, device),
        "wk": _normal(gen, lead + (d, K, hd), scale, dt, device),
        "wv": _normal(gen, lead + (d, K, hd), scale, dt, device),
        "wo": _normal(gen, lead + (H, hd, d), (H * hd) ** -0.5, dt, device),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=dt, device=device)
    return p


def attention_axes(cfg: ModelConfig) -> dict:
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one GEMM over the flattened heads."""
    d, h, k = w.shape
    if is_dtensor(w):
        w = _unsplit(w, 2)
    wf = w.reshape(d, h * k)
    if is_dtensor(wf):
        wf = _WholeHeadsGrad.apply(wf, h, 1)
    y = x @ wf
    if is_dtensor(y):
        y = _whole_heads(y, h)
    return y.reshape(*x.shape[:-1], h, k)


def _unsplit(w, dim: int):
    """DTensor ``w`` with ``dim`` (a weight's head_dim, split by the
    ``fsdp_tp_hd`` policy) gathered: DTensor flattens (heads, head_dim)
    into a strided shard that its ``mm`` cannot propagate."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if p == Shard(dim) else p for p in w.placements)
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _whole_heads(y, h: int, dim: int = -1):
    """DTensor ``y`` whose ``dim`` is a merged h·k, with any split of that
    dim that cuts a head gathered first: DTensor cannot view such a split
    as (h, k)."""
    from torch.distributed.tensor import Replicate, Shard
    last = Shard(dim % y.ndim)
    pl = tuple(Replicate() if p == last and h % y.device_mesh.shape[j]
               else p for j, p in enumerate(y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(
        y.device_mesh, pl)


class _WholeHeadsGrad(torch.autograd.Function):
    """Identity forward; ``_whole_heads`` on the gradient backward (the
    gradient of a merged (..., h·k) tensor is viewed back as (..., h, k))."""

    @staticmethod
    def forward(ctx, y, h, dim=-1):
        ctx.h, ctx.dim = h, dim
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.h, ctx.dim), None, None


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
    if is_dtensor(wo):
        wo = _unsplit(wo, 1)
    flat = out.reshape(*out.shape[:-2], h * k)
    wf = wo.reshape(h * k, d)
    if is_dtensor(flat):
        flat = _WholeHeadsGrad.apply(flat, h)
        wf = _WholeHeadsGrad.apply(wf, h, 0)
    return flat @ wf


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


def _sdpa_chunked(q, k, v, mask, head_dim: int, chunk: int = 1024):
    """Online-softmax (flash) attention in plain torch ops: walks K/V in
    chunks with a running max and denominator, never materializing the
    (S, T) score matrix (the reference's ``layers._sdpa_chunked``).  A
    fully-masked row outputs 0, as the kernels do; a T the chunk does not
    divide takes ``_sdpa_xla``, as in the reference."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    c = min(chunk, T)
    if T % c:
        return _sdpa_xla(q, k, v, mask, head_dim)
    scale = head_dim ** -0.5
    qg = q.reshape(B, S, K, G, hd)
    mask_b = mask.expand(mask.shape[0], S, T)
    m = torch.full((B, K, G, S), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, K, G, hd), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, c):
        kc, vc = k[:, t0:t0 + c], v[:, t0:t0 + c]
        mc = mask_b[:, None, None, :, t0:t0 + c]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc).float() * scale
        s = torch.where(mc, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mc, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), vc).float()
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp(l.permute(0, 3, 1, 2), min=1e-30)[..., None]
    return (acc / denom).to(q.dtype).reshape(B, S, H, hd)


def _sdpa_on_shards(q, k, v, mask, head_dim: int, lowering, kind: str):
    """``sdpa`` on local shards: batch stays sharded where it is, heads
    where both H and K divide the mesh dim; S, T and hd are replicated.
    The record is looked up at the local shape."""
    from torch.distributed.tensor import Replicate, Shard
    K = k.shape[2]
    mesh = q.device_mesh
    pl = tuple(
        p if type(p) is Shard and (
            p.dim == 0 or (p.dim == 2 and K % mesh.shape[j] == 0))
        else Replicate() for j, p in enumerate(q.placements))
    mpl = _keep(pl, (0,) if mask.shape[0] == q.shape[0] > 1 else ())
    return _on_shards(
        lambda a, b, c, m: sdpa(a, b, c, m, head_dim, lowering, kind),
        (q, k, v, mask), (pl, pl, pl, mpl), pl)


def sdpa(q, k, v, mask, head_dim: int, lowering: LoweringConfig,
         kind: str = "attention"):
    """Lowering-routed scaled-dot-product attention: the record's kernel
    route at its schedule, the chunked online softmax, or the plain
    version."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if is_dtensor(q):
        return _sdpa_on_shards(q, k, v, mask, head_dim, lowering, kind)
    rec = lowering.lower(kind, (B, S, H, K, T, hd), q.dtype)
    if rec.impl == "isax":
        return rec.kernel_fn(q, k, v, mask, sm_scale=head_dim ** -0.5,
                             schedule=rec.schedule)
    if rec.impl == "chunked":
        return _sdpa_chunked(q, k, v, mask, head_dim)
    return _sdpa_xla(q, k, v, mask, head_dim)


def attention(params, x, cfg: ModelConfig, mask, positions,
              lowering: Optional[LoweringConfig] = None):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    lw = lowering or default_lowering()
    hd = cfg.resolved_head_dim()
    q, k, v = _qkv(params, x, cfg, positions)
    out = sdpa(q, k, v, mask, hd, lw, kind="attention")
    cd = dtype_of(cfg.compute_dtype)
    return _out_proj(out, params["wo"].to(cd)), (k, v)


def write_row(cache, pos: int, row) -> None:
    """``cache[:, pos] = row`` in place.  A DTensor cache is written on its
    local shard, by the rank that holds position ``pos`` where dim 1 is
    split (a sequence-parallel KV cache): DTensor's own setitem would
    gather the split dim into a copy and write there."""
    if not is_dtensor(cache):
        cache[:, pos] = row
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    if coord is None:  # not on this mesh
        return
    pl, size, lp, mine = [], cache.shape[1], pos, True
    for j, p in enumerate(cache.placements):
        if type(p) is Shard and p.dim == 1:
            size //= mesh.shape[j]
            mine = mine and coord[j] == lp // size
            lp %= size
            pl.append(Replicate())
        elif type(p) is Shard:
            pl.append(Shard(p.dim - 1 if p.dim > 1 else 0))
        else:
            pl.append(Replicate())
    if not isinstance(row, DTensor):
        row = DTensor.from_local(row, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    row = row.redistribute(mesh, pl)
    if mine:
        cache.to_local()[:, lp] = row.to_local()


def attention_decode(params, x, cfg: ModelConfig, k_cache, v_cache, pos: int,
                     lowering: Optional[LoweringConfig] = None):
    """One-token decode against a static-size KV cache.

    x: (B,1,d); k_cache/v_cache: (B,T,K,hd); pos: current position (int).
    The caches are updated in place at ``pos`` (the reference returns new
    ones).  Returns (out, k_cache, v_cache).
    """
    lw = lowering or default_lowering()
    hd = cfg.resolved_head_dim()
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(params, x, cfg, positions)
    write_row(k_cache, pos, k[:, 0].to(k_cache.dtype))
    write_row(v_cache, pos, v[:, 0].to(v_cache.dtype))
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
    lw = lowering or default_lowering()
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


def make_mask(kind: str, S: int, T: Optional[int] = None, n_prefix: int = 0,
              device=None) -> torch.Tensor:
    """(1, S, T) boolean attention mask: ``"causal"``; ``"prefix"``, causal
    and bidirectional over the first ``n_prefix`` positions (the vlm
    prefix-LM mask); ``"full"``, every key (encoder and cross attention)."""
    T = T or S
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(T, device=device)[None, :]
    if kind == "causal":
        m = cols <= rows
    elif kind == "prefix":
        m = (cols <= rows) | (cols < n_prefix)
    elif kind == "full":
        m = torch.ones((S, T), dtype=torch.bool, device=device)
    else:
        raise ValueError(kind)
    return m[None]


# ---------------------------------------------------------------------------
# SwiGLU MLP (GEMMs stay torch.matmul: the reference's negative control)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             d_ff: Optional[int] = None, lead: tuple = ()) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    return {
        "wi_gate": _normal(gen, lead + (d, ff), d ** -0.5, dt, device),
        "wi_up": _normal(gen, lead + (d, ff), d ** -0.5, dt, device),
        "wo": _normal(gen, lead + (ff, d), ff ** -0.5, dt, device),
    }


def mlp_axes() -> dict:
    return {"wi_gate": ("embed", "ff"), "wi_up": ("embed", "ff"),
            "wo": ("ff", "embed")}


def mlp(params, x, cfg: ModelConfig,
        lowering: Optional[LoweringConfig] = None):
    lw = lowering or default_lowering()
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    d, ff = params["wi_gate"].shape
    lw.lower("matmul", (math.prod(x.shape[:-1]), d, ff), x.dtype)
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


def embedding_axes() -> dict:
    return {"table": ("vocab", "embed")}


def embed(params, tokens, cfg: ModelConfig):
    cd = dtype_of(cfg.compute_dtype)
    if is_dtensor(params["table"]):
        return _embed_on_shards(params["table"], tokens, cd)
    return params["table"].to(cd)[tokens.long()]


def _embed_on_shards(table, tokens, cd):
    """The embedding gather of a DTensor table, by hand (vocab parallel):
    each rank looks its token shard up in its vocab slice, zero outside
    it, and the rows leave as a partial sum over the vocab's mesh dims.
    DTensor's own gather (an ``index_put`` backward on a batch-sharded
    index) fails its sharding propagation in some releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl = _keep(tokens.placements, (0,))
    vpl = tuple(Shard(0) if p == Shard(0) and tpl[j] == Replicate()
                else Replicate() for j, p in enumerate(table.placements))
    v_dims = [j for j, p in enumerate(vpl) if p.is_shard()]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    shard, n = 0, 1
    for j in v_dims:
        shard, n = shard * mesh.shape[j] + coord[j], n * mesh.shape[j]
    rows = table.shape[0] // n
    opl = tuple(Partial() if j in v_dims else tpl[j]
                for j in range(mesh.ndim))

    def local(tab, tok):
        if not v_dims:
            return tab.to(cd)[tok.long()]
        r = tok.long() - shard * rows
        hit = ((r >= 0) & (r < rows))[..., None].to(cd)
        return tab.to(cd)[torch.clamp(r, 0, rows - 1)] * hit

    return _on_shards(local, (table, tokens), (vpl, tpl), opl)


def unembed(table_or_w, x, cfg: ModelConfig,
            lowering: Optional[LoweringConfig] = None):
    lw = lowering or default_lowering()
    lw.lower("matmul", (math.prod(x.shape[:-1]), x.shape[-1],
                        table_or_w.shape[0]), x.dtype)
    cd = dtype_of(cfg.compute_dtype)
    logits = x.to(cd) @ table_or_w.to(cd).T
    return logits.to(dtype_of(cfg.logit_dtype))


# ---------------------------------------------------------------------------
# Loss and rematerialization
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels == ignore_id are masked."""
    if is_dtensor(logits):
        return _cross_entropy_on_shards(logits, labels, ignore_id)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels.long(), min=0)[..., None])[..., 0]
    w = (labels != ignore_id).float()
    return torch.sum((logz - gold) * w) / torch.clamp(torch.sum(w), min=1.0)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce sum over ``group`` forward, identity backward: its
    consumers are replicated over the group, so each rank's gradient is
    already the whole one (Megatron's reduce from the model region)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _cross_entropy_on_shards(logits, labels, ignore_id: int):
    """``cross_entropy`` of a DTensor: vocab-parallel where one mesh dim
    shards the vocab (the shard's max, sum of exponentials and gold logit,
    each all-reduced over that dim's group), batch and sequence shards
    kept; the sums of the losses and weights leave as partial sums over
    the batch's mesh dims and divide once reduced.  DTensor's own gather
    on a vocab-sharded dim fails, hence this route."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = list(_keep(logits.placements, range(logits.ndim)))
    vdims = [j for j, p in enumerate(pl) if p == Shard(last)]
    for j in vdims[1:]:
        pl[j] = Replicate()
    vdim = vdims[0] if vdims else None
    lab_pl = [Replicate() if p == Shard(last) else p for p in pl]
    group = mesh.get_group(vdim) if vdim is not None else None
    rank = mesh.get_local_rank(vdim) if vdim is not None else 0

    def local(lg, lab):
        lg = lg.float()
        vl = lg.shape[-1]
        m = lg.amax(dim=-1).detach()
        if group is not None:
            torch.distributed.all_reduce(
                m, op=torch.distributed.ReduceOp.MAX, group=group)
        se = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        idx = lab.long() - rank * vl
        hit = (idx >= 0) & (idx < vl)
        gold = torch.gather(lg, -1, torch.clamp(idx, 0, vl - 1)[..., None])
        gold = gold[..., 0] * hit
        if group is not None:
            se = _SumOverGroup.apply(se, group)
            gold = _SumOverGroup.apply(gold, group)
        w = (lab != ignore_id).float()
        nll = torch.log(se) + m - gold
        return torch.sum(nll * w), torch.sum(w)

    part = [Partial() if isinstance(p, Shard) and j != vdim else Replicate()
            for j, p in enumerate(pl)]
    total, count = _on_shards(local, (logits, labels), (pl, lab_pl),
                              (part, part), n_out=2)
    return total / torch.clamp(count, min=1.0)


#: The unbatched products whose outputs the ``"dots"`` policy saves.
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _needs_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_needs_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_needs_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat_wrap(fn, policy: str):
    """``fn`` under a rematerialization policy (the reference's
    ``jax.checkpoint`` policies):

    * ``"none"``: ``fn`` as it is; autograd saves what it needs;
    * ``"dots"``: selective checkpointing that saves the outputs of the
      unbatched products, ``aten.mm`` and ``aten.addmm``, and recomputes
      everything else in the backward pass (the counterpart of
      ``dots_with_no_batch_dims_saveable``).  The port's projections
      (``x @ w`` of a (B, S, d) activation, ``_proj``, ``_out_proj``,
      ``mlp``, ``unembed``) lower to ``aten.mm`` over the flattened rows
      and are saved; the attention and SSD einsums, whose operands share a
      batch of (batch, heads) or (batch, chunk), lower to ``aten.bmm`` and
      are recomputed, as are norms, softmax and elementwise ops;
    * ``"full"``: ``torch.utils.checkpoint.checkpoint``: only the inputs
      are kept, the whole of ``fn`` runs again in the backward pass.

    The wrapper checkpoints only where autograd records: with grad
    disabled, or with no tensor argument that requires grad (serving),
    it calls ``fn`` directly."""
    if policy == "none":
        return fn
    if policy not in ("dots", "full"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not (torch.is_grad_enabled() and _needs_grad(args)):
            return fn(*args)
        return checkpoint(fn, *args, **kw)

    return wrapped
