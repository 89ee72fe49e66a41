"""Mamba2 / SSD (state-space duality) stack [arXiv:2405.21060].

The SSD layer computes, per head h with state size N and head dim P:

    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t        (N×P state)
    y_t = C_t · h_t + D · x_t

Prefill runs the chunked scan: the hand-written kernels K7/K8 on the
``"cuda"`` backend (``kernels.ops.ssd_scan``), ``ssd_chunked`` (the plain
chunked algorithm) on ``"torch"``.  Decoding is the O(1) recurrent step in
plain torch, as the reference gives it no kernel.  The GEMMs, the depthwise
causal conv, softplus and SiLU stay plain torch ops, as the reference
leaves them to XLA (``F.softplus`` returns x itself above 20, where
``jax.nn.softplus`` differs from x by less than fp32's rounding).

Parameters carry a leading layer axis (``blocks[...]`` is ``(L, ...)``), so
a ``repro`` param tree bridges over unchanged.  Caches are
``{"conv": (L,b,w-1,ch), "state": (L,b,H,N,P) fp32}``; ``decode_step``
updates them in place where the reference returns new ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params

_DEFAULT_LOWERING = LoweringConfig()


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.d_state, s.head_dim


def init_ssm_block(cfg: ModelConfig, gen: torch.Generator, device,
                   n_layers: int) -> dict:
    """The blocks' params with a leading axis of ``n_layers`` (the stack is
    drawn whole, so a full-width model never holds two copies)."""
    d = cfg.d_model
    s = cfg.ssm
    d_in, H, N, P = _dims(cfg)
    conv_ch = d_in + 2 * N
    dt = L.dtype_of(cfg.param_dtype)
    Ls = (n_layers,)

    def normal(shape, std):
        x = torch.randn(Ls + shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dt)

    def full(shape, value, dtype):
        return torch.full(Ls + shape, value, dtype=dtype, device=device)

    return {
        "norm": {"scale": full((d,), 1.0, dt)},
        "in_proj": normal((d, 2 * d_in + 2 * N + H), d ** -0.5),
        "conv_w": normal((s.conv_width, conv_ch), s.conv_width ** -0.5),
        "conv_b": full((conv_ch,), 0.0, dt),
        "A_log": full((H,), 0.0, torch.float32),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "gate_norm": {"scale": full((d_in,), 1.0, dt)},
        "out_proj": normal((d_in, d), d_in ** -0.5),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> dict:
    """Random weights with the reference's shapes, scales and stacked
    layout, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (not ``jax.random``'s numbers; parity tests bridge the
    reference's own weights)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg.param_dtype)
    return {
        "embed": L.init_embedding(cfg, gen, device),
        "blocks": init_ssm_block(cfg, gen, device, cfg.n_layers),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
    }


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill, plain version)
# ---------------------------------------------------------------------------

def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad dim 1 (the sequence) at the end."""
    widths = [0, 0] * (t.dim() - 2) + [0, pad]
    return F.pad(t, widths)


def _state_scan(a_cum, dtc, Bc, xc):
    """The state before each chunk and after the last: [h_0 = 0, h_1, ...,
    h_nc], from the chunk states S_c = Σ_k exp(acum_last - acum_k)·dt_k·
    B_k⊗x_k and h_{c+1} = exp(acum_last)·h_c + S_c.  Chunked inputs:
    a_cum/dtc (b,nc,Q,H), Bc (b,nc,Q,N), xc (b,nc,Q,H,P)."""
    decay_last = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (b,c,Q,H)
    states = torch.einsum("bckh,bckn,bckhp->bchnp", decay_last * dtc, Bc, xc)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (b,c,H)
    b, nc, _, H, P = xc.shape
    h = torch.zeros((b, H, Bc.shape[-1], P), dtype=xc.dtype, device=xc.device)
    hs = [h]
    for c in range(nc):
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
        hs.append(h)
    return hs


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """x: (b,s,H,P), dt: (b,s,H), A: (H,) negative, B/C: (b,s,N).

    Returns y: (b,s,H,P).  Sequences not divisible by ``chunk`` are padded
    with dt=0 positions (zero contribution, unit decay) and sliced back.
    """
    b, s, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, s)
    s_orig = s
    if s % Q:
        pad = Q - s % Q
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
        s = s + pad
    nc = s // Q
    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, N)
    Cc = C.reshape(b, nc, Q, N)

    a_cum = torch.cumsum(dtc * A, dim=2)  # (b,nc,Q,H)

    # intra-chunk: Y[q] = Σ_{k<=q} (C_q·B_k)·exp(acum_q - acum_k)·dt_k·x_k;
    # the mask selects, so the inf of exp(k > q) never reaches the sum
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    decay = torch.exp(a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :])
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    M = scores[..., None] * torch.where(tril[None, None, :, :, None], decay,
                                        0.0)  # (b,c,q,k,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M * dtc[:, :, None], xc)

    # inter-chunk recurrence over chunk states: h_prev of every chunk
    h_prevs = torch.stack(_state_scan(a_cum, dtc, Bc, xc)[:-1], dim=1)

    # inter-chunk contribution: Y[q] += (C_q · h_prev) · exp(acum_q)
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, h_prevs) \
        * torch.exp(a_cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, H, P)[:, :s_orig]


def _causal_conv(xBC, w, bias):
    """Depthwise causal conv1d.  xBC: (b,s,ch), w: (width,ch)."""
    width = w.shape[0]
    pad = F.pad(xBC, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i:i + xBC.shape[1], :] * w[i]
    return out + bias


def _final_state(x, dt, A, B, chunk: int):
    """The recurrent state after the whole sequence, by the chunked
    algorithm (plain torch on both backends, as in the reference)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, s)
    if s % Q:  # dt=0 padding: no contribution, unit decay
        pad = Q - s % Q
        x, dt, B = (_pad_seq(t, pad) for t in (x, dt, B))
        s = s + pad
    nc = s // Q
    xc = x.reshape(b, nc, Q, H, P)
    dtc = dt.reshape(b, nc, Q, H)
    Bc = B.reshape(b, nc, Q, N)
    return _state_scan(torch.cumsum(dtc * A, dim=2), dtc, Bc, xc)[-1]


def ssm_block(params, u, cfg: ModelConfig, collect_cache: bool = False,
              lowering: Optional[LoweringConfig] = None):
    """Full-sequence SSD block.  u: (b,s,d).  Returns (out, cache|None)."""
    lw = lowering or _DEFAULT_LOWERING
    s_cfg = cfg.ssm
    d_in, H, N, P = _dims(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x_res = u
    u = L.rmsnorm(params["norm"], u, cfg.norm_eps, lowering=lw).to(cd)
    proj = u @ params["in_proj"].to(cd)  # (b,s,2*d_in+2N+H)
    z, xBC, dt_raw = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"].to(cd),
                              params["conv_b"].to(cd)))
    x, B, C = torch.split(xBC, [d_in, N, N], dim=-1)
    b, s, _ = x.shape
    xh = x.reshape(b, s, H, P).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    Bf, Cf = B.float(), C.float()
    rec = lw.lower("ssd_scan", (b, s, H, P, N), torch.float32)
    if rec.impl == "isax":
        # kernel layout is (b, H, s, P) / (b, H, s); transpose in and out
        y = kops.ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), A, Bf,
                          Cf).transpose(1, 2)
    else:
        y = ssd_chunked(xh, dt, A, Bf, Cf, s_cfg.chunk)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(b, s, d_in).to(cd)
    y = L.rmsnorm(params["gate_norm"], y * F.silu(z), cfg.norm_eps,
                  lowering=lw)
    out = x_res + (y @ params["out_proj"].to(cd)).to(x_res.dtype)

    cache = None
    if collect_cache:
        # final recurrent state + pre-conv tail for decode continuation
        width = s_cfg.conv_width
        tail = proj[:, -(width - 1):, d_in:2 * d_in + 2 * N]
        if tail.shape[1] < width - 1:  # prompt shorter than the conv window
            tail = F.pad(tail, (0, 0, width - 1 - tail.shape[1], 0))
        cache = {"conv": tail,
                 "state": _final_state(xh, dt, A, Bf, s_cfg.chunk)}
    return out, cache


def ssm_block_decode(params, u, cfg: ModelConfig, cache,
                     lowering: Optional[LoweringConfig] = None):
    """O(1) recurrent step (plain torch: the reference gives it no kernel).

    u: (b,1,d); cache: {'conv': (b,w-1,ch), 'state': (b,H,N,P)}, both
    updated in place.  Returns (out, cache).
    """
    lw = lowering or _DEFAULT_LOWERING
    d_in, H, N, P = _dims(cfg)
    cd = L.dtype_of(cfg.compute_dtype)
    x_res = u
    u = L.rmsnorm(params["norm"], u, cfg.norm_eps, lowering=lw).to(cd)
    proj = (u @ params["in_proj"].to(cd))[:, 0]  # (b, 2d_in+2N+H)
    z, xBC_new, dt_raw = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    conv_hist = torch.cat([cache["conv"].to(cd), xBC_new[:, None, :]],
                          dim=1)  # (b,w,ch)
    w = params["conv_w"].to(cd)
    xBC = F.silu(torch.einsum("bwc,wc->bc", conv_hist, w)
                 + params["conv_b"].to(cd))
    x, B, C = torch.split(xBC, [d_in, N, N], dim=-1)
    xh = x.reshape(-1, H, P).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)  # (b,H)
    state = (decay[:, :, None, None] * cache["state"]
             + torch.einsum("bh,bn,bhp->bhnp", dt, B.float(), xh))
    y = torch.einsum("bn,bhnp->bhp", C.float(), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(-1, 1, d_in).to(cd)
    y = L.rmsnorm(params["gate_norm"], y * F.silu(z[:, None, :]),
                  cfg.norm_eps, lowering=lw)
    out = x_res + (y @ params["out_proj"].to(cd)).to(x_res.dtype)
    cache["conv"].copy_(conv_hist[:, 1:, :])
    cache["state"].copy_(state)
    return out, cache


# ---------------------------------------------------------------------------
# Full model (pure SSM stack)
# ---------------------------------------------------------------------------

def _logits(params, h, cfg: ModelConfig, lowering):
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, lowering=lowering)
    return L.unembed(params["embed"]["table"], h, cfg)[:, 0]


def prefill(params, batch, cfg: ModelConfig, pad_to=None,
            lowering: Optional[LoweringConfig] = None):
    """Returns (last-position logits (B, vocab), caches).  ``pad_to`` is
    accepted for the uniform model API and ignored: the state carries the
    history, so nothing is sized by the sequence."""
    del pad_to
    h = L.embed(params["embed"], batch["tokens"], cfg)
    convs, states = [], []
    for i in range(cfg.n_layers):
        h, cache = ssm_block(layer_params(params["blocks"], i), h, cfg,
                             collect_cache=True, lowering=lowering)
        convs.append(cache["conv"])
        states.append(cache["state"])
    caches = {"conv": torch.stack(convs), "state": torch.stack(states)}
    return _logits(params, h[:, -1:, :], cfg, lowering), caches


def decode_step(params, token, caches, pos, cfg: ModelConfig,
                lowering: Optional[LoweringConfig] = None):
    """One-token decode.  token: (B,) int; caches updated in place (SSM
    decode is position-free: ``pos`` is ignored).  Returns (logits, caches)."""
    del pos
    h = L.embed(params["embed"], token[:, None], cfg)
    for i in range(cfg.n_layers):
        h, _ = ssm_block_decode(
            layer_params(params["blocks"], i), h, cfg,
            {"conv": caches["conv"][i], "state": caches["state"][i]},
            lowering=lowering)
    return _logits(params, h, cfg, lowering), caches
