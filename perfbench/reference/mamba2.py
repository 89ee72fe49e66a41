"""Plain fp32 reference of a Mamba-2 stack (arXiv:2405.21060, one group of
B and C) with the SSD recurrence run step by step:

    h_t = exp(dt_t·A) · h_{t−1} + dt_t · B_t ⊗ x_t,   y_t = C_t · h_t + D·x_t

each block: RMSNorm → in_proj → (z, xBC, dt) → depthwise causal conv +
bias → SiLU → (x, B, C) → dt = softplus(dt + dt_bias) → the recurrence →
RMSNorm(y · SiLU(z)) · scale → out_proj → residual; then a final RMSNorm
and logits against the tied embedding table.  Sequences of one length run
together as a batch, layer by layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fp32_matmul, matmul, rmsnorm


def _scan(x, dt, A, B, C):
    """x (b,n,H,P), dt (b,n,H), A (H,), B/C (b,n,N) → y (b,n,H,P)."""
    b, n, H, P = x.shape
    N = B.shape[-1]
    dA = torch.exp(dt * A)
    dtB = dt[..., None] * B[:, :, None, :]               # (b,n,H,N)
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for t in range(n):
        h.mul_(dA[:, t, :, None, None])
        h.addcmul_(dtB[:, t, :, :, None], x[:, t, :, None, :])
        y[:, t] = torch.einsum("bn,bhnp->bhp", C[:, t], h)
    return y


def _block(bp: dict, i: int, h, m: dict, quant):
    d = m["d_model"]
    s = m["ssm"]
    d_in, N, P, w = s["expand"] * d, s["d_state"], s["head_dim"], \
        s["conv_width"]
    H = d_in // P
    b, n, _ = h.shape
    u = rmsnorm(h, bp["norm"]["scale"][i], m["norm_eps"])
    proj = matmul(u, bp["in_proj"][i].float(), quant)
    z, xBC, dt = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    cw = bp["conv_w"][i].float()
    pad = F.pad(xBC, (0, 0, w - 1, 0))
    conv = sum(pad[:, j:j + n] * cw[j] for j in range(w))
    xBC = F.silu(conv + bp["conv_b"][i].float())
    x, B, C = torch.split(xBC, [d_in, N, N], dim=-1)
    x = x.reshape(b, n, H, P)
    dt = F.softplus(dt + bp["dt_bias"][i].float())
    A = -torch.exp(bp["A_log"][i].float())
    y = _scan(x, dt, A, B, C) + bp["D"][i].float()[:, None] * x
    y = rmsnorm(y.reshape(b, n, d_in) * F.silu(z),
                bp["gate_norm"]["scale"][i], m["norm_eps"])
    return h + matmul(y, bp["out_proj"][i].float(), quant)


def logits_at(params: dict, m: dict, seqs, wanted, quant=None):
    """fp32 logits (len(wanted[i]), vocab) at positions ``wanted[i]`` of
    each token sequence ``seqs[i]`` (1-D int tensors on the weights'
    device)."""
    table = params["embed"]["table"]
    groups: dict[int, list[int]] = {}
    for j, s in enumerate(seqs):
        groups.setdefault(int(s.shape[0]), []).append(j)
    out = [None] * len(seqs)
    with fp32_matmul(), torch.no_grad():
        unembed = table.float()
        for idx in groups.values():
            h = table[torch.stack([seqs[j].long() for j in idx])].float()
            for i in range(m["n_layers"]):
                h = _block(params["blocks"], i, h, m, quant)
            for r, j in enumerate(idx):
                x = rmsnorm(h[r, torch.as_tensor(wanted[j], device=h.device)],
                            params["final_norm"]["scale"], m["norm_eps"])
                out[j] = matmul(x, unembed.T, quant)
    return out
