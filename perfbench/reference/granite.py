"""Plain fp32 reference of a dense GQA decoder as the granite-3-8b
configuration runs it: pre-norm blocks of RMSNorm → attention (RoPE on
split halves, causal, 1/√hd) → residual → RMSNorm → SwiGLU → residual,
a final RMSNorm, and logits against the (tied) embedding table.

Layer by layer over every sequence, each layer's weights widened to fp32
once; attention in blocks of query rows.  Only the requested positions'
logits are formed; ``kv_at`` gives every position's K and V instead, as
a KV cache would hold them.
"""

from __future__ import annotations

import torch

from . import fake_quant, fp32_matmul, matmul, rmsnorm

QUERY_BLOCK = 1024


def _rope(x, theta: float):
    """x (n, heads, hd) at positions 0..n−1."""
    n, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, quant):
    """Causal GQA attention: q (n,H,hd), k/v (n,K,hd) → (n, H·hd)."""
    n, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.reshape(n, K, G, hd)
    out = torch.empty((n, K, G, hd), dtype=torch.float32, device=q.device)
    for a in range(0, n, QUERY_BLOCK):
        b = min(n, a + QUERY_BLOCK)
        s = torch.einsum("qkgd,tkd->kgqt", fake_quant(qg[a:b], quant),
                         fake_quant(k[:b], quant)) * hd ** -0.5
        live = (torch.arange(b, device=q.device)[None, :]
                <= torch.arange(a, b, device=q.device)[:, None])
        s = torch.where(live, s, float("-inf")).softmax(-1)
        out[a:b] = torch.einsum("kgqt,tkd->qkgd", fake_quant(s, quant),
                                fake_quant(v[:b], quant))
    return out.reshape(n, H * hd)


def _blocks(params: dict, m: dict, seqs, quant, kv=None):
    """The residual stream after every block, for each sequence; where
    ``kv`` is a list, each sequence's per-layer (k after RoPE, v), fp32
    (n, K, hd), are appended to it as two stacks (L, n, K, hd)."""
    L, d, H, K = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd, eps = m.get("head_dim") or d // H, m["norm_eps"]
    b = params["blocks"]
    hs = [params["embed"]["table"][s.long()].float() for s in seqs]
    ks = [[] for _ in seqs]
    vs = [[] for _ in seqs]
    for i in range(L):
        w = {k: b["attn"][k][i].float().reshape(d, -1)
             for k in ("wq", "wk", "wv")}
        wo = b["attn"]["wo"][i].float().reshape(H * hd, d)
        wg = b["mlp"]["wi_gate"][i].float()
        wu = b["mlp"]["wi_up"][i].float()
        wd = b["mlp"]["wo"][i].float()
        for j, h in enumerate(hs):
            n = h.shape[0]
            x = rmsnorm(h, b["attn_norm"]["scale"][i], eps)
            q = _rope(matmul(x, w["wq"], quant).reshape(n, H, hd),
                      m["rope_theta"])
            k = _rope(matmul(x, w["wk"], quant).reshape(n, K, hd),
                      m["rope_theta"])
            v = matmul(x, w["wv"], quant).reshape(n, K, hd)
            if kv is not None:
                ks[j].append(k)
                vs[j].append(v)
            h = h + matmul(_attention(q, k, v, quant), wo, quant)
            x = rmsnorm(h, b["mlp_norm"]["scale"][i], eps)
            g = torch.nn.functional.silu(matmul(x, wg, quant))
            hs[j] = h + matmul(g * matmul(x, wu, quant), wd, quant)
    if kv is not None:
        kv.extend((torch.stack(a), torch.stack(c)) for a, c in zip(ks, vs))
    return hs


def logits_at(params: dict, m: dict, seqs, wanted, quant=None):
    """fp32 logits (len(wanted[i]), vocab) at positions ``wanted[i]`` of
    each token sequence ``seqs[i]`` (1-D int tensors on the weights'
    device)."""
    table = params["embed"]["table"]
    with fp32_matmul(), torch.no_grad():
        hs = _blocks(params, m, seqs, quant)
        unembed = (table if m.get("tie_embeddings")
                   else params["unembed"]["w"]).float()
        out = []
        for h, pos in zip(hs, wanted):
            x = rmsnorm(h[torch.as_tensor(pos, device=h.device)],
                        params["final_norm"]["scale"], m["norm_eps"])
            out.append(matmul(x, unembed.T, quant))
        return out


def kv_at(params: dict, m: dict, seqs, quant=None):
    """fp32 (k, v) stacks (L, n, K, hd) of each sequence, k after RoPE:
    what a KV cache holds for every position of it."""
    kv = []
    with fp32_matmul(), torch.no_grad():
        _blocks(params, m, seqs, quant, kv)
    return kv
