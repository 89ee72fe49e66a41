"""Weights drawn by the benchmark from ``--seed``, on the device, in the
type they are served in, in the param layout the program takes
(``params=``): blocks stacked on a leading layer axis.

All Gaussian leaves come from one ``normal_`` call on one flat buffer,
each leaf a view scaled in place; the norm scales from a second (1 + 0.1
N(0, 1), so that a dropped scale shows).  Mamba-2's A, dt bias and D are
drawn as the Mamba-2 paper initialises them: A = −U(1, 16), dt =
exp(U(ln 1e-3, ln 1e-1)) through the inverse softplus, D = 1, in fp32.
The benchmark hands the same tensors to the program and to the
reference; the program only reads them.
"""

from __future__ import annotations

import math

import torch


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 64))
    return g


def _views(flat: torch.Tensor, specs: dict) -> dict:
    """Carve ``flat`` into leaves ``{path: shape}`` (contiguous views)."""
    out, off = {}, 0
    for path, shape in specs.items():
        n = math.prod(shape)
        out[path] = flat[off:off + n].view(shape)
        off += n
    return out


def _draw(specs_std: dict, specs_norm: dict, dtype, seed: int, device):
    """{path: tensor}: Gaussian leaves with their std, norm scales."""
    g = _gen(seed, device)
    shapes = {p: s for p, (s, _) in specs_std.items()}
    flat = torch.empty(sum(math.prod(s) for s in shapes.values()),
                       dtype=dtype, device=device).normal_(generator=g)
    leaves = _views(flat, shapes)
    for p, (_, std) in specs_std.items():
        leaves[p].mul_(std)
    nflat = torch.empty(sum(math.prod(s) for s in specs_norm.values()),
                        dtype=dtype, device=device).normal_(1.0, 0.1,
                                                            generator=g)
    leaves.update(_views(nflat, specs_norm))
    return leaves, g


def _tree(leaves: dict) -> dict:
    """Nest ``a/b/c`` paths into dicts."""
    tree: dict = {}
    for path, t in leaves.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def dense(m: dict, seed: int, device) -> dict:
    """A dense decoder's weights (tied embeddings when ``tie_embeddings``)."""
    L, d, H, K = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd, ff, V = m.get("head_dim") or d // H, m["d_ff"], m["vocab"]
    std = {
        "embed/table": ((V, d), d ** -0.5),
        "blocks/attn/wq": ((L, d, H, hd), d ** -0.5),
        "blocks/attn/wk": ((L, d, K, hd), d ** -0.5),
        "blocks/attn/wv": ((L, d, K, hd), d ** -0.5),
        "blocks/attn/wo": ((L, H, hd, d), (H * hd) ** -0.5),
        "blocks/mlp/wi_gate": ((L, d, ff), d ** -0.5),
        "blocks/mlp/wi_up": ((L, d, ff), d ** -0.5),
        "blocks/mlp/wo": ((L, ff, d), ff ** -0.5),
    }
    if not m.get("tie_embeddings"):
        std["unembed/w"] = ((V, d), d ** -0.5)
    norm = {"blocks/attn_norm/scale": (L, d), "blocks/mlp_norm/scale": (L, d),
            "final_norm/scale": (d,)}
    leaves, _ = _draw(std, norm, getattr(torch, m["param_dtype"]), seed,
                      device)
    return _tree(leaves)


def ssm(m: dict, seed: int, device) -> dict:
    """A Mamba-2 stack's weights (embeddings tied)."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab"]
    s = m["ssm"]
    d_in = s["expand"] * d
    H, N, w = d_in // s["head_dim"], s["d_state"], s["conv_width"]
    ch = d_in + 2 * N
    std = {
        "embed/table": ((V, d), d ** -0.5),
        "blocks/in_proj": ((L, d, 2 * d_in + 2 * N + H), d ** -0.5),
        "blocks/conv_w": ((L, w, ch), w ** -0.5),
        "blocks/conv_b": ((L, ch), 0.1),
        "blocks/out_proj": ((L, d_in, d), d_in ** -0.5),
    }
    norm = {"blocks/norm/scale": (L, d), "blocks/gate_norm/scale": (L, d_in),
            "final_norm/scale": (d,)}
    leaves, g = _draw(std, norm, getattr(torch, m["param_dtype"]), seed,
                      device)
    u = torch.rand((2, L, H), generator=g, device=device,
                   dtype=torch.float32)
    leaves["blocks/A_log"] = torch.log(1.0 + 15.0 * u[0])
    dt = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
    leaves["blocks/dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    leaves["blocks/D"] = torch.ones((L, H), dtype=torch.float32,
                                    device=device)
    return _tree(leaves)


FAMILIES = {"dense": dense, "ssm": ssm}


def draw(m: dict, seed: int, device) -> dict:
    """The weights of model ``m`` (the configuration's ``port`` block)."""
    return FAMILIES[m["family"]](m, seed, device)
