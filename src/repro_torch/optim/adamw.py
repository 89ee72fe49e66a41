"""AdamW with global-norm clipping and optional int8 error-feedback gradient
compression, the port of ``repro/optim/adamw.py``.

The state tree is the reference's — ``{"step": int32 0-d, "m": …, "v": …}``
plus ``"err"`` when compressing — so checkpoints move between the two
packages.  ``state_dtype="bfloat16"`` keeps the moments in bf16 (the big
MoEs).  Update arithmetic is fp32, cast back to each leaf's dtype.

Where the reference returns new arrays (and its jit donates the old ones),
``apply_updates`` writes params, moments and error feedback in place and
returns the same tensors; the update and the global norm run a leaf at a
time in flat slices of ``CHUNK`` elements, so no step holds an fp32 copy
of a whole leaf (params, moments and error feedback must be contiguous).

DTensor leaves (a sharded model): the state takes each param's
placements; a gradient is first redistributed to its param's placements
(the FSDP reduce-scatter of a partial sum); the update is elementwise, so
it runs on the local shards, in the same ``CHUNK`` slices; the global
norm sums each shard's squares and reduces over the mesh dims that shard
the leaf only, so a replicated copy is counted once; the int8
compression's per-tensor scale is the max over the shards.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map

#: Elements a slice of one leaf's update (its fp32 temporaries' size).
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # 'bfloat16' for the big MoEs
    compress_grads: bool = False      # int8 error-feedback compression


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def init_state(params, cfg: AdamWConfig) -> dict:
    dt = _state_dtype(cfg)
    device = tree_leaves(params)[0].device

    def zeros(p):  # a DTensor param's state takes its placements
        return torch.zeros_like(p, dtype=dt)

    state = {"step": torch.zeros((), dtype=torch.int32, device=device),
             "m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    if cfg.compress_grads:
        state["err"] = tree_map(zeros, params)
    return state


def _local(x):
    return x.to_local() if L.is_dtensor(x) else x


def _over_shards(value: torch.Tensor, like, op: str = "sum"):
    """``value``, a local reduction of DTensor ``like``'s shard, reduced
    over the mesh dims that shard ``like`` (``op`` "sum" or "max");
    returns a plain tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial(op) if p.is_shard() else Replicate()
          for p in like.placements]
    if all(p == Replicate() for p in pl):
        return value
    return DTensor.from_local(value, like.device_mesh, pl,
                              run_check=False).full_tensor()


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf, a flat slice of
    CHUNK elements at a time; DTensor leaves sum their shards, reduced
    over the mesh dims that shard them (one reduction for all the leaves
    placed alike)."""
    total = 0
    parts: dict = {}
    for x in tree_leaves(tree):
        flat = _local(x).reshape(-1)
        s = 0
        for i in range(0, flat.numel(), CHUNK):
            s = s + torch.sum(torch.square(flat[i:i + CHUNK].float()))
        if L.is_dtensor(x):
            key = (x.device_mesh, tuple(x.placements))
            parts[key] = (parts[key][0] + s, x) if key in parts else (s, x)
        else:
            total = total + s
    for s, like in parts.values():
        total = total + _over_shards(torch.as_tensor(s), like)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def compress_int8(g, err):
    """Error-feedback int8 quantization: returns (dequantized g, new err).

    q = round(clip((g + err) / s)) with one scale s a tensor, rounded half
    to even (``torch.round``, as ``jnp.round``); the residual g + err −
    deq(q) feeds back into the next step.  The dequantized value continues
    through the update, so the numerics are those of the wire version.
    """
    if L.is_dtensor(err):  # the scale is the max over every shard
        gf = _local(g).float() + _local(err).float()
        amax = _over_shards(torch.max(torch.abs(gf)), err, "max")
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq, (gf - deq).to(err.dtype)
    gf = g.float() + err.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, (gf - deq).to(err.dtype)


def _placed_like(g, p):
    """Gradient ``g`` with its param's placements (a partial sum
    reduced); a plain one as it is."""
    if L.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig,
                  lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step: params, ``m``, ``v`` (and ``err``) updated in place.
    Returns (params, new state, {"grad_norm": 0-d fp32})."""
    step = state["step"] + 1
    grads = tree_map(_placed_like, grads, params)
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    def update(p, g, m, v, err=None):
        if err is not None:
            g, new_err = compress_int8(_local(g).float() * clip, err)
            _local(err).copy_(new_err)
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        p1, g1, m1, v1 = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for i in range(0, p1.numel(), CHUNK):
            ps, ms, vs = p1[i:i + CHUNK], m1[i:i + CHUNK], v1[i:i + CHUNK]
            gs = g1[i:i + CHUNK].float()
            if err is None:
                gs = gs * clip
            m2 = b1 * ms.float() + (1 - b1) * gs
            v2 = b2 * vs.float() + (1 - b2) * gs * gs
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps) \
                + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * delta)
            ms.copy_(m2)
            vs.copy_(v2)

    errs = state["err"] if cfg.compress_grads else None
    tree_map(update, params, grads, state["m"], state["v"],
             *((errs,) if errs is not None else ()))
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if errs is not None:
        new_state["err"] = errs
    return params, new_state, {"grad_norm": gnorm}
