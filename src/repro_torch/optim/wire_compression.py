"""Wire-level int8 gradient synchronization over the data-parallel process
group; the port of ``repro/optim/wire_compression.py``.

``adamw.compress_int8`` models error-feedback quantization numerically,
but a DTensor gradient reduction sends fp32: 4 bytes an element.  This
module is the real thing for data-parallel training, a train step whose
gradient reduction is

    1. error-feedback int8 quantization (one scale for the flat gradient,
       its max all-reduced),
    2. reduce-scatter as ``all_to_all_single`` of the int8 payload,
    3. local fp32 summation of the received chunks,
    4. the reduced chunk requantized and ``all_gather``ed as int8.

Wire bytes a rank ≈ 2·S/4 against an fp32 ring all-reduce's 2·S.  Rounding
is half to even on both sides (``torch.round``, as ``jnp.round``).  Where
the reference's step runs under ``shard_map``, here every rank calls it on
its own batch shard, with explicit collectives on the mesh's DP group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import layers as L
from repro_torch.optim.adamw import AdamWConfig, apply_updates
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import tree_leaves, tree_unflatten


def _flatten_grads(grads):
    """(one fp32 vector of every leaf, keys sorted; the shapes)."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).float() for g in leaves])
    return flat, [g.shape for g in leaves]


def _unflatten_grads(flat, shapes, like):
    """The tree of ``like``'s structure from ``flat`` (keys sorted)."""
    sizes = [s.numel() for s in shapes]
    parts = torch.split(flat, sizes)
    return tree_unflatten(like, [p.reshape(s) for p, s in zip(parts,
                                                             shapes)])


def dp_group(mesh, dp_axes: tuple[str, ...]):
    """The process group over the mesh dims ``dp_axes`` (flattened into one
    when there are several)."""
    if len(dp_axes) == 1:
        return mesh.get_group(dp_axes[0])
    return mesh[tuple(dp_axes)]._flatten().get_group()


def int8_wire_allreduce(flat: torch.Tensor, err: torch.Tensor,
                        group) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``flat`` (1-D fp32, the same length on every rank) over
    ``group`` with an int8 wire payload.  Returns (mean, new_err)."""
    n = dist.get_world_size(group)
    gf = flat + err
    amax = torch.max(torch.abs(gf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale1 = torch.clamp(amax / 127.0, min=1e-12)
    q1 = torch.clamp(torch.round(gf / scale1), -127, 127).to(torch.int8)
    new_err = gf - q1.float() * scale1

    pad = (-q1.shape[0]) % n
    q1p = torch.nn.functional.pad(q1, (0, pad))
    chunk = q1p.shape[0] // n
    # reduce-scatter: int8 chunks all-to-all, summed locally in fp32
    recv = torch.empty_like(q1p)
    dist.all_to_all_single(recv, q1p, group=group)
    local_sum = torch.sum(recv.reshape(n, chunk).float(), dim=0)
    local_mean = local_sum * (scale1 / n)
    # requantize the reduced chunk and all-gather it (int8 again)
    amax2 = torch.max(torch.abs(local_mean))
    dist.all_reduce(amax2, op=dist.ReduceOp.MAX, group=group)
    scale2 = torch.clamp(amax2 / 127.0, min=1e-12)
    q2 = torch.clamp(torch.round(local_mean / scale2), -127,
                     127).to(torch.int8)
    gathered = torch.empty(n * chunk, dtype=torch.int8, device=q2.device)
    dist.all_gather_into_tensor(gathered, q2, group=group)
    mean = gathered.float() * scale2
    return mean[:flat.shape[0]], new_err


def make_int8_wire_train_step(model, opt_cfg: AdamWConfig, mesh,
                              dp_axes: tuple[str, ...]):
    """Data-parallel (replicated params) train step with an int8 gradient
    wire: ``step(params, opt_state, err_flat, batch)`` on every rank of
    ``mesh``, ``batch`` this rank's shard of the batch (or a DTensor
    sharded over ``dp_axes``, whose shard is taken), params and state
    replicated plain tensors updated in place.  Returns (params,
    opt_state, new_err, metrics) with ``metrics["loss"]`` the DP mean."""
    group = dp_group(mesh, dp_axes)

    def step(params, opt_state, err_flat, batch):
        batch = {k: v.to_local() if L.is_dtensor(v) else v
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(model, params, batch)
        loss = loss.float().clone()
        dist.all_reduce(loss, group=group)
        loss = loss / dist.get_world_size(group)
        flat, shapes = _flatten_grads(grads)
        mean_flat, new_err = int8_wire_allreduce(flat, err_flat, group)
        grads = _unflatten_grads(mean_flat, shapes, grads)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, new_err, metrics

    return step


def init_err_state(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    n = sum(p.numel() for p in leaves)
    return torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
