"""GPipe-style pipeline parallelism over a mesh axis; the port of
``repro/sharding/pipeline.py``.

Layer stacks are split into S stages laid out along a mesh axis;
microbatches circulate stage to stage in the classic GPipe schedule
(S + M − 1 ticks, bubble fraction (S−1)/(S+M−1)): stage 0 injects
microbatch t at tick t, the last stage emits microbatch t − (S−1), and a
ring permute along the stage axis carries each stage's output to the next.
Only the last stage holds the outputs; a masked sum over the stage axis
replicates them.

The reference's ``shard_map`` + ``ppermute`` + ``psum`` are written out by
hand: the permute is ``_RingPermute`` (send to the next stage, receive from
the previous one; its backward the reverse permute), the final sum an
all-reduce whose backward is the identity (its result is replicated over
the stage axis, so each rank's gradient is already the whole one).  So the
same function trains.  ``torch.distributed.pipelining`` runs its own
schedules over ``nn.Module`` stages; it is not this function.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class _RingPermute(torch.autograd.Function):
    """x to the next rank of ``group``'s ring, the previous rank's x back."""

    @staticmethod
    def forward(ctx, x, group, shift: int):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g.contiguous(), ctx.group, -ctx.shift), None, None


def _permute(x, group, shift: int):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    peer = dist.get_global_rank
    ops = [dist.P2POp(dist.isend, x, peer(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, out, peer(group, (me - shift) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def gpipe(stage_fn: Callable, mesh, stage_axis: str = "model",
          data_axes: tuple[str, ...] = ("data",)):
    """Returns ``pipelined(params_stacked, x_microbatches)``.

    params_stacked : tree with leading dim L = n_stages × layers a stage,
                     sharded over ``stage_axis`` on that dim
    x_microbatches : (n_micro, micro_batch, seq, d), the microbatch dim
                     sharded over ``data_axes``

    Both may be DTensors (redistributed to those placements; the result is
    a DTensor replicated over ``stage_axis``, sharded over ``data_axes``
    on dim 1) or this rank's local shards (the result is then local).
    Output: (n_micro, micro_batch, seq, d) after every stage, in order.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    n_stages = mesh.shape[names.index(stage_axis)]
    group = mesh.get_group(stage_axis)
    p_pl = [Shard(0) if n == stage_axis else Replicate() for n in names]
    x_pl = [Shard(1) if n in data_axes else Replicate() for n in names]

    def run(params_local, x_local):
        stage = dist.get_rank(group)
        n_micro = x_local.shape[0]
        state = torch.zeros_like(x_local[0])
        first = torch.tensor(stage == 0, device=x_local.device)
        outputs = []
        for t in range(n_micro + n_stages - 1):
            # a select, not a branch: every stage keeps the permuted state
            # in its graph, so the reverse permutes pair up in backward
            inp = torch.where(first, x_local[min(t, n_micro - 1)], state)
            out = stage_fn(params_local, inp)
            if t >= n_stages - 1:  # the last stage emits t − (S−1)
                outputs.append(out)
            # circulate: stage i → i+1 (the last wraps; its value unused)
            state = _RingPermute.apply(out, group, 1)
        outputs = torch.stack(outputs)
        is_last = float(stage == n_stages - 1)
        return L._SumOverGroup.apply(outputs * is_last, group)

    def pipelined(params_stacked, x_micro):
        if not L.is_dtensor(x_micro):
            return run(params_stacked, x_micro)
        flat = tree_leaves(params_stacked)

        def local(x, *leaves):
            return run(tree_unflatten(params_stacked, leaves), x)

        return L._on_shards(local, (x_micro, *flat),
                            (x_pl,) + (p_pl,) * len(flat), x_pl)

    return pipelined


def reference_forward(stage_fn, params_stacked, x_micro, n_stages: int):
    """Oracle: every stage in order on each microbatch (no pipelining)."""
    n_layers = tree_leaves(params_stacked)[0].shape[0]
    per = n_layers // n_stages

    def apply_all(x):
        for s in range(n_stages):
            p = tree_map(lambda a: a[s * per:(s + 1) * per], params_stacked)
            x = stage_fn(p, x)
        return x

    return torch.stack([apply_all(x) for x in x_micro])
