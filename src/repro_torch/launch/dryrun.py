"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on a
256- or 512-rank mesh with no memory and no card; the port of
``repro/launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes

The reference forces 512 host devices and lowers and compiles each cell
with XLA.  Here each cell runs its step once under a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 or 512 ranks and
``FakeTensorMode``: weights, optimizer state, batch and caches are fake
DTensors placed by ``sharding/policies.py``, the model is bound to backend
``torch`` (the counterpart of the reference's ``xla``; no kernel runs on
fake tensors), and rank 0's local ops and collectives are what a device
would run.  The record keeps the reference's keys:

* ``collectives`` (``roofline.analysis.CostRecorder``: each collective as
  DTensor issues it, wire bytes by the reference's formulas);
* ``cost.flops`` and ``cost["bytes accessed"]``: a device's, counted on its
  local ops (FLOPs by ``torch.utils.flop_counter``'s formulas, bytes as the
  inputs and outputs of every op that is not a view: no fusion);
* ``memory.argument_size_in_bytes``: the local shard bytes of the step's
  inputs on a device; ``memory.peak_bytes`` from ``MemTracker`` or
  ``{"error": ...}`` where it cannot run;
* ``roofline`` at the ``H100`` peaks (``roofline.peaks`` names them);
* ``lower_s`` (the traced step) and ``total_s``.

The fake process group belongs to this module: importing ``launch/mesh.py``
or ``sharding/*`` starts none.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as mlayers
from repro_torch.models.registry import get_model, input_specs, param_specs
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.roofline.analysis import H100, CostRecorder, roofline
from repro_torch.sharding.policies import (Sharding, activation_specs,
                                           batch_sharding, cache_shardings,
                                           param_shardings)
from repro_torch.train.trainer import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

BACKENDS = ("torch", "torch_chunked")


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (an
    existing group of another size is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)


def local_shape(shape, mesh, placements) -> tuple:
    """A shard's shape (every spec the policies give divides evenly)."""
    out = list(shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.shape[j]
    return tuple(out)


def fake_dtensor(spec: torch.Tensor, sharding: Sharding):
    """A DTensor of ``spec``'s shape and dtype placed by ``sharding``, its
    shard an empty tensor (a fake one under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    mesh, pl = sharding.mesh, sharding.placements
    local = torch.empty(local_shape(spec.shape, mesh, pl), dtype=spec.dtype)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=spec.shape,
                              stride=torch.empty(spec.shape,
                                                 device="meta").stride())


def _opt_cfg(cfg) -> AdamWConfig:
    big = cfg.n_params() > 50e9
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def select_policy(cfg, mesh, kind: str, long_context: bool = False) -> str:
    """Arch/phase-aware sharding policy, the reference's rule: ``serve`` at
    decode (2-D contraction-dim weights) but for encdec, hybrid and long
    context; ``fsdp_tp_hd`` for training where q-heads divide the model
    axis and kv-heads do not; ``fsdp_tp`` otherwise."""
    model_size = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    if (kind == "decode" and cfg.family not in ("encdec", "hybrid")
            and not long_context):
        return "serve"
    if (kind == "train" and cfg.n_heads and cfg.n_kv_heads
            and cfg.n_heads % model_size == 0
            and cfg.n_kv_heads % model_size != 0):
        return "fsdp_tp_hd"
    return "fsdp_tp"


def build_step(cfg, shape, mesh, policy: str, backend: str = "torch",
               act_sharding: bool = True):
    """(step, inputs) of a cell: ``step(*inputs)`` runs the train step
    (loss, gradients, AdamW), the prefill or the decode step on fake
    DTensors.  Call under ``FakeTensorMode``; the activation specs stay set
    until ``mlayers.set_activation_shardings(None)``."""
    model = get_model(cfg, LoweringConfig(backend))
    specs = input_specs(cfg, shape)
    pspecs = param_specs(cfg)
    p_shard = param_shardings(cfg, mesh, model.param_axes(), pspecs, policy)
    params = tree_map(fake_dtensor, pspecs, p_shard)
    mlayers.set_activation_shardings(
        activation_specs(cfg, mesh, shape.global_batch, policy)
        if act_sharding else None)

    if shape.kind in ("train", "prefill"):
        b_shard = batch_sharding(cfg, mesh, specs["batch"], policy)
        batch = {k: fake_dtensor(v, b_shard[k])
                 for k, v in specs["batch"].items()}
    if shape.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        opt_state = init_state(params, opt_cfg)
        tc = TrainConfig(total_steps=10_000, warmup=100, optimizer=opt_cfg)
        return make_train_step(model, opt_cfg, tc), (params, opt_state, batch)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch)
        return prefill_fn, (params, batch)

    tok = fake_dtensor(specs["token"], batch_sharding(
        cfg, mesh, {"t": specs["token"]}, policy)["t"])
    caches = tree_map(fake_dtensor, specs["caches"],
                      cache_shardings(cfg, mesh, specs["caches"],
                                      policy=policy))

    def serve_step(params, token, caches, pos):
        with torch.no_grad():
            return model.decode_step(params, token, caches, pos)

    # the reference's pos is a traced int32 scalar; here a host int (the
    # decode writes its caches at a position the host knows)
    return serve_step, (params, tok, caches, shape.seq_len - 1)


def argument_bytes(inputs) -> int:
    """Bytes a device holds of the step's inputs: the local shard of every
    DTensor leaf, a plain tensor whole; a host int as int32, as the
    reference's traced ``pos``."""
    total = 0
    for leaf in tree_leaves(_as_tree(inputs)):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if mlayers.is_dtensor(leaf) else leaf
            total += t.numel() * t.element_size()
        elif isinstance(leaf, int):
            total += 4
    return total


def _as_tree(x):
    if isinstance(x, (list, tuple)):
        return {f"{i:03d}": _as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return x


def _model_flops(cfg, shape) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _peak_bytes(step, inputs) -> dict:
    """A device's peak tracked by ``MemTracker`` over one more run of the
    step, or the error that stopped it."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        with mt:
            step(*inputs)
        snap = mt.get_tracker_snapshot("peak")
        dev = max(snap, key=lambda d: snap[d].get("Total", 0))
        return {"peak_bytes": int(snap[dev]["Total"])}
    except Exception as e:  # MemTracker is a private tool; keep the cell
        return {"error": f"{type(e).__name__}: {e}"[:500]}


def trace_cell(cfg, shape, multi_pod: bool, policy=None, backend="torch",
               act_sharding: bool = True, make_step=None,
               peak: bool = True) -> dict:
    """Run one cell's step on fake DTensors; returns the record's
    measured keys (memory, cost, collectives, roofline, lower_s).
    ``make_step(cfg, shape, mesh, policy)`` replaces ``build_step`` (the
    perf variants); it returns (cfg, step, inputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    n_chips = 512 if multi_pod else 256
    start_fake_group(n_chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    policy = policy or select_policy(cfg, mesh, shape.kind,
                                     long_context=shape.name == "long_500k")
    rec = {"policy": policy}
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            if make_step is None:
                step, inputs = build_step(cfg, shape, mesh, policy, backend,
                                          act_sharding)
            else:
                cfg, step, inputs = make_step(cfg, shape, mesh, policy)
            rec["memory"] = {"argument_size_in_bytes":
                             argument_bytes(inputs)}
            with CostRecorder() as cost:
                step(*inputs)
            rec["lower_s"] = time.time() - t0
            if peak:
                rec["memory"].update(_peak_bytes(step, inputs))
    finally:
        mlayers.set_activation_shardings(None)
    coll = cost.stats()
    rec["cost"] = {"flops": float(cost.flops),
                   "bytes accessed": float(cost.bytes)}
    rec["collectives"] = {"counts": coll.counts, "in_loop":
                          coll.in_loop_counts,
                          "result_bytes": coll.result_bytes,
                          "wire_bytes_per_chip": coll.wire_bytes_per_chip}
    kind = "bf16" if cfg.compute_dtype != "float32" else "fp32"
    rl = roofline(cost.flops * n_chips, cost.bytes * n_chips,
                  coll.wire_bytes_per_chip, n_chips,
                  model_flops=_model_flops(cfg, shape), peaks=H100,
                  kind=kind)
    rec["roofline"] = {**rl.row(), "peaks": H100.name, "flop_kind": kind}
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             skip_existing: bool = True, backend: str = "torch",
             peak: bool = True) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    out_path = os.path.join(out_dir, cell_id + ".json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": 512 if multi_pod else 256, "backend": backend,
           "ok": False}
    t0 = time.time()
    try:
        rec.update(trace_cell(get_config(arch), SHAPES[shape_name],
                              multi_pod, backend=backend, peak=peak))
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = time.time() - t0
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--attn-impl", default="torch", choices=BACKENDS,
                    help="torch_chunked = online-softmax chunked attention")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_fail = 0
    for mp in meshes:  # one fake group a mesh size
        for arch in archs:
            cfg = get_config(arch)
            shapes = ([s.name for s in applicable_shapes(cfg)]
                      if args.shape == "all" else [args.shape])
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mp, args.out,
                               skip_existing=not args.force,
                               backend=args.attn_impl)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                rl = rec.get("roofline", {})
                print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {arch} "
                      f"{shape_name} {'2x16x16' if mp else '16x16'} "
                      f"traced={rec.get('lower_s', 0):.1f}s "
                      f"bottleneck={rl.get('bottleneck', '-')}"
                      + ("" if rec["ok"] else
                         f"  err={rec.get('error', '')[:120]}"),
                      flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
