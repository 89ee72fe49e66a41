"""Perf variants of a dry-run cell: trace a (arch × shape) cell under a named
variant on the fake 256/512-rank mesh and report its roofline terms; the
port of ``repro/launch/perf.py``.

    python -m repro_torch.launch.perf --arch qwen1.5-0.5b --shape train_4k \\
        --variant dp_only

Variants ('+'-separated compositions, e.g. 'dp_only+noremat'):
    baseline      — the fsdp_tp policy
    dp_only       — pure DP (params replicated, batch on both axes)
    fsdp_2d       — params sharded over both mesh axes
    noremat / fullremat / dotsremat — the remat policy
    bf16_logits   — logits and loss in bf16
    moe_grouped   — the MoE grouped (one-hot) dispatch
    flash         — chunked online-softmax attention (backend torch_chunked)
    pp            — GPipe over 'model' (train; layers divisible by 16)
    int8_wire     — DP step with an int8 gradient wire (train)
    int8_decode   — int8 weights dequantized inside the decode step
    int8_kv       — an int8 KV cache, dequantized on read (decode)

Each cell runs under ``launch.dryrun.trace_cell``: a fake process group,
``FakeTensorMode``, rank 0's local ops and collectives recorded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import (_opt_cfg, build_step, fake_dtensor,
                                       trace_cell)
from repro_torch.models import layers as mlayers
from repro_torch.models.registry import get_model, input_specs, param_specs
from repro_torch.optim.adamw import init_state
from repro_torch.sharding.policies import (Sharding, activation_specs,
                                           batch_sharding, cache_shardings,
                                           dp_axes, param_shardings)
from repro_torch.tree import tree_leaves, tree_map


def variant_config(cfg, parts: set):
    if "noremat" in parts:
        cfg = dataclasses.replace(cfg, remat="none")
    if "fullremat" in parts:
        cfg = dataclasses.replace(cfg, remat="full")
    if "dotsremat" in parts:
        cfg = dataclasses.replace(cfg, remat="dots")
    if "bf16_logits" in parts:
        cfg = dataclasses.replace(cfg, logit_dtype="bfloat16")
    if "moe_grouped" in parts and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="grouped"))
    return cfg


def _replicated(mesh, spec):
    return Sharding(mesh, (None,) * spec.ndim)


def _pp_step(cfg, shape, mesh, backend):
    """GPipe over 'model' (16 stages) of the transformer backbone's
    forward, as the reference lowers it."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.pipeline import gpipe
    n_stages = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    B, S = shape.global_batch, shape.seq_len
    n_micro = 16
    lw = LoweringConfig(backend)

    def stage_fn(bp, x):
        mask = mlayers.make_mask("causal", S, device=x.device)
        pos = T._positions(x.shape[0], S, x.device)
        for layer in T.unstack(bp, tree_leaves(bp)[0].shape[0]):
            x = T.block_fwd(cfg, x, layer, mask, pos, lw)[0]
        return x

    pipelined = gpipe(stage_fn, mesh, stage_axis="model",
                      data_axes=("data",))
    bspecs = param_specs(cfg)["blocks"]
    blocks = tree_map(lambda s: fake_dtensor(s, Sharding(
        mesh, ("model",) + (None,) * (s.ndim - 1))), bspecs)
    x = fake_dtensor(
        torch.empty((n_micro, B // n_micro, S, cfg.d_model),
                    dtype=mlayers.dtype_of(cfg.compute_dtype),
                    device="meta"),
        Sharding(mesh, (None, "data", None, None)))

    def fwd(blocks, x):
        with torch.no_grad():
            return pipelined(blocks, x)

    return fwd, (blocks, x)


def _int8_wire_step(cfg, shape, mesh, backend):
    """The DP step with an int8 gradient wire: params, optimizer state and
    error feedback replicated (this rank's plain copies), the batch over
    both axes."""
    from repro_torch.optim.wire_compression import (init_err_state,
                                                    make_int8_wire_train_step)
    model = get_model(cfg, LoweringConfig(backend))
    opt_cfg = _opt_cfg(cfg)
    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype),
                      param_specs(cfg))
    opt_state = init_state(params, opt_cfg)
    err = init_err_state(params)
    specs = input_specs(cfg, shape)["batch"]
    b_shard = batch_sharding(cfg, mesh, specs, "dp_only")
    batch = {k: fake_dtensor(v, b_shard[k]) for k, v in specs.items()}
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():  # the DP group's mesh is built on real
        step = make_int8_wire_train_step(model, opt_cfg, mesh,   # tensors
                                         dp_axes(mesh, "dp_only"))
    return step, (params, opt_state, err, batch)


def _quantized(params, p_shard, mesh):
    """Fake int8 weights (a ≥2-D leaf's ``q`` placed as the weight, a
    replicated fp32 ``scale``); other leaves as they are."""
    def q(spec, sh):
        if spec.ndim >= 2:
            scale = torch.empty((), dtype=torch.float32, device="meta")
            return {"q": fake_dtensor(torch.empty(spec.shape,
                                                  dtype=torch.int8,
                                                  device="meta"), sh),
                    "scale": fake_dtensor(scale, _replicated(mesh, scale))}
        return fake_dtensor(spec, sh)
    return tree_map(q, params, p_shard)


def _dequant(tree):
    if isinstance(tree, dict) and "q" in tree:
        return tree["q"].to(torch.bfloat16) * tree["scale"].to(
            torch.bfloat16)
    if isinstance(tree, dict):
        return {k: _dequant(v) for k, v in tree.items()}
    return tree


def _decode_step(cfg, shape, mesh, policy, backend, parts):
    """int8_decode / int8_kv decode steps."""
    model = get_model(cfg, LoweringConfig(backend))
    specs = input_specs(cfg, shape)
    pspecs = param_specs(cfg)
    p_shard = param_shardings(cfg, mesh, model.param_axes(), pspecs, policy)
    tok = fake_dtensor(specs["token"], batch_sharding(
        cfg, mesh, {"t": specs["token"]}, policy)["t"])
    c_shard = cache_shardings(cfg, mesh, specs["caches"], policy=policy)
    pos = shape.seq_len - 1
    if "int8_decode" in parts:
        qparams = _quantized(pspecs, p_shard, mesh)
        caches = tree_map(fake_dtensor, specs["caches"], c_shard)

        def serve_step(qparams, token, caches, pos):
            with torch.no_grad():
                return model.decode_step(_dequant(qparams), token, caches,
                                         pos)
        return serve_step, (qparams, tok, caches, pos)

    # int8 KV cache: per-(layer, kv-head) scales; dequant on read, requant
    # on write
    params = tree_map(fake_dtensor, pspecs, p_shard)
    cs = specs["caches"]
    Lk, _, _, Kk, _ = cs["k"].shape
    q_caches = {}
    for name, spec in cs.items():
        sh = c_shard[name]
        if name in ("k", "v"):
            spec = torch.empty(spec.shape, dtype=torch.int8, device="meta")
        q_caches[name] = tree_map(fake_dtensor, spec, sh)
    for name in ("k_scale", "v_scale"):
        s = torch.empty((Lk, Kk), dtype=torch.float32, device="meta")
        q_caches[name] = fake_dtensor(s, _replicated(mesh, s))

    def serve_step(params, token, qcaches, pos):
        with torch.no_grad():
            sk = qcaches["k_scale"][:, None, None, :, None]
            sv = qcaches["v_scale"][:, None, None, :, None]
            caches = {k: v for k, v in qcaches.items()
                      if k not in ("k", "v", "k_scale", "v_scale")}
            caches["k"] = qcaches["k"].to(torch.bfloat16) * sk.to(
                torch.bfloat16)
            caches["v"] = qcaches["v"].to(torch.bfloat16) * sv.to(
                torch.bfloat16)
            logits, new = model.decode_step(params, token, caches, pos)
            out = dict(qcaches)
            out["k"] = torch.clamp(torch.round(new["k"].float() / sk),
                                   -127, 127).to(torch.int8)
            out["v"] = torch.clamp(torch.round(new["v"].float() / sv),
                                   -127, 127).to(torch.int8)
            return logits, out
    return serve_step, (params, tok, q_caches, pos)


def build_variant(arch: str, shape_name: str, mesh, variant: str):
    """(cfg, step, inputs) of ``variant`` at a cell; call under
    ``FakeTensorMode`` (``trace_cell`` does)."""
    parts = set(variant.split("+"))
    cfg = variant_config(get_config(arch), parts)
    shape = SHAPES[shape_name]
    policy = next((p for p in ("dp_only", "fsdp_2d") if p in parts),
                  "fsdp_tp")
    backend = "torch_chunked" if "flash" in parts else "torch"
    if shape.kind == "train" and "pp" in parts:
        return (cfg, *_pp_step(cfg, shape, mesh, backend))
    if shape.kind == "train" and "int8_wire" in parts:
        return (cfg, *_int8_wire_step(cfg, shape, mesh, backend))
    if shape.kind == "decode" and ("int8_decode" in parts or (
            "int8_kv" in parts and cfg.family in ("dense", "moe", "vlm"))):
        mlayers.set_activation_shardings(
            activation_specs(cfg, mesh, shape.global_batch, policy))
        return (cfg, *_decode_step(cfg, shape, mesh, policy, backend,
                                   parts))
    return (cfg, *build_step(cfg, shape, mesh, policy, backend))


def run_variant(arch: str, shape_name: str, variant: str,
                out_dir: str = "runs/perf_torch",
                multi_pod: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = f"{arch}__{shape_name}__{mesh_name}__{variant}"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "variant": variant, "ok": False}
    t0 = time.time()
    try:
        rec.update(trace_cell(
            get_config(arch), SHAPES[shape_name], multi_pod,
            make_step=lambda c, s, m, p: build_variant(arch, shape_name,
                                                       m, variant),
            peak=False))
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-3000:]
    rec["total_s"] = time.time() - t0
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="runs/perf_torch")
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, args.variant, args.out,
                      args.multi_pod)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({k: rec.get(k) for k in ("arch", "shape", "variant",
                                              "ok", "error")}, indent=1))
    rl = rec.get("roofline", {})
    if rl:
        print(f"compute={rl['compute_s']:.4f}s memory={rl['memory_s']:.4f}s "
              f"collective={rl['collective_s']:.4f}s "
              f"bottleneck={rl['bottleneck']}")
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
