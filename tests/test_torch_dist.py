"""The port's distribution on real ranks: four gloo processes on the CPU,
held to the reference run with ``Auto`` mesh axes in its own process.

One group of four ranks (``init_method="file://..."``, no TCP port) runs
every check of the module once, beside one reference process with eight
forced host devices; both write their results to a temporary directory
and the tests compare them:

* GPipe (``sharding/pipeline.py``) on the reference script's sizes (4
  stages × 2 layers, D 16, 6 microbatches of 4 × 8) over a (1, 4) mesh:
  forward within 1e-5 and gradients within 1e-3 of ``reference_forward``
  and of the reference's ``gpipe``;
* ``int8_wire_allreduce`` on 4 ranks against the reference's on 4 host
  devices: the same int8 payloads on the wire (asserted int8), mean and
  ``new_err`` within 1e-6; three ``make_int8_wire_train_step`` steps of
  ``reduced(llama110m)`` against the reference's;
* on a (2, 2) mesh, from the same numpy-drawn params and tokens: the
  ``fsdp_tp`` loss and gradients of ``reduced()`` qwen1.5-0.5b (dense),
  dbrx-132b (moe) and mamba2-2.7b (ssm) and the ``serve`` policy's decode
  step (dbrx's one kv head puts the cache's sequence over 'model')
  against the reference's jitted under its own policies and activation
  specs, at fp32's tolerance; the same against the unsharded port, with
  one AdamW step on the shards;
* two MoE cases past the loss-free 256 tokens, where capacity drops
  pairs: the grouped dispatch with its 512-token group split over the
  batch shards and the sort dispatch, against the unsharded port and the
  reference;
* checkpoints saved on a (2, 2) mesh, by the port from DTensors and by
  the reference from sharded arrays, each loaded onto (4, 1).

The reference's ``jax.make_mesh`` makes ``Explicit`` axes under jax 0.9,
which its ``with mesh:`` code predates; its process wraps ``make_mesh`` to
pass ``Auto`` axes (ROADMAP's queue 3 fault 1).  The forced device count
lives in that process's environment only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
TIMEOUT = 420

COMMON = r"""
import numpy as np
S_, L_, D = 4, 8, 16
N_MICRO, MB, SEQ = 6, 4, 8
N_WIRE = 1003

def gpipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(L_, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(L_, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(N_MICRO, MB, SEQ, D)).astype(np.float32)
    return w, b, x

def wire_inputs():
    rng = np.random.default_rng(1)
    flat = rng.normal(size=(4, N_WIRE)).astype(np.float32)
    err = (rng.normal(size=(4, N_WIRE)) * 0.01).astype(np.float32)
    return flat, err

def train_inputs(shapes, vocab):
    rng = np.random.default_rng(2)
    init = [(rng.normal(size=s) * 0.05).astype(np.float32) for s in shapes]
    tokens = rng.integers(0, vocab, size=(8, 16)).astype(np.int32)
    return init, tokens, np.roll(tokens, -1, axis=1)

# the (2, 2) cases: (name, arch, MoE dispatch or None, B, S, decode too);
# the two MoE cases route more than 256 tokens, so capacity drops pairs,
# the grouped one with its 512-token group split over the batch shards
B22, P0 = 4, 8
SHARDED = [("qwen", "qwen1.5-0.5b", None, B22, 16, True),
           ("dbrx", "dbrx-132b", None, B22, 16, True),
           ("mamba2", "mamba2-2.7b", None, B22, 16, True),
           ("dbrx_grouped512", "dbrx-132b", "grouped", B22, 128, False),
           ("dbrx_sort320", "dbrx-132b", "sort", B22, 80, False)]

def sharded_cfg(cfg, dispatch):
    import dataclasses
    if dispatch is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))

def model_params(named):
    # (path, shape) in sorted-key order -> fp32 leaves: N(0, 0.05), norm
    # scales 1 + N(0, 0.05)
    rng = np.random.default_rng(3)
    out = []
    for name, shape in named:
        a = rng.normal(size=shape) * 0.05
        out.append((a + 1.0 if name.endswith("scale") else a)
                   .astype(np.float32))
    return out

def sharded_tokens(vocab, B, S):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)

def ckpt_inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(16, 32)).astype(np.float32),
            np.arange(32, dtype=np.float32))
"""

ORACLE = COMMON + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
_make_mesh = jax.make_mesh

def _auto(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, **kw)

jax.make_mesh = _auto
from jax.sharding import NamedSharding
from repro.train import checkpoint as jckpt
mesh22 = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
# a checkpoint of arrays sharded on (2, 2), for the ranks to reshard
wc, bc = ckpt_inputs()
jckpt.save(os.path.join(sys.argv[1], "ref_ckpt"), 7, {
    "w": jax.device_put(wc, NamedSharding(mesh22, P("data", "model"))),
    "b": jax.device_put(bc, NamedSharding(mesh22, P("model")))})
from repro.sharding.pipeline import gpipe
from repro.optim.wire_compression import (int8_wire_allreduce,
                                          init_err_state,
                                          make_int8_wire_train_step)
from jax.experimental.shard_map import shard_map
out = {}

w, b, x = gpipe_inputs()
params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
xj = jnp.asarray(x)

def stage_fn(p, h):
    def body(h, lp):
        return jnp.tanh(h @ lp[0] + lp[1]), None
    h, _ = jax.lax.scan(body, h, (p["w"], p["b"]))
    return h

mesh = jax.make_mesh((2, 4), ("data", "model"))
pipelined = gpipe(stage_fn, mesh, stage_axis="model", data_axes=("data",))
with mesh:
    out["gpipe_y"] = np.asarray(jax.jit(pipelined)(params, xj))
    g = jax.grad(lambda p: jnp.sum(jax.jit(pipelined)(p, xj) ** 2))(params)
out["gpipe_gw"], out["gpipe_gb"] = np.asarray(g["w"]), np.asarray(g["b"])

mesh4 = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4])
flat, err = wire_inputs()
f = shard_map(lambda a, e: tuple(t[None] for t in int8_wire_allreduce(
                  a[0], e[0], "data")),
              mesh=mesh4, in_specs=(P("data"), P("data")),
              out_specs=(P("data"), P("data")), check_rep=False)
mean, new_err = f(jnp.asarray(flat), jnp.asarray(err))
out["wire_mean"], out["wire_new_err"] = np.asarray(mean), np.asarray(new_err)

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.models.registry import get_model, param_specs
from repro.optim.adamw import AdamWConfig, init_state
cfg = reduced(get_config("llama110m"))
model = get_model(cfg)
leaves, treedef = jax.tree.flatten(param_specs(cfg))
init, tokens, labels = train_inputs([l.shape for l in leaves], cfg.vocab)
params = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in init])
batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
opt_cfg = AdamWConfig()
opt, errs = init_state(params, opt_cfg), init_err_state(params)
step = jax.jit(make_int8_wire_train_step(model, opt_cfg, mesh4, ("data",)))
losses = []
for _ in range(3):
    params, opt, errs, m = step(params, opt, errs, batch)
    losses.append(float(m["loss"]))
out["train_losses"] = np.array(losses)
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"train_p{i}"] = np.asarray(leaf)

# the (2, 2) cases under the reference's policies and activation specs
import repro.compile as jcompile
from repro.models import layers as jlayers
from repro.sharding import policies as jpol
xla = jcompile.LoweringConfig.from_registry("xla")
for name, arch, dispatch, B, S, decode in SHARDED:
    cfg = sharded_cfg(reduced(get_config(arch)), dispatch)
    model = get_model(cfg, lowering=xla)
    flat, treedef = jax.tree_util.tree_flatten_with_path(param_specs(cfg))
    named = [("/".join(k.key for k in path), l.shape) for path, l in flat]
    params = jax.tree.unflatten(treedef, [jnp.asarray(a)
                                          for a in model_params(named)])
    tokens, labels = sharded_tokens(cfg.vocab, B, S)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    psh = jpol.param_shardings(cfg, mesh22, model.param_axes(), params,
                               "fsdp_tp")
    bsh = jpol.batch_sharding(cfg, mesh22, batch, "fsdp_tp")
    jlayers.set_activation_shardings(jpol.activation_specs(cfg, mesh22, B,
                                                           "fsdp_tp"))
    with mesh22:
        loss, grads = jax.jit(jax.value_and_grad(model.loss),
                              in_shardings=(psh, bsh))(params, batch)
    jlayers.set_activation_shardings(None)
    out[f"{name}_loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"{name}_g{i}"] = np.asarray(g)
    if not decode:
        continue
    tok = jnp.asarray(tokens[:, P0])
    _, caches = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                   pad_to=S))(
        params, jnp.asarray(tokens[:, :P0]))
    psh = jpol.param_shardings(cfg, mesh22, model.param_axes(), params,
                               "serve")
    csh = jpol.cache_shardings(cfg, mesh22, caches, policy="serve")
    tsh = jpol.batch_sharding(cfg, mesh22, {"t": tok}, "serve")["t"]
    jlayers.set_activation_shardings(jpol.activation_specs(cfg, mesh22, B,
                                                           "serve"))
    with mesh22:
        logits, _ = jax.jit(model.decode_step, in_shardings=(
            psh, tsh, csh, NamedSharding(mesh22, P())))(
            params, tok, caches, jnp.asarray(P0, jnp.int32))
    jlayers.set_activation_shardings(None)
    out[f"{name}_logits"] = np.asarray(logits)
np.savez(os.path.join(sys.argv[1], "oracle.npz"), **out)
print("ORACLE_OK")
"""

WORKER = COMMON + r"""
import dataclasses, json, os, sys, time
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch
import torch.distributed as dist
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch.dryrun import select_policy
from repro_torch.models import layers
from repro_torch.models.registry import get_model, param_specs
from repro_torch.optim.adamw import (AdamWConfig, _global_norm, _placed_like,
                                     apply_updates, init_state)
from repro_torch.optim.wire_compression import (init_err_state,
                                                int8_wire_allreduce,
                                                make_int8_wire_train_step)
from repro_torch.sharding import policies as pol
from repro_torch.sharding.pipeline import gpipe, reference_forward
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import tree_leaves, tree_map
res, arrays = {}, {}

def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x

def maxerr(a, b):
    return float((full(a).double() - full(b).double()).abs().max())

def tree_err(a, b):
    return max(maxerr(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

def place(tree, shardings, mesh):
    return tree_map(lambda t, s: distribute_tensor(
        t.detach().clone(), mesh, list(s.placements), src_data_rank=None),
        tree, shardings)

# --- GPipe over a (1, 4) mesh --------------------------------------------
w, b, x = gpipe_inputs()
w, b, x = torch.tensor(w), torch.tensor(b), torch.tensor(x)

def stage_fn(p, h):
    for i in range(p["w"].shape[0]):
        h = torch.tanh(h @ p["w"][i] + p["b"][i])
    return h

mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
stage = [Replicate(), Shard(0)]
wd = distribute_tensor(w, mesh14, stage, src_data_rank=None).requires_grad_()
bd = distribute_tensor(b, mesh14, stage, src_data_rank=None).requires_grad_()
xd = distribute_tensor(x, mesh14, [Shard(1), Replicate()], src_data_rank=None)
y = gpipe(stage_fn, mesh14, "model", ("data",))({"w": wd, "b": bd}, xd)
(y ** 2).sum().backward()
wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
yr = reference_forward(stage_fn, {"w": wr, "b": br}, x, 4)
(yr ** 2).sum().backward()
res["gpipe_fwd_err"] = maxerr(y, yr)
res["gpipe_grad_err"] = max(maxerr(wd.grad, wr.grad), maxerr(bd.grad, br.grad))
res["gpipe_placements"] = [str(p) for p in y.placements]
arrays["gpipe_y"] = full(y).detach().numpy()
arrays["gpipe_gw"] = full(wd.grad).numpy()
arrays["gpipe_gb"] = full(bd.grad).numpy()

# --- the int8 wire -------------------------------------------------------
class Wire(TorchDispatchMode):
    # the payload each collective sends: (op, dtype, tensor)
    def __init__(self):
        super().__init__()
        self.sent = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name in ("alltoall_base_", "_allgather_base_"):
            self.sent.append((name, str(args[1].dtype), args[1].clone()))
        return func(*args, **(kwargs or {}))

flat, err = wire_inputs()
with Wire() as wire:
    mean, new_err = int8_wire_allreduce(torch.tensor(flat[rank]),
                                        torch.tensor(err[rank]),
                                        dist.group.WORLD)
res["wire_sent"] = [(n, d) for n, d, _ in wire.sent]
arrays["wire_mean"], arrays["wire_new_err"] = mean.numpy(), new_err.numpy()
arrays["wire_q1"] = [t for n, _, t in wire.sent if n == "alltoall_base_"][0].numpy()
arrays["wire_q2"] = [t for n, _, t in wire.sent if n == "_allgather_base_"][0].numpy()

cfg = reduced(get_config("llama110m"))
model = get_model(cfg, LoweringConfig("torch"))
specs = param_specs(cfg)
init, tokens, labels = train_inputs([tuple(s.shape) for s in tree_leaves(specs)],
                                    cfg.vocab)
it = iter(init)

def fill(tree):
    if isinstance(tree, dict):
        return {k: fill(tree[k]) for k in sorted(tree)}
    return torch.tensor(next(it))

params = fill(specs)
rows = slice(2 * rank, 2 * rank + 2)
batch = {"tokens": torch.tensor(tokens[rows]),
         "labels": torch.tensor(labels[rows])}
opt_cfg = AdamWConfig()
opt, errs = init_state(params, opt_cfg), init_err_state(params)
mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
step = make_int8_wire_train_step(model, opt_cfg, mesh4, ("data",))
losses = []
for _ in range(3):
    params, opt, errs, m = step(params, opt, errs, batch)
    losses.append(float(m["loss"]))
arrays["train_losses"] = np.array(losses)
for i, leaf in enumerate(tree_leaves(params)):
    arrays[f"train_p{i}"] = leaf.numpy()

# --- sharded loss, gradients, AdamW and decode on (2, 2) -----------------
mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))

def named_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{path}/{k}" if path else k)]
    return [(path, tuple(tree.shape))]

def fill_from(tree, leaves):
    it = iter(leaves)
    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return torch.tensor(next(it))
    return go(tree)

for name, arch, dispatch, B, S, decode in SHARDED:
    cfg = sharded_cfg(reduced(get_config(arch)), dispatch)
    model = get_model(cfg, LoweringConfig("torch"))
    specs = param_specs(cfg)
    params = fill_from(specs, model_params(named_leaves(specs)))
    axes = model.param_axes()
    tokens, labels = sharded_tokens(cfg.vocab, B, S)
    toks = torch.tensor(tokens)
    batch = {"tokens": toks, "labels": torch.tensor(labels)}
    r = {}
    loss_p, grads_p = loss_and_grads(model, params, batch)
    psh = pol.param_shardings(cfg, mesh22, axes, params, "fsdp_tp")
    dparams = place(params, psh, mesh22)
    bsh = pol.batch_sharding(cfg, mesh22, batch, "fsdp_tp")
    dbatch = {k: distribute_tensor(v, mesh22, list(bsh[k].placements),
                                   src_data_rank=None) for k, v in batch.items()}
    layers.set_activation_shardings(pol.activation_specs(cfg, mesh22, B, "fsdp_tp"))
    loss_d, grads_d = loss_and_grads(model, dparams, dbatch)
    layers.set_activation_shardings(None)
    r["loss"] = (float(loss_p), float(full(loss_d)))
    r["grad_err"] = tree_err(grads_d, grads_p)
    r["grad_scale"] = max(float(g.abs().max()) for g in tree_leaves(grads_p))
    for i, g in enumerate(tree_leaves(grads_d)):
        arrays[f"{name}_g{i}"] = full(g).numpy()
    if dispatch is not None:
        # the same loss with room for every pair: capacity did drop some
        roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        r["loss_no_drops"] = float(get_model(roomy, LoweringConfig(
            "torch")).loss(params, batch))
        res[name] = r
        continue
    # AdamW updates in place: on a copy, the decode below wants params
    stepped = tree_map(lambda t: t.clone(), params)
    opt_p = init_state(stepped, opt_cfg)
    opt_d = init_state(dparams, opt_cfg)
    _, _, mp = apply_updates(stepped, grads_p, opt_p, opt_cfg)
    # the same gradients placed as the params: the update and its norm on
    # shards; the sharded gradients' own norm (replicated copies counted
    # once) against the plain one
    _, _, md = apply_updates(dparams, place(grads_p, psh, mesh22), opt_d,
                             opt_cfg)
    r["adamw_err"] = tree_err(dparams, stepped)
    r["gnorm"] = (float(mp["grad_norm"]), float(md["grad_norm"]),
                  float(_global_norm(tree_map(_placed_like, grads_d,
                                              dparams))))
    r["state_placed"] = all(isinstance(m, DTensor) for m in tree_leaves(opt_d["m"]))

    prompt = {"tokens": toks[:, :P0]}
    with torch.no_grad():
        _, caches = model.prefill(params, prompt, pad_to=S)
        caches_d0 = tree_map(lambda t: t.clone(), caches)
        logits_p, caches_p = model.decode_step(params, toks[:, P0], caches, P0)
        policy = select_policy(cfg, mesh22, "decode")
        psh = pol.param_shardings(cfg, mesh22, axes, params, policy)
        dparams = place(params, psh, mesh22)
        csh = pol.cache_shardings(cfg, mesh22, caches_d0, policy=policy)
        dcaches = place(caches_d0, csh, mesh22)
        tsh = pol.batch_sharding(cfg, mesh22, {"t": toks[:, P0]}, policy)["t"]
        dtok = distribute_tensor(toks[:, P0].contiguous(), mesh22,
                                 list(tsh.placements), src_data_rank=None)
        layers.set_activation_shardings(pol.activation_specs(cfg, mesh22, B, policy))
        logits_d, caches_d = model.decode_step(dparams, dtok, dcaches, P0)
        layers.set_activation_shardings(None)
    r["policy"] = policy
    r["cache_specs"] = {k: str(v.spec) for k, v in csh.items() if hasattr(v, "spec")}
    r["logits_err"] = maxerr(logits_d, logits_p)
    r["logits_scale"] = float(logits_p.abs().max())
    r["cache_err"] = tree_err(caches_d, caches_p)
    r["cache_is_dtensor"] = all(isinstance(c, DTensor) for c in tree_leaves(dcaches))
    arrays[f"{name}_logits"] = full(logits_d).numpy()
    res[name] = r

# --- checkpoints saved on one mesh, loaded onto another ------------------
wfull, bfull = (torch.tensor(a) for a in ckpt_inputs())
mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
shardings = {"w": pol.Sharding(mesh41, ("model", "data")),
             "b": pol.Sharding(mesh41, (None,))}

def loaded(d, step):
    tree, manifest = ckpt.load(d, step, shardings=shardings, verify=True)
    return {"step": manifest["step"],
            "w_equal": bool(torch.equal(tree["w"].full_tensor(), wfull)),
            "b_equal": bool(torch.equal(tree["b"].full_tensor(), bfull)),
            "w_placements": [str(p) for p in tree["w"].placements],
            "w_local": list(tree["w"].to_local().shape),
            "mesh": list(tree["w"].device_mesh.shape)}

# the port's own, saved from DTensors on (2, 2)
d = os.path.join(tmp, "ckpt")
ckpt.save(d, 5, {
    "w": distribute_tensor(wfull, mesh22, [Shard(0), Shard(1)], src_data_rank=None),
    "b": distribute_tensor(bfull, mesh22, [Replicate(), Shard(0)], src_data_rank=None)})
res["ckpt"] = loaded(d, 5)
# the reference's, saved from arrays sharded on a (2, 2) mesh
d = os.path.join(tmp, "ref_ckpt")
deadline = time.time() + 300
while ckpt.latest_step(d) != 7 and time.time() < deadline:
    time.sleep(0.5)
res["ref_ckpt"] = loaded(d, 7)

with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **arrays)
dist.destroy_process_group()
print("WORKER_OK")
"""


exec(compile(COMMON, "common", "exec"), _common := {})
SHARDED_CASES = _common["SHARDED"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the reference process and the four ranks together; return
    (per-rank results, per-rank arrays, the reference's arrays)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    oracle = subprocess.Popen([sys.executable, "-c", ORACLE, tmp], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
    ranks = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(WORLD), tmp], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in ranks + [oracle]:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in ranks + [oracle]:
            if p.poll() is None:
                p.kill()
    for r, (out, err) in enumerate(outs[:WORLD]):
        assert "WORKER_OK" in out, (r, out[-2000:], err[-4000:])
    assert "ORACLE_OK" in outs[-1][0], (outs[-1][0][-2000:],
                                        outs[-1][1][-4000:])
    res = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
           for r in range(WORLD)]
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(WORLD)]
    return res, arrays, dict(np.load(os.path.join(tmp, "oracle.npz")))


def test_gpipe_matches_reference_forward(runs):
    res, _, _ = runs
    for r in res:
        assert r["gpipe_fwd_err"] < 1e-5, r["gpipe_fwd_err"]
        assert r["gpipe_grad_err"] < 1e-3, r["gpipe_grad_err"]
        assert r["gpipe_placements"] == ["S(1)", "R"]


def test_gpipe_matches_reference_gpipe(runs):
    _, arrays, ref = runs
    a = arrays[0]
    np.testing.assert_allclose(a["gpipe_y"], ref["gpipe_y"], atol=1e-5,
                               rtol=0)
    for k in ("gpipe_gw", "gpipe_gb"):
        np.testing.assert_allclose(a[k], ref[k], atol=1e-3, rtol=0)


def _q(x, scale):
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


def test_int8_wire_allreduce_matches_reference(runs):
    """The wire carries int8 both ways; its payloads are the reference's
    quantization of the same inputs, and the mean and error feedback are
    the reference's within 1e-6."""
    res, arrays, ref = runs
    flat, err = _common["wire_inputs"]()
    n, N = WORLD, flat.shape[1]
    gf = flat + err
    scale1 = np.float32(np.abs(gf).max() / np.float32(127.0))
    q1 = _q(gf, scale1)                                   # (n, N)
    pad = (-N) % n
    chunk = (N + pad) // n
    q1p = np.pad(q1, ((0, 0), (0, pad)))
    local_mean = [q1p[:, c * chunk:(c + 1) * chunk].astype(np.float32)
                  .sum(0) * (scale1 / np.float32(n)) for c in range(n)]
    scale2 = np.float32(max(np.abs(m).max() for m in local_mean)
                        / np.float32(127.0))
    for r in range(n):
        assert res[r]["wire_sent"] == [["alltoall_base_", "torch.int8"],
                                       ["_allgather_base_", "torch.int8"]]
        a = arrays[r]
        np.testing.assert_array_equal(a["wire_q1"], q1p[r])
        np.testing.assert_array_equal(a["wire_q2"], _q(local_mean[r],
                                                       scale2))
        np.testing.assert_allclose(a["wire_mean"], ref["wire_mean"][r],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(a["wire_new_err"], ref["wire_new_err"][r],
                                   atol=1e-6, rtol=0)


def test_int8_wire_train_steps_match_reference(runs):
    """Three steps of the int8-wire DP step on reduced(llama110m): the
    losses within 1e-5 relative, every param within 2e-3 (an int8 level's
    flip moves an AdamW update by at most the learning rate a step)."""
    _, arrays, ref = runs
    for r in range(WORLD):
        np.testing.assert_allclose(arrays[r]["train_losses"],
                                   ref["train_losses"], rtol=1e-5)
    i = 0
    while f"train_p{i}" in ref:
        for r in range(WORLD):
            np.testing.assert_allclose(arrays[r][f"train_p{i}"],
                                       ref[f"train_p{i}"], atol=2e-3,
                                       rtol=0)
        i += 1
    assert i > 5


ARCHS = {"qwen1.5-0.5b": "qwen", "dbrx-132b": "dbrx", "mamba2-2.7b": "mamba2"}
MOE_CASES = ["dbrx_grouped512", "dbrx_sort320"]
#: fp32 parity of the port with the reference (tests/test_torch_loss.py)
TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_adamw_match_unsharded(runs, arch):
    """fsdp_tp on (2, 2): the loss at fp32 (1e-5 relative), every gradient
    leaf within 1e-5 of the largest; one AdamW step on the shards of the
    same gradients within 1e-6 of the plain step, its state placed as the
    params, the global norm of the plain, placed and sharded gradients
    equal within 1e-5 relative."""
    res, _, _ = runs
    for r in res:
        a = r[ARCHS[arch]]
        plain, sharded = a["loss"]
        assert sharded == pytest.approx(plain, rel=1e-5)
        assert a["grad_err"] <= 1e-5 * max(a["grad_scale"], 1.0), a
        assert a["adamw_err"] < 1e-6, a
        assert a["state_placed"]
        norm = a["gnorm"][0]
        assert a["gnorm"][1] == pytest.approx(norm, rel=1e-5)
        assert a["gnorm"][2] == pytest.approx(norm, rel=1e-5)


@pytest.mark.parametrize("name", [c[0] for c in SHARDED_CASES])
def test_sharded_loss_and_grads_match_reference(runs, name):
    """fsdp_tp on (2, 2), the port's DTensors against the reference's
    jitted value_and_grad on a (2, 2) mesh of Auto axes with its
    policies and activation specs, on the same params and batch: the loss
    and every gradient leaf elementwise within fp32's tolerance."""
    res, arrays, ref = runs
    np.testing.assert_allclose(res[0][name]["loss"][1], ref[f"{name}_loss"],
                               **TOL)
    i = 0
    while f"{name}_g{i}" in ref:
        np.testing.assert_allclose(arrays[0][f"{name}_g{i}"],
                                   ref[f"{name}_g{i}"], **TOL,
                                   err_msg=f"{name} leaf {i}")
        i += 1
    assert i == len([k for k in arrays[0] if k.startswith(f"{name}_g")
                     and k[len(name) + 2:].isdigit()])
    assert i > 5


@pytest.mark.parametrize("name", MOE_CASES)
def test_sharded_moe_capacity_matches_unsharded(runs, name):
    """More than 256 tokens, so the expert capacity drops pairs (the loss
    differs from one with room for all): the grouped dispatch with its
    group split over the batch shards, and the sort dispatch, keep and
    drop the unsharded run's pairs: the loss within 1e-5 relative, every
    gradient leaf within 1e-5 of the largest."""
    res, _, _ = runs
    for r in res:
        a = r[name]
        plain, sharded = a["loss"]
        assert abs(a["loss_no_drops"] - plain) > 1e-4, a
        assert sharded == pytest.approx(plain, rel=1e-5)
        assert a["grad_err"] <= 1e-5 * max(a["grad_scale"], 1.0), a


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_unsharded(runs, arch):
    """The decode policy's weights and caches on (2, 2): logits within
    atol 2e-5 / rtol 2e-4 of the plain decode, the caches written in place
    on their shards equal to the plain ones."""
    res, _, _ = runs
    for r in res:
        a = r[ARCHS[arch]]
        assert a["policy"] == "serve"
        assert a["cache_is_dtensor"]
        assert a["logits_err"] <= 2e-5 + 2e-4 * a["logits_scale"], a
        assert a["cache_err"] < 1e-5, a
    if arch == "dbrx-132b":  # one kv head: the sequence over 'model'
        assert "'model'" in res[0]["dbrx"]["cache_specs"]["k"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_reference(runs, arch):
    """The serve policy's decode step on (2, 2) against the reference's
    jitted decode_step under the same policy on Auto axes, from the same
    prompt's caches: logits within fp32's tolerance."""
    _, arrays, ref = runs
    name = ARCHS[arch]
    np.testing.assert_allclose(arrays[0][f"{name}_logits"],
                               ref[f"{name}_logits"], **TOL)


def test_checkpoint_reshards_across_meshes(runs):
    """The port's checkpoint of DTensors on (2, 2) and the reference's of
    arrays sharded on a (2, 2) mesh, each loaded onto (4, 1): the saved
    values bit for bit, placed as asked."""
    res, _, _ = runs
    for r in res:
        for key, step in (("ckpt", 5), ("ref_ckpt", 7)):
            c = r[key]
            assert c["step"] == step
            assert c["w_equal"] and c["b_equal"], (key, c)
            assert c["mesh"] == [4, 1]
            assert c["w_placements"] == ["S(1)", "S(0)"]
            assert c["w_local"] == [16, 8]
