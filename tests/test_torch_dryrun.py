"""The port's dry run against the reference's.

``repro_torch.launch.dryrun.run_cell`` traces a cell's step on fake
DTensors under a fake process group of 256 ranks; the reference lowers and
compiles it with XLA on 512 forced host devices.  Both run in processes of
their own, side by side (the fake group and the forced device count never
touch the pytest process), on a dense ``train_4k``, a ``prefill_32k``, an
MoE ``decode_32k`` and an ssm ``long_500k``: the argument bytes a device
holds equal the reference's ``memory_analysis()`` to the byte, but for one
named leaf (mamba2's decode never reads ``pos``, and ``jax.jit`` prunes an
argument the step does not read; the port counts its 4 bytes).  The perf
variants ``pp`` (GPipe over 'model', yi-9b's 48 = 16 × 3 layers) and
``int8_wire`` trace to a record.  The reference's ``make_mesh`` is wrapped
to pass ``Auto`` axes (ROADMAP's queue 3 fault 1).
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs.base import applicable_shapes
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.models.registry import input_specs, param_specs
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 600
CELLS = [("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "prefill_32k"),
         ("arctic-480b", "decode_32k"), ("mamba2-2.7b", "long_500k")]
#: leaves the port counts and the reference's jit prunes: (cell, leaf, bytes)
UNREAD = {("mamba2-2.7b", "long_500k"): ("pos", 4)}

REFERENCE = r"""
import json, sys
import repro.launch.dryrun as D   # sets XLA_FLAGS (512 devices) first
import jax
from jax.sharding import AxisType
_make_mesh = jax.make_mesh

def _auto(shape, axes, **kw):
    kw.setdefault("axis_types", (AxisType.Auto,) * len(axes))
    return _make_mesh(shape, axes, **kw)

jax.make_mesh = _auto
out = {}
for cell in json.loads(sys.argv[2]):
    rec = D.run_cell(cell[0], cell[1], False, sys.argv[1], skip_existing=False)
    out["/".join(cell)] = {"ok": rec["ok"], "memory": rec.get("memory"),
                           "error": rec.get("error")}
print("REF=" + json.dumps(out))
"""

PORT = r"""
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.models import layers
from repro_torch.tree import tree_leaves
out, tmp = {}, sys.argv[1]
for i, cell in enumerate(json.loads(sys.argv[2])):
    rec = D.run_cell(cell[0], cell[1], False, tmp, skip_existing=False,
                     peak=i == 1)
    out["/".join(cell)] = rec
# the inputs of a cell are fake DTensors (no storage)
D.start_fake_group(256)
from repro_torch.launch.mesh import make_production_mesh
mesh = make_production_mesh(device_type="cpu")
with FakeTensorMode(allow_non_fake_inputs=True):
    cfg = get_config("qwen1.5-0.5b")
    step, inputs = D.build_step(cfg, SHAPES["train_4k"], mesh, "fsdp_tp")
    leaves = [l for l in tree_leaves(D._as_tree(inputs))
              if isinstance(l, torch.Tensor)]
    out["fake"] = all(isinstance(getattr(l, "to_local", lambda: l)(),
                                 FakeTensor) for l in leaves)
    out["n_inputs"] = len(leaves)
layers.set_activation_shardings(None)
out["pp"] = perf.run_variant("yi-9b", "train_4k", "pp", tmp)
out["int8_wire"] = perf.run_variant("qwen1.5-0.5b", "train_4k", "int8_wire",
                                    tmp)
print("PORT=" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cells = json.dumps(CELLS)
    procs = [subprocess.Popen([sys.executable, "-c", src,
                               os.path.join(tmp, name), cells], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for name, src in (("ref", REFERENCE), ("port", PORT))]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = {}
    for tag, (out, err) in zip(("REF=", "PORT="), outs):
        line = [ln for ln in out.splitlines() if ln.startswith(tag)]
        assert line, (tag, out[-2000:], err[-4000:])
        got[tag] = json.loads(line[0][len(tag):])
    return got["REF="], got["PORT="]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_allocate_nothing(arch):
    cfg = get_config(arch)
    for leaf in tree_leaves(param_specs(cfg)):
        assert leaf.device.type == "meta"
    for shape in applicable_shapes(cfg):
        for leaf in tree_leaves(input_specs(cfg, shape)):
            assert leaf.device.type == "meta"


def test_imports_start_no_process_group():
    import torch.distributed as dist
    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.sharding.pipeline  # noqa: F401
    import repro_torch.sharding.policies  # noqa: F401
    assert not dist.is_initialized()


@pytest.mark.parametrize("cell", CELLS, ids=["/".join(c) for c in CELLS])
def test_argument_bytes_equal_reference(runs, cell):
    ref, port = runs
    key = "/".join(cell)
    r, p = ref[key], port[key]
    assert r["ok"], r
    assert p["ok"], (p.get("error"), p.get("traceback"))
    want = r["memory"]["argument_size_in_bytes"]
    got = p["memory"]["argument_size_in_bytes"]
    unread = UNREAD.get(cell, (None, 0))[1]
    assert got - unread == want, (cell, got, want, UNREAD.get(cell))


def test_records_keep_the_reference_keys(runs):
    _, port = runs
    for cell in CELLS:
        rec = port["/".join(cell)]
        for k in ("ok", "collectives", "cost", "memory", "roofline",
                  "lower_s", "total_s", "policy"):
            assert k in rec, (cell, k)
        assert set(rec["collectives"]) == {"counts", "in_loop",
                                           "result_bytes",
                                           "wire_bytes_per_chip"}
        assert rec["cost"]["flops"] > 0
        assert rec["roofline"]["peaks"] == "h100_sxm"
        assert sum(rec["collectives"]["counts"].values()) > 0
    peak = port["/".join(CELLS[1])]["memory"]  # MemTracker on one cell
    assert "peak_bytes" in peak or "error" in peak
    assert port["fake"] and port["n_inputs"] > 0


def test_decode_policies_follow_the_reference(runs):
    _, port = runs
    assert port["arctic-480b/decode_32k"]["policy"] == "serve"
    assert port["mamba2-2.7b/long_500k"]["policy"] == "fsdp_tp"
    assert port["qwen1.5-0.5b/train_4k"]["policy"] == "fsdp_tp"


@pytest.mark.parametrize("variant", ["pp", "int8_wire"])
def test_perf_variant(runs, variant):
    _, port = runs
    rec = port[variant]
    assert rec["ok"], (rec.get("error"), rec.get("traceback"))
    counts = rec["collectives"]["counts"]
    if variant == "pp":  # the ring permute of every tick
        assert counts["collective-permute"] > 0
    else:  # int8 all-to-all and all-gather of the gradient
        assert counts["all-to-all"] == 1 and counts["all-gather"] == 1
