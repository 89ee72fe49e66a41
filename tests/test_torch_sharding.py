"""The port's sharding policies against the reference's, spec by spec.

Every param, batch, cache and activation spec of ``repro_torch.sharding.
policies`` is held equal, entry by entry, to the ``PartitionSpec`` of
``repro.sharding.policies`` for every ``ASSIGNED_ARCHS`` config, every
``applicable_shapes`` cell, both production meshes (16×16 and 2×16×16:
the reference's ``_fake_mesh``, the port's ``MeshLayout``; spec resolution
reads only axis names and sizes) and every policy.  Every ``*_axes`` tree
of the port equals the reference's.  Then the port's mirror of
``tests/test_sharding.py``, its HLO collective parser replaced by the
``CostRecorder`` on a known DTensor matmul under a fake process group.
No test here starts a real process group.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.registry import cache_specs as jcache_specs
from repro.models.registry import get_model as jget_model
from repro.models.registry import input_specs as jinput_specs
from repro.models.registry import param_specs as jparam_specs
from repro.sharding import policies as jpol
from repro_torch.configs.base import SHAPES, applicable_shapes
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.launch.mesh import MeshLayout, production_layout
from repro_torch.models import layers, mamba2, moe, transformer
from repro_torch.models.registry import (cache_specs, get_model,
                                         input_specs, param_specs)
from repro_torch.sharding import policies as pol
from repro_torch.tree import tree_leaves


def _fake_mesh(shape, axes):
    """Mesh over a numpy device grid; spec resolution only reads sizes."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices() * n)[:n]
    return Mesh(devs.reshape(shape), axes)


JMESH = {False: _fake_mesh((16, 16), ("data", "model")),
         True: _fake_mesh((2, 16, 16), ("pod", "data", "model"))}
MESH = {mp: production_layout(mp) for mp in (False, True)}
POLICIES = list(pol.POLICIES)

_PARAMS: dict = {}


def _params(arch):
    """(port meta param tree, reference ShapeDtypeStruct tree), once."""
    if arch not in _PARAMS:
        _PARAMS[arch] = (param_specs(get_config(arch)),
                         jparam_specs(jget_config(arch)))
    return _PARAMS[arch]


def _spec(x):
    """A spec (the reference's PartitionSpec or NamedSharding, or the
    port's tuple) as a tuple with one-name tuples unwrapped, the form
    ``PartitionSpec`` compares equal under (P(("data",)) == P("data"))."""
    if x is None:
        return None
    if hasattr(x, "spec"):
        x = x.spec
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in x)


def _pairs(port, ref, path=""):
    """[(path, port leaf, reference leaf)] of two trees of one structure."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        return [t for k in sorted(port)
                for t in _pairs(port[k], ref[k], f"{path}/{k}")]
    return [(path, port, ref)]


def test_policy_tables_equal_reference():
    assert pol.PARAM_RULES == jpol.PARAM_RULES
    assert pol.POLICIES == jpol.POLICIES
    assert pol.POLICY_DP == jpol.POLICY_DP


@pytest.mark.parametrize("arch", ["llama110m"] + ASSIGNED_ARCHS)
def test_axes_trees_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    got = get_model(cfg).param_axes()
    want = jget_model(jcfg).param_axes()
    for path, a, b in _pairs(got, want):
        assert a == b, (arch, path, a, b)
    # the axes tree mirrors the param tree leaf for leaf, rank for rank
    for path, ax, leaf in _pairs(got, param_specs(cfg)):
        assert len(ax) == leaf.ndim, (arch, path, ax, leaf.shape)


def test_layer_axes_functions_equal_reference():
    cfg, jcfg = get_config("dbrx-132b"), jget_config("dbrx-132b")
    assert layers.rmsnorm_axes() == jlayers.rmsnorm_axes()
    assert layers.mlp_axes() == jlayers.mlp_axes()
    assert layers.embedding_axes() == jlayers.embedding_axes()
    assert layers.attention_axes(cfg) == jlayers.attention_axes(jcfg)
    assert moe.moe_axes(cfg) == jmoe.moe_axes(jcfg)
    assert transformer.block_axes(cfg) == jtransformer.block_axes(jcfg)
    arctic, jarctic = get_config("arctic-480b"), jget_config("arctic-480b")
    assert moe.moe_axes(arctic) == jmoe.moe_axes(jarctic)
    qwen, jqwen = get_config("qwen1.5-0.5b"), jget_config("qwen1.5-0.5b")
    assert layers.attention_axes(qwen) == jlayers.attention_axes(jqwen)
    m, jm = get_config("mamba2-2.7b"), jget_config("mamba2-2.7b")
    assert mamba2.ssm_block_axes(m) == jmamba2.ssm_block_axes(jm)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_equal_reference(arch, multi_pod, policy):
    """param, batch, cache and activation specs at every shape cell."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    mesh, jmesh = MESH[multi_pod], JMESH[multi_pod]
    pp, jp = _params(arch)
    axes = get_model(cfg).param_axes()
    got = pol.param_shardings(cfg, mesh, axes, pp, policy)
    want = jpol.param_shardings(jcfg, jmesh, jget_model(jcfg).param_axes(),
                                jp, policy)
    pairs = _pairs(got, want)
    assert len(pairs) == len(tree_leaves(pp))
    for path, a, b in pairs:
        assert _spec(a) == _spec(b), (path, a.spec, b.spec)
        a.placements  # every spec converts to DTensor placements
    assert pol.dp_axes(mesh, policy) == jpol.dp_axes(jmesh, policy)
    for shape in applicable_shapes(cfg):
        jshape = JSHAPES[shape.name]
        specs, jspecs = input_specs(cfg, shape), jinput_specs(jcfg, jshape)
        if shape.kind in ("train", "prefill"):
            got = pol.batch_sharding(cfg, mesh, specs["batch"], policy)
            want = jpol.batch_sharding(jcfg, jmesh, jspecs["batch"], policy)
            for path, a, b in _pairs(got, want):
                assert _spec(a) == _spec(b), (shape.name, path, a.spec, b)
        else:
            got = pol.cache_shardings(cfg, mesh, specs["caches"],
                                      policy=policy)
            want = jpol.cache_shardings(jcfg, jmesh, jspecs["caches"],
                                        policy=policy)
            for path, a, b in _pairs(got, want):
                assert _spec(a) == _spec(b), (shape.name, path, a.spec, b)
            tok = pol.batch_sharding(cfg, mesh, {"t": specs["token"]},
                                     policy)["t"]
            jtok = jpol.batch_sharding(jcfg, jmesh, {"t": jspecs["token"]},
                                       policy)["t"]
            assert _spec(tok) == _spec(jtok)
            if "state" in specs["caches"]:
                st = pol.ssm_state_sharding(mesh, specs["caches"]["state"])
                jst = jpol.ssm_state_sharding(jmesh,
                                              jspecs["caches"]["state"])
                assert _spec(st) == _spec(jst)
        got = pol.activation_specs(cfg, mesh, shape.global_batch, policy)
        want = jpol.activation_specs(jcfg, jmesh, jshape.global_batch,
                                     policy)
        assert sorted(got) == sorted(want)
        for kind in got:
            assert _spec(got[kind]) == _spec(want[kind]), (shape.name, kind)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_equal_reference(arch):
    """batch, cache and input specs: shapes and dtypes of every leaf, on
    the meta device (no storage)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in applicable_shapes(cfg):
        got = input_specs(cfg, shape)
        want = jinput_specs(jcfg, JSHAPES[shape.name])
        for path, a, b in _pairs(got, want):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), (path, a.shape, b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (path,)
    pp, jp = _params(arch)
    for path, a, b in _pairs(pp, jp):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape), (path, a.shape, b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path


# ---------------------------------------------------------------------------
# The port's mirror of tests/test_sharding.py
# ---------------------------------------------------------------------------

MESH2 = MESH[False]
MESH3 = MESH[True]


class TestParamSpecs:
    def test_fsdp_tp_weight(self):
        spec = pol.resolve_param_spec(("embed", "ff"), (4096, 12800), MESH2)
        assert spec == ("data", "model")

    def test_vocab_table_is_vocab_parallel_only(self):
        spec = pol.resolve_param_spec(("vocab", "embed"), (151936, 1024),
                                      MESH2)
        assert spec == ("model", None)

    def test_indivisible_vocab_falls_back(self):
        spec = pol.resolve_param_spec(("vocab", "embed"), (49155, 4096),
                                      MESH2)
        assert spec == (None, None)

    def test_gqa_kv_head_no_headdim_fallback_by_default(self):
        spec = pol.resolve_param_spec(("embed", "kv_heads", "head_dim"),
                                      (4096, 8, 128), MESH2)
        assert spec == ("data", None, None)
        spec_hd = pol.resolve_param_spec(("embed", "kv_heads", "head_dim"),
                                         (4096, 8, 128), MESH2,
                                         policy="fsdp_tp_hd")
        assert spec_hd == ("data", None, "model")

    def test_no_double_use_of_axis(self):
        spec = pol.resolve_param_spec(("ff", "embed"), (12800, 4096), MESH2)
        assert spec[0] != spec[1]

    def test_layers_never_sharded(self):
        spec = pol.resolve_param_spec(("layers", "embed", "ff"),
                                      (48, 4096, 12800), MESH2)
        assert spec == (None, "data", "model")

    def test_placements(self):
        from torch.distributed.tensor import Replicate, Shard
        assert pol.to_placements(("data", "model"), MESH2) == (Shard(0),
                                                               Shard(1))
        assert pol.to_placements(("model", None), MESH2) == (Replicate(),
                                                             Shard(0))
        assert pol.to_placements((("pod", "data"), None, None), MESH3) == (
            Shard(0), Shard(0), Replicate())
        # serve's embed→("model","data"): both split dim 0, in mesh order
        assert pol.to_placements((("model", "data"),), MESH2) == (
            Shard(0), Shard(0))
        assert pol.to_placements(None, MESH2) == (Replicate(), Replicate())
        with pytest.raises(ValueError):
            pol.to_placements(("data", "data"), MESH2)


class TestActivationSpecs:
    def test_train_batch(self):
        specs = pol.activation_specs(get_config("granite-3-8b"), MESH2, 256)
        assert specs["btd"] == (("data",), None, None)

    def test_multipod_batch(self):
        specs = pol.activation_specs(get_config("granite-3-8b"), MESH3, 256)
        assert specs["btd"] == (("pod", "data"), None, None)

    def test_batch_one_long_context(self):
        specs = pol.activation_specs(get_config("zamba2-1.2b"), MESH2, 1)
        assert specs["btd"] is None

    def test_moe_buffer_specs(self):
        specs = pol.activation_specs(get_config("arctic-480b"), MESH2, 256)
        assert specs["ecd"] == ("model", "data", None)


class TestCacheSpecs:
    def test_kv_cache_specs_exist_for_all_decode_cells(self):
        for arch in ("granite-3-8b", "mamba2-2.7b", "zamba2-1.2b",
                     "seamless-m4t-medium", "arctic-480b"):
            cfg = get_config(arch)
            sh = pol.cache_shardings(cfg, MESH2, cache_specs(cfg, 128, 32768))
            for leaf in tree_leaves(sh):
                assert leaf.spec is not None

    def test_long_context_seq_parallel_kv(self):
        cfg = get_config("zamba2-1.2b")
        sh = pol.cache_shardings(cfg, MESH2, cache_specs(cfg, 1, 524288))
        assert sh["k"].spec == (None, None, "data", "model", None)


class TestDryRunPlumbing:
    def test_input_specs_no_allocation(self):
        specs = input_specs(get_config("arctic-480b"), SHAPES["train_4k"])
        for leaf in tree_leaves(specs):
            assert isinstance(leaf, torch.Tensor)
            assert leaf.device.type == "meta"

    def test_param_specs_no_allocation(self):
        for leaf in tree_leaves(param_specs(get_config("arctic-480b"))):
            assert leaf.device.type == "meta"

    def test_cost_recorder_on_a_dtensor_matmul(self):
        """A (256·16, 4096) @ (4096, 11008) product, rows over 'data',
        columns over 'model', on a fake 16×16 mesh: no collective, the
        local product's FLOPs; then the weight's rows sharded over 'data'
        too: an operand all-gathered over 'data' (16 ranks)."""
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.roofline.analysis import (CostRecorder,
                                                   collective_stats)
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError):
            make_production_mesh(device_type="cpu")
        dist.init_process_group("fake", store=FakeStore(), world_size=256,
                                rank=0)
        try:
            mesh = make_production_mesh(device_type="cpu")
            with FakeTensorMode():
                a = DTensor.from_local(torch.empty(256, 4096), mesh,
                                       [Shard(0), Replicate()],
                                       run_check=False)
                w = DTensor.from_local(torch.empty(4096, 688), mesh,
                                       [Replicate(), Shard(1)],
                                       run_check=False)
                with CostRecorder() as rec:
                    c = a @ w
                assert tuple(c.placements) == (Shard(0), Shard(1))
                assert rec.records == []
                assert rec.flops == 2 * 256 * 4096 * 688
                w2 = DTensor.from_local(torch.empty(256, 688), mesh,
                                        [Shard(0), Shard(1)],
                                        run_check=False)
                with CostRecorder() as rec:
                    a @ w2
                kinds = [r[0] for r in rec.records]
                assert "all-gather" in kinds, rec.records
                ag = [r for r in rec.records if r[0] == "all-gather"][0]
                # one operand gathered whole over 'data' (DTensor's pick)
                assert ag[2] == 16
                assert ag[1] in (4096 * 4096 * 4, 4096 * 688 * 4), ag
            st = collective_stats([("all-reduce", 32, 4),
                                   ("all-gather", 64, 16),
                                   ("reduce-scatter", 8, 2),
                                   ("collective-permute", 10, 2)])
            assert st.counts["all-reduce"] == 1
            assert st.wire_bytes_per_chip == pytest.approx(
                2 * 32 * 3 / 4 + 64 * 15 / 16 + 8 * 1 + 10)
        finally:
            dist.destroy_process_group()

    def test_roofline_terms(self):
        from repro_torch.roofline.analysis import H100, TPU_V5E, roofline
        r = roofline(flops=1e18, hbm_bytes=1e15, wire_bytes_per_chip=1e9,
                     n_chips=256, model_flops=9e17, peaks=TPU_V5E)
        assert r.compute_s == pytest.approx(1e18 / (256 * 197e12))
        assert r.bottleneck == "compute"
        assert 0.8 < r.useful_ratio < 1.0
        h = roofline(flops=1e18, hbm_bytes=1e15, wire_bytes_per_chip=1e9,
                     n_chips=256, peaks=H100)
        assert h.compute_s == pytest.approx(1e18 / (256 * 989e12))


def test_shard_act_identity_without_specs():
    """No specs, or a plain tensor: ``shard_act`` returns its input."""
    x = torch.randn(2, 3, 4)
    layers.set_activation_shardings(None)
    assert layers.shard_act(x, "btd") is x
    layers.set_activation_shardings({"btd": ("data", None, None)})
    try:
        assert layers.shard_act(x, "btd") is x
        assert layers.shard_act(x, "btv") is x
    finally:
        layers.set_activation_shardings(None)


def test_mesh_layout():
    assert production_layout(False) == MeshLayout((16, 16),
                                                  ("data", "model"))
    assert production_layout(True).ndim == 3
