"""The port's compile/dispatch engine (``repro_torch.compile``) against the
reference's (``repro.compile``) on the CPU.

The reference's cases of ``tests/test_dispatch.py`` run on the port's
engine with the port's backend names (``cuda`` for ``pallas``, ``torch``
for ``xla``, ``torch_chunked`` for ``xla_chunked``).  The 11 golden keys
(``tests/golden/dispatch_records.json``) give the golden ``impl``,
``matched`` and ``target`` on ``cuda``, and every ``MatchOutcome``
counter equals the reference's dispatcher's in the same process (the
counters follow Python's string hash seed, so never the file's).  The
chunked backend is held to the reference's ``xla_chunked`` path."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compile as jcompile
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models.registry import get_model as jax_get_model
from repro_torch.bridge import params_from_numpy
from repro_torch.compile import (TARGET_ISAX, Dispatcher, LoweringConfig,
                                 OpKey, lower)
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ref as kref
from repro_torch.models import layers
from repro_torch.models.registry import get_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = json.loads((ROOT / "tests/golden/dispatch_records.json").read_text())
RNG = np.random.default_rng(0)


class TestLoweringDecisions:
    def test_attention_extracts_flash_isax(self):
        lw = LoweringConfig("cuda", Dispatcher())
        rec = lw.lower("attention", (1, 128, 4, 2, 128, 64), "float32")
        assert rec.impl == "isax"
        assert "flash_attention" in rec.matched
        assert rec.kernel_fn is not None
        assert rec.schedule["kernel"] in ("flash_attention",
                                          "flash_attention_pipelined")

    def test_single_row_decode_falls_back(self):
        lw = LoweringConfig("cuda", Dispatcher())
        rec = lw.lower("attention_paged", (4, 1, 4, 2, 64, 16), "float32")
        assert rec.impl == "reference"
        assert "flash_attention" in rec.matched
        assert "degenerate" in rec.note

    def test_plain_matmul_is_negative_control(self):
        lw = LoweringConfig("cuda", Dispatcher())
        rec = lw.lower("matmul", (32, 64, 128), "float32")
        assert rec.impl == "reference" and rec.matched == ()
        assert TARGET_ISAX["matmul"] is None

    def test_rmsnorm_ssd_int8_match(self):
        lw = LoweringConfig("cuda", Dispatcher())
        assert lw.lower("rmsnorm", (32, 64), "float32").impl == "isax"
        assert lw.lower("ssd_scan", (2, 16, 16, 8, 16),
                        "float32").impl == "isax"
        assert lw.lower("int8_matmul", (128, 128, 128),
                        "float32").impl == "isax"

    def test_torch_backend_records_match_but_runs_reference(self):
        lw = LoweringConfig("torch", Dispatcher())
        rec = lw.lower("attention", (1, 128, 4, 2, 128, 64), "float32")
        assert rec.impl == "reference"
        assert "flash_attention" in rec.matched

    def test_chunked_backend_for_attention(self):
        lw = LoweringConfig("torch_chunked", Dispatcher())
        assert lw.lower("attention", (1, 128, 4, 2, 128, 64),
                        "float32").impl == "chunked"
        one = lw.lower("attention_decode", (1, 1, 4, 2, 128, 64), "float32")
        assert one.impl == "reference" and "single-row" in one.note

    def test_unknown_op_rejected(self):
        with pytest.raises(ValueError, match="known:"):
            Dispatcher().lower(OpKey("conv3d", (1,), "float32", "torch"))
        with pytest.raises(ValueError):
            OpKey("", (1,), "float32", "torch")

    def test_top_level_lower_entry_point(self):
        rec = lower("rmsnorm", shape=(32, 64), dtype="float32",
                    backend="cuda")
        assert rec.impl == "isax"
        again = lower("rmsnorm", shape=(32, 64), dtype="float32",
                      backend="cuda")
        assert again is rec

    def test_torch_dtypes_and_names_share_a_key(self):
        lw = LoweringConfig("cuda", Dispatcher())
        a = lw.lower("rmsnorm", (32, 64), torch.bfloat16)
        b = lw.lower("rmsnorm", [32, 64], "bfloat16")
        assert a is b and a.key.dtype == "bfloat16"


class TestCompileCache:
    def test_cache_hit_on_second_lowering(self):
        disp = Dispatcher()
        lw = LoweringConfig("cuda", disp)
        key = ("attention", (1, 64, 4, 2, 64, 16), "float32")
        r1 = lw.lower(*key)
        assert disp.misses == 1 and disp.hits == 0
        r2 = lw.lower(*key)
        assert r2 is r1
        assert disp.hits == 1 and disp.misses == 1
        assert r1.hits == 1

    def test_second_forward_hits_cache(self):
        """A second forward at the same shapes resolves every key from the
        cache: the e-graph pipeline does not run again."""
        cfg = reduced(get_config("llama110m"))
        disp = Dispatcher()
        model = get_model(cfg, lowering=LoweringConfig("cuda", disp))
        params = model.init(0, "cpu")
        tokens = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 16),
                                               dtype=np.int32))
        model.prefill(params, {"tokens": tokens})
        misses0, hits0 = disp.misses, disp.hits
        assert misses0 > 0
        model.prefill(params, {"tokens": tokens})
        assert disp.misses == misses0, "second forward recompiled"
        assert disp.hits > hits0

    def test_backend_is_part_of_the_key(self):
        disp = Dispatcher()
        shape = (1, 64, 4, 2, 64, 16)
        a = LoweringConfig("torch", disp).lower("attention", shape, "float32")
        b = LoweringConfig("cuda", disp).lower("attention", shape, "float32")
        assert a.impl == "reference" and b.impl == "isax"
        assert disp.misses == 2

    def test_stats_shape(self):
        disp = Dispatcher()
        lw = LoweringConfig("cuda", disp)
        lw.lower("rmsnorm", (32, 64), "float32")
        lw.lower("matmul", (32, 64, 128), "float32")
        lw.lower("ssd_scan", (4, 512, 80, 64, 128), "float32")
        st = disp.stats()
        assert st["n_keys"] == 3 and st["matched_keys"] == 2
        assert st["isax_keys"] == 2 and st["pipelined_keys"] == 1
        assert 0.0 < st["match_rate"] < 1.0
        assert len(st["ops"]) == 3
        json.dumps(st)   # the stats print as one JSON line


# ---------------------------------------------------------------------------
# golden keys and counters against the reference, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(GOLDEN)))
def test_golden_key_lowers_as_the_golden_record(i):
    g = GOLDEN[i]
    rec = Dispatcher().lower(OpKey(g["op"], tuple(g["shape"]), g["dtype"],
                                   "cuda"))
    assert (rec.impl, list(rec.matched), rec.target) == (
        g["impl"], g["matched"], g["target"])
    assert rec.outcome.saturated_enodes == g["saturated_enodes"]


@pytest.mark.parametrize("i", range(len(GOLDEN)))
def test_match_outcome_counters_are_the_references(i):
    g = GOLDEN[i]
    got = Dispatcher().lower(OpKey(g["op"], tuple(g["shape"]), g["dtype"],
                                   "cuda")).outcome
    want = jcompile.Dispatcher().lower(jcompile.OpKey(
        g["op"], tuple(g["shape"]), g["dtype"], "pallas_interpret")).outcome
    assert (got.matched, got.internal_rewrites, got.external_rewrites,
            got.initial_enodes, got.saturated_enodes) == (
        want.matched, want.internal_rewrites, want.external_rewrites,
        want.initial_enodes, want.saturated_enodes)


# ---------------------------------------------------------------------------
# the chunked backend against the reference's xla_chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,K,hd,chunk,mask", [
    (2, 16, 16, 4, 2, 16, 8, "causal"), (1, 8, 64, 4, 4, 32, 16, "random"),
    (2, 12, 48, 2, 1, 8, 1024, "causal"), (1, 8, 40, 2, 2, 16, 16, "random"),
    (1, 4, 32, 2, 2, 16, 8, "row_masked")])
def test_sdpa_chunked_matches_the_references(B, S, T, H, K, hd, chunk, mask):
    """``layers._sdpa_chunked`` (online softmax over key chunks) gives the
    reference's ``_sdpa_chunked``, GQA, a chunk that does not divide T
    (the plain version) and a fully masked row (0) included."""
    rng = np.random.default_rng(B * 100 + T)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    if mask == "causal":
        m = np.tril(np.ones((S, T), bool), T - S)[None]
    else:
        m = rng.random((B, S, T)) < 0.7
        m[..., 0] = mask != "row_masked"
        if mask == "row_masked":
            m[0, 1] = False
    want = jlayers._sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(m), hd,
                                 chunk=chunk)
    got = layers._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(m), hd,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-4)


def test_chunked_backend_prefill_matches_the_references():
    """Reduced llama110m on backend torch_chunked against the reference on
    xla_chunked, same weights: logits and K/V within the models' 1e-5."""
    jcfg = jax_reduced(jax_get_config("llama110m"))
    cfg = reduced(get_config("llama110m"))
    jmodel = jax_get_model(jcfg, lowering=jcompile.LoweringConfig.from_registry(
        "xla_chunked"))
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    model = get_model(cfg, lowering=LoweringConfig("torch_chunked"))
    prompts = RNG.integers(0, cfg.vocab, (2, 16), dtype=np.int32)
    jl, jkv = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, None)
    tl, tkv = model.prefill(tparams, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]),
                               atol=1e-5, rtol=0)


def test_int8_matmul_dispatch_parity():
    disp = Dispatcher()
    x = torch.from_numpy(RNG.normal(size=(128, 128)).astype(np.float32))
    wq = torch.from_numpy(RNG.integers(-127, 127, size=(128, 128)).astype(
        np.int8))
    scale = torch.from_numpy(RNG.uniform(0.001, 0.02, size=(128,)).astype(
        np.float32))
    got = LoweringConfig("cuda", disp).int8_matmul(x, wq, scale)
    want = kref.int8_matmul_ref(x, wq, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-2,
                               rtol=2e-2)
    rec = disp.records[OpKey("int8_matmul", (128, 128, 128), "float32",
                             "cuda")]
    assert rec.impl == "isax"


# ---------------------------------------------------------------------------
# the environment override, read in the constructor only
# ---------------------------------------------------------------------------

class TestConfigSurface:
    @pytest.mark.parametrize("value,want", [
        ("xla", "torch"), ("xla_chunked", "torch_chunked"), ("pallas", "cuda"),
        ("pallas_interpret", "cuda"), ("torch", "torch"),
        ("torch_chunked", "torch_chunked"), ("cuda", "cuda")])
    def test_env_names_map_to_the_ports(self, monkeypatch, value, want):
        monkeypatch.delenv("REPRO_ATTENTION_IMPL", raising=False)
        monkeypatch.setenv("REPRO_BACKEND", value)
        assert LoweringConfig().backend == want

    def test_default_backend_is_cuda(self, monkeypatch):
        for name in ("REPRO_ATTENTION_IMPL", "REPRO_BACKEND"):
            monkeypatch.delenv(name, raising=False)
        assert LoweringConfig().backend == "cuda"

    def test_no_module_global_impl_flag_left(self):
        assert not hasattr(layers, "_ATTENTION_IMPL")
        assert not hasattr(layers, "_DEFAULT_LOWERING")

    def test_set_default_backend_round_trips(self):
        import repro_torch.compile as C
        prior = C.get_default_backend()
        try:
            assert C.set_default_backend("torch_chunked") == prior
            assert C.get_default_backend() == "torch_chunked"
            assert C.lower("attention", shape=(1, 16, 2, 2, 16, 8),
                           dtype="float32").impl == "chunked"
        finally:
            C.set_default_backend(prior)
