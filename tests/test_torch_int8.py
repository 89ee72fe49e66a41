"""The port's int8 slice against the JAX package on the same inputs.

* The int8 GEMM: the port's plain version (``kernels.ref.int8_matmul_ref``)
  and its entry point ``LoweringConfig("cuda").int8_matmul`` (which routes
  to the K4/K5 wrappers, computing the plain version on CPU tensors)
  against the Pallas kernels ``int8_matmul`` / ``int8_matmul_pipelined`` in
  interpret mode, at atol 1e-2 (fp32) / 0.5 (bf16, fp16), rtol 2e-2
  (tests/test_kernels.py:69); ``lower("int8_matmul")`` against
  ``repro.compile.lower``; the K4/K5 route by call spies.
* K6's plain version against ``flash_attention_int8kv`` in interpret mode
  at atol 2e-5 / rtol 1e-4 (tests/test_kernels.py:124).
* ``quantize_params_int8``: ``q`` bit for bit, ``scale`` exactly, the
  dequantized tree exactly, ``quantization_error`` within 1e-6 relative.
* ``StaticBatchEngine`` (fp and int8) against the JAX engine's per-step
  logits under teacher forcing at atol 1e-5 (tests/test_serve.py:75), and
  the ``quantize=True`` engines loading the reference's weights.

Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compile as jax_compile
from repro.compile import LoweringConfig as JaxLowering
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.kernels.flash_attention import \
    flash_attention_int8kv as jax_flash_int8kv
from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.kernels.pipeline import \
    int8_matmul_pipelined as jax_int8_matmul_pipelined
from repro.models.registry import get_model as jax_get_model
from repro.serve import engine as jax_engine
from repro.serve.scheduler import make_poisson_workload as jax_workload
from repro_torch.bridge import params_from_numpy
from repro_torch.compile.config import LoweringConfig, lower
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels.flash_attention import flash_attention_int8kv
from repro_torch.kernels.int8_matmul import int8_matmul
from repro_torch.serve.engine import (ContinuousEngine, ServeEngine,
                                      StaticBatchEngine, quantization_error,
                                      quantize_params_int8)
from repro_torch.serve.scheduler import make_poisson_workload

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
GEMM_TOL = {"float32": dict(atol=1e-2, rtol=2e-2),
            "bfloat16": dict(atol=0.5, rtol=2e-2),
            "float16": dict(atol=0.5, rtol=2e-2)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _gemm_inputs(M, N, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq = rng.integers(-127, 127, size=(N, K)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, size=(N,)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    port = (torch.from_numpy(x).to(tdt), torch.from_numpy(wq),
            torch.from_numpy(scale))
    jx = (jnp.asarray(x, jdt), jnp.asarray(wq), jnp.asarray(scale))
    return port, jx


# ---------------------------------------------------------------------------
# int8 GEMM: plain version and entry point against the Pallas kernels
# ---------------------------------------------------------------------------

# (M, N, K): tests/test_kernels.py:57's shapes, and llama-like decode and
# prefill rows at the reduced config's width (d 64, d_ff 128, vocab 512)
GEMM_SHAPES = [(128, 128, 128), (256, 384, 512), (128, 256, 1024),
               (8, 512, 64), (32, 128, 64)]


@pytest.mark.parametrize("kernel", ["baseline", "pipelined"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
def test_int8_matmul_matches_pallas_kernels(M, N, K, dtype, kernel):
    (x, wq, scale), (jx, jwq, jscale) = _gemm_inputs(M, N, K, dtype)
    fn = jax_int8_matmul if kernel == "baseline" else jax_int8_matmul_pipelined
    want = np.asarray(fn(jx, jwq, jscale, interpret=True), np.float32)
    for got in (ref.int8_matmul_ref(x, wq, scale),
                LoweringConfig("cuda").int8_matmul(x, wq, scale),
                LoweringConfig("torch").int8_matmul(x, wq, scale)):
        assert got.dtype == x.dtype and got.shape == (M, N)
        np.testing.assert_allclose(_np(got), want, **GEMM_TOL[dtype])


# (M, K, N) keys: odd, the unembedding at one row, ragged prefill and K,
# and llama110m's projections at the decode and prefill rows
INT8_KEYS = [(3, 5, 7), (1, 768, 32000), (100, 768, 2048), (8, 100, 768),
             (8, 768, 768), (8, 768, 32000), (512, 768, 2048),
             (512, 2048, 768), (64, 768, 768), (2048, 768, 32000)]


@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas_interpret"),
                                                 ("torch", "xla")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", INT8_KEYS)
def test_int8_lowering_matches_reference_dispatch(shape, dtype, backend,
                                                  ref_backend):
    """``impl`` as the reference's on every shape and float dtype."""
    want = jax_compile.lower("int8_matmul", shape=shape, dtype=dtype,
                             backend=ref_backend).impl
    got = lower("int8_matmul", shape=shape, dtype=getattr(torch, dtype),
                backend=backend)
    assert got.impl == want, got.note


def _spy(calls, name, fn):
    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return wrapped


@pytest.fixture
def route_calls(monkeypatch):
    """Names of the K4/K5 wrappers ``ops.int8_matmul`` calls, in order."""
    calls = []
    monkeypatch.setattr(ops, "_int8_matmul",
                        _spy(calls, "K4", ops._int8_matmul))
    monkeypatch.setattr(ops, "int8_matmul_pipelined",
                        _spy(calls, "K5", ops.int8_matmul_pipelined))
    return calls


@pytest.mark.parametrize("M,K,pipelined,want", [
    (8, 768, None, "K5"), (1, 768, None, "K5"), (64, 768, None, "K5"),
    (65, 768, None, "K4"), (512, 768, None, "K4"), (512, 2048, True, "K5"),
    (8, 768, False, "K4"), (8, 100, None, "K4"), (8, 100, True, "K4"),
    (7, 16, None, "K4"), (8, 24, None, "K4"), (8, 64, True, "K4"),
    (7, 80, None, "K5")])
def test_int8_route_k5_for_decode_rows_and_k4_otherwise(route_calls, M, K,
                                                        pipelined, want):
    (x, wq, scale), _ = _gemm_inputs(M, 40, K, "float32")
    got = ops.int8_matmul(x, wq, scale, pipelined=pipelined)
    assert route_calls == [want]
    torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, scale))


def test_int8_entry_point_routes_only_where_lower_says_isax(route_calls):
    (x, wq, scale), _ = _gemm_inputs(8, 40, 128, "float32")
    LoweringConfig("cuda").int8_matmul(x, wq, scale)
    LoweringConfig("cuda").int8_matmul(torch.cat([x] * 9), wq, scale)
    LoweringConfig("torch").int8_matmul(x, wq, scale)
    got = LoweringConfig("cuda").int8_matmul(x.half(), wq, scale)
    assert route_calls == ["K5", "K4", "K5"]
    assert got.dtype == torch.float16


@pytest.mark.parametrize("K,itemsize,want", [(768, 4, 4), (2048, 2, 4),
                                             (64, 4, 2), (128, 4, 2),
                                             (192, 4, 3), (16, 2, 2)])
def test_int8_ring_depth(K, itemsize, want):
    assert pipeline.int8_depth(K, itemsize) == want
    assert pipeline.int8_ring_bytes(itemsize, want) <= pipeline.MAX_SMEM


# ---------------------------------------------------------------------------
# K6: int8-K/V flash attention, plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _int8kv_inputs(B, S, H, K, T, hd, seed):
    """q, float K/V, their int8 codes and per-KV-head scales
    (tests/test_kernels.py:107-114), and a causal mask."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    kf = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    vf = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    ks = (np.abs(kf).max(axis=(0, 1, 3)) / 127.0).astype(np.float32)
    vs = (np.abs(vf).max(axis=(0, 1, 3)) / 127.0).astype(np.float32)
    k8 = np.clip(np.round(kf / ks[None, None, :, None]), -127, 127)
    v8 = np.clip(np.round(vf / vs[None, None, :, None]), -127, 127)
    mask = np.tril(np.ones((S, T), bool), k=T - S)[None]
    return q, kf, vf, k8.astype(np.int8), v8.astype(np.int8), ks, vs, mask


@pytest.mark.parametrize("B,S,H,K,T,hd,masked_rows", [
    (1, 128, 4, 2, 256, 64, 0),      # tests/test_kernels.py:101-104
    (2, 128, 8, 1, 128, 128, 0),
    (1, 64, 4, 2, 64, 32, 8)])       # rows 0..7 fully masked
def test_flash_int8kv_plain_matches_pallas_kernel(B, S, H, K, T, hd,
                                                  masked_rows):
    q, kf, vf, k8, v8, ks, vs, mask = _int8kv_inputs(B, S, H, K, T, hd, S + hd)
    mask[:, :masked_rows, :] = False
    scale = hd ** -0.5
    want = np.asarray(jax_flash_int8kv(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(mask), sm_scale=scale, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k8, v8, ks, vs, mask)]
    for got in (ref.flash_attention_int8kv_ref(*t, sm_scale=scale),
                flash_attention_int8kv(*t, sm_scale=scale)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
        assert not got[:, :masked_rows].any()
    fp = ref.flash_attention_ref(t[0], torch.from_numpy(kf),
                                 torch.from_numpy(vf), t[5], sm_scale=scale)
    assert float((got - fp).abs().max()) < 0.1     # int8 quantization noise


# ---------------------------------------------------------------------------
# quantize_params_int8 / quantization_error against the reference
# ---------------------------------------------------------------------------

def _jax_params(arch: str, full: bool = False, dtype: str | None = None):
    jcfg = jax_get_config(arch)
    if not full:
        jcfg = jax_reduced(jcfg)
    if dtype:
        jcfg = dataclasses.replace(jcfg, param_dtype=dtype)
    return jcfg, jax_get_model(jcfg).init(jax.random.key(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and "q" not in tree:
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _assert_quantized_like_reference(jparams):
    jq, jdeq = jax_engine.quantize_params_int8(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    q, deq = quantize_params_int8(params)
    want, got = _flat(jq), _flat(q)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            assert g["dtype"] == w["dtype"], name
            assert g["q"].dtype == torch.int8, name
            np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]),
                                          err_msg=name)
            assert g["scale"].dtype == torch.float32
            assert float(g["scale"]) == float(w["scale"]), name
        else:
            assert g.dim() < 2
    want_deq = params_from_numpy(jax.tree.map(np.asarray, jdeq(jq)))
    got_deq = deq(q)
    for name, w in _flat(want_deq).items():
        g = _flat(got_deq)[name]
        assert g.dtype == w.dtype and torch.equal(g, w), name
    want_err = jax_engine.quantization_error(jparams, jq, jdeq)
    got_err = quantization_error(params, q, deq)
    assert 0 < want_err < 0.05
    assert abs(got_err - want_err) <= 1e-6 * want_err


@pytest.mark.parametrize("arch,dtype", [("llama110m", None),
                                        ("mamba2-2.7b", "bfloat16")])
def test_quantize_params_int8_bit_exact(arch, dtype):
    _assert_quantized_like_reference(_jax_params(arch, dtype=dtype)[1])


def test_quantize_params_int8_bit_exact_at_full_llama110m_width():
    _assert_quantized_like_reference(_jax_params("llama110m", full=True)[1])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _record_jax_static(eng, log):
    """Wrap the JAX static engine's prefill/decode so every step's logits
    land in ``log``; its own greedy tokens drive the run."""
    model = eng.model
    prefill = jax.jit(lambda p, b: model.prefill(p, b, eng.max_len))
    decode = jax.jit(model.decode_step)

    def _prefill(p, b):
        logits, caches = prefill(p, b)
        log.append(np.asarray(logits))
        return logits, caches

    def _decode(p, t, c, pos):
        logits, c = decode(p, t, c, pos)
        log.append(np.asarray(logits))
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), c

    eng._prefill, eng._decode = _prefill, _decode


def _force_torch_static(eng, jax_log, log):
    """Wrap the port's static engine so each step's logits land in ``log``
    while the tokens fed on are the JAX run's."""
    model = eng.model
    step = iter(jax_log)

    def _prefill(p, b):
        logits, caches = model.prefill(p, b, eng.max_len)
        log.append(logits.numpy().copy())
        forced = np.full_like(log[-1], -1e9)
        forced[np.arange(len(forced)), np.argmax(next(step), axis=-1)] = 0.0
        return torch.from_numpy(forced), caches

    def _decode(p, t, c, pos):
        logits, c = model.decode_step(p, t, c, pos)
        log.append(logits.numpy().copy())
        nxt = np.argmax(next(step), axis=-1).astype(np.int32)
        return torch.from_numpy(nxt), c

    eng._prefill, eng._decode = _prefill, _decode


@pytest.mark.parametrize("arch,backend,quantize", [
    ("llama110m", "torch", False), ("llama110m", "cuda", False),
    ("llama110m", "torch", True), ("llama110m", "cuda", True),
    ("mamba2-2.7b", "torch", True)])
def test_static_batch_engine_matches_jax_engine(arch, backend, quantize):
    """Per-step logits of every group's prefill and decode steps against the
    JAX ``StaticBatchEngine`` (backend xla), teacher forced, on the
    reference's weights, at atol 1e-5 (llama110m, tests/test_serve.py:75)
    or 5e-5 / rtol 1e-4 (mamba2, tests/test_models.py:82); with
    ``quantize`` both engines quantize them."""
    jcfg, jparams = _jax_params(arch)
    tol = (dict(atol=1e-5, rtol=0) if arch == "llama110m"
           else dict(atol=5e-5, rtol=1e-4))
    kw = dict(batch=3, max_len=64, prompt_buckets=(16, 32),
              quantize=quantize)
    jeng = jax_engine.StaticBatchEngine(
        jcfg, jparams, seed=0, lowering=JaxLowering.from_registry("xla"), **kw)
    teng = StaticBatchEngine(
        reduced(get_config(arch)),
        params_from_numpy(jax.tree.map(np.asarray, jparams)),
        lowering=LoweringConfig(backend), device="cpu", **kw)
    workload = dict(rate=1.5, vocab=jcfg.vocab, prompt_lens=(5, 16, 27),
                    out_lens=(1, 5, 9), seed=4)
    jlog, tlog = [], []
    _record_jax_static(jeng, jlog)
    jreqs = jax_workload(8, **workload)
    jstats = jeng.run(jreqs)
    _force_torch_static(teng, jlog, tlog)
    treqs = make_poisson_workload(8, **workload)
    tstats = teng.run(treqs)

    assert len(tlog) == len(jlog) > 10
    assert tstats.decode_steps == jstats.decode_steps > 0
    for i, (jl, tl) in enumerate(zip(jlog, tlog)):
        np.testing.assert_allclose(tl, jl, err_msg=f"step {i}", **tol)
    for a, b in zip(treqs, jreqs):
        assert a.out_tokens == b.out_tokens, a.rid
        assert len(a.out_tokens) == a.max_new_tokens
        assert a.t_first_token is not None and a.t_done is not None


def test_static_batch_engine_refuses_a_group_past_max_len():
    cfg = reduced(get_config("llama110m"))
    eng = StaticBatchEngine(cfg, batch=2, max_len=32, prompt_buckets=(16,),
                            device="cpu")
    reqs = make_poisson_workload(2, rate=2.0, vocab=cfg.vocab,
                                 prompt_lens=(8,), out_lens=(20,), seed=0)
    with pytest.raises(ValueError, match="max_len"):
        eng.run(reqs)


def test_static_batch_engine_raises_without_cuda_when_no_device_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticBatchEngine(reduced(get_config("llama110m")))


@pytest.mark.parametrize("kind", ["serve", "continuous", "static"])
def test_quantize_true_engines_load_the_reference_weights(kind):
    jcfg, jparams = _jax_params("llama110m")
    cfg = reduced(get_config("llama110m"))
    lw = JaxLowering.from_registry("xla")
    raw = params_from_numpy(jax.tree.map(np.asarray, jparams))
    if kind == "serve":
        jeng = jax_engine.ServeEngine(jcfg, jparams, max_len=32,
                                      quantize=True, lowering=lw)
        teng = ServeEngine(cfg, raw, max_len=32, quantize=True, device="cpu")
    elif kind == "continuous":
        kw = dict(max_batch=2, page_size=16, max_len=64, prompt_buckets=(16,),
                  quantize=True)
        jeng = jax_engine.ContinuousEngine(jcfg, jparams, lowering=lw, **kw)
        teng = ContinuousEngine(cfg, raw, device="cpu", **kw)
    else:
        jeng = jax_engine.StaticBatchEngine(jcfg, jparams, batch=2, max_len=32,
                                            quantize=True, lowering=lw)
        teng = StaticBatchEngine(cfg, raw, batch=2, max_len=32, quantize=True,
                                 device="cpu")
    want = _flat(params_from_numpy(jax.tree.map(np.asarray, jeng.params)))
    got = _flat(teng.params)
    assert sorted(got) == sorted(want)
    assert not all(torch.equal(g, w) for g, w in zip(_flat(raw).values(),
                                                     got.values()))
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_serve_launcher_int8_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama110m", "--smoke", "--int8", "--device", "cpu",
          "--batch", "2", "--tokens", "3", "--prompt-len", "8"])
    main(["--arch", "llama110m", "--smoke", "--int8", "--continuous",
          "--device", "cpu", "--requests", "2", "--tokens", "4"])
    out = capsys.readouterr().out
    assert "int8=True" in out and "continuous int8=True" in out


def test_int8_kernel_wrappers_refuse_non_cuda_devices():
    x = torch.ones((8, 64), device="meta")
    wq = torch.ones((16, 64), dtype=torch.int8, device="meta")
    scale = torch.ones((16,), device="meta")
    for call in (lambda: int8_matmul(x, wq, scale),
                 lambda: pipeline.int8_matmul_pipelined(x, wq, scale, depth=2)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    q = torch.ones((1, 64, 4, 64), device="meta")
    k8 = torch.ones((1, 64, 2, 64), dtype=torch.int8, device="meta")
    ks = torch.ones((2,), device="meta")
    mask = torch.ones((1, 64, 64), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention_int8kv(q, k8, k8, ks, ks, mask, sm_scale=0.125)
