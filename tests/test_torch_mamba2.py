"""The port's SSM slice against the JAX package on the same inputs.

* The SSD scan: the port's plain version (``kernels.ref.ssd_scan_ref``)
  and its routes (``kernels.ops.ssd_scan``, the K7/K8 wrappers, which
  compute the plain version on CPU tensors) against the Pallas kernels
  ``ssd_scan`` / ``ssd_scan_pipelined`` in interpret mode, at atol 5e-4 /
  rtol 1e-3 (tests/test_kernels.py:86).
* ``ssd_chunked`` against the reference's, padding included.
* Reduced mamba2-2.7b (2 layers, d_model 64, 16 heads of 8, state 16,
  fp32), weights from the reference's own initializer bridged through
  numpy: backend ``"torch"`` against ``xla`` and ``"cuda"`` (plain versions
  on CPU tensors) against ``pallas_interpret``, at atol 5e-5 / rtol 1e-4
  (tests/test_models.py:82-83).
* ``ServeEngine.generate`` against the JAX engine's greedy tokens, and
  ``ContinuousEngine`` refusing the family as the reference does.

Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import LoweringConfig as JaxLowering
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.kernels.pipeline import ssd_scan_pipelined as jax_ssd_pipelined
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import mamba2 as jm
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels import ssd_scan as k7
from repro_torch.models import mamba2 as tm
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import layer_params
from repro_torch.serve.engine import ContinuousEngine, ServeEngine

SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
MODEL_TOL = dict(atol=5e-5, rtol=1e-4)
BACKENDS = [("xla", "torch"), ("pallas_interpret", "cuda")]


def _spy(calls, name, fn):
    """``fn`` that first records ``name`` in ``calls``."""
    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    return wrapped


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _scan_inputs(BT, H, S, P, N, seed, dt_range=(0.1, 0.9),
                 a_range=(0.5, 1.5)):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(BT, H, S, P)).astype(f32),
            rng.uniform(*dt_range, size=(BT, H, S)).astype(f32),
            (-rng.uniform(*a_range, size=(H,))).astype(f32),
            rng.normal(size=(BT, S, N)).astype(f32),
            rng.normal(size=(BT, S, N)).astype(f32))


def _port_routes(arrays):
    """Every CPU route of the port on the same inputs (numpy arrays or
    tensors), by name."""
    x, dt, A, B, C = (a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
                      for a in arrays)
    return {
        "ssd_scan_ref": ref.ssd_scan_ref(x, dt, A, B, C),
        "ops.ssd_scan": ops.ssd_scan(x, dt, A, B, C),
        "ops.ssd_scan pipelined": ops.ssd_scan(x, dt, A, B, C,
                                               pipelined=True),
        "ops.ssd_scan baseline": ops.ssd_scan(x, dt, A, B, C,
                                              pipelined=False),
        "K7 wrapper": k7.ssd_scan(x, dt, A, B, C),
        "K8 wrapper": pipeline.ssd_scan_pipelined(x, dt, A, B, C, depth=2),
    }


# (BT, H, S, P, N, chunk of the JAX kernel): the sweep of
# tests/test_kernels.py:75-77, the pipelined shape of
# tests/test_membw_pipeline.py:75-84, a ragged S (the reference's wrapper
# takes chunk 4 at S=100), S=1 and a one-chunk S below the port's 64.
SCAN_CASES = [
    (1, 1, 128, 8, 16, 64),
    (2, 3, 256, 16, 32, 128),
    (1, 2, 512, 64, 128, 256),
    (2, 3, 128, 16, 8, 32),
    (2, 2, 100, 8, 16, 4),
    (2, 2, 1, 8, 16, 1),
    (1, 2, 40, 16, 16, 8),
]


@pytest.mark.parametrize("BT,H,S,P,N,chunk", SCAN_CASES)
def test_ssd_scan_routes_match_jax_kernels(BT, H, S, P, N, chunk):
    arrays = _scan_inputs(BT, H, S, P, N, seed=S + P)
    j = [jnp.asarray(a) for a in arrays]
    want = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    if S // chunk >= 2:
        _close(jax_ssd_pipelined(*j, chunk=chunk, depth=2, interpret=True),
               want, SCAN_TOL, "JAX pipelined vs baseline")
    for name, got in _port_routes(arrays).items():
        assert got.shape == (BT, H, S, P) and got.dtype == torch.float32
        _close(got, want, SCAN_TOL, name)


# (BT, H, S, P, N, chunk of the JAX kernel, dtype): bf16 and fp16 I/O at
# the served widths (two heads), P = 6 (not a multiple of 4), N = 256 (K7
# at a 32-position chunk, K8 at 16 in fp32), and a ragged state in bf16.
DTYPE_SCAN_CASES = [
    (1, 2, 128, 64, 128, 64, "bfloat16"),
    (1, 2, 128, 64, 128, 64, "float16"),
    (2, 2, 96, 6, 16, 32, "float32"),
    (1, 2, 64, 64, 256, 32, "float32"),
    (1, 2, 64, 6, 6, 32, "bfloat16"),
]


@pytest.mark.parametrize("BT,H,S,P,N,chunk,dtype", DTYPE_SCAN_CASES)
def test_ssd_scan_routes_match_jax_kernels_in_every_dtype(BT, H, S, P, N,
                                                         chunk, dtype):
    """x, dt, B, C in ``dtype`` (A fp32), y in x's dtype: the reference
    widens every input to fp32 and rounds y once; fp32 at the scan's
    tolerance, bf16/fp16 at the reference's 2e-2."""
    arrays = list(_scan_inputs(BT, H, S, P, N, seed=S + P + N))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = [jnp.asarray(a, jnp.float32 if i == 2 else jd)
         for i, a in enumerate(arrays)]
    want = jax_ssd_scan(*j, chunk=chunk, interpret=True)
    assert want.dtype == jd
    tol = SCAN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    x, dt, B, C = (t.to(td) for t in (x, dt, B, C))
    for name, got in _port_routes((x, dt, A, B, C)).items():
        assert got.shape == (BT, H, S, P) and got.dtype == td, name
        _close(got.float(), jnp.asarray(want, jnp.float32), tol, name)


def test_ssd_scan_strong_decay_stays_finite():
    """dt·A ≈ -7 a step: exp(acum_q - acum_k) for k > q overflows fp32
    within a chunk, so every route must select, not multiply by a mask."""
    arrays = _scan_inputs(2, 3, 128, 8, 16, seed=7, dt_range=(3.0, 5.0),
                          a_range=(1.5, 2.0))
    j = [jnp.asarray(a) for a in arrays]
    want = jax_ssd_scan(*j, chunk=64, interpret=True)
    assert bool(jnp.isfinite(want).all())
    for name, got in _port_routes(arrays).items():
        assert torch.isfinite(got).all(), name
        _close(got, want, SCAN_TOL, name)
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrays)
    chunked = tm.ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A, B, C,
                             64).transpose(1, 2)
    assert torch.isfinite(chunked).all()
    _close(chunked, want, SCAN_TOL, "ssd_chunked")


@pytest.mark.parametrize("b,s,chunk", [(2, 48, 16), (2, 64, 16), (1, 7, 4),
                                       (2, 20, 256)])
def test_ssd_chunked_matches_reference(b, s, chunk):
    """tests/test_models.py:86-95's padding case (48 with chunk 16) among
    others."""
    rng = np.random.default_rng(s)
    H, P, N = 3, 4, 5
    arrays = (rng.normal(size=(b, s, H, P)), rng.uniform(0.1, 1.0, (b, s, H)),
              -rng.uniform(0.5, 1.5, (H,)), rng.normal(size=(b, s, N)),
              rng.normal(size=(b, s, N)))
    arrays = [a.astype(np.float32) for a in arrays]
    want = jm.ssd_chunked(*[jnp.asarray(a) for a in arrays], chunk=chunk)
    got = tm.ssd_chunked(*[torch.from_numpy(a) for a in arrays], chunk)
    _close(got, want, MODEL_TOL)
    want_h = jm._final_state(*[jnp.asarray(a) for a in arrays[:4]], chunk)
    got_h = tm._final_state(*[torch.from_numpy(a) for a in arrays[:4]], chunk)
    _close(got_h, want_h, MODEL_TOL, "final state")


def test_softplus_matches_jax_in_fp32():
    x = np.linspace(-30, 40, 7001, dtype=np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Reduced mamba2-2.7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfgs():
    return (reduced(get_config("mamba2-2.7b")),
            jax_reduced(jax_get_config("mamba2-2.7b")))


@pytest.fixture(scope="module")
def params(cfgs):
    _, jcfg = cfgs
    jparams = jm.init_params(jcfg, jax.random.key(0))
    # nonzero A_log, dt_bias and conv bias so that every term is exercised
    rng = np.random.default_rng(5)
    blocks = dict(jparams["blocks"])
    for name in ("A_log", "dt_bias", "conv_b"):
        blocks[name] = jnp.asarray(
            0.3 * rng.normal(size=blocks[name].shape), blocks[name].dtype)
    jparams = dict(jparams, blocks=blocks)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _lowerings(backends):
    jb, tb = backends
    return JaxLowering.from_registry(jb), LoweringConfig(tb)


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def test_config_matches_reference(cfgs):
    cfg, jcfg = cfgs
    for c, j in ((cfg, jcfg), (get_config("mamba2-2.7b"),
                               jax_get_config("mamba2-2.7b"))):
        assert dataclasses.asdict(c) == dataclasses.asdict(j)


def test_port_init_matches_reference_shapes_and_dtypes(cfgs, params):
    cfg, _ = cfgs
    jparams, _ = params
    mine = get_model(cfg).init(0, "cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path


@pytest.mark.parametrize("S", [20, 16, 2])
@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_ssm_block_and_decode_match_reference(cfgs, params, backends, S):
    cfg, jcfg = cfgs
    jparams, tparams = params
    jl, tl = _lowerings(backends)
    u = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(
        np.float32)
    jbp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    tbp = layer_params(tparams["blocks"], 0)
    jout, jcache = jm.ssm_block(jbp, jnp.asarray(u), jcfg, collect_cache=True,
                                lowering=jl)
    tout, tcache = tm.ssm_block(tbp, torch.from_numpy(u), cfg,
                                collect_cache=True, lowering=tl)
    _close(tout, jout, MODEL_TOL, "block out")
    _close(tcache["state"], jcache["state"], MODEL_TOL, "final state")
    w1 = cfg.ssm.conv_width - 1
    if S >= w1:   # the reference's conv tail is shorter below the window
        _close(tcache["conv"], jcache["conv"], MODEL_TOL, "conv tail")
        u1 = np.random.default_rng(S + 1).normal(
            size=(2, 1, cfg.d_model)).astype(np.float32)
        jd, jc2 = jm.ssm_block_decode(jbp, jnp.asarray(u1), jcfg, jcache,
                                      lowering=jl)
        td, tc2 = tm.ssm_block_decode(tbp, torch.from_numpy(u1), cfg, tcache,
                                      lowering=tl)
        assert tc2 is tcache                       # updated in place
        _close(td, jd, MODEL_TOL, "decode out")
        _close(tc2["conv"], jc2["conv"], MODEL_TOL, "decode conv")
        _close(tc2["state"], jc2["state"], MODEL_TOL, "decode state")
    else:
        assert tuple(tcache["conv"].shape) == (2, w1, jcache["conv"].shape[-1])
        _close(tcache["conv"][:, w1 - S:], jcache["conv"], MODEL_TOL,
               "conv tail")
        assert float(tcache["conv"][:, :w1 - S].abs().max()) == 0.0


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_prefill_and_decode_steps_match_reference(cfgs, params, backends):
    cfg, jcfg = cfgs
    jparams, tparams = params
    jl, tl = _lowerings(backends)
    jmodel = jax_get_model(jcfg, lowering=jl)
    model = get_model(cfg, lowering=tl)
    prompts = _prompts(cfg, 2, 20, seed=1)
    jlog, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, None)
    tlog, tc = model.prefill(tparams, {"tokens": torch.from_numpy(prompts)})
    _close(tlog, jlog, MODEL_TOL, "prefill logits")
    for key in ("conv", "state"):
        _close(tc[key], jc[key], MODEL_TOL, f"prefill cache {key}")
    toks = _prompts(cfg, 2, 3, seed=2)
    for i in range(3):
        jlog, jc = jmodel.decode_step(jparams, jnp.asarray(toks[:, i]), jc,
                                      jnp.int32(20 + i))
        tlog, tc = model.decode_step(tparams, torch.from_numpy(toks[:, i]),
                                     tc, 20 + i)
        _close(tlog, jlog, MODEL_TOL, f"decode step {i} logits")
        _close(tc["state"], jc["state"], MODEL_TOL, f"decode step {i} state")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_decode_matches_prefill(cfgs, backend):
    """decode_step(t | prefix) equals prefill(prefix + t), as
    tests/test_models.py:63-82 holds the reference."""
    cfg, _ = cfgs
    model = get_model(cfg, lowering=LoweringConfig(backend))
    params = model.init(1, "cpu")
    toks = torch.from_numpy(_prompts(cfg, 2, 17, seed=3))
    _, caches = model.prefill(params, {"tokens": toks[:, :16]}, 20)
    got, _ = model.decode_step(params, toks[:, 16], caches, 16)
    want, _ = model.prefill(params, {"tokens": toks}, 20)
    _close(got, want, MODEL_TOL)


def test_backends_route_the_scan_as_lowered(cfgs, params, monkeypatch):
    """Backend "cuda" runs a scan kernel (K7 or K8, one launch a layer)
    and never ``ssd_chunked``; backend "torch" the reverse."""
    cfg, _ = cfgs
    _, tparams = params
    calls = []
    for mod, name, label in ((ops, "_ssd_scan", "ssd_scan"),
                             (ops, "ssd_scan_pipelined", "ssd_scan"),
                             (tm, "ssd_chunked", "ssd_chunked")):
        monkeypatch.setattr(mod, name, _spy(calls, label,
                                            getattr(mod, name)))
    tokens = torch.from_numpy(_prompts(cfg, 2, 20, seed=4))
    for backend, want in (("cuda", "ssd_scan"), ("torch", "ssd_chunked")):
        calls.clear()
        get_model(cfg, lowering=LoweringConfig(backend)).prefill(
            tparams, {"tokens": tokens})
        assert calls == [want] * cfg.n_layers, backend


@pytest.mark.parametrize("S,pipelined,want", [
    (40, None, "k8"), (64, None, "k8"), (65, None, "k8"), (512, None, "k8"),
    (512, False, "k7"), (40, True, "k8"), (100, True, "k8"), (16, None, "k7"),
    (16, True, "k7")])
def test_ops_route_k7_for_one_chunk_and_k8_for_more(monkeypatch, S,
                                                    pipelined, want):
    """K7 for a sweep of one 16-position chunk (K8 is not offered: a single
    streamed tile never pipelines); above that the cost model's pick
    (``schedule.ssd_schedule``), K8 at these widths (BT=1, H=2, P=64,
    N=128); ``pipelined`` forces a kernel where it is offered."""
    calls, depths = [], []
    monkeypatch.setattr(ops, "_ssd_scan", _spy(calls, "k7", ops._ssd_scan))
    monkeypatch.setattr(ops, "ssd_scan_pipelined", _spy(
        calls, "k8", lambda *a, depth: depths.append(depth)
        or pipeline.ssd_scan_pipelined(*a, depth=depth)))
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _scan_inputs(1, 2, S, 64, 128, seed=0))
    ops.ssd_scan(x, dt, A, B, C, pipelined=pipelined)
    assert calls == [want]
    assert depths == ([pipeline.ssd_depth(64, 128, S)] if want == "k8"
                      else [])


def test_ssd_ring_depth_rule():
    """K8's ring of 16-position chunks: of the depths 2-4 that fit 227 KB
    (no deeper than the sweep), the one that leaves room for the most
    blocks an SM, the deepest of equals.  With the state in registers only
    B and C rows of N bound the ring (fp32 at N = 780 fits none) and K7's
    block; the lowering's envelope still refuses P = N = 256."""
    assert pipeline.ssd_depth(64, 128, 512) == 2
    assert pipeline.ssd_ring_bytes(64, 128, 4) <= pipeline.MAX_SMEM
    assert pipeline.blocks_fit(pipeline.ssd_ring_bytes(64, 128, 2)) == 4
    assert pipeline.blocks_fit(pipeline.ssd_ring_bytes(64, 128, 3)) == 3
    assert pipeline.ssd_depth(64, 128, 65) == 2
    assert pipeline.ssd_depth(8, 16, 20) == 2
    assert pipeline.ssd_depth(128, 128, 512) == 2
    assert pipeline.ssd_plan(64, 256, 512) == 2
    assert pipeline.ssd_plan(64, 256, 512, itemsize=2) == 3
    assert pipeline.ssd_plan(128, 256, 512) == 2
    assert pipeline.ssd_plan(4, 780, 512) is None
    with pytest.raises(ValueError):
        pipeline.ssd_depth(4, 780, 512)
    assert all(k7.block_fits(P, N, k7.smem_bytes(P, N))
               for P, N in ((64, 128), (6, 128), (64, 256), (4, 780)))
    assert k7.ssd_tileable(6, 128) and k7.ssd_tileable(64, 256)
    assert k7.ssd_tileable(4, 780)
    assert not k7.ssd_tileable(256, 256)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_serve_engine_tokens_match_jax_engine(cfgs, params, backends):
    cfg, jcfg = cfgs
    jparams, tparams = params
    jl, tl = _lowerings(backends)
    prompts = _prompts(cfg, 2, 20, seed=6)
    jeng = JaxServeEngine(jcfg, jparams, max_len=40, lowering=jl)
    want, _ = jeng.generate({"tokens": jnp.asarray(prompts)}, 8)
    eng = ServeEngine(cfg, tparams, max_len=40, lowering=tl, device="cpu")
    got, stats = eng.generate({"tokens": prompts}, 8)
    np.testing.assert_array_equal(got, want)
    assert stats.tokens == 8 and stats.ttft_s > 0


def test_continuous_engine_refuses_ssm_as_reference_does(cfgs):
    """tests/test_serve.py:239-242: no paged decode path for the family."""
    cfg, _ = cfgs
    with pytest.raises(ValueError, match="no paged decode path"):
        ContinuousEngine(cfg, max_batch=2, page_size=16, max_len=64,
                         device="cpu")


def test_launcher_serves_mamba2_static_and_refuses_continuous():
    from repro_torch.launch.serve import main
    stats = main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "12", "--tokens", "4"])
    assert stats.tokens == 4
    with pytest.raises(ValueError, match="no paged decode path"):
        main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
              "--continuous"])
