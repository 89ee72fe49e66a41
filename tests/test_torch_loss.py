"""The port's training losses against the JAX package at ``reduced()`` size.

Every one of the 11 archs: ``Model.loss`` and every leaf of its
``torch.autograd.grad`` against ``jax.value_and_grad`` of the reference's
``loss`` (backend ``xla``, the reference trainer's default; the port's
``torch``), from the reference's own initial weights bridged through numpy,
on a batch from ``TokenPipeline``.  Tolerance: the reference's fp32
``atol=2e-5, rtol=2e-4`` (``tests/test_kernels.py:18``), elementwise on the
loss and on every gradient leaf (no leaf needs the relative-norm fallback:
the largest distance seen is ~6e-6).  The moe archs' losses carry the
Switch auxiliary term.  ``remat_wrap``: the gradients under ``dots`` and
``full`` equal those under ``none`` bit for bit, and the bytes autograd
saves (``saved_tensors_hooks``) fall under ``full`` and do not rise under
``dots``; the bytes a forward leaves alive for its backward order
full < dots < none.  The kernel routes raise under autograd.  The SSD
plain version's gradient stays finite at the configs' chunk of 256, where
the reference's is NaN.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import repro.compile as jcompile
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.models import transformer as jtransformer
from repro.models.registry import get_model as jax_get_model
from repro_torch.bridge import params_from_numpy
from repro_torch.compile import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.pointcloud import ops as pcops
from repro_torch.train.trainer import loss_and_grads
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(atol=2e-5, rtol=2e-4)
MOE_ARCHS = ["dbrx-132b", "arctic-480b"]
B, S_TEXT = 2, 16

_CACHE: dict = {}


def _setup(arch: str):
    """(port cfg, reference cfg, reference params, port params), once."""
    if arch not in _CACHE:
        cfg = reduced(get_config(arch))
        jcfg = jax_reduced(jax_get_config(arch))
        jparams = jax_get_model(jcfg).init(jax.random.key(0))
        _CACHE[arch] = (cfg, jcfg, jparams,
                        params_from_numpy(jax.tree.map(np.asarray, jparams)))
    return _CACHE[arch]


def _batch(cfg, step: int = 3, seed: int = 0):
    """(numpy batch, port batch) from the port's pipeline (bit-equal to the
    reference's, tests/test_torch_train.py); vlm's S counts its prefix."""
    S = S_TEXT + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    b = TokenPipeline(cfg, B, S, PipelineConfig(seed=seed)).get_batch(step)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _port_model(cfg, backend="torch"):
    return get_model(cfg, lowering=LoweringConfig(backend))


def _jax_model(jcfg):
    return jax_get_model(
        jcfg, lowering=jcompile.LoweringConfig.from_registry("xla"))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg, jcfg, jparams, params = _setup(arch)
    nb, tb = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(_jax_model(jcfg).loss)(
        jparams, jax.tree.map(jnp.asarray, nb))
    loss, grads = loss_and_grads(_port_model(cfg), params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(jleaves)
    for (path, want), got in zip(jleaves, leaves):
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_carries_the_reference_aux_term(arch):
    """loss(aux_weight=0.01) − loss(aux_weight=0) = 0.01 · the blocks' summed
    Switch loss, the reference's (which is not 0 at these weights)."""
    cfg, jcfg, jparams, params = _setup(arch)
    nb, tb = _batch(cfg)
    jb = jax.tree.map(jnp.asarray, nb)
    jlw = jcompile.LoweringConfig.from_registry("xla")
    jdiff = (float(jtransformer.loss(jparams, jb, jcfg, lowering=jlw))
             - float(jtransformer.loss(jparams, jb, jcfg, aux_weight=0.0,
                                       lowering=jlw)))
    lw = LoweringConfig("torch")
    with torch.no_grad():
        full = transformer.loss(params, tb, cfg, lowering=lw)
        bare = transformer.loss(params, tb, cfg, aux_weight=0.0, lowering=lw)
        x = transformer._inputs_to_x(params, tb, cfg)
        Bx, S, _ = x.shape
        _, aux, _ = transformer.backbone(
            params, x, cfg, transformer._prefill_mask(cfg, S, x.device),
            transformer._positions(Bx, S, x.device), lowering=lw)
    assert jdiff > 1e-4
    np.testing.assert_allclose(float(full - bare), jdiff, rtol=1e-3)
    np.testing.assert_allclose(0.01 * float(aux), jdiff, rtol=1e-3)


# ---------------------------------------------------------------------------
# remat_wrap
# ---------------------------------------------------------------------------

class _LiveBytes(TorchDispatchMode):
    """Weak references to every tensor the ops under it make; ``live()``
    sums the storages still alive (each once): what a forward leaves for
    its backward."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor)]
        return out

    def live(self) -> int:
        gc.collect()
        storages = {}
        for ref in self.refs:
            t = ref()
            if t is not None:
                s = t.untyped_storage()
                storages[s.data_ptr()] = s.nbytes()
        return sum(storages.values())


def _remat_run(cfg, params, tb):
    """(bytes autograd saved outside checkpointed regions, bytes the
    forward left alive, gradients)."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    model = _port_model(cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    mode = _LiveBytes()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), mode:
        loss = model.loss(live, tb)
    alive = mode.live()
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return saved[0], alive, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("arch", ["llama110m", "mamba2-2.7b"])
def test_remat_policies_keep_gradients_and_cut_saved_bytes(arch):
    """Gradients bit-equal across policies.  Saved bytes (the hooks see
    only what autograd saves outside a checkpoint): fewer under ``full``,
    no more under ``dots``.  Bytes the forward leaves alive (which also
    see ``dots``' saved products): full < dots < none."""
    cfg, _, _, params = _setup(arch)
    _, tb = _batch(cfg)
    out = {policy: _remat_run(dataclasses.replace(cfg, remat=policy),
                              params, tb)
           for policy in ("none", "dots", "full")}
    none_saved, none_alive, none_grads = out["none"]
    for policy in ("dots", "full"):
        for got, want in zip(out[policy][2], none_grads):
            assert torch.equal(got, want), policy
    assert out["full"][0] < none_saved / 2
    assert out["dots"][0] <= none_saved
    assert out["full"][1] < out["dots"][1] < none_alive


def test_remat_rejects_an_unknown_policy():
    from repro_torch.models.layers import remat_wrap
    with pytest.raises(ValueError, match="remat policy"):
        remat_wrap(lambda x: x, "everything")


def test_remat_calls_through_when_nothing_needs_grad():
    """Serving paths (no tensor requires grad) run ``fn`` directly."""
    from repro_torch.models.layers import remat_wrap
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return x * 2

    for policy in ("dots", "full"):
        assert torch.equal(remat_wrap(fn, policy)(torch.ones(3)),
                           torch.full((3,), 2.0))
    assert calls == [True, True]


def test_serving_outputs_unchanged_by_remat_policy():
    """prefill under the full configs' remat policies gives the same bits
    as under ``none``: remat only acts where autograd records."""
    cfg, _, _, params = _setup("dbrx-132b")
    _, tb = _batch(cfg)
    outs = [get_model(dataclasses.replace(cfg, remat=p),
                      lowering=LoweringConfig("torch")).prefill(
                          params, {"tokens": tb["tokens"]})[0]
            for p in ("none", "dots", "full")]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


# ---------------------------------------------------------------------------
# The kernel routes' autograd guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama110m", "mamba2-2.7b"])
def test_loss_through_kernel_routes_raises_under_autograd(arch):
    cfg, _, _, params = _setup(arch)
    _, tb = _batch(cfg)
    model = _port_model(cfg, backend="cuda")
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="no gradient.*\"torch\""):
        model.loss(live, tb)
    with torch.no_grad():
        got = model.loss(live, tb)
    want = _port_model(cfg).loss(params, tb)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _route_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    mask = torch.ones((1, 4, 4), dtype=torch.bool)
    xyz = r(1, 256, 3)
    idx = torch.zeros((1, 8, 4), dtype=torch.int32)
    wq = torch.ones((8, 16), dtype=torch.int8)
    return {
        "flash_attention_gqa": (lambda q: kops.flash_attention_gqa(
            q, r(1, 4, 2, 8), r(1, 4, 2, 8), mask, sm_scale=0.3),
            r(1, 4, 2, 8)),
        "rmsnorm": (lambda x: kops.rmsnorm(x, torch.ones(8)), r(4, 8)),
        "int8_matmul": (lambda x: kops.int8_matmul(x, wq, torch.ones(8)),
                        r(4, 16)),
        "ssd_scan": (lambda x: kops.ssd_scan(
            x, r(1, 2, 16).abs(), -torch.ones(2), r(1, 16, 4), r(1, 16, 4)),
            r(1, 2, 16, 4)),
        "kernel_fps": (lambda p: pcops.kernel_fps(p, 8), xyz),
        "kernel_ball_query": (lambda p: pcops.kernel_ball_query(
            p, p[:, :8], 0.5, 4), xyz),
        "kernel_group_aggregate": (lambda f: pcops.kernel_group_aggregate(
            f, idx), r(1, 256, 8)),
    }


@pytest.mark.parametrize("route", sorted(_route_calls()))
def test_every_kernel_route_raises_under_autograd(route):
    call, x = _route_calls()[route]
    with pytest.raises(RuntimeError, match=f"{route}: the hand-written "
                                           f"kernels have no gradient"):
        call(x.clone().requires_grad_(True))
    with torch.no_grad():
        call(x.clone().requires_grad_(True))
    call(x)  # nothing requires grad: autograd records nothing


def test_ssd_chunked_gradient_is_finite_at_a_full_chunk():
    """At the configs' chunk of 256, exp(acum_q − acum_k) above the
    diagonal overflows to inf: the reference's where(tril, exp(.), 0)
    forward is right but its dt gradient is 0 · inf = NaN.  The port
    masks inside the exp: the same forward, finite gradients, within a
    relative norm of 2e-4 of the reference's wherever those are finite."""
    from repro.models.mamba2 import ssd_chunked as jssd
    from repro_torch.models.mamba2 import ssd_chunked
    rng = np.random.default_rng(0)
    b, s, H, P, N = 1, 256, 2, 4, 8
    x = rng.normal(size=(b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, H)))).astype(np.float32)
    A = -np.ones(H, np.float32)
    Bm = rng.normal(size=(b, s, N)).astype(np.float32)
    Cm = rng.normal(size=(b, s, N)).astype(np.float32)

    def f(*a):
        return jnp.sum(jssd(a[0], a[1], jnp.asarray(A), a[2], a[3], 256))

    ins = (x, dt, Bm, Cm)
    jval, jgrads = jax.value_and_grad(f, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, ins))
    assert np.isnan(np.asarray(jgrads[1])).any()   # the reference's dt grad
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = ssd_chunked(ts[0], ts[1], torch.from_numpy(A), ts[2], ts[3],
                    256).sum()
    y.backward()
    np.testing.assert_allclose(float(y.detach()), float(jval), **TOL)
    for t, want in zip(ts, jgrads):
        assert torch.isfinite(t.grad).all()
        want = np.asarray(want, np.float64)
        ok = np.isfinite(want)
        got = t.grad.numpy().astype(np.float64)[ok]
        # a per-leaf relative norm: 256-term fp32 sums in another order
        # leave an element near cancellation ~1e-4 apart
        assert (np.linalg.norm(got - want[ok])
                <= 2e-4 * np.linalg.norm(want[ok]))
