"""The port's dense model against the JAX package on the same weights.

Reduced llama110m (2 layers, d_model 64, 4 heads of 16), weights from the
reference's own initializer bridged through numpy.  Backend ``"torch"`` is
held against ``xla`` and backend ``"cuda"`` (plain versions on CPU tensors)
against ``pallas_interpret``.  Logits and KV use atol 1e-5, the tolerance
of tests/test_serve.py:75.
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
from repro.models.registry import get_model as jax_get_model
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import params_from_numpy
from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models.registry import get_model
from repro_torch.serve.kv_cache import PagedKVCache

BACKENDS = [("xla", "torch"), ("pallas_interpret", "cuda")]
ATOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def cfgs():
    return reduced(get_config("llama110m")), jax_reduced(
        jax_get_config("llama110m"))


@pytest.fixture(scope="module")
def params(cfgs):
    _, jcfg = cfgs
    jparams = jax_get_model(jcfg).init(jax.random.key(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _models(cfgs, backends):
    cfg, jcfg = cfgs
    jb, tb = backends
    return (jax_get_model(jcfg, lowering=JaxLowering.from_registry(jb)),
            get_model(cfg, lowering=LoweringConfig(tb)))


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **ATOL,
                               err_msg=what)


def test_config_matches_reference(cfgs):
    """Every config of the reference's registry, field for field, full
    and reduced."""
    from repro.configs.registry import available_configs as jax_available
    from repro_torch.configs.registry import available_configs
    assert available_configs() == jax_available()
    for name in available_configs():
        full, jfull = get_config(name), jax_get_config(name)
        for a, b in ((full, jfull), (reduced(full), jax_reduced(jfull))):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name


def test_port_init_matches_reference_shapes(cfgs, params):
    cfg, _ = cfgs
    jparams, _ = params
    mine = get_model(cfg).init(0, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert node.dtype == torch.float32


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_prefill_logits_and_kv(cfgs, params, backends):
    cfg, _ = cfgs
    jmodel, model = _models(cfgs, backends)
    jparams, tparams = params
    prompts = _prompts(cfg, 2, 16, seed=1)
    jl, jkv = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, None)
    tl, tkv = model.prefill(tparams, {"tokens": torch.from_numpy(prompts)})
    _close(tl, jl, "prefill logits")
    _close(tkv["k"], jkv["k"], "prefill K")
    _close(tkv["v"], jkv["v"], "prefill V")


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_prefill_at_right_padded_bucket(cfgs, params, backends):
    cfg, _ = cfgs
    jmodel, model = _models(cfgs, backends)
    jparams, tparams = params
    PL, BUCKET = 11, 16
    padded = np.zeros((1, BUCKET), np.int32)
    padded[0, :PL] = _prompts(cfg, 1, PL, seed=2)
    jl, jkv = jmodel.prefill_at(jparams, {"tokens": jnp.asarray(padded)},
                                jnp.int32(PL))
    tl, tkv = model.prefill_at(tparams, {"tokens": torch.from_numpy(padded)},
                               PL)
    _close(tl, jl, "prefill_at logits")
    _close(tkv["k"][:, :, :PL], jkv["k"][:, :, :PL], "prefill_at K")
    # the padded prompt's logits equal the unpadded prompt's (causality)
    ul, _ = model.prefill(tparams, {"tokens": torch.from_numpy(padded[:, :PL])})
    _close(tl, ul, "prefill_at vs unpadded prefill")


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_static_decode_step(cfgs, params, backends):
    cfg, _ = cfgs
    jmodel, model = _models(cfgs, backends)
    jparams, tparams = params
    B, PL, MAXLEN = 2, 16, 32
    prompts = _prompts(cfg, B, PL, seed=3)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, MAXLEN)
    tl, tc = model.prefill(tparams, {"tokens": torch.from_numpy(prompts)},
                           MAXLEN)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                  jnp.int32(PL))
    tl2, tc2 = model.decode_step(tparams, torch.from_numpy(tok), tc, PL)
    _close(tl2, jl2, "static decode logits")
    _close(tc2["k"], jc2["k"], "static decode K cache")
    _close(tc2["v"], jc2["v"], "static decode V cache")


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
def test_paged_decode_step(cfgs, params, backends):
    """Two live slots of three (slot 1 inactive) through one paged decode
    step: logits of the live slots and both page pools match (the port's
    pools carry one spare page past the reference's, which takes the
    inactive slot's write)."""
    cfg, jcfg = cfgs
    jmodel, model = _models(cfgs, backends)
    jparams, tparams = params
    B, PS, MAXLEN = 3, 16, 64
    lens = {0: 16, 2: 9}
    jcache = JaxPagedKVCache(jcfg, max_batch=B, page_size=PS,
                             n_pages=B * MAXLEN // PS, max_len=MAXLEN)
    tcache = PagedKVCache(cfg, max_batch=B, page_size=PS,
                          n_pages=B * MAXLEN // PS, max_len=MAXLEN)
    toks = np.zeros((B,), np.int32)
    for slot, n in lens.items():
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = _prompts(cfg, 1, n, seed=10 + slot)
        jcache.bind_slot(slot, n + 8)
        tcache.bind_slot(slot, n + 8)
        jl, jkv = jmodel.prefill_at(jparams, {"tokens": jnp.asarray(padded)},
                                    jnp.int32(n))
        _, tkv = model.prefill_at(tparams,
                                  {"tokens": torch.from_numpy(padded)}, n)
        jcache.write_prefill(slot, jkv, n)
        tcache.write_prefill(slot, tkv, n)
        toks[slot] = int(jnp.argmax(jl[0]))
    live = set(lens)
    jpt, jsl, jact = jcache.device_views(live)
    tpt, tsl, tact = tcache.device_views(live)
    jl, jk, jv = jmodel.decode_paged(jparams, jnp.asarray(toks),
                                     jcache.k_pages, jcache.v_pages,
                                     jpt, jsl, jact)
    tl, tk, tv = model.decode_paged(tparams, torch.from_numpy(toks),
                                    tcache.k_pages, tcache.v_pages,
                                    tpt, tsl, tact)
    for slot in live:
        _close(tl[slot], jl[slot], f"paged decode logits, slot {slot}")
    _close(tk[:, :-1], jk, "paged K pool")
    _close(tv[:, :-1], jv, "paged V pool")
