"""The port's model families against the JAX package at ``reduced()`` size.

The nine configurations beyond llama110m and mamba2-2.7b: the dense
granite-3-8b, yi-9b, internlm2-20b and qwen1.5-0.5b; the moe dbrx-132b and
arctic-480b (``models/moe.py``); the hybrid zamba2-1.2b; the vlm
paligemma-3b (prefix-LM mask, decode past the prefix); the encdec
seamless-m4t-medium.  Weights come from the reference's own initializer,
bridged through numpy; inputs are made with numpy from a seed.  Backend
``"torch"`` is held against ``xla`` and backend ``"cuda"`` (plain versions
on CPU tensors) against ``pallas_interpret``, at the reference's fp32
tolerance (atol 2e-5, rtol 2e-4); decode against prefill at 5e-5 / 1e-4
(tests/test_models.py:83).  The MoE dispatches are held to the
reference's with drops (T > 256) and the sort fallback (T % 512 != 0), the
routing exactly and with no tie in the top-k.  After a prefill and a
decode step of every family, the port's compile records (key → impl,
matched ISAXes) equal the reference's, ``matmul`` keys included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compile as jcompile
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.registry import get_model as jax_get_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro_torch.bridge import params_from_numpy
from repro_torch.compile import Dispatcher, LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.models import encdec, layers, moe
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import Request

NEW_ARCHS = ["granite-3-8b", "yi-9b", "internlm2-20b", "qwen1.5-0.5b",
             "dbrx-132b", "arctic-480b", "zamba2-1.2b", "paligemma-3b",
             "seamless-m4t-medium"]
MOE_ARCHS = ["dbrx-132b", "arctic-480b"]
BACKENDS = [("xla", "torch"), ("pallas_interpret", "cuda")]
TOL = dict(atol=2e-5, rtol=2e-4)
B, S, FRAMES = 2, 16, 12

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


def _models(arch, backends, dispatchers=(None, None)):
    cfg, jcfg, _, _ = _setup(arch)
    jb, tb = backends
    jd, td = dispatchers
    jlw = (jcompile.LoweringConfig.from_registry(jb, dispatcher=jd) if jd
           else jcompile.LoweringConfig.from_registry(jb))
    return (jax_get_model(jcfg, lowering=jlw),
            get_model(cfg, lowering=LoweringConfig(tb, td)))


def _n_prefix(cfg) -> int:
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def _batch(cfg, S_text: int, seed: int, tokens=None):
    """(reference batch, port batch): tokens, and prefix_embeds (vlm: the
    config's prefix; encdec: FRAMES frames), made with numpy."""
    rng = np.random.default_rng(seed)
    if tokens is None:
        tokens = rng.integers(0, cfg.vocab, (B, S_text), dtype=np.int32)
    out = {"tokens": tokens}
    P = {"vlm": cfg.n_prefix_tokens, "encdec": FRAMES}.get(cfg.family)
    if P:
        out["prefix_embeds"] = rng.normal(size=(B, P, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _close_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], f"{what}.{k}")
    else:
        _close(got, want, what)


def test_assigned_archs_match_reference():
    from repro.configs.registry import ASSIGNED_ARCHS as JAX_ASSIGNED
    assert ASSIGNED_ARCHS == JAX_ASSIGNED


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_n_params_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_matches_reference_shapes(arch):
    """The port's own init: every leaf of the reference's tree, with its
    shape, stacked (L, ...) where the reference stacks."""
    cfg, _, jparams, _ = _setup(arch)
    mine = get_model(cfg).init(0, "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n = 0
    for path, leaf in flat_j:
        node = mine
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert node.dtype == torch.float32, path
        n += 1
    assert n == sum(1 for _ in _leaves(mine))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_logits_and_caches(arch, backends):
    cfg, _, jparams, tparams = _setup(arch)
    jmodel, model = _models(arch, backends)
    jb, tb = _batch(cfg, S, seed=1)
    pad = S + _n_prefix(cfg) + 4
    jl, jc = jmodel.prefill(jparams, jb, pad)
    tl, tc = model.prefill(tparams, tb, pad)
    _close(tl, jl, f"{arch} prefill logits")
    _close_tree(tc, jc, f"{arch} prefill caches")


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_step(arch, backends):
    """One decode step at S + n_prefix (vlm: past its prefix) from the
    prefill's caches: logits and every cache."""
    cfg, _, jparams, tparams = _setup(arch)
    jmodel, model = _models(arch, backends)
    jb, tb = _batch(cfg, S, seed=2)
    pos = S + _n_prefix(cfg)
    jl, jc = jmodel.prefill(jparams, jb, pos + 4)
    _, tc = model.prefill(tparams, tb, pos + 4)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                  jnp.int32(pos))
    tl2, tc2 = model.decode_step(tparams, torch.from_numpy(tok), tc, pos)
    _close(tl2, jl2, f"{arch} decode logits")
    _close_tree(tc2, jc2, f"{arch} decode caches")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_prefill(arch):
    """decode_step(t | prefix) equals prefill(prefix + t) on the port."""
    cfg, _, _, tparams = _setup(arch)
    model = get_model(cfg, lowering=LoweringConfig("cuda"))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    _, tb = _batch(cfg, S, seed=4, tokens=toks[:, :S])
    pos = S + _n_prefix(cfg)
    _, caches = model.prefill(tparams, tb, pos + 4)
    got, _ = model.decode_step(tparams, torch.from_numpy(toks[:, S]),
                               caches, pos)
    want, _ = model.prefill(tparams, dict(tb, tokens=torch.from_numpy(toks)),
                            pos + 4)
    _close(got, want, f"{arch} decode vs prefill",
           dict(atol=5e-5, rtol=1e-4))


@pytest.mark.parametrize("kind", ["causal", "prefix", "full"])
def test_make_mask_matches_reference(kind):
    for S_, T_, n in ((8, None, 3), (5, 9, 0), (16, 16, 16)):
        got = layers.make_mask(kind, S_, T_, n_prefix=n)
        want = jlayers.make_mask(kind, S_, T_, n_prefix=n)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# MoE: both dispatches, drops, the sort fallback, arctic's residual
# ---------------------------------------------------------------------------

def _moe_cfgs(arch, dispatch):
    cfg, jcfg, _, _ = _setup(arch)
    return (dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch=dispatch)),
            dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, dispatch=dispatch)))


def _kept_pairs(idx, E, capacity, grouped, Tg):
    """Kept (token, choice) pairs of a routing (T, k), by the reference's
    rules: slot-major priority in groups of Tg (grouped) or token order
    (sort); an independent count of the drops."""
    T, k = idx.shape
    keep = np.zeros((T, k), bool)
    for g0 in range(0, T, Tg if grouped else T):
        g1 = g0 + (Tg if grouped else T)
        used = np.zeros(E, int)
        order = ([(t, s) for s in range(k) for t in range(g0, g1)] if grouped
                 else [(t, s) for t in range(g0, g1) for s in range(k)])
        for t, s in order:
            e = idx[t, s]
            keep[t, s] = used[e] < capacity
            used[e] += 1
    return keep


MOE_CASES = [  # (B, S, dispatch): loss-free, grouped drops, sort fallback
    (2, 16, "grouped"), (2, 512, "grouped"), (1, 600, "grouped"),
    (2, 16, "sort"), (1, 600, "sort")]


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: f"{c[2]}-T{c[0] * c[1]}")
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_reference(arch, case):
    """y and the auxiliary loss against the reference's moe_mlp; the top-k
    experts equal the reference's with no tie in the inputs; where T > 256
    some pairs are dropped (counted independently of both)."""
    Bm, Sm, dispatch = case
    cfg, jcfg = _moe_cfgs(arch, dispatch)
    _, _, jparams, tparams = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["moe"].items()}
    # a component shared by every token skews the routing, so that T > 256
    # fills some experts past their capacity
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(Bm, Sm, cfg.d_model))
         + 2.0 * rng.normal(size=cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg,
                            lowering=jcompile.LoweringConfig("xla"))
    ty, taux = moe.moe_mlp(tp, torch.from_numpy(x), cfg,
                           lowering=LoweringConfig("torch", Dispatcher()))
    _close(ty, jy, f"{arch} {case} y")
    _close(taux, jaux, f"{arch} {case} aux")
    # routing: exact, with no tie at the k-th choice
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model))
                                      @ jp["router"], axis=-1))
    srt = np.sort(probs, axis=-1)[:, ::-1]
    assert np.all(np.diff(-srt[:, :k + 1], axis=-1) > 0), "top-k tie"
    _, jidx = jax.lax.top_k(jnp.asarray(probs), k)
    _, _, tidx = moe._route(tp["router"], torch.from_numpy(x).reshape(
        -1, cfg.d_model), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    T = Bm * Sm
    grouped = dispatch == "grouped" and T % min(moe.GROUP_SIZE, T) == 0
    Tg = min(moe.GROUP_SIZE, T) if grouped else T
    capacity = moe._capacity(cfg, T, Tg)
    keep = _kept_pairs(tidx.numpy(), E, capacity, grouped, Tg)
    assert keep.all() == (T <= moe.LOSS_FREE_TOKENS), (case, keep.mean())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grouped_falls_back_to_sort(arch):
    """A token count the group does not divide runs the sort dispatch
    (the same output as forcing it), looking up the sort's GEMM rows."""
    cfg, _ = _moe_cfgs(arch, "grouped")
    scfg, _ = _moe_cfgs(arch, "sort")
    _, _, _, tparams = _setup(arch)
    tp = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 600, cfg.d_model)).astype(np.float32))
    disp = Dispatcher()
    y, _ = moe.moe_mlp(tp, x, cfg, lowering=LoweringConfig("torch", disp))
    ys, _ = moe.moe_mlp(tp, x, scfg, lowering=LoweringConfig("torch"))
    torch.testing.assert_close(y, ys, atol=0, rtol=0)
    rows = {r.key.shape[0] for r in disp.records.values()
            if r.key.op == "matmul" and r.key.shape[2] == cfg.d_ff}
    assert rows == {cfg.moe.n_experts * moe._capacity(cfg, 600, 600)}


@pytest.mark.parametrize("backends", BACKENDS, ids=lambda b: b[1])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_paged_decode(arch, backends):
    """prefill_at into buckets, then one paged decode step with slot 1
    inactive: live logits and both page pools (the port's pools carry one
    spare page past the reference's)."""
    cfg, jcfg, jparams, tparams = _setup(arch)
    jmodel, model = _models(arch, backends)
    Bp, PS, MAXLEN = 3, 16, 64
    lens = {0: 16, 2: 9}
    jcache = JaxPagedKVCache(jcfg, max_batch=Bp, page_size=PS,
                             n_pages=Bp * MAXLEN // PS, max_len=MAXLEN)
    tcache = PagedKVCache(cfg, max_batch=Bp, page_size=PS,
                          n_pages=Bp * MAXLEN // PS, max_len=MAXLEN)
    toks = np.zeros((Bp,), np.int32)
    rng = np.random.default_rng(7)
    for slot, n in lens.items():
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = rng.integers(0, cfg.vocab, n)
        jcache.bind_slot(slot, n + 8)
        tcache.bind_slot(slot, n + 8)
        jl, jkv = jmodel.prefill_at(jparams, {"tokens": jnp.asarray(padded)},
                                    jnp.int32(n))
        tl, tkv = model.prefill_at(tparams,
                                   {"tokens": torch.from_numpy(padded)}, n)
        _close(tl, jl, f"{arch} prefill_at logits, slot {slot}")
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
        _close(tl[slot], jl[slot], f"{arch} paged decode logits, slot {slot}")
    _close(tk[:, :-1], jk, f"{arch} paged K pool")
    _close(tv[:, :-1], jv, f"{arch} paged V pool")


def test_continuous_engine_serves_moe():
    """ContinuousEngine takes a moe config (it has a paged decode path);
    every trace spec a request looks up is saturated when it is built."""
    cfg, _, _, tparams = _setup("dbrx-132b")
    disp = Dispatcher()
    eng = ContinuousEngine(cfg, tparams, max_batch=2, page_size=16,
                           max_len=64, prompt_buckets=(16, 32),
                           lowering=LoweringConfig("cuda", disp),
                           device="cpu")
    saturated = set(disp._outcomes)
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new_tokens=4, arrival_step=0)
        for i, n in enumerate((5, 20, 11))]
    stats = eng.run(reqs)
    assert stats.total_tokens == 12
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    assert set(disp._outcomes) == saturated
    assert any(k.op == "matmul" and k.shape[2] == cfg.d_ff
               for k in disp.records)


# ---------------------------------------------------------------------------
# encdec, vlm, hybrid specifics; the engine against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq", [1, 9])
def test_cross_attention_matches_reference(Sq):
    """Cross attention with S != T (full mask; 9 query rows: a kernel
    record) and at a one-row query (a degenerate q tile: the plain
    version), on backend cuda's plain versions against pallas_interpret."""
    from repro.models import encdec as jencdec
    cfg, jcfg, jparams, tparams = _setup("seamless-m4t-medium")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[1], jparams["dec_blocks"]["cross"])
    tp = {k: v[1] for k, v in tparams["dec_blocks"]["cross"].items()}
    jmask = jlayers.make_mask("full", Sq, FRAMES)
    tmask = layers.make_mask("full", Sq, FRAMES)
    jd, td = jcompile.Dispatcher(), Dispatcher()
    want = jencdec._cross_attention(
        jp, jnp.asarray(x), jnp.asarray(enc), jcfg, jmask,
        jcompile.LoweringConfig.from_registry("pallas_interpret",
                                              dispatcher=jd))
    got = encdec._cross_attention(tp, torch.from_numpy(x),
                                  torch.from_numpy(enc), cfg, tmask,
                                  LoweringConfig("cuda", td))
    _close(got, want, f"cross attention S={Sq} T={FRAMES}")
    (jrec,), (trec,) = jd.records.values(), td.records.values()
    assert trec.impl == jrec.impl == ("reference" if Sq == 1 else "isax")
    if Sq == 1:
        assert "degenerate" in trec.note


@pytest.mark.parametrize("arch", ["paligemma-3b", "seamless-m4t-medium",
                                  "zamba2-1.2b", "dbrx-132b"])
def test_serve_engine_matches_reference(arch):
    """ServeEngine.generate passes the whole batch (prefix_embeds too) and
    starts a vlm's decode at S + n_prefix_tokens: the tokens equal the
    reference engine's on the same weights and inputs."""
    cfg, jcfg, jparams, tparams = _setup(arch)
    jb, tb = _batch(cfg, 8, seed=10)
    max_len = 8 + _n_prefix(cfg) + 8
    jeng = JaxServeEngine(jcfg, jparams, max_len=max_len,
                          lowering=jcompile.LoweringConfig("xla"))
    eng = ServeEngine(cfg, tparams, max_len=max_len,
                      lowering=LoweringConfig("torch"), device="cpu")
    want, _ = jeng.generate(jb, 4)
    got, _ = eng.generate({k: v.numpy() for k, v in tb.items()}, 4)
    np.testing.assert_array_equal(got, want)


def test_vlm_prefix_mask_reaches_prefill():
    """The prefix embeddings see each other (bidirectional), the text does
    not see ahead: changing the last prefix embedding moves the first
    prefix position's hidden state, changing the last token does not move
    the logits of a shorter prompt."""
    cfg, _, _, tparams = _setup("paligemma-3b")
    model = get_model(cfg, lowering=LoweringConfig("torch"))
    _, tb = _batch(cfg, S, seed=11)
    _, c1 = model.prefill(tparams, tb)
    pe = tb["prefix_embeds"].clone()
    pe[:, -1] += 1.0
    _, c2 = model.prefill(tparams, dict(tb, prefix_embeds=pe))
    # layer 1's K at position 0 depends on layer 0's output there
    assert not torch.allclose(c1["k"][1, :, 0], c2["k"][1, :, 0])
    toks = tb["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab
    _, c3 = model.prefill(tparams, dict(tb, tokens=toks))
    torch.testing.assert_close(c3["k"][:, :, :-1], c1["k"][:, :, :-1],
                               atol=0, rtol=0)


def test_hybrid_site_caches():
    """KV caches only at the ceil(L / every) attention sites; SSM caches
    at every layer."""
    from repro_torch.models import hybrid
    cfg, _, _, tparams = _setup("zamba2-1.2b")
    model = get_model(cfg, lowering=LoweringConfig("torch"))
    _, tb = _batch(cfg, S, seed=12)
    _, caches = model.prefill(tparams, tb, S + 4)
    sites = hybrid.n_sites(cfg)
    assert sites == len(hybrid._sites(cfg)) == 2
    hd = cfg.resolved_head_dim()
    assert caches["k"].shape == (sites, B, S + 4, cfg.n_kv_heads, hd)
    assert caches["ssm"]["state"].shape[0] == cfg.n_layers
    assert caches["ssm"]["conv"].shape[0] == cfg.n_layers


def test_launcher_names_missing_prefix_embeds():
    from repro_torch.launch import serve
    for arch in ("paligemma-3b", "seamless-m4t-medium"):
        with pytest.raises(ValueError, match="prefix_embeds"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Compile records of a forward: the port's equal the reference's
# ---------------------------------------------------------------------------

_BACKEND_NAME = {"pallas_interpret": "cuda", "xla": "torch"}


def _dtype_name(name: str) -> str:
    """A key's dtype name; the reference's SSD lookup passes the class
    ``jnp.float32``, which its key spells "<class 'jax.numpy.float32'>"."""
    prefix = "<class 'jax.numpy."
    return name[len(prefix):-2] if name.startswith(prefix) else name


def _records(disp, backend_map=None):
    return {(r.key.op, tuple(r.key.shape), _dtype_name(r.key.dtype),
             (backend_map or {}).get(r.key.backend, r.key.backend)):
            (r.impl, tuple(r.matched)) for r in disp.records.values()}


@pytest.mark.parametrize("arch", ["llama110m", "mamba2-2.7b", *NEW_ARCHS])
def test_records_match_reference_after_forward(arch):
    """A prefill and one decode step of the reduced model on both sides,
    each with a fresh dispatcher: the same keys (matmul's included), each
    with the same impl and matched ISAXes."""
    cfg, _, jparams, tparams = _setup(arch)
    jd, td = jcompile.Dispatcher(), Dispatcher()
    jmodel, model = _models(arch, ("pallas_interpret", "cuda"), (jd, td))
    jb, tb = _batch(cfg, S, seed=13)
    pos = S + _n_prefix(cfg)
    jl, jc = jmodel.prefill(jparams, jb, pos + 4)
    _, tc = model.prefill(tparams, tb, pos + 4)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    jmodel.decode_step(jparams, jnp.asarray(tok), jc, jnp.int32(pos))
    model.decode_step(tparams, torch.from_numpy(tok), tc, pos)
    want = _records(jd, _BACKEND_NAME)
    got = _records(td)
    assert got == want
    assert any(k[0] == "matmul" for k in got)
