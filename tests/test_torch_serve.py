"""The port's serving stack: page allocator, scheduler admission, the
snapshot-before-transfer invariant, and a continuous-batching run whose
per-step logits match the JAX engine's under teacher forcing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compile import LoweringConfig as JaxLowering
from repro.configs.base import reduced as jax_reduced
from repro.configs.registry import get_config as jax_get_config
from repro.serve.engine import ContinuousEngine as JaxContinuousEngine
from repro.serve.scheduler import make_poisson_workload as jax_workload
from repro_torch.bridge import params_from_numpy
from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.kv_cache import (PageAllocationError, PageAllocator,
                                        PagedKVCache)
from repro_torch.serve.scheduler import (Request, RequestQueue, Scheduler,
                                         make_poisson_workload, pick_bucket)


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("llama110m"))


def _engine(cfg, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("page_size", 16)
    kw.setdefault("max_len", 64)
    kw.setdefault("prompt_buckets", (16,))
    return ContinuousEngine(cfg, seed=0, device="cpu", **kw)


# ---------------------------------------------------------------------------
# page allocator
# ---------------------------------------------------------------------------

def test_alloc_free_roundtrip():
    a = PageAllocator(8)
    pages = a.alloc(5)
    assert len(set(pages)) == 5 and a.n_free == 3
    a.check_invariants()
    a.free(pages)
    a.check_leaks()


def test_exhaustion_raises():
    a = PageAllocator(4)
    a.alloc(4)
    assert not a.can_alloc(1)
    with pytest.raises(PageAllocationError):
        a.alloc(1)


def test_double_free_and_foreign_page_raise():
    a = PageAllocator(4)
    pages = a.alloc(2)
    a.free(pages)
    with pytest.raises(PageAllocationError):
        a.free(pages)
    with pytest.raises(PageAllocationError):
        a.free([99])


def test_leak_is_detected():
    a = PageAllocator(4)
    a.alloc(1)
    a.check_invariants()
    with pytest.raises(PageAllocationError):
        a.check_leaks()


def test_cache_bind_release_and_rebind(cfg):
    c = PagedKVCache(cfg, max_batch=2, page_size=16, n_pages=4, max_len=64)
    pages = c.bind_slot(0, 20)
    assert list(c.page_table[0, :2]) == pages
    with pytest.raises(PageAllocationError):
        c.bind_slot(0, 4)
    c.release_slot(0)
    assert not c.page_table[0].any() and c.seq_lens[0] == 0
    c.allocator.check_leaks()


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_workload_matches_reference_rng(cfg):
    mine = make_poisson_workload(12, rate=2.0, vocab=cfg.vocab, seed=5)
    ref = jax_workload(12, rate=2.0, vocab=cfg.vocab, seed=5)
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new_tokens, a.arrival_step) == \
            (b.rid, b.max_new_tokens, b.arrival_step)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_queue_fifo_slot_reuse_and_buckets():
    q = RequestQueue()
    a = Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=1,
                arrival_step=5)
    q.push(a)
    assert q.pop_eligible(step=4) is None
    assert q.pop_eligible(step=5) is a
    s = Scheduler(max_batch=2)
    slot = s.bind(a)
    a.out_tokens.append(1)
    assert s.finished_slots() == [slot]
    assert s.retire(slot) is a and s.has_capacity()
    assert pick_bucket(8, (16, 32)) == 16 and pick_bucket(17, (16, 32)) == 32
    with pytest.raises(ValueError):
        pick_bucket(64, (16, 32))


def test_late_request_admitted_and_completes(cfg):
    eng = _engine(cfg)
    rng = np.random.default_rng(0)
    early = [Request(rid=i,
                     prompt=rng.integers(0, cfg.vocab, 8, dtype=np.int32),
                     max_new_tokens=12, arrival_step=0) for i in range(2)]
    late = Request(rid=2, prompt=rng.integers(0, cfg.vocab, 8, dtype=np.int32),
                   max_new_tokens=3, arrival_step=4)
    stats = eng.run(early + [late])
    for r in early + [late]:
        assert len(r.out_tokens) == r.max_new_tokens, r.rid
        assert r.t_first_token is not None and r.t_done is not None
    # the late request rode along with the in-flight batch
    assert stats.decode_steps < 12 + 3
    eng.cache.allocator.check_leaks()


def test_no_leak_across_poisson_run_and_rejections(cfg):
    eng = _engine(cfg, max_batch=4, max_len=128, prompt_buckets=(16, 32))
    reqs = make_poisson_workload(10, rate=2.0, vocab=cfg.vocab, seed=3)
    for r in reqs:
        eng.submit(r)
    while eng.queue or eng.scheduler.has_active():
        eng.step()
        eng.cache.allocator.check_invariants()
    eng.cache.allocator.check_leaks()
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=99, prompt=np.zeros(16, np.int32),
                           max_new_tokens=200))
    one = Request(rid=100, prompt=np.zeros(8, np.int32), max_new_tokens=1)
    assert eng.run([one]).decode_steps == 0 and len(one.out_tokens) == 1


# ---------------------------------------------------------------------------
# snapshot before transfer
# ---------------------------------------------------------------------------

def test_device_views_snapshot_host_arrays(cfg):
    """Advancing the host-side lengths/table after ``device_views`` (what the
    engine does right after dispatching a decode step) must not change the
    tensors the step reads."""
    c = PagedKVCache(cfg, max_batch=3, page_size=16, n_pages=8, max_len=64)
    c.bind_slot(0, 40)
    c.bind_slot(2, 20)
    c.seq_lens[0], c.seq_lens[2] = 17, 5
    pt, sl, act = c.device_views({0, 2})
    want = (c.page_table.copy(), c.seq_lens.copy())
    c.seq_lens[:] += 1
    c.page_table[:] = 7
    np.testing.assert_array_equal(pt.numpy(), want[0])
    np.testing.assert_array_equal(sl.numpy(), want[1])
    assert act.tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# continuous batching against the JAX engine, teacher forced
# ---------------------------------------------------------------------------

def _record_jax(eng, log):
    """Wrap the JAX engine's prefill/decode so every step's logits land in
    ``log``; its own greedy tokens drive the run."""
    model = eng.model
    prefill = jax.jit(lambda p, b, n: model.prefill_at(p, b, n))
    decode = jax.jit(lambda *a: model.decode_paged(*a))

    def _prefill(p, b, n):
        logits, kv = prefill(p, b, n)
        log.append(("prefill", np.asarray(logits), None))
        return logits, kv

    def _decode(p, t, kp, vp, pt, sl, act):
        logits, kp, vp = decode(p, t, kp, vp, pt, sl, act)
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        log.append(("decode", np.asarray(logits), np.asarray(act)))
        return nxt, kp, vp, sl + act.astype(sl.dtype)

    eng._prefill, eng._decode = _prefill, _decode


def _force_torch(eng, jax_log, log):
    """Wrap the port's engine so each step's logits land in ``log`` while the
    tokens fed on are the JAX run's (an argmax near-tie cannot make the two
    runs drift apart)."""
    model = eng.model
    step = iter(jax_log)

    def _prefill(p, b, n):
        logits, kv = model.prefill_at(p, b, n)
        log.append(logits.numpy().copy())
        forced = np.full_like(log[-1], -1e9)
        forced[0, int(np.argmax(next(step)[1][0]))] = 0.0
        return torch.from_numpy(forced), kv

    def _decode(p, t, kp, vp, pt, sl, act):
        logits, kp, vp = model.decode_paged(p, t, kp, vp, pt, sl, act)
        log.append(logits.numpy().copy())
        nxt = np.argmax(next(step)[1], axis=-1).astype(np.int32)
        return torch.from_numpy(nxt), kp, vp, sl + act.to(sl.dtype)

    eng._prefill, eng._decode = _prefill, _decode


def test_continuous_run_matches_jax_engine(cfg):
    """Backend ``torch`` against ``xla``; logits at atol 1e-5 (as
    tests/test_serve.py:75)."""
    jcfg = jax_reduced(jax_get_config("llama110m"))
    kw = dict(max_batch=3, page_size=16, max_len=64, prompt_buckets=(16, 32))
    jeng = JaxContinuousEngine(jcfg, seed=0,
                               lowering=JaxLowering.from_registry("xla"),
                               **kw)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = ContinuousEngine(cfg, params, lowering=LoweringConfig("torch"),
                            device="cpu", **kw)
    workload = dict(rate=1.5, vocab=cfg.vocab, prompt_lens=(5, 16, 27),
                    out_lens=(2, 5, 9), seed=4)
    jlog, tlog = [], []
    _record_jax(jeng, jlog)
    jreqs = jax_workload(7, **workload)
    jstats = jeng.run(jreqs)
    _force_torch(teng, jlog, tlog)
    treqs = make_poisson_workload(7, **workload)
    tstats = teng.run(treqs)

    assert len(tlog) == len(jlog) > 10
    assert tstats.decode_steps == jstats.decode_steps
    for i, ((kind, jl, act), tl) in enumerate(zip(jlog, tlog)):
        rows = slice(None) if act is None else act
        np.testing.assert_allclose(tl[rows], jl[rows], atol=1e-5, rtol=0,
                                   err_msg=f"{kind} step {i}")
    for a, b in zip(treqs, jreqs):
        assert a.out_tokens == b.out_tokens, a.rid


def test_static_engine_generates_greedy_tokens(cfg):
    eng = ServeEngine(cfg, max_len=32, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8),
                                                 dtype=np.int32)
    toks, stats = eng.generate({"tokens": prompts}, 4)
    assert toks.shape == (2, 4) and stats.tokens == 4
    assert ((toks >= 0) & (toks < cfg.vocab)).all()


# ---------------------------------------------------------------------------
# paged decode: inactive slots, the spare page, no host sync
# ---------------------------------------------------------------------------

def _old_attention_decode_paged(params, x, cfg, k_pages, v_pages, page_table,
                                seq_lens, active, lowering):
    """The port's paged decode as it stood before the spare page: the
    writes gathered to the active rows through ``torch.nonzero`` (a host
    sync); kept here as the bit-for-bit oracle of the new one."""
    from repro_torch.models import layers as L
    hd = cfg.resolved_head_dim()
    B, page, P = x.shape[0], k_pages.shape[1], page_table.shape[1]
    q, k, v = L._qkv(params, x, cfg, seq_lens[:, None].to(torch.int32))
    rows = torch.nonzero(active).flatten()
    sl = seq_lens[rows].long()
    phys = page_table[rows, sl // page].long()
    k_pages[phys, sl % page] = k[rows, 0].to(k_pages.dtype)
    v_pages[phys, sl % page] = v[rows, 0].to(v_pages.dtype)
    pt = page_table.long()
    kg = k_pages[pt].reshape(B, P * page, *k_pages.shape[2:])
    vg = v_pages[pt].reshape(B, P * page, *v_pages.shape[2:])
    mask = (torch.arange(P * page)[None, None, :] <= seq_lens[:, None, None])
    out = L.sdpa(q, kg.to(q.dtype), vg.to(q.dtype), mask, hd, lowering,
                 kind="attention_paged")
    return L._out_proj(out, params["wo"])


def _paged_layer_case(active_bits, seed=0):
    """Layer-0 attention params of reduced llama110m (the reference's
    initializer), a token batch and page pools of N = 6 pages (the port's
    with its spare page appended), from numpy's ``seed``.  Slot 1's table
    row points at pages that slot 0 owns, and slot 3 sits at the last
    position of its table, where seq_lens // page runs past the table."""
    from repro.models.registry import get_model as jax_get_model
    from repro_torch.models.transformer import layer_params
    jcfg = jax_reduced(jax_get_config("llama110m"))
    jparams = jax_get_model(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    jattn = jax.tree.map(lambda a: a[0], jparams["blocks"]["attn"])
    tattn = layer_params(tparams["blocks"], 0)["attn"]
    rng = np.random.default_rng(seed)
    Bn, page, P, N = 4, 4, 3, 6
    K, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim()
    x = rng.normal(size=(Bn, 1, jcfg.d_model)).astype(np.float32)
    pools = [rng.normal(size=(N + 1, page, K, hd)).astype(np.float32)
             for _ in range(2)]
    table = np.array([[0, 1, 2], [0, 1, 0], [3, 4, 5], [5, 4, 3]], np.int32)
    lens = np.array([5, 2, 9, P * page], np.int32)
    active = np.array(active_bits, bool)
    return (jcfg, jattn, tattn, x, pools, table, lens, active, N)


@pytest.mark.parametrize("active_bits", [(1, 0, 1, 0), (1, 1, 1, 0),
                                         (0, 0, 0, 0), (1, 0, 0, 0)])
def test_paged_decode_matches_reference_with_inactive_slots(cfg, active_bits):
    """``attention_decode_paged`` with inactive slots: the output and the
    first N pages of each pool match the reference's (which drops the
    inactive writes; atol 1e-5, tests/test_serve.py:75), match bit for bit
    the port's earlier version (which wrote only the active rows), and
    every page no active row writes is untouched."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers as L
    (jcfg, jattn, tattn, x, pools, table, lens, active,
     N) = _paged_layer_case(active_bits)
    jout, jk, jv = jax_layers.attention_decode_paged(
        jattn, jnp.asarray(x), jcfg, jnp.asarray(pools[0][:N]),
        jnp.asarray(pools[1][:N]), jnp.asarray(table), jnp.asarray(lens),
        jnp.asarray(active), lowering=JaxLowering.from_registry("xla"))
    lw = LoweringConfig("cuda")
    kp, vp = (torch.from_numpy(p.copy()) for p in pools)
    args = (torch.from_numpy(x), cfg, kp, vp, torch.from_numpy(table),
            torch.from_numpy(lens), torch.from_numpy(active))
    out, kp2, vp2 = L.attention_decode_paged(tattn, *args, lowering=lw)
    assert kp2 is kp and vp2 is vp                   # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(kp[:N].numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(vp[:N].numpy(), np.asarray(jv), atol=1e-5,
                               rtol=0)

    old_k, old_v = (torch.from_numpy(p.copy()) for p in pools)
    old_out = _old_attention_decode_paged(
        tattn, torch.from_numpy(x), cfg, old_k, old_v, *args[4:],
        lowering=lw)
    assert torch.equal(out, old_out)
    assert torch.equal(kp[:N], old_k[:N]) and torch.equal(vp[:N], old_v[:N])

    page = pools[0].shape[1]
    written = {(int(table[b, lens[b] // page]), int(lens[b] % page))
               for b in range(len(active)) if active[b]}
    for p in range(N):
        for s in range(page):
            if (p, s) not in written:
                assert np.array_equal(kp[p, s].numpy(), pools[0][p, s])
                assert np.array_equal(vp[p, s].numpy(), pools[1][p, s])


def test_paged_decode_makes_no_host_sync(cfg, monkeypatch):
    """The paged KV write picks its page on the device: no
    ``torch.nonzero``, ``.item()``, ``.cpu()``, ``.tolist()`` or
    ``.numpy()`` in ``attention_decode_paged`` (each would copy to the host
    and wait for the card)."""
    from repro_torch.models import layers as L
    (_, _, tattn, x, pools, table, lens, active,
     _) = _paged_layer_case((1, 0, 1, 0))
    args = [torch.from_numpy(a) for a in (x, pools[0], pools[1], table, lens,
                                          active)]

    def sync(*a, **k):
        raise AssertionError("host sync in the paged decode")
    monkeypatch.setattr(torch, "nonzero", sync)
    for name in ("nonzero", "item", "cpu", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    out, _, _ = L.attention_decode_paged(tattn, args[0], cfg, *args[1:],
                                         lowering=LoweringConfig("cuda"))
    monkeypatch.undo()
    assert out.shape == (4, 1, cfg.d_model) and torch.isfinite(out).all()


def test_paged_cache_keeps_a_spare_page_the_allocator_never_hands_out(cfg):
    c = PagedKVCache(cfg, max_batch=2, page_size=16, n_pages=4, max_len=64)
    assert c.k_pages.shape[1] == c.v_pages.shape[1] == 5
    assert sorted(c.allocator.alloc(4)) == [0, 1, 2, 3]
    assert not c.allocator.can_alloc(1)
