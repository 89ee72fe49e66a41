"""The port's span recorder (``repro_torch.obs``) and the spans the serving
engines and the dispatcher record: nesting, the ring's bound, the engine's
step tree and the latency stamps it shares, ``ServeStats`` against a copy
of the computation it replaced, and the clock against a profiler trace."""

import ast
import dataclasses
import inspect
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.compile.config import LoweringConfig
from repro_torch.compile.dispatch import Dispatcher
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import ContinuousEngine, ServeEngine, ServeStats
from repro_torch.serve.scheduler import Request


@pytest.fixture(autouse=True)
def _fresh_ring():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("llama110m"))


class FakeClock:
    """``time.perf_counter`` that moves only when a test moves it."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_parent_indices_and_rid():
    with obs.span("a") as a:
        with obs.span("b", rid=7) as b:
            b.attrs["extra"] = 2
        with obs.span("c") as c:
            pass
    got = {s.name: s for s in obs.spans()}
    assert [s.name for s in obs.spans()] == ["b", "c", "a"]   # end order
    assert (a.parent, b.parent, c.parent) == (None, a.idx, a.idx)
    assert a.idx < b.idx < c.idx
    assert got["b"].rid == 7 and got["b"].attrs == {"extra": 2}
    assert a.t0 <= b.t0 <= b.t1 <= c.t0 <= c.t1 <= a.t1


def test_span_is_recorded_and_unwound_when_the_body_raises():
    with pytest.raises(RuntimeError):
        with obs.span("outer"):
            with obs.span("inner"):
                raise RuntimeError("boom")
    with obs.span("after") as after:
        pass
    names = [s.name for s in obs.spans()]
    assert names == ["inner", "outer", "after"]
    assert after.parent is None and all(s.t1 is not None
                                        for s in obs.spans())


def test_record_stamps_elsewhere_and_has_no_parent():
    with obs.span("outer"):
        s = obs.record("q", 1.0, 2.5, rid=3)
    assert (s.t0, s.t1, s.rid, s.parent, s.attrs) == (1.0, 2.5, 3, None, {})


def test_ring_is_bounded_and_counts_what_it_drops():
    n = obs.RING + 37
    for i in range(n):
        obs.record("x", float(i), float(i))
    got = obs.spans()
    assert len(got) == obs.RING and obs.dropped() == 37
    assert got[0].t0 == 37.0 and got[-1].t0 == float(n - 1)
    obs.reset()
    assert obs.spans() == [] and obs.dropped() == 0


def test_recorder_calls_no_profiler(monkeypatch):
    tree = ast.parse(inspect.getsource(obs))
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)}
    assert imported == {"__future__", "collections", "time", "typing"}

    def boom(*a, **k):
        raise AssertionError("the recorder called the profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with obs.span("a"):
        obs.record("b", 0.0, 1.0)
    assert len(obs.spans()) == 2


# ---------------------------------------------------------------------------
# ContinuousEngine
# ---------------------------------------------------------------------------

STEP_CHILDREN = {"serve.admit", "serve.decode.enqueue", "serve.decode.fetch"}
ADMIT_CHILDREN = ["serve.first_token"]


def _kids(spans):
    out = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    for v in out.values():
        v.sort(key=lambda s: s.idx)
    return out


def test_continuous_engine_step_tree_and_stamps(cfg):
    rng = np.random.default_rng(3)
    eng = ContinuousEngine(cfg, seed=0, device="cpu", max_batch=2,
                           page_size=16, max_len=64, prompt_buckets=(16,),
                           lowering=LoweringConfig("cuda", Dispatcher()))
    disp = eng.lowering.dispatcher
    reqs = [Request(i, rng.integers(0, cfg.vocab, 5 + 3 * i,
                                    dtype=np.int32), n)
            for i, n in enumerate([3, 1, 4])]
    for r in reqs:
        eng.submit(r)
    lookups, decoded = [], []
    while eng.queue or eng.scheduler.has_active():
        n0, m0 = disp.hits + disp.misses, disp.misses
        decoded.append(eng.step())
        lookups.append((disp.hits + disp.misses - n0, disp.misses - m0))
    spans = obs.spans()
    kids = _kids(spans)
    steps = sorted((s for s in spans if s.name == "serve.step"),
                   key=lambda s: s.idx)
    assert len(steps) == len(lookups) == eng.step_count
    assert all(s.parent is None for s in steps)
    assert [s.attrs for s in steps] == [{"lookups": n} for n, _ in lookups]
    assert lookups[0][1] > 0 and sum(n for n, _ in lookups[1:]) > 0
    assert any(decoded)
    for st, ran in zip(steps, decoded):
        names = [c.name for c in kids.get(st.idx, [])]
        assert set(names) <= STEP_CHILDREN
        decode = ["serve.decode.enqueue", "serve.decode.fetch"]
        assert (names[-2:] == decode) == ran
        assert names.count("serve.decode.enqueue") == ran
        for c in kids.get(st.idx, []):
            assert st.t0 <= c.t0 <= c.t1 <= st.t1

    admits = {s.rid: s for s in spans if s.name == "serve.admit"}
    queued = {s.rid: s for s in spans if s.name == "serve.queued"}
    assert set(admits) == set(queued) == {r.rid for r in reqs}
    for r in reqs:
        a, q = admits[r.rid], queued[r.rid]
        assert q.t0 == r.t_submit and q.t1 == a.t0
        assert q.t1 - q.t0 == a.t0 - r.t_submit
        # a first prefill's lowering misses sit beside its fetch
        own = [c for c in kids[a.idx] if c.name != "lower.decide"]
        assert [c.name for c in own] == ADMIT_CHILDREN
        assert all(c.rid == r.rid for c in own)
        first = own[-1]
        assert r.t_first_token == first.t1
        assert len(r.out_tokens) == r.max_new_tokens
        fetches = [first.t1] + [s.t1 for s in spans
                                if s.name == "serve.decode.fetch"]
        assert r.t_done in fetches
    one = next(r for r in reqs if r.max_new_tokens == 1)
    assert one.t_done == one.t_first_token


def test_forced_cache_miss_records_one_decide_and_a_hit_none():
    disp = Dispatcher()
    key = ("attention", (1, 64, 4, 2, 64, 16), "float32", "cuda")
    disp.lower(key)                          # saturates the spec's e-graph
    disp.lower(key)                          # a hit records nothing
    disp.lower(("attention_paged", (2, 1, 4, 2, 64, 16), "float32",
                "cuda"))                     # same spec: no saturation
    spans = obs.spans()
    assert [s.name for s in spans] == ["lower.decide"] * 2
    assert all(s.parent is None and s.attrs == {} for s in spans)
    assert spans[0].t1 <= spans[1].t0
    assert disp.misses == 2 and disp.hits == 1


# ---------------------------------------------------------------------------
# ServeEngine: ServeStats from the spans, as computed before them
# ---------------------------------------------------------------------------

def _generate_before(self, batch, n_tokens):
    """``ServeEngine.generate`` as it stamped ``ServeStats`` before the
    spans: a copy kept as the reference of the boundaries."""
    batch = {k: torch.as_tensor(v, device=self.device)
             for k, v in batch.items()}
    t0 = time.perf_counter()
    logits, caches = self.model.prefill(self.params, batch, self.max_len)
    engine_mod._sync(self.device)
    ttft = time.perf_counter() - t0
    n_prefix = self.cfg.n_prefix_tokens if self.cfg.family == "vlm" else 0
    pos = batch["tokens"].shape[1] + n_prefix
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token.cpu().numpy()]
    t1 = time.perf_counter()
    for i in range(n_tokens - 1):
        logits, caches = self.model.decode_step(self.params, token, caches,
                                                pos + i)
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token.cpu().numpy())
    t2 = time.perf_counter()
    itl = (t2 - t1) / max(n_tokens - 1, 1)
    stats = ServeStats(ttft_s=ttft, itl_s=itl, tokens=n_tokens,
                       tokens_per_s=n_tokens / (t2 - t0))
    return np.stack(out, axis=1), stats


@pytest.mark.parametrize("n_tokens", [1, 5])
def test_serve_stats_keep_their_boundaries(cfg, monkeypatch, n_tokens):
    eng = ServeEngine(cfg, seed=0, device="cpu", max_len=32)
    clock = FakeClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    prefill, decode, argmax = (eng.model.prefill, eng.model.decode_step,
                               torch.argmax)

    def ticking(fn, dt):
        def wrapped(*a, **k):
            clock.now += dt
            return fn(*a, **k)
        return wrapped

    # distinct binary fractions: a boundary moved by one call shows
    monkeypatch.setattr(eng, "model", dataclasses.replace(
        eng.model, prefill=ticking(prefill, 0.5),
        decode_step=ticking(decode, 0.125)))
    monkeypatch.setattr(torch, "argmax", ticking(argmax, 0.03125))
    batch = {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8)}
    want_out, want = _generate_before(eng, batch, n_tokens)
    got_out, got = eng.generate(batch, n_tokens)
    np.testing.assert_array_equal(got_out, want_out)
    assert got == want
    assert got.ttft_s == 0.5 and got.itl_s == (0.15625 if n_tokens > 1
                                               else 0.0)
    names = [s.name for s in obs.spans()]
    assert names.count("serve.decode.enqueue") == n_tokens - 1
    assert names.count("serve.decode.fetch") == n_tokens - 1
    assert names[-1] == "serve.generate"


# ---------------------------------------------------------------------------
# the clock: a span lands where the profiler saw its work
# ---------------------------------------------------------------------------

def test_span_clock_maps_onto_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h0 = time.perf_counter()     # stamped as the harness stamps it
        with torch.profiler.record_function("bench.traced"):
            time.sleep(0.002)
            with obs.span("work") as s:
                x.add_(1)
            time.sleep(0.002)
    events = list(prof.profiler.kineto_results.events())

    def start(e):
        return e.start_ns() * 1e-9 if hasattr(e, "start_ns") \
            else e.start_us() * 1e-6

    traced = next(e for e in events if e.name() == "bench.traced")
    add = next(e for e in events if e.name() == "aten::add_")
    off = start(traced) - h0
    a0 = start(add) - off
    a1 = a0 + add.duration_ns() * 1e-9
    assert s.t0 - 1e-3 <= a0 and a1 <= s.t1 + 1e-3
