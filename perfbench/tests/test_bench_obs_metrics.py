"""The readers of the program's own spans (``repro_torch.obs``): each on a
hand-built run and recorder for its value, None with no span, None where
the ring dropped spans of the part read, None where the program has no
recorder (a commit before it), and each in its cells' traced lines."""

import json
import time

import pytest
import repro_torch
from conftest import ROOT
from test_bench_cells import tiny_run
from yardstick.cell import Run, reader
from yardstick.tracing import Trace

import run as bench_run
from repro_torch import obs
from repro_torch.compile import dispatch

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["decode_enqueue_ms.chat", "decode_enqueue_ms.batch",
       "queue_wait_p90_ms", "decode_busy_ms.chat",
       "lowering_lookups_per_decode_step", "setup_lowering_s"]
#: Window: the schedule starts at 5 (ramp 5), opens at 10, the traced
#: slice is [20, 25] on the host's clock and [1000, 1005] on the trace's
WANT = {"decode_enqueue_ms.chat": 150.0, "decode_enqueue_ms.batch": 200.0,
        "queue_wait_p90_ms": 469.0, "decode_busy_ms.chat": 55.0,
        "lowering_lookups_per_decode_step": 150.0, "setup_lowering_s": 0.75}


@pytest.fixture(autouse=True)
def _fresh_ring():
    obs.reset()
    yield
    obs.reset()


def tree(clock, name, t0, t1, kids=(), rid=None, attrs=None):
    """Record span ``name`` over [t0, t1] with ``kids`` ((name, t0, t1,
    kids, rid, attrs) tuples, shorter allowed) inside it."""
    clock[0] = t0
    with obs.span(name, rid=rid) as s:
        s.attrs.update(attrs or {})
        for k in kids:
            tree(clock, *k)
        clock[0] = t1


def decode(t0, enq, lookups, admit=()):
    kids = [*admit,
            ("serve.decode.enqueue", t0 + 0.03, t0 + 0.03 + enq),
            ("serve.decode.fetch", t0 + 0.03 + enq, t0 + 0.05 + enq)]
    return ("serve.step", t0, t0 + 0.05 + enq, kids, None,
            {"lookups": lookups})


def record_program(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    # set-up: two decisions before the schedule's start
    tree(clock, "lower.decide", 1.0, 1.5)
    tree(clock, "lower.decide", 2.0, 2.25)
    obs.record("serve.queued", 3.0, 3.1, rid=-1)          # warm-up
    tree(clock, "lower.decide", 7.0, 7.5)             # in the ramp
    # the untraced part [10, 20]
    tree(clock, *decode(11.0, 0.1, 200))
    tree(clock, *decode(12.0, 0.2, 100))
    obs.record("serve.queued", 12.5, 13.01, rid=5)
    tree(clock, *decode(13.0, 0.05, 400, admit=[
        ("serve.admit", 13.01, 13.02,
         [("serve.first_token", 13.015, 13.02, (), 5)], 5)]))
    obs.record("serve.queued", 13.9, 14.0, rid=6)
    for t0, enq in ((15.0, (0.1, 0.3, 0.2)), (21.0, (0.9,))):
        kids = [("serve.prefill", t0, t0 + 0.1)] + [
            ("serve.decode.enqueue", t0 + 0.1 + j, t0 + 0.1 + j + e)
            for j, e in enumerate(enq)]
        tree(clock, "serve.generate", t0, t0 + len(enq) + 0.2, kids)
    # the traced slice, [1000, 1005] on the trace's clock: two pure decode
    # steps, over [1001.27, 1001.42] (the device works 70 ms of it) and
    # [1002, 1002.25] (40 ms), and one that admitted (100 ms, not read)
    tree(clock, *decode(21.27, 0.1, 999))
    tree(clock, *decode(22.0, 0.2, 999))
    tree(clock, *decode(23.0, 0.1, 999, admit=[
        ("serve.admit", 23.0, 23.02, (), 7)]))
    monkeypatch.undo()


def hand_run(closed=False):
    device = [("k", 1001.0, 1001.15), ("k", 1001.35, 1002.0),
              ("k", 1002.1, 1002.12), ("k", 1002.11, 1002.14),
              ("k", 1003.0, 1003.1)]
    cell = {"engine": {"max_batch": 8, "max_len": 64}}
    if not closed:
        cell["ramp_s"] = 5
    return Run({"family": "dense"}, cell, 15.0, 5.0 if closed else 10.0,
               25.0, 20.0, 1.0, [],
               trace=Trace(1000.0, 1005.0, device, [], []),
               traced_host=(20.0, 25.0))


@pytest.mark.parametrize("name", NEW)
def test_reads_its_spans(name, monkeypatch):
    record_program(monkeypatch)
    run = hand_run()
    if name == "decode_enqueue_ms.batch":
        run = hand_run(closed=True)
        run.t_open = 10.0
    assert reader(name)(run) == pytest.approx(WANT[name], rel=1e-6)


def test_setup_lowering_counts_up_to_the_closed_loops_start(monkeypatch):
    record_program(monkeypatch)
    run = hand_run(closed=True)      # the schedule starts at t_open = 5
    assert reader("setup_lowering_s")(run) == pytest.approx(0.75)
    run.t_open = 8.0
    assert reader("setup_lowering_s")(run) == pytest.approx(1.25)


@pytest.mark.parametrize("name", NEW)
def test_no_span_no_reading(name):
    assert reader(name)(hand_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_dropped_spans_no_reading(name, monkeypatch, capsys):
    record_program(monkeypatch)
    for i in range(obs.RING):
        obs.record("filler", 30.0 + i, 30.0 + i)
    assert obs.dropped() > 0
    assert reader(name)(hand_run()) is None
    assert "dropped" in capsys.readouterr().err


def test_spans_dropped_before_the_part_read_still_read(monkeypatch):
    for i in range(obs.RING):
        obs.record("filler", -1e6 + i, -1e6 + i)
    record_program(monkeypatch)
    assert obs.dropped() > 0
    assert reader("queue_wait_p90_ms")(hand_run()) == pytest.approx(469.0)
    assert reader("setup_lowering_s")(hand_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_no_recorder_no_reading(name, monkeypatch):
    record_program(monkeypatch)
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(__import__("sys").modules, "repro_torch.obs", None)
    assert reader(name)(hand_run()) is None


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_line_carries_the_new_metrics(cell, monkeypatch):
    # a fresh compile cache, as in the benchmark's own process
    monkeypatch.setattr(dispatch, "_DISPATCHER", None)
    spec, out = tiny_run(cell, 2 ** 31 + 91, True,
                         5.0 if "longdoc" in cell else 2.0)
    line = bench_run.result_line(spec, out, True, "cpu")
    want = {m["name"] for m in spec.per_layer if m["name"] in NEW}
    assert want and want <= set(line["metrics"])
    m = line["metrics"]
    if "decode_enqueue_ms.chat" in want:
        assert m["decode_enqueue_ms.chat"]["value"] <= \
            m["decode_step_ms.chat"]["value"]
    if "decode_busy_ms.chat" in want:
        assert m["decode_busy_ms.chat"]["value"] >= 0   # no device on CPU
