"""Drivers: they offer a cell's traffic to the program's entry points on the
host's clock and keep what a run's metrics read.

* ``serve_open``: an open loop into ``ContinuousEngine.submit``/``step``.
  Each request is submitted at its due time, or as soon after it as the
  loop is free of a step; latency counts from the due time.  The engine's
  prefill and decode callables are wrapped for the time of the run, so
  each step knows the prefills (bucket, real length, span) and the decode
  (start, active slots, keys attended) that ran in it.
* ``serve_batches``: a closed loop of ``ServeEngine.generate`` calls, the
  next batch sent when one ends; its requests are due when it starts.

Token times: a request's first token is the engine's own stamp
(``t_first_token``, after the prefill's argmax reached the host); a
decoded token is stamped when its step returns (the step ends in the
token fetch).  In a batch, decoded token j is stamped ``t_end − (n − 1 −
j)·itl``, from the engine's mean time a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Req:
    """One request as the harness sees it."""

    rid: int
    due: float
    prompt: np.ndarray
    max_new: int
    tokens: list = dataclasses.field(default_factory=list)
    times: list = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None
    failed: bool = False

    @property
    def t_first(self) -> Optional[float]:
        return self.times[0] if self.times else None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


@dataclasses.dataclass
class Step:
    """One ``ContinuousEngine.step`` call."""

    t0: float
    t1: float = 0.0
    prefills: list = dataclasses.field(default_factory=list)
    decode: Optional[tuple] = None   # (start, active slots, keys attended)


@dataclasses.dataclass
class Batch:
    """One ``ServeEngine.generate`` call."""

    t0: float
    t1: float
    ttft_s: float
    itl_s: float
    n_seq: int
    prompt_len: int


def sync(device) -> None:
    """Wait for the card where ``device`` is one."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_open(engine, plan, t_start: float, t_close: float, tracer,
               trace_from: float, sync_prefill: bool):
    """Serve the open-loop ``plan`` (``traffic.Planned``, due relative to
    ``t_start``) until ``t_close``.  Returns (requests, steps)."""
    from repro_torch.serve.scheduler import Request
    dev = engine.device
    reqs = [Req(p.rid, t_start + p.due_s, p.prompt, p.max_new) for p in plan]
    steps: list[Step] = []
    inflight: list[tuple[Req, Request]] = []
    cur: list[Step] = []
    prefill0, decode0 = engine._prefill, engine._decode

    def prefill(params, batch, length):
        if sync_prefill:
            sync(dev)
        a = time.perf_counter()
        with tracer.span("bench.prefill"):
            out = prefill0(params, batch, length)
            if sync_prefill:
                sync(dev)
        cur[-1].prefills.append((int(batch["tokens"].shape[1]), int(length),
                                 a, time.perf_counter()))
        return out

    def decode(*args):
        active = engine.scheduler.active_slots
        keys = sum(int(engine.cache.seq_lens[s]) + 1 for s in active)
        cur[-1].decode = (time.perf_counter(), len(active), keys)
        with tracer.span("bench.decode"):
            return decode0(*args)

    engine._prefill, engine._decode = prefill, decode
    i = 0
    try:
        while True:
            now = time.perf_counter()
            if tracer.enabled and tracer.host[0] is None and \
                    now >= trace_from:
                tracer.start()
            if now >= t_close:
                break
            while i < len(reqs) and reqs[i].due <= now:
                r = reqs[i]
                pr = Request(r.rid, r.prompt, r.max_new, arrival_step=0)
                r.tokens = pr.out_tokens
                r.t_submit = time.perf_counter()
                try:
                    engine.submit(pr)
                    inflight.append((r, pr))
                except ValueError:
                    r.failed = True
                i += 1
            if not (engine.queue or engine.scheduler.has_active()):
                wake = min(reqs[i].due if i < len(reqs) else t_close, t_close)
                if tracer.enabled and tracer.host[0] is None:
                    wake = min(wake, trace_from)
                with tracer.span("bench.wait"):
                    time.sleep(max(0.0, wake - time.perf_counter()))
                continue
            cur.append(Step(time.perf_counter()))
            with tracer.span("bench.step"):
                engine.step()
            t1 = cur[-1].t1 = time.perf_counter()
            steps.append(cur[-1])
            left = []
            for r, pr in inflight:
                new = len(pr.out_tokens) - len(r.times)
                if new > 0 and not r.times:
                    r.times.append(pr.t_first_token)
                    new -= 1
                r.times.extend([t1] * new)
                if not r.done:
                    left.append((r, pr))
            inflight = left
        if tracer.active:
            tracer.stop()
    finally:
        engine._prefill, engine._decode = prefill0, decode0
    return reqs[:i], steps


def serve_batches(engine, batches, t_close: float, tracer,
                  trace_from: float):
    """Closed loop: ``generate`` a batch from ``batches``
    (``traffic.ClosedBatches``) whenever one ends, until ``t_close``; the
    batch running at the close runs to its end.  Returns (requests,
    batches)."""
    reqs, done = [], []
    rid = 0
    while time.perf_counter() < t_close:
        now = time.perf_counter()
        last = done[-1].t1 - done[-1].t0 if done else 0.0
        if tracer.enabled and tracer.host[0] is None and (
                now >= trace_from or now + last >= t_close):
            tracer.start()   # at the latest, for the window's last batch
        prompts = batches.next()
        t0 = time.perf_counter()
        with tracer.span("bench.batch"):
            out, st = engine.generate({"tokens": prompts}, batches.new)
        t1 = time.perf_counter()
        n = out.shape[1]
        done.append(Batch(t0, t1, st.ttft_s, st.itl_s, out.shape[0],
                          prompts.shape[1]))
        times = [t0 + st.ttft_s] + [t1 - (n - 1 - j) * st.itl_s
                                    for j in range(1, n)]
        for row in range(out.shape[0]):
            reqs.append(Req(rid, t0, prompts[row], n,
                            tokens=[int(x) for x in out[row]],
                            times=list(times), t_submit=t0))
            rid += 1
    if tracer.active:
        tracer.stop()
    return reqs, done
