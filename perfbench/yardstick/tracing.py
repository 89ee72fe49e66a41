"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over whole
engine steps, and its reduction to device intervals, the harness's own
annotations and the host's operators.

The harness names its calls into the program with ``record_function``
annotations (``bench.step``, ``bench.prefill``, ``bench.decode``,
``bench.batch``, ``bench.wait``); their times and the device's share one
clock in the profiler's trace, so a kernel, or an idle stretch of the
device, is placed inside the step and the call the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

from .stats import gaps, union_length


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    return fn() if fn is not None else int(getattr(e, f"{which}_us")() * 1e3)


@dataclasses.dataclass
class Trace:
    """Reduced trace, times in seconds on the profiler's clock."""

    t0: float
    t1: float
    device: list          # (name, start, end): kernels, copies, sets
    annotations: list     # (name, start, end): the harness's bench.* spans
    host_ops: list        # (name, start, end): the host's operators
    _starts: tuple = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float:
        return union_length((s, e) for _, s, e in self.device)

    def launches(self) -> list:
        """Device events that are kernels (not copies or sets)."""
        return [ev for ev in self.device
                if not ev[0].startswith(("Memcpy", "Memset"))]

    def host_at(self, t: float) -> str:
        """What the host was in at ``t``: the innermost annotation and the
        innermost operator around it."""
        if self._starts is None:
            self._starts = ([s for _, s, _ in self.annotations],
                            [s for _, s, _ in self.host_ops])
        found = (_innermost(self.annotations, self._starts[0], t),
                 _innermost(self.host_ops, self._starts[1], t))
        return " > ".join(x for x in found if x) or "outside the harness"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle
        stretches summed by what the host was doing, ``top`` of each."""
        by_op: dict[str, float] = {}
        for n, s, e in self.device:
            by_op[n[:160]] = by_op.get(n[:160], 0.0) + (e - s)
        idle: dict[str, float] = {}
        for a, b in gaps([(s, e) for _, s, e in self.device], self.t0,
                         self.t1):
            key = self.host_at((a + b) / 2)
            idle[key] = idle.get(key, 0.0) + (b - a)
        best = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(by_op), "idle_gaps": best(idle)}


def _innermost(events, starts, t: float):
    """Name of the latest-starting event that contains ``t`` (``events``
    sorted by start, ``starts`` their starts)."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(-1, k - 200), -1):
        if events[j][2] >= t:
            return events[j][0]
    return None


class Tracer:
    """Starts and stops the profiler between engine steps; a no-op when
    disabled (``--trace 0``)."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self._outer = None
        self.active = False
        self.host = (None, None)     # host clock at start and stop

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so that the tracing
        library's own start-up does not fall in the window."""
        if self.enabled:
            self.start()
            torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
            self.stop()
            self.prof, self.host = None, (None, None)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        self.prof.start()
        self.active = True
        self.host = (time.perf_counter(), None)
        self._outer = torch.profiler.record_function("bench.traced")
        self._outer.__enter__()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def stop(self) -> None:
        self._sync()
        self._outer.__exit__(None, None, None)
        self.host = (self.host[0], time.perf_counter())
        self.prof.stop()
        self.active = False

    def span(self, name: str):
        """A ``record_function`` annotation while tracing, else nothing."""
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def reduce(self) -> Trace:
        """The trace of the last start/stop, reduced."""
        from torch.autograd import DeviceType
        device, ann, host = [], [], []
        t0, t1 = None, None
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start") * 1e-9
            end = s + e.duration_ns() * 1e-9
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not name.startswith("bench."):  # not the device's copy
                    device.append((name, s, end))  # of an annotation
            elif name.startswith("bench."):
                ann.append((name, s, end))
                if name == "bench.traced":
                    t0, t1 = s, end
            else:
                host.append((name, s, end))
        if t0 is None:
            raise RuntimeError("the trace lacks its bench.traced span")
        device.sort(key=lambda ev: ev[1])
        ann.sort(key=lambda ev: ev[1])
        host.sort(key=lambda ev: ev[1])
        return Trace(t0, t1, device, ann, host)
