"""decode_busy_ms.chat: median ms per step that the device works inside
the traced slice's ``serve.step`` spans that decoded and admitted nothing
(moved by the ``bench.traced`` offset); the step's fetch has drained the
device before the next, so beside ``decode_enqueue_ms.chat`` it says host
or device."""

import statistics

from yardstick.spans import pure_decode_steps, program_spans
from yardstick.stats import union_length


def read(run):
    if run.trace is None:
        return None
    tr, h0 = run.trace, run.traced_host[0]
    spans = program_spans(h0)
    if spans is None:
        return None
    off = tr.t0 - h0
    ms = []
    for st, _ in pure_decode_steps(run, spans, run.traced):
        a, b = st.t0 + off, st.t1 + off
        ms.append(1e3 * union_length((max(s, a), min(e, b))
                                     for _, s, e in tr.device
                                     if s < b and e > a))
    return statistics.median(ms) if ms else None
