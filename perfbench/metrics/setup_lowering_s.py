"""setup_lowering_s: seconds of ``setup_s`` in the program's lowering
decisions (``lower.decide`` spans, each with its e-graph saturation where
a spec's first key ran it, overlaps once) that end before the schedule's
start: the engine's own lookups and the warm-up's misses."""

from yardstick.spans import program_spans
from yardstick.stats import union_length


def read(run):
    spans = program_spans(float("-inf"))
    if spans is None:
        return None
    start = run.t_open - run.cell.get("ramp_s", 0)
    took = [(s.t0, s.t1) for s in spans
            if s.name == "lower.decide" and s.t1 <= start]
    return union_length(took) if took else None
