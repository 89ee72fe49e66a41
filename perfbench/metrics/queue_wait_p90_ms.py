"""queue_wait_p90_ms: 90th percentile of the program's ``serve.queued``
spans (``submit`` → the start of that request's admission: prefills ahead
and the head-of-line page wait) that end in the window's untraced part,
~112 samples in chat and ~84 in rag; warm-up requests left out."""

from yardstick.spans import program_spans
from yardstick.stats import percentile


def read(run):
    spans = program_spans(run.t_open)
    if spans is None:
        return None
    ms = [1e3 * (s.t1 - s.t0) for s in spans
          if s.name == "serve.queued" and s.rid >= 0
          and run.untraced(s.t1, s.t1)]
    return percentile(ms, 90) if ms else None
