"""decode_enqueue_ms.batch: median ms the host takes to enqueue one decode
step of ``ServeEngine.generate`` (the program's ``serve.decode.enqueue``
span: the step and its argmax, before the fetch waits), over the
``serve.generate`` spans of the window's untraced part."""

import statistics

from yardstick.spans import children, program_spans


def read(run):
    spans = program_spans(run.t_open)
    if spans is None:
        return None
    kids = children(spans)
    ms = [1e3 * (c.t1 - c.t0) for s in spans
          if s.name == "serve.generate" and run.untraced(s.t0, s.t1)
          for c in kids.get(s.idx, ()) if c.name == "serve.decode.enqueue"]
    return statistics.median(ms) if ms else None
