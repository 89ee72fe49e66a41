"""decode_step_ms.chat: median wall ms of the ``ContinuousEngine.step``
calls that decoded and admitted nothing, in the window's untraced part
(the step ends in its token fetch, a device sync)."""

import statistics


def read(run):
    ms = [1e3 * (s.t1 - s.t0) for s in run.steps
          if s.decode is not None and not s.prefills
          and run.untraced(s.t0, s.t1)]
    return statistics.median(ms) if ms else None
