"""decode_step_ms.batch: median of ``ServeEngine.generate``'s mean time a
decode step (``ServeStats.itl_s``) over the batches of the window's
untraced part."""

import statistics


def read(run):
    ms = [1e3 * b.itl_s for b in run.batches if run.untraced(b.t0, b.t1)]
    return statistics.median(ms) if ms else None
