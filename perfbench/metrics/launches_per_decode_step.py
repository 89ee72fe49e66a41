"""launches_per_decode_step: kernels the traced steps that decoded and
admitted nothing launched, ÷ those steps."""

import bisect


def read(run):
    if run.trace is None:
        return None
    traced = [s for s in run.steps if run.traced(s.t0, s.t1)]
    spans = sorted((s, e) for n, s, e in run.trace.annotations
                   if n == "bench.step")
    if len(spans) != len(traced):
        raise RuntimeError(f"{len(spans)} traced step spans for "
                           f"{len(traced)} steps")
    pure = [sp for st, sp in zip(traced, spans)
            if st.decode is not None and not st.prefills]
    if not pure:
        return None
    kernels = sorted(s for _, s, _ in run.trace.launches())
    n = sum(bisect.bisect_right(kernels, e) - bisect.bisect_left(kernels, s)
            for s, e in pure)
    return n / len(pure)
