"""itl_p95_ms: 95th percentile of every gap between consecutive output
tokens of a request that ends inside the window, pooled over requests, so
the stalls of prefills in other requests' steps count."""

from yardstick.stats import percentile


def read(run):
    gaps = [b - a for r in run.requests for a, b in zip(r.times, r.times[1:])
            if run.t_open <= b <= run.t_close]
    return 1e3 * percentile(gaps, 95) if gaps else None
