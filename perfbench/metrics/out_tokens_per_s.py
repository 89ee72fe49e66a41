"""out_tokens_per_s: output tokens produced inside the window ÷ the
window's seconds."""


def read(run):
    n = sum(run.t_open <= t <= run.t_close for r in run.requests
            for t in r.times)
    return n / run.seconds
