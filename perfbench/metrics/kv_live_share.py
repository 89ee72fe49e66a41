"""kv_live_share: mean share of the paged KV pool's positions that hold a
live token's K/V (the active slots' stored lengths and the token being
decoded) over the decode steps of the window's untraced part, in %.  The
pool itself is reserved whole at set-up (``memory_peak_bytes``)."""


def read(run):
    shares = run.kv_live_shares()
    return sum(shares) / len(shares) if shares else None
