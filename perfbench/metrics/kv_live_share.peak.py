"""kv_live_share.peak: the highest share of the paged KV pool's positions
that hold a live token's K/V at one decode step of the window's untraced
part, in % (``kv_live_share``'s peak)."""


def read(run):
    shares = run.kv_live_shares()
    return max(shares) if shares else None
