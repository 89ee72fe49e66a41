"""mfu.decode: model FLOPs of the active slots' tokens, attention over
their real contexts, ÷ (the decodes' wall, from the decode call to the
step's end, × the bf16 peak), in %, over the window's untraced part."""

from yardstick import formulas as F


def read(run):
    m = run.model
    flops = wall = 0.0
    for s in run.steps:
        if s.decode is None or not run.untraced(s.t0, s.t1):
            continue
        t, active, keys = s.decode
        flops += active * (F.dense_linear_flops(m) + F.logits_flops(m)) \
            + F.attn_flops(m, keys)
        wall += s.t1 - t
    if not wall:
        return None
    return 100.0 * flops / (wall * F.PEAK_FLOPS[m["compute_dtype"]])
