"""mfu.prefill: model FLOPs of the real prompt tokens prefilled ÷ (the
prefills' summed wall × the bf16 peak), in %, over the window's untraced
part.  Continuous cells time the engine's prefill callable between two
device syncs; the batch cell takes ``ServeStats.ttft_s`` (the prefill,
synced)."""

from yardstick import formulas as F


def read(run):
    m = run.model
    peak = F.PEAK_FLOPS[m["compute_dtype"]]
    flops = wall = 0.0
    if m["family"] == "dense":
        for s in run.steps:
            for _, n, a, b in s.prefills:
                if run.untraced(a, b):
                    flops += F.dense_prefill_flops(m, n)
                    wall += b - a
    else:
        for bt in run.batches:
            if run.untraced(bt.t0, bt.t1):
                flops += bt.n_seq * F.ssm_prefill_flops(m, bt.prompt_len)
                wall += bt.ttft_s
    return 100.0 * flops / (wall * peak) if wall else None
