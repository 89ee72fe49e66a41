"""flash_prefill_roofline: the least time of the traced prefills'
attention (every layer, at the bucket the kernel was given, causal) ÷ the
device time of the kernels ``kernel_ops/flash_prefill.json`` names, in
%."""

from yardstick import formulas as F


def read(run):
    if run.trace is None or run.model["family"] != "dense":
        return None
    m = run.model
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    bound = 0.0
    for s in run.steps:
        for S, _, a, b in s.prefills:
            if run.traced(a, b):
                bound += m["n_layers"] * F.flash_bound_s(
                    1, S, S, m["n_heads"], m["n_kv_heads"], hd,
                    m["compute_dtype"], F.causal_pairs(S, S), S * S)
    took = run.kernel_time_s("flash_prefill")
    return 100.0 * bound / took if bound and took else None
