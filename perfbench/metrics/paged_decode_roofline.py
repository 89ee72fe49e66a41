"""paged_decode_roofline: the least time of the traced decode steps'
attention (every layer: each active slot's attended keys' K and V read
once, its query rows read and output rows written once, at the HBM rate)
÷ the device time of the kernels ``kernel_ops/paged_decode.json`` names,
in %.  None where no such kernel ran in the trace."""

from yardstick import formulas as F


def read(run):
    if run.trace is None or run.model["family"] != "dense":
        return None
    m = run.model
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    item = F.ITEMSIZE[m["compute_dtype"]]
    nbytes = 0
    for s in run.steps:
        if s.decode is None or not run.traced(s.decode[0], s.t1):
            continue
        _, active, keys = s.decode
        nbytes += m["n_layers"] * hd * item * (
            keys * 2 * m["n_kv_heads"] + active * 2 * m["n_heads"])
    took = run.kernel_time_s("paged_decode")
    if not nbytes or not took:
        return None
    return 100.0 * nbytes / F.HBM_BYTES_PER_S / took
