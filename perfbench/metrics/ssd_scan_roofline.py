"""ssd_scan_roofline: the least time of the traced batches' SSD scans
(every layer, fp32 I/O as the model hands them over) ÷ the device time of
the kernels ``kernel_ops/ssd_scan.json`` names, in %."""

from yardstick import formulas as F


def read(run):
    if run.trace is None or run.model["family"] != "ssm":
        return None
    m = run.model
    _, H, N, P, _ = F.ssm_dims(m)
    bound = sum(m["n_layers"] * F.ssd_bound_s(b.n_seq, H, b.prompt_len, P, N,
                                              4)
                for b in run.batches if run.traced(b.t0, b.t1))
    took = run.kernel_time_s("ssd_scan")
    return 100.0 * bound / took if bound and took else None
