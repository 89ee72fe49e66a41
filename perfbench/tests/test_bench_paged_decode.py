"""paged_decode_roofline (and its rag cell's twin) on hand-built runs: the least time of the traced
decode steps' K/V, q and output bytes ÷ the device time of K14's kernels;
None with no trace, no K14 kernel in it (a program without K14), or no
decode step in the traced slice."""

import pytest
from test_bench_arith import GRANITE, MAMBA, run_of
from yardstick import formulas as F
from yardstick.cell import kernel_patterns, reader
from yardstick.drivers import Step
from yardstick.tracing import Trace

READ = reader("paged_decode_roofline")
K14 = [("void pd::paged_decode_kernel<__nv_bfloat16, 128, 4>(...)",
        1.0, 1.00008),
       ("void pd::paged_decode_merge<__nv_bfloat16>(...)", 1.0001, 1.00012),
       ("void pd::paged_decode_kernel<__nv_bfloat16, 128, 4>(...)",
        2.0, 2.0001),
       ("void at::native::elementwise_kernel<128, 4>(...)", 2.001, 2.01)]
STEPS = [Step(11.0, 11.3, decode=(11.1, 3, 900)),    # traced
         Step(11.4, 11.6, decode=(11.5, 2, 41)),     # traced
         Step(11.6, 11.9, prefills=[(512, 300, 11.6, 11.8)]),
         Step(13.0, 13.2, decode=(13.1, 5, 5000))]   # after the slice


def trace(device):
    return Trace(0.9, 2.2, device, [("bench.traced", 0.9, 2.2)], [])


def test_reads_the_hand_computed_share():
    run = run_of(steps=STEPS, trace=trace(K14), traced=(10.5, 12.0))
    nbytes = 40 * 128 * 2 * ((900 + 41) * 2 * 8 + (3 + 2) * 2 * 32)
    took = 0.00008 + 0.00002 + 0.0001
    assert READ(run) == pytest.approx(100 * nbytes / 3.35e12 / took)
    assert F.HBM_BYTES_PER_S == 3.35e12


def test_names_the_kernel_and_its_merge_pass():
    pats = kernel_patterns("paged_decode")
    assert {"paged_decode_kernel", "paged_decode_merge"} <= set(pats)
    run = run_of(steps=STEPS, trace=trace(K14), traced=(10.5, 12.0))
    assert run.kernel_time_s("paged_decode") == pytest.approx(0.0002)


@pytest.mark.parametrize("what", ["no_trace", "no_k14", "no_decode", "ssm"])
def test_nothing_to_read(what):
    kw = dict(steps=STEPS, trace=trace(K14), traced=(10.5, 12.0))
    if what == "no_trace":
        kw.update(trace=None, traced=None)
    elif what == "no_k14":                # the parent: the gather path
        kw.update(trace=trace(K14[3:]))
    elif what == "no_decode":
        kw.update(steps=STEPS[2:])
    else:
        kw.update(model=MAMBA)
    assert READ(run_of(**kw)) is None


def test_the_rag_cells_metric_reads_the_same():
    run = run_of(steps=STEPS, trace=trace(K14), traced=(10.5, 12.0))
    assert reader("paged_decode_roofline.rag")(run) == READ(run)
    assert reader("paged_decode_roofline.rag")(run_of(steps=STEPS)) is None
