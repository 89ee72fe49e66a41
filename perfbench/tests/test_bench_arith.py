"""The yardstick's arithmetic: percentiles over every request (the
unfinished at their age), idle share as a union, roofline bounds and MFU
against hand-computed shapes and the bound µs PERF.md gives."""

import random

import numpy as np
import pytest
import torch
from yardstick import check
from yardstick import formulas as F
from yardstick.cell import Run, reader
from yardstick.drivers import Batch, Req, Step
from yardstick.stats import gaps, percentile, union_length
from yardstick.tracing import Trace

GRANITE = {"family": "dense", "n_layers": 40, "d_model": 4096, "n_heads": 32,
           "n_kv_heads": 8, "head_dim": 128, "d_ff": 12800, "vocab": 49155,
           "compute_dtype": "bfloat16"}
MAMBA = {"family": "ssm", "n_layers": 64, "d_model": 2560, "vocab": 50288,
         "ssm": {"d_state": 128, "head_dim": 64, "expand": 2,
                 "conv_width": 4}, "compute_dtype": "bfloat16"}


def run_of(requests=(), steps=(), batches=(), trace=None, model=GRANITE,
           t_open=10.0, t_close=20.0, traced=None, cell=None):
    return Run(model, cell or {"engine": {"max_batch": 4}}, t_close - t_open,
               t_open, t_close, traced[0] if traced else t_close, 1.0,
               list(requests), list(steps), list(batches), trace, traced)


def test_percentile_is_numpys_linear():
    rng = random.Random(3)
    for n in (1, 2, 7, 120):
        xs = [rng.random() for _ in range(n)]
        for q in (50, 90, 95):
            assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_ttft_counts_unfinished_requests_at_their_age():
    done = [Req(i, 10.0 + i, np.zeros(4), 2, times=[10.0 + i + 0.1])
            for i in range(9)]
    never = Req(9, 19.0, np.zeros(4), 2)            # nothing by the close
    late = Req(10, 19.5, np.zeros(4), 2, times=[25.0])
    early = Req(11, 5.0, np.zeros(4), 2, times=[30.0])  # due before: out
    run = run_of([*done, never, late, early])
    ages = [0.1] * 9 + [1.0, 0.5]
    assert reader("ttft_p90_ms")(run) == pytest.approx(
        1e3 * np.percentile(ages, 90))


def test_itl_pools_gaps_ending_in_the_window():
    a = Req(0, 9.0, np.zeros(1), 4, times=[9.5, 10.5, 11.0, 21.0])
    b = Req(1, 11.0, np.zeros(1), 3, times=[11.2, 11.4, 11.6])
    run = run_of([a, b])
    want = [1.0, 0.5, 0.2, 0.2]
    assert reader("itl_p95_ms")(run) == pytest.approx(
        1e3 * np.percentile(want, 95))
    assert reader("out_tokens_per_s")(run) == pytest.approx(5 / 10)


def test_union_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 2.5), (2.4, 2.6), (4.0, 5.0)]
    assert union_length(iv) == pytest.approx(3.1)
    assert gaps(iv, 0.0, 5.0) == [(1.5, 2.0), (2.6, 4.0)]
    tr = Trace(0.0, 5.0, [("k", s, e) for s, e in iv],
               [("bench.step", 0.0, 5.0)], [])
    assert reader("device_idle_share")(run_of(trace=tr)) == \
        pytest.approx(100 * (1 - 3.1 / 5.0))
    br = tr.breakdown()
    assert br["device_ops"] == [["k", pytest.approx(3.7)]]
    assert br["idle_gaps"] == [["bench.step", pytest.approx(1.9)]]


def test_flash_bound_of_granites_512_prefill():
    S = 512
    b = F.flash_bound_s(1, S, S, 32, 8, 128, "bfloat16",
                        F.causal_pairs(S, S), S * S)
    assert round(b * 1e6, 2) == 3.21           # PERF.md's K3 row, bytes
    assert F.causal_pairs(S, S) == S * (S + 1) // 2
    assert F.causal_pairs(2, 4) == 3 + 4


def test_ssd_bound_of_k8s_main_case():
    b = F.ssd_bound_s(4, 80, 512, 64, 128, 4)
    assert round(b * 1e6, 2) == 32.54          # PERF.md's K7/K8 rows


def test_model_flops_by_hand():
    lin = 2 * 40 * (4096 * 128 * (2 * 32 + 2 * 8) + 3 * 4096 * 12800)
    assert F.dense_linear_flops(GRANITE) == lin
    assert F.dense_prefill_flops(GRANITE, 3) == (
        3 * lin + 4 * 40 * 32 * 128 * 6 + 2 * 4096 * 49155)
    per = (2 * 2560 * (2 * 5120 + 2 * 128 + 80) + 2 * 5120 * 2560
           + 2 * 4 * (5120 + 256) + 4 * 80 * 128 * 64)
    assert F.ssm_token_flops(MAMBA) == 64 * per
    assert F.ssm_prefill_flops(MAMBA, 5) == 5 * 64 * per + 2 * 2560 * 50288


def test_mfu_readers():
    st = Step(11.0, 11.5, prefills=[(512, 300, 11.0, 11.2)],
              decode=(11.2, 3, 900))
    run = run_of(steps=[st])
    peak = 989e12
    assert reader("mfu.prefill")(run) == pytest.approx(
        100 * F.dense_prefill_flops(GRANITE, 300) / (0.2 * peak))
    dec = 3 * (F.dense_linear_flops(GRANITE) + F.logits_flops(GRANITE)) \
        + F.attn_flops(GRANITE, 900)
    assert reader("mfu.decode")(run) == pytest.approx(
        100 * dec / (0.3 * peak))
    assert reader("slot_occupancy")(run) == pytest.approx(75.0)
    # 900 live keys of 4 slots x 1024 positions; 300 at a second step
    kv = run_of(steps=[st, Step(11.5, 11.6, decode=(11.5, 1, 300))],
                cell={"engine": {"max_batch": 4, "max_len": 1024}})
    assert reader("kv_live_share")(kv) == pytest.approx(
        100 * (900 + 300) / 2 / 4096)
    assert reader("kv_live_share.peak")(kv) == pytest.approx(
        100 * 900 / 4096)
    bt = Batch(11.0, 12.0, 0.4, 0.05, 16, 2040)
    mrun = run_of(batches=[bt], model=MAMBA)
    assert reader("mfu.prefill")(mrun) == pytest.approx(
        100 * 16 * F.ssm_prefill_flops(MAMBA, 2040) / (0.4 * peak))
    assert reader("decode_step_ms.batch")(mrun) == pytest.approx(50.0)
    assert reader("mfu.prefill.batch")(mrun) == reader("mfu.prefill")(mrun)


def test_roofline_and_launch_readers():
    steps = [Step(11.0, 11.5, prefills=[(512, 300, 11.0, 11.2)],
                  decode=(11.2, 1, 300)),
             Step(11.5, 11.6, decode=(11.5, 1, 301))]
    kern = [("void flash_kernel<128, __nv_bfloat16, 2>(...)", 1.0, 1.0004),
            ("other", 1.0005, 1.0006), ("Memcpy HtoD", 1.0007, 1.0008),
            ("k1", 2.01, 2.02), ("k2", 2.03, 2.04), ("Memset", 2.05, 2.06)]
    ann = [("bench.traced", 0.9, 2.2), ("bench.step", 1.0, 2.0),
           ("bench.step", 2.0, 2.1)]
    tr = Trace(0.9, 2.2, kern, ann, [])
    run = run_of(steps=steps, trace=tr, traced=(10.5, 12.0))
    bound = 40 * F.flash_bound_s(1, 512, 512, 32, 8, 128, "bfloat16",
                                 F.causal_pairs(512, 512), 512 * 512)
    assert reader("flash_prefill_roofline")(run) == pytest.approx(
        100 * bound / 0.0004)
    assert reader("launches_per_decode_step")(run) == 2
    assert reader("ssd_scan_roofline")(run) is None   # no SSD kernel ran


def test_kv_error_sees_each_stretch_apart():
    g = torch.Generator().manual_seed(3)
    ref = [(torch.randn(2, 40, 1, 8, generator=g),
            torch.randn(2, 40, 1, 8, generator=g))]
    same = [(ref[0][0].clone(), ref[0][1] * 1.01)]
    assert check.kv_error(ref, same, [30]) == pytest.approx(0.01, rel=1e-4)
    # one layer's decoded V left at zero: a tenth of the positions
    lost = [(ref[0][0].clone(), ref[0][1].clone())]
    lost[0][1][1, 36:] = 0
    assert check.kv_error(ref, lost, [30]) == pytest.approx(
        float((ref[0][1][1, 36:]).norm() / ref[0][1][1, 30:].norm()))
    lost[0][1][1, 30:] = 0
    assert check.kv_error(ref, lost, [30]) == pytest.approx(1.0)
