"""The port's interface model, synthesis and kernel schedule synthesis
(``repro_torch.core.{interface_model,aquas_ir,synthesis,kernel_synth}``,
``roofline.analysis``, ``core.tiling.dtype_itemsize``) against the
reference's on the CPU, and the H100 instance's picks.

The reference's cases of ``tests/test_interface_model.py`` run on the
port's modules (its hypothesis properties over fixed draws).  With the TPU
instance every ``choose_*_blocks`` returns the reference's
``KernelSchedule`` field for field, at the golden keys'
(``tests/golden/dispatch_records.json``) and the reference tests' shapes.
With the H100 instance (``kernels/schedule.py`` over
``kernel_synth.decide_hopper``, on a card of 132 SMs) the model picks the
faster kernel of each pair at every shape the card has measured both
(PERF.md)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import interface_model as jim
from repro.core import kernel_synth as jks
from repro.core import synthesis as jsyn
from repro.core.tiling import dtype_itemsize as jitemsize
from repro.roofline import analysis as jroof
from repro_torch.core import aquas_ir as ir
from repro_torch.core import kernel_synth as ks
from repro_torch.core.interface_model import (MemInterface, approx_latency,
                                              hopper_interfaces,
                                              paper_example_interfaces,
                                              sequence_latency,
                                              tpu_interfaces)
from repro_torch.core.synthesis import (elide_scratchpads,
                                        schedule_transactions,
                                        select_interfaces, synthesize)
from repro_torch.core.tiling import dtype_itemsize
from repro_torch.kernels import schedule
from repro_torch.roofline import analysis as roof


class TestModel:
    def test_legal_transactions(self):
        bus = paper_example_interfaces()["busitfc"]
        assert bus.is_legal_transaction(64)
        assert bus.is_legal_transaction(4)
        assert not bus.is_legal_transaction(12)   # not a power-of-two beats
        assert not bus.is_legal_transaction(128)  # exceeds M·W
        assert not bus.is_legal_transaction(8, addr=4)  # misaligned

    def test_figure4b_canonicalization(self):
        bus = paper_example_interfaces()["busitfc"]
        assert bus.decompose(108) == [64, 32, 8, 4]

    def test_recurrence_single_transaction(self):
        itf = MemInterface("t", W=4, M=1, I=1, L=2, E=1, C=64)
        assert sequence_latency(itf, [4], "load") == 2
        assert sequence_latency(itf, [4], "store") == 1

    def test_recurrence_inflight_pipelining(self):
        i1 = MemInterface("a", W=4, M=1, I=1, L=6, E=1, C=64)
        i2 = MemInterface("b", W=4, M=1, I=2, L=6, E=1, C=64)
        sizes = [4] * 8
        assert sequence_latency(i2, sizes, "load") < \
            sequence_latency(i1, sizes, "load")

    def test_figure2_suboptimal_gap(self):
        itfcs = paper_example_interfaces()
        cpu, bus = itfcs["cpuitfc"], itfcs["busitfc"]
        lat_cpu = sequence_latency(cpu, cpu.decompose(108), "load")
        lat_bus = sequence_latency(bus, bus.decompose(108), "load")
        assert lat_bus < lat_cpu
        assert lat_cpu - lat_bus >= 7

    @pytest.mark.parametrize("seed", range(50))
    def test_latency_monotone_in_sequence(self, seed):
        """Adding a transaction never reduces completion time; the
        approximation stays within 3x of the recurrence; both equal the
        reference's."""
        rng = np.random.default_rng(seed)
        sizes = [int(s) for s in rng.choice([4, 8, 16, 32, 64],
                                            size=rng.integers(1, 13))]
        direction = ("load", "store")[seed % 2]
        bus = paper_example_interfaces()["busitfc"]
        jbus = jim.paper_example_interfaces()["busitfc"]
        full = sequence_latency(bus, sizes, direction)
        assert full == jim.sequence_latency(jbus, sizes, direction)
        assert full >= sequence_latency(bus, sizes[:-1], direction)
        assert full > 0
        approx = approx_latency(bus, [[s] for s in sizes], direction)
        assert approx == jim.approx_latency(jbus, [[s] for s in sizes],
                                            direction)
        assert approx <= 3 * full + 10 and full <= 3 * approx + 10

    def test_tpu_interfaces_are_the_references(self):
        t = tpu_interfaces()
        assert t["hbm_vmem"].W * t["hbm_vmem"].M >= 512 * 1024
        assert t["vmem_vreg"].L < t["hbm_vmem"].L < t["ici_link"].L
        assert {k: dataclasses.asdict(v) for k, v in t.items()} == {
            k: dataclasses.asdict(v) for k, v in jim.tpu_interfaces().items()}

    @pytest.mark.parametrize("m", [1, 3, 4, 17, 64, 108, 200, 511, 512])
    def test_decompose_covers_request(self, m):
        for name, itf in paper_example_interfaces().items():
            chunks = itf.decompose(m)
            assert chunks == jim.paper_example_interfaces()[name].decompose(m)
            assert m <= sum(chunks) < m + itf.W
            assert all(itf.is_legal_transaction(c) for c in chunks)


def _fir7_program():
    sp = {
        "bias": ir.ScratchpadDecl("bias", 28, ir.CacheHint.WARM,
                                  compute_cycles_per_elem=8.0, elem_bytes=4),
        "coef": ir.ScratchpadDecl("coef", 28, ir.CacheHint.WARM,
                                  reuse_factor=7, elem_bytes=4),
    }
    ops = [
        ir.FuncOp("transfer", "src", 108, ir.Space.GLOBAL,
                  ir.Space.SCRATCHPAD, "load", ir.CacheHint.COLD),
        ir.FuncOp("transfer", "coef", 28, ir.Space.GLOBAL,
                  ir.Space.SCRATCHPAD, "load", ir.CacheHint.WARM,
                  scratchpad="coef"),
        ir.FuncOp("transfer", "bias", 28, ir.Space.GLOBAL,
                  ir.Space.SCRATCHPAD, "load", ir.CacheHint.WARM,
                  scratchpad="bias"),
        ir.FuncOp("read_smem", "bias_rd", 28, ir.Space.SCRATCHPAD,
                  ir.Space.REG, "load", scratchpad="bias"),
        ir.FuncOp("transfer", "dst", 80, ir.Space.REG, ir.Space.GLOBAL,
                  "store", ir.CacheHint.COLD),
    ]
    return ir.FunctionalProgram("fir7", ops, sp)


class TestSynthesis:
    def test_elision_decisions(self):
        out, decisions = elide_scratchpads(_fir7_program(),
                                           paper_example_interfaces())
        assert decisions["scratchpad:bias"] == "elided"
        assert decisions["scratchpad:coef"] == "kept"
        assert "bias" not in out.scratchpads and "coef" in out.scratchpads
        kinds = [(o.kind, o.name) for o in out.ops]
        assert ("fetch", "bias_rd") in kinds
        assert ("transfer", "bias") not in kinds

    def test_elision_respects_legality_guards(self):
        sp = ir.ScratchpadDecl("t", 28, accessed_in_unrolled_region=True,
                               compute_cycles_per_elem=100.0)
        prog = ir.FunctionalProgram("p", [
            ir.FuncOp("transfer", "t", 28, ir.Space.GLOBAL,
                      ir.Space.SCRATCHPAD, "load", scratchpad="t")],
            {"t": sp})
        _, decisions = elide_scratchpads(prog, paper_example_interfaces())
        assert decisions["scratchpad:t"] == "kept"

    def test_interface_selection_routes_bulk_to_bus(self):
        prog, _ = elide_scratchpads(_fir7_program(),
                                    paper_example_interfaces())
        arch = select_interfaces(prog, paper_example_interfaces())
        assert arch.decisions["itfc:src"] == "busitfc"
        assert [o.size_bytes for o in arch.ops if o.name == "src"] == \
            [64, 32, 8, 4]

    def test_selection_is_optimal_vs_bruteforce(self):
        from repro_torch.core.synthesis import _assign_exact, _objective
        itfcs = list(paper_example_interfaces().values())
        ops = [ir.FuncOp("fetch", f"q{i}", sz, ir.Space.GLOBAL, ir.Space.REG,
                         "load")
               for i, sz in enumerate([4, 28, 64, 108])]
        assign, cost = _assign_exact(ops, itfcs, "load")
        for trial in itertools.product(range(len(itfcs)), repeat=len(ops)):
            assert cost <= _objective(trial, ops, itfcs, "load") + 1e-9

    def test_schedule_beats_naive_order(self):
        itfcs = paper_example_interfaces()
        prog, _ = elide_scratchpads(_fir7_program(), itfcs)
        temporal = schedule_transactions(select_interfaces(prog, itfcs))
        assert temporal.total_cycles > 0
        assert [o for o in temporal.ops if o.kind == "copy_issue"]
        assert [o for o in temporal.ops if o.kind == "copy_wait"]
        ids = {o.op_id for o in temporal.ops}
        assert all(o.after is None or o.after in ids for o in temporal.ops)


def test_full_pipeline_decisions_logged():
    """The port's synthesis of the paper's fir7 kernel logs its decisions
    and totals the reference's cycles."""
    t = synthesize(_fir7_program(), paper_example_interfaces())
    assert "scratchpad:bias" in t.decisions
    assert any(k.startswith("itfc:") for k in t.decisions)
    assert any(k.startswith("order:") for k in t.decisions)
    from repro.core import aquas_ir as jir
    jprog = jir.FunctionalProgram("fir7", [
        jir.FuncOp(o.kind, o.name, o.size_bytes, jir.Space(o.src_space.value),
                   jir.Space(o.dst_space.value), o.direction,
                   jir.CacheHint(o.cache_hint.value), scratchpad=o.scratchpad)
        for o in _fir7_program().ops], {
        k: jir.ScratchpadDecl(**{**dataclasses.asdict(v), "cache_hint":
                                 jir.CacheHint(v.cache_hint.value)})
        for k, v in _fir7_program().scratchpads.items()})
    want = jsyn.synthesize(jprog, jim.paper_example_interfaces())
    assert t.total_cycles == want.total_cycles
    assert t.decisions == want.decisions


# ---------------------------------------------------------------------------
# kernel_synth's TPU instance: the reference's KernelSchedule field for field
# ---------------------------------------------------------------------------

def _fields(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


TPU_CASES = [
    # golden keys (tests/golden/dispatch_records.json) as their schedulers
    # call the choosers, then tests/test_interface_model.py's shapes, then
    # the main path's and the Motivation's
    ("flash", (16, 16, 16, 4)), ("matmul", (16, 128, 64, 1)),
    ("fps", (256, 64, 4)), ("ball", (64, 256, 8, 4)),
    ("group", (64, 256, 8, 32, 4)),
    ("matmul", (4096, 4096, 4096)), ("matmul", (8, 4096, 8192, 1)),
    ("flash", (4096, 4096, 128)), ("ssd", (4096, 80, 64, 128)),
    ("flash", (512, 512, 64, 4)), ("flash", (128, 128, 64, 2)),
    ("flash", (256, 256, 256, 4)), ("matmul", (512, 32000, 768, 1)),
    ("matmul", (8, 768, 768, 1)), ("ssd", (512, 80, 64, 128)),
    ("ssd", (40, 80, 64, 128)), ("ssd", (20, 16, 8, 16)),
    ("fps", (4096, 512, 4)), ("ball", (512, 4096, 16, 4)),
    ("ball", (512, 1024, 32, 4)), ("group", (512, 4096, 16, 64, 4)),
    ("group", (512, 1024, 32, 64, 2)), ("group", (128, 512, 64, 128, 4)),
]
CHOOSERS = {"flash": "choose_flash_blocks", "matmul": "choose_matmul_blocks",
            "ssd": "choose_ssd_blocks", "fps": "choose_fps_blocks",
            "ball": "choose_ball_blocks", "group": "choose_group_blocks"}


@pytest.mark.parametrize("kind,args", TPU_CASES)
def test_tpu_instance_schedules_are_the_references(kind, args):
    got = getattr(ks, CHOOSERS[kind])(*args)
    want = getattr(jks, CHOOSERS[kind])(*args)
    assert _fields(got) == _fields(want)
    assert ks.pipeline_fields(got) == jks.pipeline_fields(want)


def test_matmul_blocks_fit_and_align():
    s = ks.choose_matmul_blocks(4096, 4096, 4096)
    assert s.vmem_bytes <= ks.TPU_VMEM_BUDGET
    assert s.block("b")[1] % ks.MXU_DIM == 0
    assert not s.pipelined
    skinny = ks.choose_matmul_blocks(8, 4096, 8192, dtype_bytes=1)
    assert skinny.pipelined and skinny.buffering > 2


def test_flash_blocks_prefer_streaming_kv():
    s = ks.choose_flash_blocks(4096, 4096, 128)
    assert s.decisions["kv_hint"] == "cold"
    assert s.decisions["q_hint"] == "warm"


@pytest.mark.parametrize("flops,nbytes", [(1e9, 1e6), (1e6, 1e9), (0, 0),
                                          (3e12, 2e10)])
def test_pipeline_speedup_is_the_references_at_its_peaks(flops, nbytes):
    assert roof.pipeline_speedup(flops, nbytes, peaks=roof.TPU_V5E) == \
        jroof.pipeline_speedup(flops, nbytes)
    r = roof.roofline(flops, nbytes, 1e6, 1, peaks=roof.TPU_V5E)
    assert r.row() == jroof.roofline(flops, nbytes, 1e6, 1).row()


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16", "int8",
                                  "float64"])
def test_dtype_itemsize_takes_names_and_torch_dtypes(name):
    assert dtype_itemsize(name) == jitemsize(name)
    assert dtype_itemsize(f"torch.{name}") == jitemsize(name)
    assert dtype_itemsize(getattr(torch, name)) == jitemsize(name)


# ---------------------------------------------------------------------------
# kernel_synth's H100 instance
# ---------------------------------------------------------------------------

def test_hopper_interfaces_share_the_device_rate():
    """One SM alone pulls what the probe measured; all 132 share the
    device's rate; latencies order L2 < HBM, shared memory below both."""
    alone, full = hopper_interfaces(1), hopper_interfaces(132)
    assert alone["hbm_smem"].W > full["hbm_smem"].W >= 12
    assert alone["l2_smem"].W > full["l2_smem"].W
    assert full["smem_reg"].L < full["l2_smem"].L < full["hbm_smem"].L
    for itf in full.values():
        assert itf.W * itf.M >= 128


def test_hopper_model_overlaps_copies_by_residency_and_ring():
    """A baseline grid with blocks to spare on every SM hides its copies
    like a ring does; one block an SM does not, and then the ring wins."""
    one = dict(blocks=132, steps=8, compute=2000.0, tile_bytes=32768)
    base = ks.hopper_cycles(ks.HopperGrid(resident=1, **one))
    ring = ks.hopper_cycles(ks.HopperGrid(resident=1, depth=2, **one))
    assert ring < base
    four = dict(one, blocks=4 * 132)
    base4 = ks.hopper_cycles(ks.HopperGrid(resident=4, **four))
    ring4 = ks.hopper_cycles(ks.HopperGrid(resident=4, depth=2, **four))
    assert ring4 >= 0.98 * base4


def test_hopper_never_pipelines_one_streamed_tile():
    g = dict(blocks=64, resident=1, compute=10.0, tile_bytes=1 << 16)
    sched = ks.decide_hopper("t", ks.HopperGrid(steps=1, **g),
                             ks.HopperGrid(steps=1, depth=2, **g),
                             flops=1e6, hbm_bytes=1e8, kind="fp32")
    assert not sched.pipelined


SMS = 132
#: (schedule function, arguments, the faster kernel on the card: PERF.md
#: §6 and the pair sweeps of PRs 12-17, NVIDIA H100 80GB HBM3 at 700 W)
MEASURED = [
    (schedule.flash_schedule, (1, 256, 12, 12, 256, 64, 4),
     "flash_attention"),                               # 25.82 vs K3 27.41
    (schedule.flash_schedule, (1, 512, 12, 12, 512, 64, 4),
     "flash_attention"),                               # 47.94 vs 50.54
    (schedule.ball_schedule, (2, 4096, 512, 16, 4), "ball_query"),
    (schedule.ball_schedule, (16, 1024, 512, 32, 4), "ball_query"),
    (schedule.group_schedule, (2, 4096, 512, 16, 64, 4), "group_aggregate"),
    (schedule.group_schedule, (16, 1024, 512, 32, 64, 2), "group_aggregate"),
    (schedule.group_schedule, (16, 1024, 512, 32, 64, 4),
     "group_aggregate_pipelined"),                     # 8.05 vs K12 8.53
    (schedule.group_schedule, (16, 512, 128, 64, 128, 4),
     "group_aggregate_pipelined"),                     # sa2: 6.78 vs 8.26
    (schedule.ssd_schedule, (4, 512, 80, 64, 128, 4),
     "ssd_scan_pipelined"),                            # 233.04 vs 268.72
    # (i2) in fp32: K5 at M = 8 (13.83 / 5.85 / 6.94 / 6.81 µs), K4 at M =
    # 512 (212.95 / 15.34 / 19.38 / 23.50), PERF.md's K4/K5 rows and the
    # route's picks then
    *[(schedule.int8_schedule, (M, K, N, 4),
       "int8_matmul_pipelined" if M == 8 else "int8_matmul")
      for M in (8, 512) for K, N in ((768, 32000), (768, 768), (768, 2048),
                                     (2048, 768))],
    # bf16 at M = 8: K5 7.34 µs cold against K4 9.79 (chip_smoke.py's route phase)
    (schedule.int8_schedule, (8, 768, 2048, 2), "int8_matmul_pipelined"),
]


@pytest.mark.parametrize("fn,args,want", MEASURED)
def test_hopper_model_picks_the_faster_kernel_where_measured(fn, args, want):
    sched = fn(*args, SMS)
    assert sched["kernel"] == want, (sched["pipeline_gain"],
                                     sched["est_serial_cycles"],
                                     sched["est_pipe_cycles"])


@pytest.mark.parametrize("fn,args,want", MEASURED)
def test_hopper_schedule_records_each_kernels_plan(fn, args, want):
    """The schedule names its kernel's plan and ring depth as the plan
    rules give them (``kernels/pipeline.py``), for both kernels of the
    pair."""
    from repro_torch.kernels import pipeline as pl
    sched = fn(*args, SMS)
    run = sched["pipe"] if sched["pipelined"] else sched["base"]
    assert (sched["kernel"], sched["plan"], sched["depth"]) == (
        run["kernel"], run["plan"], run["depth"])
    if fn is schedule.int8_schedule:
        M, K, N, isz = args
        assert sched["base"]["plan"] == pl.int8_plan(M, N, K, isz,
                                                     pipelined=False, sms=SMS)
    if fn is schedule.group_schedule:
        assert sched["base"]["plan"] == pl.group_plan(*args, 0, SMS)
    if fn is schedule.flash_schedule and sched["pipe"]:
        B, S, H, K, T, hd, isz = args
        assert sched["pipe"]["depth"] == pl.choose_depth(hd, isz, -(-T // 64))
