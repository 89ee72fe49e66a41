"""Kernel schedule synthesis: Aquas's interface-aware synthesis applied to
kernel configuration, with two machine instances.

**The TPU instance** (the reference's, ``repro/core/kernel_synth.py``, kept
field for field so that tests can hold the port to it): for each candidate
tiling of a kernel we build the per-grid-step functional Aquas-IR program
(the staging transfers the kernel's DMA pipeline performs), run the §4.3
synthesis pipeline to get a model-estimated DMA cycle count, add an
MXU/VPU compute estimate, and pick the candidate minimizing the pipelined
steady-state step time:

    step_cycles ≈ max(compute_cycles, dma_cycles / overlap)

where overlap = min(I_hbm, buffering depth).  ``choose_*_blocks`` are this
instance.

**The H100 instance** (``HopperGrid``, ``hopper_cycles``,
``decide_hopper``): the port's kernels come in pairs, a baseline and a
pipelined variant, each with its plan (``kernels/pipeline.py``).  The model
costs each plan on the card — blocks in waves over the SMs, the blocks an
SM holds at once (registers and shared memory), a block's compute a step
against its copies through the interfaces of ``hopper_interfaces`` — and
keeps the reference's decision: a baseline cost against a pipelined one,
the gain the minimum of the model's ratio and ``pipeline_speedup``'s
roofline bound, ``PIPELINE_GAIN_MIN``, and never a pipeline for one
streamed tile.

This module is pure Python (no torch): the kernels' plans and occupancy
come in as numbers from ``kernels/schedule.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable

from repro_torch.core import aquas_ir as ir
from repro_torch.core.interface_model import (
    H100_CLOCK_HZ,
    H100_SMS,
    MXU_DIM,
    TPU_CLOCK_HZ,
    TPU_PEAK_FLOPS_BF16,
    TPU_VMEM_BUDGET,
    MemInterface,
    hopper_interfaces,
    tpu_interfaces,
)
from repro_torch.core.synthesis import synthesize
from repro_torch.roofline.analysis import H100, TPU_V5E, pipeline_speedup

# MXU does a 128x128x128 bf16 matmul-accumulate per ~1 cycle equivalent:
_MXU_FLOPS_PER_CYCLE = TPU_PEAK_FLOPS_BF16 / TPU_CLOCK_HZ  # ≈ 123k flops/cycle
_VPU_FLOPS_PER_CYCLE = 8 * 128 * 2  # elementwise lanes

#: Candidate burst-DMA buffer depths; 1 = plain BlockSpec streaming (no
#: manual pipeline), >1 = `kernels/pipeline.py` multi-buffering.
PIPELINE_DEPTHS = (1, 2, 3, 4)

#: Mosaic automatically double-buffers BlockSpec operands across grid
#: steps, so the *baseline* kernel is already overlap-2 — the explicit
#: burst pipeline only wins where deeper staging (up to the interface's
#: in-flight window I) hides more latency than that.  Modeling the
#: baseline as serialized would measure the pipeline against a strawman.
BASELINE_OVERLAP = 2

#: Minimum conservatively-predicted speedup before the burst pipeline is
#: auto-selected — below this the extra VMEM and semaphore traffic isn't
#: worth it, and the kernel runs the plain BlockSpec path.
PIPELINE_GAIN_MIN = 1.02


@dataclasses.dataclass(frozen=True)
class KernelSchedule:
    """Synthesized schedule of one kernel (or of a baseline/pipelined pair).

    ``buffering`` is the burst-DMA pipeline depth (1 = plain BlockSpec
    streaming, itself implicitly overlap-2 — see ``BASELINE_OVERLAP``);
    ``pipelined`` is the go/no-go decision after comparing the
    interface-model estimate against that baseline AND the roofline overlap
    bound (the conservative minimum of the two — ``pipeline_gain``).
    ``est_serial_cycles`` is the BlockSpec-baseline cost of the same tiling,
    so consumers can report the predicted win.
    """

    name: str
    block_shapes: dict[str, tuple[int, ...]]
    buffering: int                 # DMA pipeline depth (in-flight staging)
    est_step_cycles: float
    est_total_cycles: float
    vmem_bytes: int
    decisions: dict[str, str]
    pipelined: bool = False
    est_serial_cycles: float = 0.0
    pipeline_gain: float = 1.0

    def block(self, key: str) -> tuple[int, ...]:
        """Tile shape chosen for buffer ``key`` (e.g. ``"kv"``, ``"a"``)."""
        return self.block_shapes[key]


def pipeline_fields(sched: "KernelSchedule") -> dict:
    """Burst-DMA pipeline decision as compile-cache schedule fields.

    Every domain scheduler folds these into the schedule dict it records
    (and therefore into ``BENCH_compile.json`` via ``CompileRecord.row``):
    whether the kernel streams its cold operands through
    ``kernels/pipeline.py`` and the conservatively-predicted gain (the
    depth is the schedule's ``buffering`` field, recorded alongside).
    """
    return {"pipelined": sched.pipelined,
            "pipeline_gain": round(sched.pipeline_gain, 3),
            "est_serial_cycles": sched.est_serial_cycles}


@dataclasses.dataclass(frozen=True)
class _PipeCost:
    """Cost of one (tiling, depth) candidate under the pipeline model."""

    step: float
    total: float
    serial_total: float
    pipelined: bool
    gain: float


def _pipeline_cost(compute: float, dma: float, buf: int, steps: int,
                   flops_per_step: float, bytes_per_step: float,
                   itfc: MemInterface) -> _PipeCost:
    """Burst-pipeline vs BlockSpec-baseline step cost for one candidate.

    depth 1: the BlockSpec baseline — Mosaic's implicit double buffering
    already overlaps at ``BASELINE_OVERLAP``, so a step costs
    ``max(compute, dma / 2)``.  depth > 1: the explicit pipeline keeps up
    to ``min(I, depth)`` copies in flight — ``max(compute, dma/overlap)``.
    Both pay one pipeline-fill DMA per sweep.  The decision gain is the
    *minimum* of the interface-model ratio and the roofline overlap bound
    (``roofline.analysis.pipeline_speedup``), so a predicted loss under
    either model keeps the kernel on the plain path; a depth-2 explicit
    pipeline can never beat the baseline (same overlap), which is exactly
    right — it would replicate what BlockSpec already does.
    """
    base_step = max(compute, dma / min(itfc.I, BASELINE_OVERLAP))
    base_total = base_step * steps + dma
    if buf == 1:
        return _PipeCost(base_step, base_total, base_total, False, 1.0)
    overlap = min(itfc.I, buf)
    step = max(compute, dma / overlap)
    total = step * steps + dma
    gain_model = base_total / total if total > 0 else 1.0
    gain_roofline = pipeline_speedup(flops_per_step * steps,
                                     bytes_per_step * steps, peaks=TPU_V5E)
    gain = min(gain_model, gain_roofline)
    pipelined = steps >= 2 and gain >= PIPELINE_GAIN_MIN
    return _PipeCost(step, total, base_total, pipelined, gain)


def _pipe_note(cost: _PipeCost, buf: int) -> str:
    if not cost.pipelined:
        return "off"
    return f"burst(depth={buf},gain={cost.gain:.2f}x)"


def _round_to(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


def _candidate_tiles(dim: int, mult: int, caps: Iterable[int]) -> list[int]:
    out = []
    for c in caps:
        t = min(dim, c)
        t = _round_to(t, mult) if t >= mult else t
        if t > 0 and t not in out:
            out.append(t)
    return out


def _staging_program(
    name: str, transfers: list[tuple[str, int, str]],
) -> ir.FunctionalProgram:
    """Per-grid-step staging as a functional Aquas-IR program.

    transfers: list of (buffer_name, bytes, direction) for one grid step.
    """
    ops = [
        ir.FuncOp(kind="transfer", name=nm, size_bytes=b,
                  src_space=ir.Space.GLOBAL if d == "load" else ir.Space.REG,
                  dst_space=ir.Space.SCRATCHPAD if d == "load" else ir.Space.GLOBAL,
                  direction=d,
                  cache_hint=ir.CacheHint.COLD)  # streamed tiles are cold
        for nm, b, d in transfers
    ]
    return ir.FunctionalProgram(name, ops, {})


def _dma_cycles(name: str, transfers: list[tuple[str, int, str]],
                interfaces: dict[str, MemInterface] | None = None) -> float:
    itfcs = interfaces or {"hbm_vmem": tpu_interfaces()["hbm_vmem"]}
    t = synthesize(_staging_program(name, transfers), itfcs)
    return t.total_cycles


# ---------------------------------------------------------------------------
# Matmul (used by int8_matmul and as the GEMM model for roofline napkin math)
# ---------------------------------------------------------------------------

def choose_matmul_blocks(
    m: int, n: int, k: int,
    dtype_bytes: int = 2,
    acc_bytes: int = 4,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Pick (bm, bn, bk) + buffering for a tiled GEMM C[m,n] += A[m,k]@B[k,n]."""
    itfc = tpu_interfaces()["hbm_vmem"]
    best: KernelSchedule | None = None
    sub = 8 if dtype_bytes == 4 else 16  # sublane multiple
    for bm in _candidate_tiles(m, sub, (128, 256, 512)):
        for bn in _candidate_tiles(n, MXU_DIM, (128, 256, 512, 1024)):
            for bk in _candidate_tiles(k, MXU_DIM, (128, 256, 512, 1024, 2048)):
                for buf in PIPELINE_DEPTHS:
                    a_b = bm * bk * dtype_bytes
                    b_b = bk * bn * dtype_bytes
                    c_b = bm * bn * acc_bytes
                    # even the depth-1 baseline holds BASELINE_OVERLAP copies
                    # of each streamed tile (Mosaic double-buffers BlockSpecs)
                    n_bufs = max(buf, BASELINE_OVERLAP)
                    vmem = n_bufs * (a_b + b_b) + c_b
                    if vmem > vmem_budget:
                        continue
                    # The burst pipeline streams within one (mi, ni) k-sweep;
                    # each sweep re-pays the pipeline fill.
                    k_steps = math.ceil(k / bk)
                    mn_sweeps = math.ceil(m / bm) * math.ceil(n / bn)
                    dma = _dma_cycles("gemm_step",
                                      [("a_tile", a_b, "load"),
                                       ("b_tile", b_b, "load")])
                    compute = 2 * bm * bn * bk / _MXU_FLOPS_PER_CYCLE
                    cost = _pipeline_cost(compute, dma, buf, k_steps,
                                          2 * bm * bn * bk, a_b + b_b, itfc)
                    if buf > 1 and not cost.pipelined:
                        continue  # deeper staging predicted not to pay off
                    total = cost.total * mn_sweeps
                    if best is None or total < best.est_total_cycles:
                        best = KernelSchedule(
                            name="matmul",
                            block_shapes={"a": (bm, bk), "b": (bk, bn),
                                          "c": (bm, bn)},
                            buffering=buf,
                            est_step_cycles=cost.step,
                            est_total_cycles=total,
                            vmem_bytes=vmem,
                            decisions={
                                "bound": "compute"
                                         if cost.step <= compute * (1 + 1e-9)
                                         else "memory",
                                "steps": str(k_steps * mn_sweeps),
                                "pipeline": _pipe_note(cost, buf),
                            },
                            pipelined=cost.pipelined,
                            est_serial_cycles=cost.serial_total * mn_sweeps,
                            pipeline_gain=cost.gain)
    assert best is not None, "no feasible matmul tiling"
    return best


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

def choose_flash_blocks(
    seq_q: int, seq_k: int, head_dim: int,
    dtype_bytes: int = 2,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Pick (block_q, block_k) + buffering for the flash-attention ISAX.

    Working set per step: Q tile (persistent across the kv loop — "warm"),
    K/V tiles (streamed — "cold"), running stats, O accumulator.
    """
    best: KernelSchedule | None = None
    hd = max(head_dim, MXU_DIM)  # lane-padded head dim
    itfc = tpu_interfaces()["hbm_vmem"]
    for bq in _candidate_tiles(seq_q, 8, (128, 256, 512, 1024)):
        for bk in _candidate_tiles(seq_k, MXU_DIM, (128, 256, 512, 1024)):
            for buf in PIPELINE_DEPTHS:
                q_b = bq * hd * dtype_bytes
                kv_b = 2 * bk * hd * dtype_bytes
                o_b = bq * hd * 4
                s_b = bq * bk * 4
                n_bufs = max(buf, BASELINE_OVERLAP)
                vmem = q_b + n_bufs * kv_b + o_b + s_b + bq * 4 * 2
                if vmem > vmem_budget:
                    continue
                kv_steps = math.ceil(seq_k / bk)
                q_steps = math.ceil(seq_q / bq)
                dma = _dma_cycles("flash_step", [("kv_tile", kv_b, "load")])
                flops = 2 * bq * bk * hd * 2 + 5 * bq * bk  # qk + pv + softmax
                compute = (4 * bq * bk * hd / _MXU_FLOPS_PER_CYCLE
                           + 5 * bq * bk / _VPU_FLOPS_PER_CYCLE)
                cost = _pipeline_cost(compute, dma, buf, kv_steps,
                                      flops, kv_b, itfc)
                if buf > 1 and not cost.pipelined:
                    continue
                total = cost.total * q_steps
                if best is None or total < best.est_total_cycles:
                    best = KernelSchedule(
                        name="flash_attention",
                        block_shapes={"q": (bq, head_dim), "kv": (bk, head_dim)},
                        buffering=buf,
                        est_step_cycles=cost.step,
                        est_total_cycles=total,
                        vmem_bytes=vmem,
                        decisions={
                            "bound": "compute"
                                     if cost.step <= compute * (1 + 1e-9)
                                     else "memory",
                            "kv_steps": str(kv_steps),
                            "q_hint": "warm", "kv_hint": "cold",
                            "pipeline": _pipe_note(cost, buf),
                        },
                        pipelined=cost.pipelined,
                        est_serial_cycles=cost.serial_total * q_steps,
                        pipeline_gain=cost.gain)
    assert best is not None, "no feasible flash tiling"
    return best


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan
# ---------------------------------------------------------------------------

def choose_ssd_blocks(
    seq: int, heads: int, head_dim: int, d_state: int,
    dtype_bytes: int = 2,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Chunk length for the SSD (state-space duality) chunked scan.

    Per chunk: X, B, C tiles streamed; running state (heads,hd,d_state) warm.
    Intra-chunk cost is quadratic in chunk length (attention-like), state
    update linear — the model balances the two against DMA.
    """
    best: KernelSchedule | None = None
    itfc = tpu_interfaces()["hbm_vmem"]
    for chunk in (128, 256, 512):
        if chunk > seq:
            chunk = seq
        for buf in PIPELINE_DEPTHS:
            x_b = chunk * head_dim * dtype_bytes
            bc_b = 2 * chunk * d_state * dtype_bytes
            state_b = head_dim * d_state * 4
            n_bufs = max(buf, BASELINE_OVERLAP)
            vmem = n_bufs * (x_b + bc_b) + state_b + chunk * chunk * 4
            if vmem > vmem_budget:
                continue
            steps = math.ceil(seq / chunk)
            dma = _dma_cycles("ssd_step", [("x", x_b, "load"),
                                           ("bc", bc_b, "load")])
            flops = (2 * chunk * chunk * head_dim
                     + 4 * chunk * head_dim * d_state)
            compute = flops / _MXU_FLOPS_PER_CYCLE
            cost = _pipeline_cost(compute, dma, buf, steps,
                                  flops, x_b + bc_b, itfc)
            if buf > 1 and not cost.pipelined:
                continue
            if best is None or cost.total < best.est_total_cycles:
                best = KernelSchedule(
                    name="ssd_scan",
                    block_shapes={"chunk": (chunk, head_dim),
                                  "state": (head_dim, d_state)},
                    buffering=buf,
                    est_step_cycles=cost.step,
                    est_total_cycles=cost.total,
                    vmem_bytes=vmem,
                    decisions={"bound": "compute"
                               if cost.step <= compute * (1 + 1e-9)
                               else "memory",
                               "chunks": str(steps),
                               "pipeline": _pipe_note(cost, buf)},
                    pipelined=cost.pipelined,
                    est_serial_cycles=cost.serial_total,
                    pipeline_gain=cost.gain)
    assert best is not None, "no feasible ssd tiling"
    return best


# ---------------------------------------------------------------------------
# Point-cloud ops (the irregular gather/scatter workloads of the second
# application domain: FPS, ball query, grouped feature aggregation)
# ---------------------------------------------------------------------------

def fps_vmem_bytes(n_pts: int, n_samples: int, dtype_bytes: int = 4) -> int:
    """VMEM working set of the FPS kernel: the whole point set plus the
    running min-distance and the sample indices (FPS has no tiling — a
    cloud that does not fit must take the reference path)."""
    return n_pts * 3 * dtype_bytes + n_pts * 4 + n_samples * 4


def choose_fps_blocks(
    n_pts: int, n_samples: int,
    dtype_bytes: int = 4,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Farthest-point sampling schedule: the whole point set stays VMEM-
    resident across the sample loop.

    FPS is latency-bound and loop-carried — sample ``s+1``'s argmax depends
    on the distance sweep of sample ``s`` — so there is no cross-step
    transfer to overlap and the burst pipeline is *structurally*
    inapplicable (``buffering=1``, ``pipelined=False`` by construction,
    not a cost-model outcome).

    Callers must pre-check ``fps_vmem_bytes`` (the dispatcher and the op
    wrapper both fall back to the reference when the cloud doesn't fit).
    """
    xyz_b = n_pts * 3 * dtype_bytes
    vmem = fps_vmem_bytes(n_pts, n_samples, dtype_bytes)
    assert vmem <= vmem_budget, f"point set too large for VMEM: {vmem}"
    dma = _dma_cycles("fps_load", [("xyz", xyz_b, "load")])
    # per sample: one (n_pts, 3) diff²-sum sweep + argmax, all on the VPU
    compute = n_samples * (8.0 * n_pts) / _VPU_FLOPS_PER_CYCLE
    total = dma + compute
    return KernelSchedule(
        name="fps",
        block_shapes={"pts": (n_pts, 3)},
        buffering=1,
        est_step_cycles=compute / max(n_samples, 1),
        est_total_cycles=total,
        vmem_bytes=vmem,
        decisions={"bound": "latency", "samples": str(n_samples),
                   "pipeline": "off (loop-carried argmax)"},
        pipelined=False,
        est_serial_cycles=total,
        pipeline_gain=1.0)


def choose_ball_blocks(
    n_centers: int, n_pts: int, k_nb: int,
    dtype_bytes: int = 4,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Pick (bm centers, bn streamed points) + buffering for ball query.

    Per step: one X coordinate tile streamed (cold), selection state (chosen
    indices, running count/rank, nearest fallback) warm in scratch.  The
    per-point selection math (distance + rank compares against ``k_nb``
    slots) runs on the VPU, so small center tiles are memory-bound and big
    ones compute-bound — the model decides.
    """
    itfc = tpu_interfaces()["hbm_vmem"]
    best: KernelSchedule | None = None
    for bm in _candidate_tiles(n_centers, 8, (8, 16, 32, 64, 128)):
        for bn in _candidate_tiles(n_pts, MXU_DIM, (128, 256, 512, 1024)):
            for buf in PIPELINE_DEPTHS:
                x_b = bn * 3 * dtype_bytes
                state_b = bm * (k_nb + 3) * 4
                n_bufs = max(buf, BASELINE_OVERLAP)
                # per-step intermediates: the (bm, bn) distance tile and the
                # (bm, k, bn) hit tensor the rank selection materializes
                vmem = n_bufs * x_b + bm * 3 * dtype_bytes + state_b \
                    + bm * bn * (1 + k_nb) * 4
                if vmem > vmem_budget:
                    continue
                steps = math.ceil(n_pts / bn)
                m_sweeps = math.ceil(n_centers / bm)
                dma = _dma_cycles("ball_step", [("x_tile", x_b, "load")])
                flops = bm * bn * (8 + k_nb)  # dist² + rank/slot compares
                compute = flops / _VPU_FLOPS_PER_CYCLE
                cost = _pipeline_cost(compute, dma, buf, steps,
                                      flops, x_b, itfc)
                if buf > 1 and not cost.pipelined:
                    continue
                total = cost.total * m_sweeps
                if best is None or total < best.est_total_cycles:
                    best = KernelSchedule(
                        name="ball_query",
                        block_shapes={"centers": (bm, 3), "x": (bn, 3)},
                        buffering=buf,
                        est_step_cycles=cost.step,
                        est_total_cycles=total,
                        vmem_bytes=vmem,
                        decisions={
                            "bound": "compute"
                                     if cost.step <= compute * (1 + 1e-9)
                                     else "memory",
                            "steps": str(steps * m_sweeps),
                            "pipeline": _pipe_note(cost, buf),
                        },
                        pipelined=cost.pipelined,
                        est_serial_cycles=cost.serial_total * m_sweeps,
                        pipeline_gain=cost.gain)
    assert best is not None, "no feasible ball-query tiling"
    return best


def choose_group_blocks(
    n_centers: int, n_pts: int, k_nb: int, channels: int,
    dtype_bytes: int = 4,
    vmem_budget: int = TPU_VMEM_BUDGET,
) -> KernelSchedule:
    """Pick (bm centers, bn streamed feature rows) + buffering for grouped
    feature aggregation (gather-as-one-hot-matmul + running max-pool).

    The streamed feature tile is the cold operand — ``bn * channels`` bytes
    against ``2·bm·k_nb·bn·channels`` MXU flops, so the op is memory-bound
    exactly when ``bm·k_nb`` is small (each feature byte is reused
    ``bm·k_nb`` times): the paper's poster-child shape for the burst DMA
    engine.  Deep staging is auto-selected only on a predicted win (the
    ``_pipeline_cost`` invariant), so compute-bound grouping shapes stay on
    plain BlockSpec streaming.
    """
    itfc = tpu_interfaces()["hbm_vmem"]
    best: KernelSchedule | None = None
    for bm in _candidate_tiles(n_centers, 8, (8, 16, 32, 64, 128)):
        for bn in _candidate_tiles(n_pts, MXU_DIM, (128, 256, 512, 1024)):
            for buf in PIPELINE_DEPTHS:
                f_b = bn * channels * dtype_bytes
                idx_b = bm * k_nb * 4
                acc_b = bm * channels * 4
                n_bufs = max(buf, BASELINE_OVERLAP)
                # per-step intermediates: the (bm·k, bn) one-hot matrix and
                # the (bm, k, channels) gathered tensor — the dominant part
                # of the real working set for large tiles
                vmem = (n_bufs * f_b + idx_b + acc_b
                        + bm * k_nb * bn * 4 + bm * k_nb * channels * 4)
                if vmem > vmem_budget:
                    continue
                steps = math.ceil(n_pts / bn)
                m_sweeps = math.ceil(n_centers / bm)
                dma = _dma_cycles("group_step", [("f_tile", f_b, "load")])
                flops = 2 * bm * k_nb * bn * channels
                compute = (flops / _MXU_FLOPS_PER_CYCLE
                           + bm * k_nb * bn / _VPU_FLOPS_PER_CYCLE)
                cost = _pipeline_cost(compute, dma, buf, steps,
                                      flops, f_b, itfc)
                if buf > 1 and not cost.pipelined:
                    continue
                total = cost.total * m_sweeps
                if best is None or total < best.est_total_cycles:
                    best = KernelSchedule(
                        name="group_aggregate",
                        block_shapes={"centers": (bm, k_nb),
                                      "f": (bn, channels)},
                        buffering=buf,
                        est_step_cycles=cost.step,
                        est_total_cycles=total,
                        vmem_bytes=vmem,
                        decisions={
                            "bound": "compute"
                                     if cost.step <= compute * (1 + 1e-9)
                                     else "memory",
                            "steps": str(steps * m_sweeps),
                            "pipeline": _pipe_note(cost, buf),
                        },
                        pipelined=cost.pipelined,
                        est_serial_cycles=cost.serial_total * m_sweeps,
                        pipeline_gain=cost.gain)
    assert best is not None, "no feasible group-aggregate tiling"
    return best


# ---------------------------------------------------------------------------
# The H100 instance: a baseline kernel against its pipelined variant, each
# under the plan the port's plan rule gives it
# ---------------------------------------------------------------------------

#: The least device time of a launch: K1 on 8 × 768 rows sits at 2.25 µs
#: warm (PERF.md §6's K1 row, NVIDIA H100 80GB HBM3, 700 W), in
#: SM cycles.
H100_LAUNCH_CYCLES = 2.25e-6 * H100_CLOCK_HZ
#: What one step of a ring costs a block beside its copy: a block barrier
#: and the wait on the step's copies (``tools/fps_barrier_probe.py``: a
#: ``__syncthreads`` 0.02–0.05 µs; the upper end).
H100_RING_STEP_CYCLES = 0.05e-6 * H100_CLOCK_HZ


@dataclasses.dataclass(frozen=True)
class HopperGrid:
    """One kernel under its plan, as the H100 model costs it.

    ``blocks`` blocks, at most ``resident`` of them on an SM at once (its
    registers, shared memory and threads).  A block copies ``fill_bytes``
    whole before its first step (a resident operand: K10's part of the
    cloud, K13's channel slice, a q tile), then walks ``steps`` steps
    (``mean_steps`` for an average block, where the work is uneven, as a
    causal mask makes it).  A step takes ``compute`` cycles of one block
    alone (its latency) and ``issue`` cycles of the SM's issue (its share
    of the SM's throughput; ``compute`` where None), after a copy of
    ``tile_bytes``: ``depth`` 1 copies a tile and then computes it; a ring
    of ``depth`` ≥ 2 keeps ``depth`` - 1 copies ahead and pays
    ``ring_cost`` a step.  ``port`` names the interface the copies cross
    (``hopper_interfaces``), ``fixed`` the cycles a block spends on its
    own set-up and close (a cluster's merge) that nothing overlaps.
    ``streams`` counts the tiles a block streams where they are not its
    steps (K13 copies its slice in tiles, then gathers in steps).
    """

    blocks: int
    resident: int
    steps: int
    compute: float
    tile_bytes: int
    depth: int = 1
    mean_steps: float | None = None
    issue: float | None = None
    fill_bytes: int = 0
    port: str = "l2_smem"
    fixed: float = 0.0
    ring_cost: float = H100_RING_STEP_CYCLES
    smem_bytes: int = 0
    streams: int | None = None

    @property
    def streamed(self) -> int:
        """Tiles a block streams (its steps unless ``streams`` says)."""
        return self.steps if self.streams is None else self.streams


@functools.lru_cache(maxsize=4096)
def copy_cycles(nbytes: int, itfc: MemInterface) -> float:
    """Cycles from the first issue to the last byte of one copy of
    ``nbytes`` through ``itfc``: the §4.3 synthesis of one transfer (its
    legal decomposition, in-flight-limited issue order and lead-off)."""
    if nbytes <= 0:
        return 0.0
    return _dma_cycles("copy", [("tile", int(nbytes), "load")],
                       {itfc.name: itfc})


def hopper_cycles(g: HopperGrid, *, sms: int = H100_SMS,
                  clock_hz: float = H100_CLOCK_HZ) -> float:
    """Modelled cycles of grid ``g`` on a card of ``sms`` SMs: the launch,
    then the blocks in waves.

    ``q`` = ⌈blocks / sms⌉ blocks an SM, ``r`` = min(resident, q) of them
    at once, ⌈q / r⌉ waves.  A wave takes the longest of three things: the
    SM's issue for its r blocks' steps; the SM's port for their bytes, at
    its share of the device's rate over the SMs the grid keeps busy; one
    block's latency chain — its fill, then per step the copy's lead-off
    and transfer and the compute in series (depth 1), or the compute while
    the ring keeps the copies ahead (its first copy, then per step the
    longer of the compute and a copy over the ring's depth - 1, and the
    ring's own cost).  So the baseline overlaps its copies only across
    co-resident blocks (r of them), a ring also within each block.
    """
    per_sm = -(-g.blocks // sms)
    r = max(1, min(g.resident, per_sm))
    waves = -(-per_sm // r)
    itfc = hopper_interfaces(min(g.blocks, sms), clock_hz)[g.port]
    d = copy_cycles(g.tile_bytes, itfc)
    f = copy_cycles(g.fill_bytes, itfc)
    mean = g.steps if g.mean_steps is None else g.mean_steps
    work = r * mean * (g.compute if g.issue is None else g.issue)
    port = r * (mean * g.tile_bytes + g.fill_bytes) / itfc.W
    if g.depth <= 1:
        chain = f + g.steps * (g.compute + d)
    else:
        chain = f + d + g.steps * (max(g.compute, d / (g.depth - 1))
                                   + g.ring_cost)
    return H100_LAUNCH_CYCLES + waves * (g.fixed + max(work, port, chain))


def decide_hopper(name: str, base: HopperGrid, pipe: HopperGrid | None, *,
                  flops: float, hbm_bytes: float, kind: str,
                  sms: int = H100_SMS,
                  block_shapes: dict | None = None) -> KernelSchedule:
    """Baseline against pipelined on the H100 (``_pipeline_cost``'s rule).

    ``flops`` and ``hbm_bytes`` are the op's (each input read and each
    output written once), ``kind`` the arithmetic whose peak bounds it
    (``roofline.analysis.H100``).  The pipelined kernel is picked when it
    streams two tiles or more and the gain — the minimum of the model's
    ratio ``hopper_cycles(base) / hopper_cycles(pipe)`` and the roofline's
    overlap bound — reaches ``PIPELINE_GAIN_MIN``.  ``pipe`` None: the
    pipelined kernel takes no plan at this shape."""
    base_total = hopper_cycles(base, sms=sms)
    if pipe is None:
        pipe_total, gain_model = float("inf"), 0.0
    else:
        pipe_total = hopper_cycles(pipe, sms=sms)
        gain_model = base_total / pipe_total if pipe_total > 0 else 1.0
    gain_roofline = pipeline_speedup(flops, hbm_bytes, peaks=H100, kind=kind)
    gain = min(gain_model, gain_roofline)
    pipelined = (pipe is not None and pipe.streamed >= 2
                 and gain >= PIPELINE_GAIN_MIN)
    chosen = pipe if pipelined else base
    total = pipe_total if pipelined else base_total
    return KernelSchedule(
        name=name,
        block_shapes=dict(block_shapes or {}),
        buffering=chosen.depth,
        est_step_cycles=total / max(chosen.steps, 1),
        est_total_cycles=total,
        vmem_bytes=chosen.smem_bytes,
        decisions={"pipeline": (f"ring(depth={pipe.depth},"
                                f"gain={gain:.2f}x)" if pipelined else "off")},
        pipelined=pipelined,
        est_serial_cycles=base_total,
        pipeline_gain=gain)
