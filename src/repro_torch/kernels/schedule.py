"""The schedule of each kernel pair on the card: which of the baseline and
the pipelined kernel runs, under which plan and ring depth.

For every op there is one function here (``flash_schedule``,
``int8_schedule``, ``ssd_schedule``, ``ball_schedule``, ``group_schedule``,
and the single kernels' ``rmsnorm_schedule`` and ``fps_schedule``).  The
dispatcher's schedulers (``targets/llm.py``, ``targets/pointcloud.py``)
record what it returns, and the kernel routes (``kernels/ops.py``,
``pointcloud/ops.py``) run what the record says, or call the same function
where no schedule is passed: what is recorded is what runs.

Each function takes the plans as the plan rules give them
(``kernels/pipeline.py``, ``kernels/rmsnorm.py``) and describes each
kernel under its plan to the H100 instance of the cost model
(``core/kernel_synth.HopperGrid``): its blocks, how many an SM holds, the
steps of a block, a step's compute and copies.  ``decide_hopper`` then
keeps the reference's rule (``repro/core/kernel_synth._pipeline_cost``).

A schedule is a plain dict (shared between callers: do not mutate it):

    kernel     the kernel that runs ("flash_attention", ...)
    pipelined  True where it is the pipelined kernel of the pair
    plan       its plan, or None for a kernel without one
    depth      its ring depth (0: no ring)
    base/pipe  of a pair: {"kernel", "plan", "depth"} of each kernel (pipe
               None where the pipelined kernel takes no plan or would
               stream one tile)
    pipeline_gain, est_cycles, est_serial_cycles, est_pipe_cycles
               the model's gain and cycles (serial: the baseline's; pipe:
               the pipelined kernel's, None where it has no plan)
    sms        the SMs of the card the schedule is for
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.interface_model import (H100_CLOCK_HZ, H100_SM_REGS,
                                              H100_SM_THREADS)
from repro_torch.core.kernel_synth import (H100_RING_STEP_CYCLES,
                                           HopperGrid, decide_hopper,
                                           hopper_cycles)
from repro_torch.kernels import pipeline as pl
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels.flash_attention import (BLOCK_Q, block_k,
                                                 padded_head_dim)
from repro_torch.kernels.ssd_scan import CHUNK, geom
from repro_torch.kernels.ssd_scan import smem_bytes as ssd_smem_bytes

#: The most blocks an SM holds (data sheet).
SM_BLOCKS = 32
#: Operations a (point, center) pair of ball query: the squared distance
#: (three subtractions, three multiply-adds), the compare and the select,
#: as ``chip_smoke.py``'s bound counts them.
BALL_OPS = 10
#: Registers a thread of K12 and of K13 where no kernel is built (no card):
#: what ptxas gave their C = 64 fp32 and bf16 instantiations in the build
#: PERF.md's K12/K13 rows record (76 and 54).  On a card ``group_regs``
#: reads the build's count.
GROUP_REGS = {"group_aggregate": 76, "group_aggregate_pipelined": 54}
#: One cluster barrier (``tools/fps_barrier_probe.py``: 0.44–0.77
#: µs on an NVIDIA H100 80GB HBM3): what a split plan's merge of its
#: parts waits, in SM cycles.
CLUSTER_MERGE_CYCLES = 0.6e-6 * H100_CLOCK_HZ
#: The SM's peak issue of each tile's arithmetic (data sheet: 67 TFLOP/s
#: fp32 on the CUDA cores, 989 bf16 and 495 TF32 on the tensor cores, over
#: 132 SMs), in flops a cycle: a step's share of the SM's throughput.
SM_PEAK = {"ffma": 67e12, "bf16": 989e12, "tf32": 495e12}
SM_PEAK = {k: v / (132 * H100_CLOCK_HZ) for k, v in SM_PEAK.items()}
#: flops a cycle of one block issuing ``wgmma`` alone on an SM
#: (``tools/int8kv_mma_probe.py``: 790.0 TFLOP/s over 132 SMs).
WGMMA_RATE = 790.0e12 / (132 * H100_CLOCK_HZ)

# What one block alone takes for a step of each kernel family's tile (its
# latency, SM cycles), each from one chip run the repository records
# (PERF.md, ROADMAP.md) on an NVIDIA H100 80GB HBM3 at 700 W (µs warm):
# the constant is the one at which ``hopper_cycles`` gives that run's
# time.  The model's other terms
# (waves, blocks an SM holds, copies, the ring) carry it to other shapes.
#: flops a cycle of one fp32 K2/K3 block (the CUDA-core tile): K2
#: at B=1, H=K=12, S=T=512, hd 64 (47.94 µs).
FLASH_FFMA_RATE = 108.6
#: what a ring step costs that tile beyond a block barrier: K3 at
#: the same shape (50.54 µs; the ring is the slower there, PERF.md).
FLASH_FFMA_RING = 1610.0
#: flops a cycle of one 16-bit K2/K3 block (``mma.sync``): fp16 K2
#: at B=1, H=K=12, S=T=256, hd 64 (12.88 µs).
FLASH_MMA_RATE = 245.5
#: flops a cycle (three TF32 passes counted) of one K7/K8 block: K7
#: at BT=4, H=80, S=512, P=64, N=128 fp32 (268.72 µs).
SSD_RATE = 262.4
#: cycles of one warp's 32 points tested against one of its centers, with
#: the hits kept: K10 at (b) B=16, N=1024, M=512, k=32 (13.41 µs).
BALL_ITER_CYCLES = 73.6
#: what a step of K4's ring costs beyond a block barrier (the TMA issue,
#: the consumers' mbarrier wait, the ``wgmma`` fence and commit, the
#: slot's release to the producer): K4 at M = 512, K = 768, N =
#: 2048 fp32 (19.38 µs).
K4_RING = 1558.5
#: flops a cycle (bf16 passes counted) of one K5 block's ``mma.sync`` stage
#: with its int8 wq widened: ``chip_smoke.py``'s route phase, K5 at M =
#: 512, K = 768, N = 2048 fp32 (36.87 µs cold), a shape no earlier run
#: timed K5 at.
K5_RATE = 644.1
#: what a ring step costs K11 beyond a block barrier (its mbarrier wait and
#: the next tile's TMA issue): K11 at (b) (14.30 µs).
BALL_RING = 377.8
#: cycles of one K13 lane group's row out of shared memory, folded into its
#: center's maxima: K13 at (b) fp32 B=16, N=1024, M=512, k=32,
#: C=64 (8.05 µs).
GROUP_ROW_CYCLES = 28.7


def resident(threads: int, smem: int, min_blocks: int = 1,
             regs: int | None = None) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory one
    SM holds: by shared memory (``pipeline.blocks_fit``), by threads, and
    by registers — ``regs`` a thread where the build reports them, else the
    most ``__launch_bounds__(threads, min_blocks)`` lets the compiler use
    (65536 / (threads · min_blocks), at most 255)."""
    if regs is None:
        regs = min(255, H100_SM_REGS // (threads * max(1, min_blocks)))
    return max(0, min(pl.blocks_fit(smem), H100_SM_THREADS // threads,
                      H100_SM_REGS // (threads * regs), SM_BLOCKS))


def _port(nbytes: int) -> str:
    """The interface a kernel's copies cross: L2 where its operands fit the
    card's L2 (re-read tiles hit there), else HBM."""
    return "l2_smem" if nbytes <= pl.current_l2_bytes() else "hbm_smem"


def _pair(sched, base: dict, pipe: dict | None, pipe_grid: HopperGrid | None,
          sms: int) -> dict:
    """The schedule dict of a pair.  A pipelined kernel that would stream
    fewer than two tiles is offered to no one (a single tile never
    overlaps: the reference's rule), not even to a forcing caller."""
    pipe_cycles = (None if pipe_grid is None
                   else round(hopper_cycles(pipe_grid, sms=sms)))
    if pipe_grid is None or pipe_grid.streamed < 2:
        pipe = None
    chosen = pipe if sched.pipelined else base
    return {"kernel": chosen["kernel"], "pipelined": sched.pipelined,
            "plan": chosen["plan"], "depth": chosen["depth"],
            "base": base, "pipe": pipe,
            "pipeline_gain": round(sched.pipeline_gain, 3),
            "est_cycles": round(sched.est_total_cycles),
            "est_serial_cycles": round(sched.est_serial_cycles),
            "est_pipe_cycles": pipe_cycles, "sms": sms}


def _checked(kernel: str, plan, legal: bool, shape) -> None:
    """Raise unless the plan rule's ``plan`` is one the kernel takes at
    ``shape``: checked here, once a schedule, so that the routes run a
    schedule's plans with no check a call."""
    if not legal:
        raise ValueError(f"{kernel}: the plan rule's {plan} is not legal "
                         f"at {shape}")


def _single(kernel: str, plan, sms: int) -> dict:
    return {"kernel": kernel, "plan": plan, "depth": 0, "pipelined": False,
            "pipeline_gain": 1.0, "sms": sms}


# ---------------------------------------------------------------------------
# K2 / K3: flash attention
# ---------------------------------------------------------------------------

def flash_min_blocks(hd: int, itemsize: int, depth: int) -> int:
    """``min_blocks`` of csrc/flash_tile.cuh: the blocks an SM must hold by
    the kernel's ``__launch_bounds__``."""
    w = padded_head_dim(hd)
    if itemsize == 2:
        return 3 if w <= 64 else 1
    return 2 if w == 64 and depth <= 2 else 1


def flash_resident(hd: int, itemsize: int, depth: int) -> int:
    """Blocks of K2 (``depth`` 1) or K3 at ring ``depth`` one SM holds."""
    threads = 128 if itemsize == 2 else 256
    return resident(threads, pl.ring_smem_bytes(hd, itemsize, depth),
                    flash_min_blocks(hd, itemsize, depth))


def causal_tiles(S: int, T: int, hd: int) -> list[int]:
    """Live K/V tiles of each 64-row q tile under a causal mask whose last
    row sees all T keys (a served prompt)."""
    bk = block_k(hd)
    nt = -(-T // bk)
    return [min(nt, max(1, -(-(min(S, q0 + BLOCK_Q) + T - S) // bk)))
            for q0 in range(0, S, BLOCK_Q)]


@functools.lru_cache(maxsize=None)
def flash_schedule(B: int, S: int, H: int, K: int, T: int, hd: int,
                   itemsize: int, sms: int = pl.SMS) -> dict:
    """K2 or K3 (and K3's ring depth, ``pipeline.choose_depth``) for q
    (B, S, H, hd) over T keys of K heads, under a causal mask.

    A step is one K/V tile: Q Kᵀ and P V of a 64-row q tile (fp32 rows on
    the CUDA cores, 16-bit rows on ``mma.sync``) and the copy of its K and
    V rows.  A block first copies its q tile and scans its mask rows."""
    w, bk = padded_head_dim(hd), block_k(hd)
    live = causal_tiles(S, T, hd)
    mma = itemsize == 2
    ops = 4 * BLOCK_Q * bk * w + 8 * BLOCK_Q * bk
    in_bytes = (B * S * H + 2 * B * T * K) * hd * itemsize + B * S * T
    depth = pl.choose_depth(hd, itemsize, max(live))

    def grid(d: int) -> HopperGrid:
        return HopperGrid(
            blocks=B * H * len(live), resident=flash_resident(hd, itemsize, d),
            steps=max(live), mean_steps=sum(live) / len(live),
            compute=ops / (FLASH_MMA_RATE if mma else FLASH_FFMA_RATE),
            issue=ops / SM_PEAK["bf16" if mma else "ffma"],
            tile_bytes=2 * bk * w * itemsize, depth=d,
            fill_bytes=BLOCK_Q * w * itemsize + BLOCK_Q * T,
            port=_port(in_bytes),
            ring_cost=H100_RING_STEP_CYCLES + (0 if mma else FLASH_FFMA_RING),
            smem_bytes=pl.ring_smem_bytes(hd, itemsize, d))

    flops = 4 * B * H * hd * sum(min(T, q * BLOCK_Q + BLOCK_Q + T - S)
                                 * min(BLOCK_Q, S - q * BLOCK_Q)
                                 for q in range(len(live)))
    pipe = grid(depth)
    sched = decide_hopper("flash_attention", grid(1), pipe,
                          flops=flops, hbm_bytes=in_bytes + B * S * H * hd
                          * itemsize, kind="bf16" if mma else "fp32",
                          sms=sms)
    return _pair(sched,
                 {"kernel": "flash_attention", "plan": None, "depth": 0},
                 {"kernel": "flash_attention_pipelined", "plan": None,
                  "depth": depth}, pipe, sms)


# ---------------------------------------------------------------------------
# K4 / K5: the int8-weight GEMM
# ---------------------------------------------------------------------------

def _int8_grid(M: int, N: int, K: int, itemsize: int, plan,
               pipelined: bool) -> HopperGrid:
    """K4 (a ``wgmma`` tile of x and wq stages through a TMA ring) or K5
    (an ``mma.sync`` tile over a ring of wq stages, x's block rows resident
    as bf16 terms) under ``plan``; a split K sums its partials over a
    cluster, whose blocks stream the K sweep's stages between them."""
    tm, tn, split, depth = plan
    passes = 3 if itemsize == 4 else 1
    stages = -(-(-(-K // pl.K4_STAGE_K)) // split)
    blocks = -(-M // tm) * -(-N // tn) * split
    in_bytes = M * K * itemsize + N * K
    fixed = CLUSTER_MERGE_CYCLES if split > 1 else 0.0
    if pipelined:
        smem = pl.k5_smem_bytes(tm, tn, split, depth, itemsize, K)
        return HopperGrid(
            blocks=blocks, resident=resident(32 * (tn // 16), smem),
            steps=stages,
            compute=2 * tm * tn * pl.K5_STAGE_K * passes / K5_RATE,
            issue=2 * tm * tn * pl.K5_STAGE_K * passes / SM_PEAK["bf16"],
            tile_bytes=tn * pl.K5_STAGE_K, depth=depth,
            streams=-(-K // pl.K5_STAGE_K),
            fill_bytes=tm * stages * pl.K5_STAGE_K * itemsize,
            port=_port(in_bytes), fixed=fixed, smem_bytes=smem)
    smem = pl.k4_smem_bytes(tm, tn, split, depth, itemsize)
    return HopperGrid(
        blocks=blocks, resident=resident(128 * (tm // 64 + 1), smem),
        steps=stages,
        compute=2 * tm * tn * pl.K4_STAGE_K * passes / WGMMA_RATE,
        issue=2 * tm * tn * pl.K4_STAGE_K * passes / SM_PEAK["bf16"],
        tile_bytes=pl.K4_STAGE_K * (tm * itemsize + tn), depth=depth,
        ring_cost=H100_RING_STEP_CYCLES + K4_RING,
        port=_port(in_bytes), fixed=fixed, smem_bytes=smem)


@functools.lru_cache(maxsize=None)
def int8_schedule(M: int, K: int, N: int, itemsize: int,
                  sms: int = pl.SMS) -> dict:
    """K4 or K5 for an (M, K) x (N, K) int8 GEMM with x of ``itemsize``
    bytes, each at ``pipeline.int8_plan``'s plan.  K5's TMA copies take only
    K % 16 == 0 (else it has no plan); its route copies an operand that is
    not 16-byte aligned."""
    p4 = pl.int8_plan(M, N, K, itemsize, pipelined=False, sms=sms)
    p5 = (pl.int8_plan(M, N, K, itemsize, pipelined=True, sms=sms)
          if K % 16 == 0 else None)
    _checked("int8_matmul", p4, pl.int8_plan_legal(
        p4, M, N, K, itemsize, pipelined=False), (M, K, N))
    _checked("int8_matmul_pipelined", p5, p5 is None or pl.int8_plan_legal(
        p5, M, N, K, itemsize, pipelined=True), (M, K, N))
    passes = 3 if itemsize == 4 else 1
    pipe = None if p5 is None else _int8_grid(M, N, K, itemsize, p5, True)
    sched = decide_hopper(
        "int8_matmul", _int8_grid(M, N, K, itemsize, p4, False), pipe,
        flops=2 * M * N * K * passes,
        hbm_bytes=M * K * itemsize + N * K + 4 * N + M * N * itemsize,
        kind="bf16", sms=sms)
    return _pair(sched,
                 {"kernel": "int8_matmul", "plan": p4, "depth": p4[3]},
                 {"kernel": "int8_matmul_pipelined", "plan": p5,
                  "depth": p5 and p5[3]}, pipe, sms)


# ---------------------------------------------------------------------------
# K7 / K8: the SSD chunked scan
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ssd_schedule(BT: int, S: int, H: int, P: int, N: int, itemsize: int,
                 sms: int = pl.SMS) -> dict:
    """K7 or K8 (its ring depth ``pipeline.ssd_plan``; None: no ring fits,
    K7) for x (BT, H, S, P) and a state of N.  A step is one 16-position
    chunk: its x, dt, B and C copied, then the intra-chunk scores, outputs
    and the state update in 3xTF32 on ``mma.sync``."""
    g = geom(P, N)
    Q = CHUNK
    pb = -(-P // g.psplit)
    flops_chunk = 3 * (2 * Q * Q * N + 2 * Q * Q * pb + 4 * Q * N * pb)
    tile = Q * (pb + 2 * N) * itemsize + 4 * Q
    in_bytes = BT * S * (H * P + 2 * N + H) * itemsize
    threads = 32 * g.warps
    depth = pl.ssd_plan(P, N, S, itemsize)

    def grid(d: int, smem: int) -> HopperGrid:
        return HopperGrid(blocks=H * BT * g.psplit,
                          resident=resident(threads, smem, 2),
                          steps=-(-S // Q), compute=flops_chunk / SSD_RATE,
                          issue=flops_chunk / SM_PEAK["tf32"],
                          tile_bytes=tile, depth=d, port=_port(in_bytes),
                          smem_bytes=smem)

    pipe = (None if depth is None else
            grid(depth, pl.ssd_ring_bytes(P, N, depth, itemsize)))
    sched = decide_hopper(
        "ssd_scan", grid(1, ssd_smem_bytes(P, N)), pipe,
        flops=4 * BT * H * S * N * P * 3,
        hbm_bytes=in_bytes + BT * H * S * P * itemsize, kind="tf32", sms=sms)
    return _pair(sched, {"kernel": "ssd_scan", "plan": None, "depth": 0},
                 {"kernel": "ssd_scan_pipelined", "plan": None,
                  "depth": depth}, pipe, sms)


# ---------------------------------------------------------------------------
# K1 and K9: single kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rmsnorm_schedule(rows: int, d: int, itemsize: int,
                     sms: int = pl.SMS) -> dict:
    """K1 at ``rmsnorm.plan``'s launch shape (for 16-byte aligned rows)."""
    return _single("rmsnorm", tuple(_rms.plan(rows, d, itemsize, sms)), sms)


@functools.lru_cache(maxsize=None)
def fps_schedule(B: int, N: int, S: int, sms: int = pl.SMS) -> dict:
    """K9 at ``pipeline.fps_plan``'s plan: a loop-carried argmax, never
    pipelined."""
    return _single("fps", pl.fps_plan(B, N), sms)


# ---------------------------------------------------------------------------
# K10 / K11: ball query
# ---------------------------------------------------------------------------

def _ball_grid(B: int, N: int, M: int, itemsize: int, plan, k: int
               ) -> HopperGrid:
    """K10 (``plan[3]`` 0: the block's part of the cloud copied whole, then
    walked) or K11 (the part's 256-point tiles through a ring); a step is
    one tile tested against the block's centers."""
    cpw, warps, split, depth = plan
    part = min(pl.ball_part_points(N, split), N)
    tiles = -(-part // pl.BALL_TILE)
    smem = pl.ball_smem_bytes(plan, N, k, itemsize) + pl.BALL_STATIC_SMEM
    raw = 3 * itemsize
    return HopperGrid(
        blocks=B * -(-M // (cpw * warps)) * split,
        resident=resident(32 * warps, smem), steps=tiles,
        compute=pl.BALL_TILE // 32 * cpw * BALL_ITER_CYCLES,
        issue=cpw * warps * pl.BALL_TILE * BALL_OPS / SM_PEAK["ffma"],
        tile_bytes=0 if depth == 0 else pl.BALL_TILE * raw,
        depth=max(1, depth), fill_bytes=part * raw if depth == 0 else 0,
        ring_cost=H100_RING_STEP_CYCLES + BALL_RING,
        port=_port(B * N * raw), smem_bytes=smem,
        fixed=CLUSTER_MERGE_CYCLES if split > 1 else 0.0)


@functools.lru_cache(maxsize=None)
def ball_schedule(B: int, N: int, M: int, k: int, itemsize: int,
                  sms: int = pl.SMS) -> dict:
    """K10 or K11 for B clouds of N points and M centers of k neighbours,
    each at ``pipeline.ball_plan``'s plan (K11's ring as deep as the
    cloud's 256-point tiles allow, at most 4)."""
    depth = min(max(pl.DEPTHS), max(2, -(-N // pl.BALL_TILE)))
    p10 = pl.ball_plan(B, N, M, k, itemsize, 0, sms)
    p11 = pl.ball_plan(B, N, M, k, itemsize, depth, sms)
    if B * N * M:
        for kernel, plan in (("ball_query", p10),
                             ("ball_query_pipelined", p11)):
            _checked(kernel, plan, pl.ball_plan_legal(
                plan, B, N, M, k, itemsize), (B, N, M, k))
    pipe = _ball_grid(B, N, M, itemsize, p11, k)
    sched = decide_hopper(
        "ball_query", _ball_grid(B, N, M, itemsize, p10, k), pipe,
        flops=B * M * N * BALL_OPS,
        hbm_bytes=(B * N + B * M) * 3 * itemsize + B * M * k * 4,
        kind="fp32", sms=sms)
    return _pair(sched, {"kernel": "ball_query", "plan": p10, "depth": 0},
                 {"kernel": "ball_query_pipelined", "plan": p11,
                  "depth": depth}, pipe, sms)


# ---------------------------------------------------------------------------
# K12 / K13: grouped aggregation
# ---------------------------------------------------------------------------

def group_regs(kernel: str, itemsize: int, C: int, plan) -> int:
    """Registers a thread of the K12 or K13 instantiation that ``plan``
    launches (the more of bf16's and fp16's for 16-bit rows): the count
    ptxas gave this card's build (``pointcloud.kernels.group_ptxas``), or
    ``GROUP_REGS`` where no card is at hand."""
    if not torch.cuda.is_available():
        return GROUP_REGS[kernel]
    from repro_torch.pointcloud.kernels import group_ptxas
    names = ("float32",) if itemsize == 4 else ("bfloat16", "float16")
    return max(group_ptxas(kernel, n, C, plan)[0] for n in names)


def _group_grids(B: int, N: int, M: int, k: int, C: int, itemsize: int,
                 p12, p13) -> tuple[HopperGrid, HopperGrid | None]:
    """K12: a warp a center (or cpw of them), each lane group loading its
    centers' k rows straight from L2, ``GROUP_LOADS`` rows in flight, and
    folding them: a step is one such batch of loads of the block's warps.
    K13: the cloud's channel slice copied whole into shared memory (the
    fill), then each lane group gathers its centers' rows from there: a
    step is one row for every lane group of the block, through the
    shared-memory port."""
    row = C * itemsize
    cpw = p12[0]
    units = row // 16 if row % 16 == 0 else C
    loops = max(1, -(-units // 32))
    warps = 8
    base = HopperGrid(
        blocks=B * -(-M // (warps * cpw)),
        resident=resident(32 * warps, 0, regs=group_regs(
            "group_aggregate", itemsize, C, p12)),
        steps=-(-k // pl.GROUP_LOADS) * loops, compute=0.0, issue=0.0,
        tile_bytes=warps * cpw * pl.GROUP_LOADS * min(row, 512),
        fill_bytes=warps * cpw * k * 4, port="l2_smem")
    if p13 is None:
        return base, None
    bn, cs, split, tiles = p13
    lanes = cs * itemsize // 16
    groups = pl.GROUP_THREADS // lanes
    cpg = -(-(-(-M // split)) // groups)
    smem = pl.group_smem_bytes(p13, M, k, itemsize)
    pipe = HopperGrid(
        blocks=B * (C // cs) * split,
        resident=resident(pl.GROUP_THREADS, smem, regs=group_regs(
            "group_aggregate_pipelined", itemsize, C, p13)),
        steps=cpg * k, streams=tiles, compute=GROUP_ROW_CYCLES,
        issue=groups * cs * itemsize / 128,
        tile_bytes=0, depth=tiles,
        fill_bytes=N * cs * itemsize + -(-M // split) * k * 4,
        port=_port(B * N * row), smem_bytes=smem)
    return base, pipe


@functools.lru_cache(maxsize=None)
def group_schedule(B: int, N: int, M: int, k: int, C: int, itemsize: int,
                   sms: int = pl.SMS) -> dict:
    """K12 or K13 for B clouds of N rows of C channels and M centers of k
    neighbours, each at ``pipeline.group_plan``'s plan (K13 has none where
    rows are not whole 16-byte chunks or no slice of the cloud fits a
    block).  The model weighs K12's gathered bytes from L2 against K13's
    copy of each distinct row into shared memory and its gather there:
    the reuse (gathered rows over distinct rows) and the dtype decide."""
    p12 = pl.group_plan(B, N, M, k, C, itemsize, 0, sms)
    p13 = pl.group_plan(B, N, M, k, C, itemsize, None, sms)
    if B * M * C:
        # K13 has no plan where no slice of the cloud fits a block
        _checked("group_aggregate", p12, pl.group_plan_legal(
            p12, B, N, M, k, C, itemsize), (B, N, M, k, C))
        _checked("group_aggregate_pipelined", p13, p13 is None or
                 pl.group_plan_legal(p13, B, N, M, k, C, itemsize),
                 (B, N, M, k, C))
    base, pipe = _group_grids(B, N, M, k, C, itemsize, p12, p13)
    sched = decide_hopper(
        "group_aggregate", base, pipe, flops=B * M * k * C,
        hbm_bytes=(B * N * C + B * M * C) * itemsize + B * M * k * 4,
        kind="fp32", sms=sms)
    return _pair(sched,
                 {"kernel": "group_aggregate", "plan": p12, "depth": 0},
                 {"kernel": "group_aggregate_pipelined", "plan": p13,
                  "depth": p13 and p13[3]}, pipe, sms)
