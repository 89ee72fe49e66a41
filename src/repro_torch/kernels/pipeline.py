"""Wrappers of the pipelined kernels: K3, flash attention with K/V streamed
through a ``depth``-stage ``cp.async`` ring
(``csrc/flash_attention_pipelined.cu``), K5, the int8-weight GEMM with its
x and wq tiles streamed the same way (``csrc/int8_matmul_pipelined.cu``),
and K8, the SSD scan with its x/B/C chunks streamed
(``csrc/ssd_scan_pipelined.cu``); the ring depths, and the plans of the
kernels that take one (K4/K5, K6, K9-K13).

The port of ``repro/kernels/pipeline.py``.  Which kernel of a pair runs —
baseline or pipelined — is not decided here: the H100 instance of the cost
model (``core/kernel_synth.decide_hopper``) weighs the two under these
plans, through ``kernels/schedule.py``, which both the dispatcher's
schedulers and the kernel routes call.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from repro_torch.core.interface_model import H100_L2_BYTES
from repro_torch.kernels import _build, ref
from repro_torch.kernels import int8_matmul as _i8
from repro_torch.kernels.flash_attention import (BLOCK_Q, DTYPE_CODES,
                                                 MAX_HEAD_DIM, block_k,
                                                 check_flash_args,
                                                 live_count_ptr,
                                                 padded_head_dim)
from repro_torch.kernels.ssd_scan import CHUNK
from repro_torch.kernels.ssd_scan import DTYPE_CODES as SSD_DTYPE_CODES
from repro_torch.kernels.ssd_scan import (block_fits, check_ssd_args,
                                          fixed_floats, stage_floats)

#: Ring depths the kernel is instantiated for.
DEPTHS = (2, 3, 4)
MAX_SMEM = _build.MAX_SMEM

FLASH_ATTENTION_PIPELINED = _build.CudaKernel(
    "flash_attention_pipelined", lib="flash_attention_pipelined",
    symbol="flash_attention_pipelined_launch",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p],
    replaces="src/repro/kernels/pipeline.py:163")


#: Shared memory of one SM on sm_90, and what the SM keeps back for each
#: resident block (bytes).
SM_SMEM = 233_472
BLOCK_RESERVED_SMEM = 1024
#: The live list of a K2/K3/K6 block (csrc/flash_tile.cuh LiveList).
LIST_BYTES = 528


def ring_smem_bytes(hd: int, itemsize: int, depth: int) -> int:
    """Shared memory of one K3 block at the padded head width, as
    csrc/flash_tile.cuh ``Layout`` lays it out: the Q tile, fp32 rows' P
    tile (64 x keys), ``depth`` stages of a K, a V and a mask tile, and the
    live list.  fp32 rows hold Q, K and V as fp32; bf16/fp16 rows keep
    their type and pad each mask row by 16 bytes.  Q/K/V rows are padded
    by 16 bytes."""
    w, bk = padded_head_dim(hd), block_k(hd)
    mma = itemsize == 2
    row = w * itemsize + 16
    p_tile = 0 if mma else BLOCK_Q * (bk + 4) * 4
    mask_tile = BLOCK_Q * (bk + 16 if mma else bk)
    return (BLOCK_Q * row + p_tile + depth * (2 * bk * row + mask_tile)
            + LIST_BYTES)


def blocks_fit(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory that one SM holds."""
    return SM_SMEM // (smem + BLOCK_RESERVED_SMEM)


def deepest_ring(ring_bytes, n_steps: int, cap: int = 4) -> int | None:
    """Deepest ring (2..cap, and no deeper than the sweep) whose shared
    memory, ``ring_bytes(depth)``, fits; None if none does."""
    for depth in range(min(cap, max(n_steps, 2)), 1, -1):
        if ring_bytes(depth) <= MAX_SMEM:
            return depth
    return None


def choose_depth(hd: int, itemsize: int, n_steps: int, cap: int = 4) -> int:
    """K3's ring depth: of the depths 2..cap (and no deeper than the
    sweep) whose block fits, the one whose shared memory leaves room for
    the most blocks on an SM (``blocks_fit``), the deepest of those.  The
    count is by shared memory only: the register caps of the kernel's
    ``__launch_bounds__`` can hold fewer (bf16 at hd 64: 4 blocks by
    shared memory at depth 2, 3 on the card), which
    ``flash_attention.blocks_per_sm`` reports.  Resident blocks hide one
    another's waits and barriers better than a deeper ring hides its
    copies: at (i1)'s shape (B = 8, S = T = 512, hd 64) depth 2 beat
    depths 3 and 4 in fp32 (two blocks an SM against one) and in bf16
    (three against two; the depth sweep in PERF.md).  At every width
    and dtype the kernels are built for this comes to depth 2."""
    def key(depth):
        return blocks_fit(ring_smem_bytes(hd, itemsize, depth)), depth
    depth = max(range(2, min(cap, max(n_steps, 2)) + 1), key=key)
    if key(depth)[0] < 1:
        raise ValueError(f"no ring depth fits head dim {hd}")
    return depth


def flash_attention_pipelined(q, k, v, mask, *, sm_scale: float,
                              depth: int = 2, live_count=None):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    live = live_count_ptr("flash_attention_pipelined", live_count, q)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, mask, sm_scale=sm_scale)
    check_flash_args("flash_attention_pipelined", q, k, v, mask)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if depth not in DEPTHS:
        raise ValueError(f"depth {depth} not in {DEPTHS}")
    if ring_smem_bytes(hd, q.element_size(), depth) > MAX_SMEM:
        raise ValueError(f"a depth-{depth} ring at head dim {hd} does not "
                         f"fit in {MAX_SMEM} bytes of shared memory")
    out = torch.empty_like(q)
    FLASH_ATTENTION_PIPELINED.launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
        _build.ptr(out), B, S, T, H, K, hd, mask.shape[0], float(sm_scale),
        live, depth, DTYPE_CODES[q.dtype], q.device.index,
        _build.stream_of(q))
    return out


# ---------------------------------------------------------------------------
# K5: the int8-weight GEMM with x and wq tiles streamed
# ---------------------------------------------------------------------------

INT8_MATMUL_PIPELINED = _build.CudaKernel(
    "int8_matmul_pipelined", lib="int8_matmul_pipelined",
    symbol="int8_matmul_pipelined_launch",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    replaces="src/repro/kernels/pipeline.py:242")

#: k-values a stage of K5's ring (one 64-byte row of wq a tile row).
K5_STAGE_K = 64
#: What csrc/int8_matmul_pipelined.cu is built for: rows of x a block (8
#: a tensor-core n-tile; more rows take more blocks) and rows of wq (16 a
#: warp).
K5_TILE_M = (8, 16, 32)
K5_TILE_N = (64, 128)

#: Most bytes of x's bf16 terms a K5 panel holds (csrc kPanelBudget).
K5_PANEL_BUDGET = 110_592


def int8_ring_bytes(itemsize: int, depth: int, tile_n: int = 128) -> int:
    """Shared memory of ``depth`` stages of K5's wq ring: ``tile_n`` rows
    of 64 int8 a stage.  x's itemsize does not enter: x lies in its own
    panel (``k5_smem_bytes``)."""
    del itemsize
    return depth * tile_n * K5_STAGE_K


def int8_depth(K: int, itemsize: int, cap: int = 4) -> int:
    """Deepest K5 ring (2..cap) no deeper than a sweep of K values takes
    64-wide stages, whose stages fit."""
    depth = deepest_ring(lambda d: int8_ring_bytes(itemsize, d),
                         -(-K // K5_STAGE_K), cap)
    if depth is None:
        raise ValueError(f"no int8 ring depth fits itemsize {itemsize}")
    return depth


def k5_panel_stages(tile_m: int, itemsize: int, stages: int) -> int:
    """Stages of a block's K range one panel of x's terms holds (3 terms
    for fp32 x, 1 for bf16 and fp16), at most the block's ``stages``."""
    terms = 3 if itemsize == 4 else 1
    fit = (K5_PANEL_BUDGET // (terms * tile_m) - 16) // (2 * K5_STAGE_K)
    return max(1, min(stages, fit))


def k5_smem_bytes(tile_m: int, tile_n: int, split: int, depth: int,
                  itemsize: int, K: int) -> int:
    """Dynamic shared memory of one K5 block (csrc/int8_matmul_pipelined.cu
    ``smem_bytes``): 128 bytes of alignment slack and 64 of mbarriers, the
    ring, and the panel of x's terms (rows of 16-bit values padded by 8),
    or where K is split and it is larger, the fp32 partial tile."""
    stages = -(-(-(-K // K5_STAGE_K)) // split)
    terms = 3 if itemsize == 4 else 1
    ps = k5_panel_stages(tile_m, itemsize, stages)
    main = (int8_ring_bytes(itemsize, depth, tile_n)
            + terms * tile_m * (ps * K5_STAGE_K + 8) * 2)
    part = tile_n * (tile_m + 4) * 4 if split > 1 else 0
    return 128 + 64 + max(main, part)


def int8_ring_takes(x, wq) -> bool:
    """True iff K5's TMA copies take these operands: wq rows of a multiple
    of 16 bytes (K % 16 == 0, which also makes x's rows of fp32, bf16 or
    fp16 whole 16-byte vectors) and 16-byte aligned bases."""
    return (x.shape[-1] % 16 == 0 and x.data_ptr() % 16 == 0
            and wq.data_ptr() % 16 == 0)


def int8_matmul_pipelined(x, wq, scale, *, depth: int | None = None,
                          plan=None, _plan=None):
    """K5 on CUDA tensors, the plain version on CPU tensors.

    ``plan`` (tile_m, tile_n, split, depth) is the plan a schedule holds
    (``kernels/schedule.py`` checked it when it made the schedule) and runs
    as given; without it, ``int8_plan``'s.  ``depth`` replaces the ring
    depth, and ``_plan`` the whole plan, for the plan sweep and the card's
    tests only.  A plan or depth the kernel does not take raises."""
    if x.device.type == "cpu":
        return ref.int8_matmul_ref(x, wq, scale)
    device = _i8.check_int8_args("int8_matmul_pipelined", x, wq, scale)
    if not int8_ring_takes(x, wq):
        raise ValueError(f"int8_matmul_pipelined: K={x.shape[1]} is not a "
                         f"multiple of 16 or an operand is not 16-byte "
                         f"aligned (TMA); K4 takes it")
    if depth is not None and depth not in DEPTHS:
        raise ValueError(f"depth {depth} not in {DEPTHS}")
    M, K = x.shape
    N = wq.shape[0]
    plan = _plan or plan or int8_plan(M, N, K, x.element_size(),
                                      pipelined=True, sms=sm_count(x.device))
    if depth is not None:
        plan = (*plan[:3], depth)
    if (_plan is not None or depth is not None) and not int8_plan_legal(
            plan, M, N, K, x.element_size(), pipelined=True):
        raise ValueError(f"int8_matmul_pipelined: plan {plan} is not built "
                         f"or does not fit for M={M}, N={N}, K={K}, "
                         f"{x.dtype}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    INT8_MATMUL_PIPELINED.launch(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N,
        K, *plan, _i8.DTYPE_CODES[x.dtype], device,
        _i8.current_stream(device))
    return out


# ---------------------------------------------------------------------------
# K4's and K5's plan
# ---------------------------------------------------------------------------

#: SMs of an H100 SXM: the plans' default where no card is at hand (the
#: wrappers and schedules pass their card's count, ``sm_count``).
SMS = 132
#: What csrc/int8_matmul.cu (K4) is built for: rows of the output tile (64
#: a consumer warpgroup), its columns by x's itemsize (256 only for bf16
#: and fp16: fp32 keeps a second set of accumulators), and the blocks of a
#: cluster that split K.
K4_TILE_M = (64, 128)
K4_TILE_N = {4: (64, 128), 2: (64, 128, 256)}
INT8_SPLITS = (1, 2, 4, 8)
#: k-values a stage of K4's ring.
K4_STAGE_K = 64


def k4_smem_bytes(tile_m: int, tile_n: int, split: int, depth: int,
                  itemsize: int) -> int:
    """Dynamic shared memory of one K4 block (csrc/int8_matmul.cu
    ``smem_bytes``): 1024 bytes of alignment slack and 128 of mbarriers,
    then ``depth`` stages of the x tile (x's type), the widened wq tile
    (2 bytes a value) and the int8 wq tile, or where K is split and it is
    larger, the fp32 partial tile (rows padded by 8 floats)."""
    stage = K4_STAGE_K * (tile_m * itemsize + 3 * tile_n)
    part = tile_m * (tile_n + 8) * 4 if split > 1 else 0
    return 1024 + 128 + max(depth * stage, part)


def int8_plan_legal(plan, M: int, N: int, K: int, itemsize: int, *,
                    pipelined: bool) -> bool:
    """True iff the kernel (K5 if ``pipelined``, else K4) is built for
    ``plan`` = (tile_m, tile_n, split, depth) and its block fits."""
    tile_m, tile_n, split, depth = plan
    if pipelined:
        return (tile_m in K5_TILE_M and tile_n in K5_TILE_N
                and split in INT8_SPLITS and split <= -(-K // K5_STAGE_K)
                and depth in DEPTHS and K % 16 == 0
                and -(-M // tile_m) <= 65535
                and k5_smem_bytes(tile_m, tile_n, split, depth, itemsize,
                                  K) <= MAX_SMEM)
    return (tile_m in K4_TILE_M and tile_n in K4_TILE_N[itemsize]
            and split in INT8_SPLITS and split <= -(-K // K4_STAGE_K)
            and depth in DEPTHS and -(-M // tile_m) <= 65535
            and k4_smem_bytes(tile_m, tile_n, split, depth,
                              itemsize) <= MAX_SMEM)


def int8_plans(M: int, N: int, K: int, itemsize: int, *,
               pipelined: bool) -> list[tuple[int, int, int, int]]:
    """Every plan the kernel (K5 if ``pipelined``, else K4) is built for
    and takes at this shape (``int8_plan_legal``)."""
    tiles_m, tiles_n = ((K5_TILE_M, K5_TILE_N) if pipelined
                        else (K4_TILE_M, K4_TILE_N[itemsize]))
    return [plan for plan in itertools.product(tiles_m, tiles_n, INT8_SPLITS,
                                               DEPTHS)
            if int8_plan_legal(plan, M, N, K, itemsize, pipelined=pipelined)]


@functools.lru_cache(maxsize=None)
def int8_plan(M: int, N: int, K: int, itemsize: int, *,
              pipelined: bool, sms: int = SMS) -> tuple[int, int, int, int]:
    """The plan (tile_m, tile_n, split, depth) of K5 (``pipelined``) or K4
    for an (M, K) x (N, K) int8 GEMM with x of ``itemsize`` bytes, on a
    card of ``sms`` SMs.

    K4: 128 rows a tile (two consumer warpgroups) above 64 rows, else 64;
    the widest tile whose grid reaches 7/8 of the SMs, else 128 columns;
    K split over a cluster of 2, 4 or 8 blocks while the grid stays within
    one wave and each block keeps two stages or more; a ring of 3 stages,
    no deeper than the block's stages.
    At the (i2) shapes (M = 512; K, N of 768, 2048 and the 768 x 32000
    unembedding) this takes the fastest plan of the sweep in PERF.md, or
    one within 4 % of it.

    K5: ``_k5_plan``."""
    if pipelined:
        return _k5_plan(M, N, K, itemsize, sms)
    nk = -(-K // K4_STAGE_K)
    tile_m = 128 if M > 64 else 64
    widths = K4_TILE_N[itemsize]

    def tiles(tn):
        return -(-M // tile_m) * -(-N // tn)
    tile_n = next((tn for tn in reversed(widths)
                   if 8 * tiles(tn) >= 7 * sms), 128)
    split = 1
    while (2 * split in INT8_SPLITS and tiles(tile_n) * 2 * split <= sms
           and nk >= 4 * split):
        split *= 2
    depth = min(3, max(2, -(-nk // split)))
    return tile_m, tile_n, split, depth


def _k5_plan(M: int, N: int, K: int, itemsize: int, sms: int):
    """K5's plan: the fewest rows of x a block (8, 16 or 32) that hold M,
    else 32 and more blocks; 128 rows of wq a block where the blocks reach
    the SMs, else 64; K split over a cluster of 2, 4 or 8 blocks while the
    grid stays within two blocks an SM and no split is past K's 64-wide
    stages; a ring of 2 stages (deeper rings were no faster at any (i2)
    shape in the sweep in PERF.md)."""
    nk = -(-K // K5_STAGE_K)
    tile_m = next((t for t in K5_TILE_M if t >= M), max(K5_TILE_M))
    rows = -(-M // tile_m)
    tile_n = 128 if rows * -(-N // 128) >= sms else 64
    blocks = rows * -(-N // tile_n)
    split = 1
    while (2 * split in INT8_SPLITS and blocks * 2 * split <= 2 * sms
           and 2 * split <= nk):
        split *= 2
    return tile_m, tile_n, split, 2


# ---------------------------------------------------------------------------
# K8: the SSD scan with x/B/C chunks streamed
# ---------------------------------------------------------------------------

SSD_SCAN_PIPELINED = _build.CudaKernel(
    "ssd_scan_pipelined", lib="ssd_scan_pipelined",
    symbol="ssd_scan_pipelined_launch",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    replaces="src/repro/kernels/pipeline.py:334")


#: Shared bytes before K8's ring: one mbarrier a stage, padded.
SSD_BARRIER_BYTES = 64


def ssd_ring_bytes(P: int, N: int, depth: int, itemsize: int = 4) -> int:
    """Shared memory of one K8 block: the stages' mbarriers, ``depth``
    stages of raw x, B and C with K7's strides (csrc/ssd_tile.cuh), for
    bf16/fp16 one fp32 stage they are widened into, and K7's fixed part."""
    stage = stage_floats(P, N)
    work = 0 if itemsize == 4 else 4 * stage
    return (SSD_BARRIER_BYTES + depth * stage * itemsize + work
            + 4 * fixed_floats(P, N))


def ssd_plan(P: int, N: int, S: int, itemsize: int = 4,
             cap: int = 4) -> int | None:
    """K8's ring depth for a sweep of S positions: of the depths from 2 to
    ``cap`` (and no deeper than the sweep's chunks) whose ring fits, the
    one whose block leaves room for the most blocks on an SM by shared
    memory (``blocks_fit``), the deepest of equals; None if no ring
    fits."""
    fits = [d for d in range(2, min(cap, max(-(-S // CHUNK), 2)) + 1)
            if block_fits(P, N, ssd_ring_bytes(P, N, d, itemsize))]
    if not fits:
        return None
    return max(fits, key=lambda d: (blocks_fit(
        ssd_ring_bytes(P, N, d, itemsize)), d))


def ssd_depth(P: int, N: int, S: int, cap: int = 4, itemsize: int = 4) -> int:
    """K8's ring depth for a sweep of S positions (``ssd_plan``); raises
    if no ring fits."""
    depth = ssd_plan(P, N, S, itemsize, cap)
    if depth is None:
        raise ValueError(f"no SSD ring fits P={P}, N={N}")
    return depth


def ssd_scan_pipelined(x, dt, A, B, C, *, depth: int = 2):
    """K8 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_pipelined: no kernel for device "
                         f"{x.device}")
    check_ssd_args("ssd_scan_pipelined", x, dt, A, B, C)
    BT, H, S, P = x.shape
    N = B.shape[-1]
    if depth not in DEPTHS:
        raise ValueError(f"depth {depth} not in {DEPTHS}")
    if not block_fits(P, N, ssd_ring_bytes(P, N, depth, x.element_size())):
        raise ValueError(f"a depth-{depth} SSD ring at P={P}, N={N} does not "
                         f"fit in {MAX_SMEM} bytes of shared memory")
    y = torch.empty_like(x)
    SSD_SCAN_PIPELINED.launch(
        _build.ptr(x), _build.ptr(dt), _build.ptr(A), _build.ptr(B),
        _build.ptr(C), _build.ptr(y), BT, H, S, P, N, depth,
        SSD_DTYPE_CODES[x.dtype], x.device.index, _build.stream_of(x))
    return y


# ---------------------------------------------------------------------------
# K9's plan: farthest-point sampling on a cluster of blocks
# ---------------------------------------------------------------------------

#: What csrc/fps.cu is instantiated for: blocks a cloud (a thread-block
#: cluster), threads a block, points a thread in registers (0: the scratch
#: path, distances in global memory).
FPS_CLUSTERS = (1, 2, 4, 8, 16)
FPS_THREADS = (256, 512, 1024)
FPS_PPTS = (1, 2, 4, 8)
#: Clusters of each size an H100 SXM runs at once, one block an SM
#: (``cudaOccupancyMaxActiveClusters``, tools/fps_barrier_probe.py): a
#: cluster's blocks share one GPC, so 8- and 16-block clusters leave SMs
#: idle and B clouds beyond this count queue behind the first wave.
FPS_CLUSTERS_AT_ONCE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
#: Most points of a cloud whose distances K9 keeps in registers.
FPS_CAPACITY = max(FPS_CLUSTERS) * max(FPS_THREADS) * max(FPS_PPTS)
#: Most points one block holds in registers.
FPS_BLOCK_POINTS = max(FPS_THREADS) * max(FPS_PPTS)
#: Most points a block of a cluster is given (256 threads at 8 points): a
#: cluster barrier costs 0.4-0.8 µs against 0.02-0.05 for a block's, and
#: least at 256 threads (the barrier probe, PERF.md), so clusters pay only
#: where the update they split is large, and then fastest on 256-thread
#: blocks (the sweep, PERF.md).
FPS_CLUSTER_SPAN = 2048


def fps_ppt(span: int, threads: int) -> int:
    """Least points a thread (of ``FPS_PPTS``) for ``threads`` threads to
    hold ``span`` points in registers, or 0 where none does."""
    return next((p for p in FPS_PPTS if threads * p >= span), 0)


def fps_plan(B: int, N: int) -> tuple[int, int, int]:
    """K9's plan for B clouds of N points: (cluster, threads, ppt).

    One block a cloud while one block holds it in registers (up to 8192
    points): one block barrier a step beats a cluster barrier at every
    size the sweep reached.  Above that, the smallest cluster that gives
    each block at most ``FPS_CLUSTER_SPAN`` points (at most 16 blocks),
    halved while the B clusters would not all run at once
    (``FPS_CLUSTERS_AT_ONCE``): a second wave costs a whole first one.
    Registers where the cluster holds the cloud at 8 points a thread, at
    the fewest threads that do (fewer warps, a shorter reduction); else
    the scratch path (ppt 0; clouds above ``FPS_CAPACITY`` points and
    clusters halved below holding theirs), 512 threads a block on 8 or 16
    blocks, 1024 on fewer."""
    if N <= FPS_BLOCK_POINTS:
        cluster = 1
    else:
        cluster = next((c for c in FPS_CLUSTERS
                        if c * FPS_CLUSTER_SPAN >= N), max(FPS_CLUSTERS))
        while cluster > 1 and B > FPS_CLUSTERS_AT_ONCE[cluster]:
            cluster //= 2
    span = -(-N // cluster)
    if span > FPS_BLOCK_POINTS:
        return cluster, 512 if cluster >= 8 else 1024, 0
    threads = next(t for t in FPS_THREADS if t * max(FPS_PPTS) >= span)
    return cluster, threads, fps_ppt(span, threads)


def fps_plan_legal(plan, N: int) -> bool:
    """True iff csrc/fps.cu takes ``plan`` for clouds of N points."""
    cluster, threads, ppt = plan
    return (cluster in FPS_CLUSTERS and threads in FPS_THREADS
            and (ppt == 0 or (ppt in FPS_PPTS
                              and cluster * threads * ppt >= N)))


# ---------------------------------------------------------------------------
# K10's and K11's plan: ball query, C centers a warp, the cloud split over a
# cluster
# ---------------------------------------------------------------------------

#: Points of a K11 ring slot; a split cuts the cloud into whole tiles
#: (csrc/ball_tile.cuh kTile).
BALL_TILE = 256
#: What csrc/ball_query.cu (K10) and csrc/ball_query_pipelined.cu (K11) are
#: built for: centers a warp (held in registers, each loaded point tested
#: against all of them), warps a block, and blocks of a cluster that split
#: the cloud.  K10's depth is 0 (no ring), K11's one of ``DEPTHS``.
BALL_CPW = (1, 2, 4, 8)
BALL_WARPS = (2, 4, 8)
BALL_SPLITS = (1, 2, 4, 8)
#: Most points of a part K10 holds in shared memory at once, as fp32
#: (csrc/ball_query.cu kResident).
BALL_RESIDENT = 4096
#: Shared memory a K10/K11 block keeps for its static part, its queue of
#: empty balls (csrc/ball_tile.cuh kMaxDynamicSmem); the dynamic part must
#: leave room for it.
BALL_STATIC_SMEM = 1024


def ball_part_points(N: int, split: int) -> int:
    """Points of one part of a cloud of N split ``split`` ways: whole
    ``BALL_TILE`` tiles (the last part may be shorter or empty)."""
    return -(-(-(-N // BALL_TILE)) // split) * BALL_TILE


def ball_smem_bytes(plan, N: int, k: int, itemsize: int) -> int:
    """Shared memory of one K10 (depth 0) or K11 block under ``plan`` =
    (cpw, warps, split, depth), as the kernels lay it out: K10 up to
    ``BALL_RESIDENT`` points of fp32 coordinates, K11 ``depth`` slots of a
    raw tile plus a 16-byte lead and its mbarriers; then, where the cloud
    is split, an inbox of (count, first k hits) from every part for each
    center the block merges."""
    cpw, warps, split, depth = plan
    lists = (0 if split == 1 else
             4 * -(-(cpw * warps) // split) * split * (1 + k))
    if depth == 0:
        return 12 * min(ball_part_points(N, split), N, BALL_RESIDENT) + lists
    slot = -(-(BALL_TILE * 3 * itemsize + 16) // 16) * 16
    return depth * slot + 32 + lists


def ball_plan_legal(plan, B: int, N: int, M: int, k: int,
                    itemsize: int) -> bool:
    """True iff K10 (depth 0) or K11 (depth in ``DEPTHS``) is built for
    ``plan`` = (cpw, warps, split, depth), no part is past the cloud's
    tiles, and the block's shared memory fits beside its static part."""
    cpw, warps, split, depth = plan
    return (cpw in BALL_CPW and warps in BALL_WARPS and split in BALL_SPLITS
            and split <= -(-N // BALL_TILE) and (depth == 0 or depth in DEPTHS)
            and 1 <= B <= 65535 and M >= 1 and k >= 1
            and ball_smem_bytes(plan, N, k, itemsize) + BALL_STATIC_SMEM
            <= MAX_SMEM)


def ball_plans(B: int, N: int, M: int, k: int, itemsize: int,
               depth: int = 0) -> list[tuple[int, int, int, int]]:
    """Every plan of K10 (``depth`` 0) or of K11 at ring ``depth`` that is
    legal at this shape."""
    return [(c, w, s, depth) for c, w, s in itertools.product(
        BALL_CPW, BALL_WARPS, BALL_SPLITS)
        if ball_plan_legal((c, w, s, depth), B, N, M, k, itemsize)]


@functools.lru_cache(maxsize=None)
def ball_plan(B: int, N: int, M: int, k: int, itemsize: int,
              depth: int = 0, sms: int = SMS) -> tuple[int, int, int, int]:
    """The plan (cpw, warps, split, depth) of K10 (``depth`` 0) or of K11
    at ring ``depth`` for B clouds of N points and M centers of k
    neighbours, on a card of ``sms`` SMs.

    K11: 4 centers a warp, 4 warps a block.  K10: 8 warps a block (each
    K10 block copies its whole part into shared memory, so fewer, wider
    blocks copy less); one center a warp where the centers alone give at
    most 8 warps an SM and the cloud fits one block's shared memory (a
    warp then stops at its one center's k-th hit), else 2.  Both: the
    cloud split over a cluster of 2, 4 or 8 blocks while the warps of all
    parts stay under 12 an SM (a warp's walk over its part is the latency
    the split cuts; past that the merge costs more than it saves), K10
    further while a part is past the ``BALL_RESIDENT`` points it holds at
    once; no part without a tile, and only as far as the block fits.  At
    the swept shapes ((a), (b), a 65536-point cloud and (a) with empty
    balls) this takes the fastest plan of the sweep in PERF.md or one
    within 5 % of it, except K10 with empty balls (7.6 %): it has (a)'s
    shape, so it takes (a)'s plan."""
    if depth:
        cpw, warps = 4, 4
    else:
        cpw = 1 if B * M <= 8 * sms and N <= BALL_RESIDENT else 2
        warps = 8
    walks = B * -(-M // cpw)
    split = 1
    while (2 * split in BALL_SPLITS
           and (walks * split < 12 * sms
                or (depth == 0
                    and ball_part_points(N, split) > BALL_RESIDENT))
           and ball_plan_legal((cpw, warps, 2 * split, depth), B, N, M, k,
                               itemsize)):
        split *= 2
    return cpw, warps, split, depth


# ---------------------------------------------------------------------------
# K12's and K13's plan: grouped aggregation, a direct gather (K12) or the
# cloud's feature tiles copied whole into shared memory (K13)
# ---------------------------------------------------------------------------

#: Threads of a K13 block (csrc/group_aggregate_pipelined.cu kThreads).
GROUP_THREADS = 512
#: What csrc/group_aggregate_pipelined.cu (K13) is built for: bytes of a
#: row of the channel slice (read by 1, 2, 4 or 8 lanes of 16 bytes; 128
#: bytes is one conflict-free shared-memory wavefront), rows of a feature
#: tile (a TMA box is at most 256 rows), blocks of a cluster that share
#: each tile (one multicast copy) and split the centers, and the most
#: centers one lane group keeps in registers.
GROUP_SLICE_BYTES = (16, 32, 64, 128)
GROUP_TILE_ROWS = (64, 128, 256)
GROUP_SPLITS = (1, 2, 4, 8)
GROUP_CPG = 4
#: What csrc/group_aggregate.cu (K12) is built for: centers a warp (the
#: warp's lanes split evenly between them), and row loads a lane issues
#: before it folds them (compile-time, so all are in flight at once).
GROUP_CPW = (1, 2, 4, 8)
GROUP_LOADS = 8


def group_lanes(C: int, itemsize: int) -> int:
    """Lanes K12 gives one row of C channels: one a 16-byte chunk (one an
    element where rows are not whole chunks), rounded up to a power of
    two, at most the warp (wider rows loop over chunks of 32 lanes)."""
    units = C * itemsize // 16 if (C * itemsize) % 16 == 0 else C
    return min(32, 1 << max(0, units - 1).bit_length())


def group_tiles(N: int, bn: int) -> int:
    """Feature tiles of ``bn`` rows K13 streams for a cloud of N points:
    the reference's ``N // bn`` where bn divides N."""
    return -(-N // bn)


def group_smem_bytes(plan, M: int, k: int, itemsize: int) -> int:
    """Dynamic shared memory of one K13 block under ``plan`` = (bn, cs,
    split, depth), as csrc/group_aggregate_pipelined.cu ``Layout`` lays
    it out: ``depth`` slots (one a tile) of bn rows of the cs-channel
    slice, the block's centers' neighbour offsets (16-byte chunks of four,
    an odd count a center against bank conflicts), one mbarrier a slot."""
    bn, cs, split, depth = plan
    mb = -(-M // split)
    return depth * bn * cs * itemsize + 16 * mb * (-(-k // 4) | 1) + 8 * depth


def group_plan_legal(plan, B: int, N: int, M: int, k: int, C: int,
                     itemsize: int) -> bool:
    """True iff K12 (depth 0: (cpw, 0, 0, 0)) or K13 ((bn, cs, split,
    depth), depth >= 1) is built for ``plan`` and takes this shape.

    K13: rows of whole 16-byte chunks, a slice of ``GROUP_SLICE_BYTES``
    that divides the row, no tile wider than the cloud unless it is the
    narrowest, each of the split's parts of a tile at least 8 rows, one
    slot a tile (``depth`` = the tiles: the whole slice in shared
    memory); each lane group keeps at most
    ``GROUP_CPG`` centers, and the block fits."""
    if not (1 <= B <= 65535 and N >= 1 and M >= 1 and k >= 1 and C >= 1):
        return False
    if plan[3] == 0:
        cpw = plan[0]
        return (tuple(plan[1:]) == (0, 0, 0) and cpw in GROUP_CPW
                and cpw * group_lanes(C, itemsize) <= 32)
    bn, cs, split, depth = plan
    nt = group_tiles(N, bn)
    lanes = cs * itemsize // 16
    return ((C * itemsize) % 16 == 0 and cs * itemsize in GROUP_SLICE_BYTES
            and C % cs == 0 and C // cs <= 65535
            and bn in GROUP_TILE_ROWS and (bn <= N or bn == GROUP_TILE_ROWS[0])
            and split in GROUP_SPLITS and bn // split >= 8
            and depth == nt
            and -(-(-(-M // split)) // (GROUP_THREADS // lanes)) <= GROUP_CPG
            and group_smem_bytes(plan, M, k, itemsize) <= MAX_SMEM)


def group_plans(B: int, N: int, M: int, k: int, C: int, itemsize: int,
                depth: int | None = None) -> list[tuple[int, int, int, int]]:
    """Every legal plan of K12 (``depth`` 0) or of K13 (None)."""
    if depth == 0:
        plans = [(c, 0, 0, 0) for c in GROUP_CPW]
    else:
        plans = [(bn, sb // itemsize, split, group_tiles(N, bn))
                 for bn, sb, split in itertools.product(
                     GROUP_TILE_ROWS, GROUP_SLICE_BYTES, GROUP_SPLITS)]
    return [p for p in plans
            if group_plan_legal(p, B, N, M, k, C, itemsize)]


def sm_count(device=None) -> int:
    """SMs of ``device``'s card (a CUDA device, as the driver reports
    them); ``SMS`` for a CPU device, whose tensors take the plain
    versions."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return SMS
    index = torch.cuda.current_device() if device.index is None else device.index
    return _sms_of(index)


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_sm_count() -> int:
    """SMs of the current CUDA device, or ``SMS`` where there is none: the
    card the dispatcher's schedules are for."""
    return sm_count("cuda") if torch.cuda.is_available() else SMS


@functools.lru_cache(maxsize=None)
def current_l2_bytes() -> int:
    """L2 bytes of the current CUDA device, or an H100's 50 MB where there
    is none."""
    if not torch.cuda.is_available():
        return H100_L2_BYTES
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size


#: K13's plan rule (``group_plan``), from the card's sweep (PERF.md): a
#: block's gather out of shared memory at most this many bytes, and the
#: tiles copied into all blocks' shared memory at most this many in all.
GROUP_GATHER_CAP = 512 * 1024
GROUP_FILL_CAP = 8 * 1024 * 1024


@functools.lru_cache(maxsize=None)
def group_plan(B: int, N: int, M: int, k: int, C: int, itemsize: int,
               depth: int | None = None, sms: int = SMS):
    """The plan of K12 (``depth`` 0: (cpw, 0, 0, 0)) or of K13 (None: (bn,
    cs, split, depth)) for B clouds of N rows of C channels and M centers
    of k neighbours, on a card of ``sms`` SMs; None where K13 takes no plan
    (rows that are not whole 16-byte chunks, or no slice of the cloud fits
    a block whole), so the route sends the cloud to K12.

    K12: as many centers a warp as the row's lanes leave room for, while
    that keeps 8 warps an SM busy, else one.

    K13: tiles of 256 rows (or the narrowest where the cloud is shorter),
    of the plans whose slice fits a block whole: the blocks one wave and
    more than a quarter of the SMs, a block's gather (its centers' k rows
    of the slice) at most ``GROUP_GATHER_CAP`` bytes, the slices copied into all blocks at most
    ``GROUP_FILL_CAP`` bytes (dropping these conditions from the last where
    no plan meets them all); then the largest gather a block (fewer, fuller
    blocks), the widest slice, the smallest split.  At the swept shapes
    this takes the fastest plan of the sweep in PERF.md or one within 3 %
    of it."""
    if depth == 0:
        lanes = group_lanes(C, itemsize)
        cpw = max(c for c in GROUP_CPW
                  if c == 1 or (c * lanes <= 32 and B * M >= 8 * sms * c))
        return cpw, 0, 0, 0
    bn = max(b for b in GROUP_TILE_ROWS if b <= N or b == GROUP_TILE_ROWS[0])
    plans = [p for p in group_plans(B, N, M, k, C, itemsize) if p[0] == bn]

    def blocks(p):
        return B * (C // p[1]) * p[2]

    def gather(p):
        return -(-M // p[2]) * k * p[1] * itemsize
    conds = (lambda p: sms // 4 < blocks(p) <= sms,
             lambda p: gather(p) <= GROUP_GATHER_CAP,
             lambda p: blocks(p) * N * p[1] * itemsize <= GROUP_FILL_CAP)
    for n in range(len(conds), -1, -1):
        chosen = [p for p in plans if all(c(p) for c in conds[:n])]
        if chosen:
            return max(chosen, key=lambda p: (gather(p), p[1], -p[2]))
    return None


# ---------------------------------------------------------------------------
# K6's plan: int8-K/V flash attention, a q tile's keys split over a cluster
# ---------------------------------------------------------------------------

#: What csrc/flash_attention_int8kv.cu (K6) is built for: blocks of a
#: cluster that share a q tile's live K/V tiles, and the stages of its int8
#: ring (``kDepth`` in csrc/int8kv_tile.cuh; 3 was never faster by more than
#: 1 % in the card's sweep, PERF.md).
INT8KV_SPLITS = (1, 2, 4)
INT8KV_RING = 2


def int8kv_smem_bytes(hd: int, itemsize: int) -> int:
    """Shared memory of one K6 block (csrc/int8kv_tile.cuh ``Layout``): the
    q tile (three bf16 terms for fp32 q), two 16-bit tiles of widened K, V
    and mask bytes, ``INT8KV_RING`` stages of int8 K, int8 V and mask
    bytes, and the live list; at least a split block's partial acc, m and
    l.  Rows are padded by 16 bytes."""
    w, bk = padded_head_dim(hd), block_k(hd)
    terms = 3 if itemsize == 4 else 1
    mask_tile = BLOCK_Q * (bk + 16)
    wide = 2 * bk * 2 * (w + 8) + mask_tile
    stage = 2 * bk * (w + 16) + mask_tile
    sweep = (terms * BLOCK_Q * 2 * (w + 8) + 2 * wide + INT8KV_RING * stage
             + LIST_BYTES)
    return max(sweep, 4 * BLOCK_Q * (w + 4) + 8 * BLOCK_Q)


def int8kv_plan_legal(plan, B: int, S: int, T: int, H: int, K: int, hd: int,
                      dtype: torch.dtype) -> bool:
    """True iff K6 is built for ``plan`` = (split, depth) at this shape.  A
    split may leave a rank without a live tile (it then adds nothing)."""
    split, depth = plan
    return (split in INT8KV_SPLITS and depth == INT8KV_RING
            and 1 <= hd <= MAX_HEAD_DIM and -(-S // BLOCK_Q) <= 65535
            and min(B, S, T, H, K) >= 1)


def int8kv_plans(B: int, S: int, T: int, H: int, K: int, hd: int,
                 dtype: torch.dtype) -> list[tuple[int, int]]:
    """Every plan K6 takes at this shape (``int8kv_plan_legal``)."""
    return [(s, INT8KV_RING) for s in INT8KV_SPLITS
            if int8kv_plan_legal((s, INT8KV_RING), B, S, T, H, K, hd, dtype)]


def int8kv_blocks_per_sm(hd: int, itemsize: int) -> int:
    """K6 blocks one SM holds: by shared memory (``blocks_fit``) and by
    registers (``__launch_bounds__``: two blocks at widths up to 64, one
    above)."""
    regs = 2 if padded_head_dim(hd) <= 64 else 1
    return min(regs, blocks_fit(int8kv_smem_bytes(hd, itemsize)))


@functools.lru_cache(maxsize=None)
def int8kv_plan(B: int, S: int, T: int, H: int, K: int, hd: int,
                dtype: torch.dtype, sms: int = SMS) -> tuple[int, int]:
    """The plan (split, depth) of K6 for q (B, S, H, hd) of ``dtype`` over
    T keys, on a card of ``sms`` SMs (the wrapper passes its card's): a q
    tile's keys split over a cluster of 2, then 4 blocks while the grid of
    q tiles (B · H · ⌈S/64⌉ blocks) leaves SMs idle, the split grid stays
    within one wave of resident blocks, and each rank keeps a tile of the
    longest sweep."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_sm = int8kv_blocks_per_sm(hd, itemsize)
    blocks = B * H * -(-S // BLOCK_Q)
    tiles = -(-T // block_k(hd))
    split = 1
    while (2 * split in INT8KV_SPLITS and blocks * split < sms
           and blocks * 2 * split <= per_sm * sms and tiles >= 2 * split):
        split *= 2
    return split, INT8KV_RING
