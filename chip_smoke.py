#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, then
serves full-width llama110m through the continuous-batching engine, runs
the point-cloud set-abstraction stage, serves full-width mamba2-2.7b
through the static-batch engine, serves every other config of the
registry at full width (dbrx-132b and arctic-480b cut in depth only),
serves llama110m on int8 weights through
``StaticBatchEngine`` and sends its quantized projections through the
quantized-GEMM entry point, checks that each path went through the
kernels its compile records name, trains through the port's ``Trainer``
(llama110m with a failure and a restart, qwen1.5-0.5b under each remat
policy, every other family two steps), then prints the compile cache, runs the
e-graph's offloaded programs on the kernels, and times both kernels of
each baseline/pipelined pair where the cost model picks between them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. card: ``nvidia-smi`` name and power limit; TF32 off for fp32 parity.
2. build: every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, all at
   once.
3. kernels: K1 rmsnorm, K2 flash attention, K3 pipelined flash attention at
   the main paths' shapes (batch 1 for the continuous engine's prefills,
   batch 8 and R = 8·bucket rows for run (i1)'s static groups) against
   their plain versions (fp32 atol 2e-5 / rtol 2e-4, bf16 and fp16 2e-2:
   the reference's tests/test_kernels.py:18), one JSON
   line per case with device times (CUDA events around back-to-back
   launches queued behind a GPU spin, so host overhead is excluded: ``ms``
   repeats one call on the same inputs, ``cold_ms`` rotates through copies
   of them past 4x the 50 MB L2), the plain version's and one PyTorch
   library call's time as a yardstick, and the bound: max(bytes / 3.35
   TB/s, flops / peak), with fp32 work on the 67 TFLOP/s CUDA-core rate
   and bf16/fp16 on the 989 TFLOP/s tensor cores.  K1 rows also time the
   first design's two-pass loop shape (``loop_ms``, ``loop_cold_ms``) and
   ``F.rms_norm`` cold; K1 fp16 rows; K2 at (i1)'s groups (B = 8, S = T
   = 64, 128, 512; the last K2's main case, the largest shape the main
   path gives it); K2/K3 at head dims 80, 96 and 256
   (one KV head) and in fp16; K3 at (i1)'s B = 8, S = T = 512 at ring
   depths 2, 3 and 4 in fp32 and bf16 (the sweep ``choose_depth``'s rule
   rests on); a local + strided block-sparse mask (K2, K3); a long T in
   bf16 (S = 64, T = 4096: P rounded to bf16 over 4096 keys; its outputs
   average ~4000 values and are held to 2e-2 of the largest output, not
   an atol of 2e-2).  Rows that differ only in the kernel or its ring
   depth share one timing of the plain version and of SDPA.  Every K2,
   K3 and K6 row carries ``blocks_per_sm`` (what
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports) and
   ``live_tiles`` ([K/V tiles the kernel counted computing in one more
   launch, all tile pairs] per batch and head; the run fails unless the
   count is that of the tiles with a valid entry), and every row with a
   fully masked query row checks it is exactly 0.
4b. sync check: one ``layers.attention_decode_paged`` at llama110m's width
   with inactive slots under ``torch.cuda.set_sync_debug_mode("error")``
   (any host sync raises), equal to the same call outside it; then a whole
   ``decode_step_paged`` under that mode, reported.
4. serve: llama110m (12 layers, d 768, 12 heads, vocab 32000, fp32, random
   weights from seed 0) through ``ContinuousEngine`` on backend "cuda":
   16 Poisson requests, prompts up to 512, buckets 16..512, 8 slots, pages
   of 16.  Launch counts are zeroed just before the run and read just after
   and must be exactly what the compile records name: K1 at every norm,
   and per prefill layer the attention kernel (K2 or K3) of its bucket's
   record.  First-token logits of one request per
   bucket are held against backend "torch" on the same card (atol = rtol =
   1e-4: twelve full-width fp32 layers, where the reference's 1e-5 is for
   two narrow ones).
5. pointcloud: K9 fps, K10/K11 ball query, K12/K13 grouped aggregation
   against their plain versions on the card, exactly (indices, and the
   max-pool, which only selects), in fp32 and bf16, on an integer-lattice
   cloud (exact FPS ties, d² exactly on r²) and on a cloud with empty
   balls; bound = max(bytes / 3.35 TB/s, ops / 67 TFLOP/s), all arithmetic
   fp32 on the CUDA cores.  The library yardstick of K12/K13 is
   ``F.embedding_bag(mode="max")`` over the flattened batch (offsets built
   outside the timed call; its output is held exactly against the plain
   version too); no single PyTorch call computes FPS or ball query, so
   theirs is null.  Each K12/K13 row carries its plan
   (``pipeline.group_plan``: K12 (centers a warp, 0, 0, 0), K13 (tile
   rows, channel slice, cluster split, slots: one a tile)), registers and spills,
   ``gathered_bytes`` (B·M·k·C·itemsize), ``reuse`` (gathered ÷ the
   distinct rows' bytes) and ``l2_bound_us`` (the gathered bytes at the
   card's L2 read rate, ``l2_read_rate``: the floor of a gather from L2,
   K12's design), and the pointcloud phase prints that rate.  Then the set-abstraction stage (fps → gather
   → ball query → group aggregate) through ``LoweringConfig("cuda")``,
   held exactly against backend "torch", in four runs, each with launch
   counts zeroed just before and read just after: (a) the bench's full size
   (B=2, N=4096, M=512, k=16, C=64, r=0.9, normal(0,1) from seed 0);
   (b) PointNet++ SSG ModelNet40 SA1 (Qi et al., NeurIPS 2017: 1024 points,
   512 centers, r=0.2, 32 samples) at batch 16, C=64, points uniform in
   the unit ball; (c) run (a) with ``pipelined=False``; (d) run (a) with
   ``pipelined=True``.  (a) and (b) launch K9 and the ball-query and
   aggregation kernels their records name (the cost model's picks), (c)
   K9, K10, K12, (d) K9, K11, K13.  The kernel rows include fp16
   at (a)'s shape (distances in fp32, exact as bf16's).  Each K9 row
   carries its µs a step (ms·1e3 / (S - 1)), its plan (``fps_plan``:
   cluster, threads, points a thread), the SMs it runs on and its
   registers and spills; the SMs are those the kernel's blocks wrote
   (``sm_ids``) in the timed calls.  Each K10/K11 row carries its plan
   (``ball_plan``: centers a warp, warps a block, cloud split, ring
   depth), registers and spills, ``visited_share`` (the share of the
   B·M·N pairs the exact result needs: each center's points up to its
   k-th hit, all N for a center with fewer, from the plain output) and
   ``bound_visited_ms`` (the bound over those pairs; ``bound_ms`` stays
   the full sweep's).
5b. fps sweep (before the stage runs): K9 at every plan it is built for
   at (a), (b), a large cloud (1, 65536, 128) alone and at B = 8 and 16, one
   block's largest cloud and twice it, the largest cloud in registers
   (1, 131072, 64) and a cloud on the scratch path, each plan held
   exactly to ``fps_ref``; the rule's pick beside the fastest, timed in
   turns for their spread.
5c. ball sweep (before the stage runs): K10 at every plan it is built
   for and K11 at every plan and ring depth (``ball_plans``), fp32, at
   (a), (b), a cloud past K10's shared memory (1, 65536, 1024, k 32, r
   0.2) and (a)'s cloud with empty balls, each plan held exactly to
   ``ball_query_ref``; the rule's pick (K11 at the route's depth) beside
   the fastest, timed in turns for their spread.
5d. group sweep (before the stage runs): K12 at every plan and K13 at
   every plan (``group_plans``) at (a), (b), (b) in bf16, a PointNet++ SSG
   SA2-like stage (16 × 512 points, 128 centers, r 0.4, k 64, C 128) and
   one large cloud (1 × 65536, 1024 centers, k 32, C 64; no 16-byte slice
   of it fits a K13 block, so K13 has no plan there and the route takes
   K12), ball query's indices, each plan held exactly to
   ``group_aggregate_ref``, its warm µs, registers and spills; the rule's
   pick beside the fastest, timed in turns; K13's fastest time at each
   slice width (the bank conflicts of narrow rows); the fastest of each
   kernel beside the one the route picks.  Then every plan of both exact
   at (a) and (b) in bf16 and fp16, and with stray indices, and equal
   (NaN in the same places) on features with NaNs in all three dtypes.
6. ssm kernels: K1 at the SSM path's widths (d 2560 and 5120, 2048 rows of
   a 4 x 512 prefill and 4 of a decode step, fp32 and bf16; tolerances of
   phase 3), then K7 ssd_scan and K8 ssd_scan_pipelined (every ring depth
   that fits) against the plain recurrence ``ssd_scan_ref`` on the card,
   fp32, atol 5e-4 / rtol 1e-3 (the reference's tests/test_kernels.py:86):
   K7 at the one-chunk prefill of run (s3) (BT=4, H=80, S=16, P=64, N=128:
   the one shape the path gives it), both kernels at the 512-token serving
   shape (BT=4, H=80, S=512: four prompts through mamba2-2.7b, each batch
   row with its own B and C), K8 at every depth that fits; S=1, S below
   and around the 16-position chunk and past 64, a ragged S=300, and a
   strong decay (dt·A ≈ -7 a step, where exp(acum_q - acum_k) for k > q
   overflows fp32); bound = max(bytes / 3.35 TB/s, ops / 165 TFLOP/s: the
   TF32 tensor cores' 495 taken three times, as 3xTF32, the least that
   keeps the scan's fp32 accuracy), one bound for both kernels, see
   SSD_FORMULA.  Then bf16 and fp16 I/O (tolerance 2e-2) at the model's
   widths, P = 6 and N = 256, in fp32 and bf16, K8 at every depth that
   fits.  Every SSD row carries its design: chunk, heads a block, blocks
   an SM (occupancy query), registers and spill bytes (the build log).
   No single PyTorch call computes the scan: library null.
7. ssm serve: mamba2-2.7b (64 layers, d 2560, 80 heads of 64, state 128,
   vocab 50280; random weights from seed 0), each run with launch counts
   zeroed just before and read just after and required exact: every
   prefill launches the scan kernel its record names (K8 at 512 tokens,
   K7 for one 16-position chunk) once a layer and K1 2·64+1 times, every
   decode step K1 2·64+1 times, nothing else.
   (s1) fp32, 4 prompts of 512 tokens then 4 teacher-forced decode steps,
   logits of backend "cuda" within 1e-3·max|logit| of backend "torch";
   (s2) bf16 (the config as it stands) through ``ServeEngine.generate``,
   4 × 512 tokens, 32 new: TTFT, ITL, tokens/s, then the prefill logits of
   the first 1, 2, 4, ..., 64 blocks on backends "cuda" and "torch" in
   bf16, each against backend "torch" computing in fp32 on the same
   weights, cuda at most BF16_GAP_RATIO times as far as torch
   (``bf16_depth_sweep``); (s3) the same engine, 4 × 16 tokens, 8 new (one
   chunk: K7).
7b. families: each config of FAMILY_RUNS, bf16 (the configs' dtypes),
   random weights from seed 0 drawn on the card (the peak memory of the
   init printed), backend "cuda", each run with launch counts zeroed just
   before and read just after and required exactly the records' (K1 at
   every norm, each prefill attention's K2 or K3, zamba2's scans' K7 or
   K8; decode attention and the SSM step run none): granite-3-8b (full)
   and dbrx-132b (full width, 4 of 40 layers: one card's memory) through
   ``ContinuousEngine`` (4 slots, pages of 16, buckets 16..512, 8 Poisson
   requests, prompts 10-512, 8 or 16 new); yi-9b, internlm2-20b,
   qwen1.5-0.5b (B 2, S 128, 8 new), arctic-480b (full width, 1 of 35
   layers; S 64), zamba2-1.2b (B 4, S 512, 16 new), paligemma-3b (256
   random prefix embeddings + 64 tokens: decode from S + 256) and
   seamless-m4t-medium (1024 random frames, 32 tokens) through
   ``ServeEngine.generate``.  Every token in the vocab; first-token logits
   (one request a bucket, or the batch) of backends "cuda" and "torch" in
   bf16 against "torch" computing in fp32 on the same weights, cuda at
   most BF16_GAP_RATIO times as far as torch, the first check at depths
   1, 2, 4, ..., L and the rest at L (``family_logits_check``); TTFT, ITL
   and tokens/s as smoke readings.
   The kernel phase holds K2/K3 at these runs' attention shapes in bf16
   (FAMILY_FLASH: hd 128 GQA, hd 256 with one KV head under the prefix
   mask, the full mask over 1024 frames and 32 queries to 1024 keys), the
   ssm kernel phase K7/K8 at zamba2's scan (4 x 512, 64 heads, P = N =
   64).
8. int8 kernels: K4 int8_matmul and K5 int8_matmul_pipelined, each forced,
   at llama110m's four projection shapes (K, N) in {(768, 768), (768,
   2048), (2048, 768), (768, 32000)} at M = 512 (the largest prompt bucket)
   and M = 8 (the decode slots), fp32 and bf16, plus ragged M in {1, 7,
   100} at N = 1000 (and K = 100, K4 only) and three fp16 cases, against
   ``int8_matmul_ref``: fp32 within K ulps (2^-23) of the largest product
   |x|·|scale·wq| (``int8_tol``: the rounding of a K-term fp32 sum, which
   a TF32 or bf16 rounding of x exceeds many times over), bf16 and fp16
   at the reference's atol 0.5 / rtol 2e-2 (tests/test_kernels.py:69),
   scales from U(0.001, 0.02); bound = max(bytes / 3.35 TB/s, 2·M·N·K ·
   passes / 989 TFLOP/s) at the bf16 tensor cores' rate, three passes for
   fp32 x, beside ``bound_cuda_core_ms`` (fp32 at 67 TFLOP/s), see
   INT8_FORMULA; each row with its plan (``pipeline.int8_plan``: tile_m,
   tile_n, split, depth), the instantiation's registers and spills, and
   ``dequant_mm_ms`` (``torch.mm`` on weights dequantized once in x's
   dtype, what int8 serving runs); library yardstick
   ``torch.ops.aten._weight_int8pack_mm`` where this PyTorch build runs it
   on CUDA, else null with its error.  K6 flash_attention_int8kv at its
   ten rows (INT8KV_SHAPES): llama110m's attention (B=1, H=K=12, hd=64,
   S=T=512 and 64, causal), a GQA case (K=4), fully masked rows, bf16 q,
   head dims 80, 96 and 256 (one KV head) and fp16 q, against
   ``flash_attention_int8kv_ref`` at atol 2e-5 / rtol 1e-4 (fp32,
   tests/test_kernels.py:124; bf16/fp16 phase 3's) and within 0.1 of the
   fp oracle on the unquantized K/V; each row with its plan
   (``pipeline.int8kv_plan``: split, depth), the instantiation's
   registers and spills, bound = max(bytes / 3.35 TB/s, 4·hd·H·pairs ·
   passes / 989 TFLOP/s) at the tensor cores' rate (three bf16 passes for
   fp32 q) beside ``bound_cuda_core_ms`` (the same ops at 67 TFLOP/s),
   see INT8KV_FORMULA, and ``dequant_sdpa_ms`` (SDPA on K/V dequantized
   once in q's dtype: a yardstick, not a one-call counterpart; there is
   none, library null).
8b. int8 sweep: K4 at M = 512 and K5 at M = 8 at every plan they are
   built for (K5 at the rule's tile_m), at the (i2) shapes in fp32 and
   bf16, each held to the plain version and timed warm; the rule's pick
   beside the fastest, timed again in turns.
8c. k4 repeat: K4 at every plan at which two or more of its blocks fit an
   SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), 500 runs each
   at a grid of at least two blocks an SM, fp32/bf16/fp16: every run the
   first run's bits, the first within ``int8_tol``; blocks per SM printed.
8d. int8kv sweep: K6 at every plan it takes (``pipeline.int8kv_plans``:
   split 1/2/4 over a cluster, a ring of 2) at its ten rows, each held
   to the plain version at INT8KV_TOL and timed warm; the rule's pick
   beside the fastest, timed in turns for their spread.
8e. int8kv repeat: K6 at every split plan at the main case in fp32, bf16
   and fp16 and at hd 256 with one KV head, 50 runs each with the first
   run's bits (the ranks' partial states are combined in rank order).
9. int8 serve (i1): llama110m as in phase 4 (fp32, random weights from
   seed 0) through ``StaticBatchEngine(quantize=True)`` on backend "cuda":
   the serve phase's 16 Poisson requests in static groups of 8 padded to
   buckets 16..512.  Launch counts zeroed just before and read just after,
   exact: K1 25 per prefill and per decode step, the attention kernel its
   group's record names (K2 or K3) 12 per prefill, nothing else.  Each group's first-token logits against
   backend "torch" on the same dequantized weights (atol = rtol = 1e-4).
10. int8 GEMM (i2): every projection of the 12 layers (wq, wk, wv, wo,
   wi_gate, wi_up, mlp wo) and the unembedding, from (i1)'s int8 tree laid
   out as (N, K), through ``LoweringConfig("cuda").int8_matmul`` at M = 512
   and M = 8: exactly one launch a projection of the kernel its record
   names (the cost model: K4 at M = 512, K5 at M = 8), each output against
   the plain version at phase 8's fp32 tolerance; the card's µs for the
   85 calls back to back and the host's µs a call (queued behind a GPU
   spin), and their wall time.
10b. train: the port's ``Trainer`` on the card, backend "torch" (the
   kernels have no gradient; launch counts zeroed before and read after:
   the training path launches none).  (t1) llama110m fp32 at full width,
   ``TrainConfig``'s batch 8 x seq 128: the first step's gradients
   against the port's on the CPU from the same weights and batch (each
   leaf's relative norm distance at most 1e-4, every leaf's norm above
   0: a graph cut by a kernel launch fails here), a loss under backend
   "cuda" raising the routes' guard, 8 AdamW updates on the step-0 batch
   lowering its loss, 20 steps timed (warm median step ms, tokens/s,
   ``max_memory_allocated``), and 20 steps under ``run_with_restarts``
   with a ``FailureInjector`` at step 12 and checkpoints every 5 steps
   in a temporary directory: exactly one restart, step 20 reached, every
   post-restart loss within rel 1e-4 of the no-failure run's.  (t2)
   qwen1.5-0.5b bf16, B 4 x S 512, two steps under each remat policy
   (none, dots, full): the steps' peak memory above the weights and
   AdamW state lower under dots and full than under none, the first
   loss the same within bf16's 2e-2.  (t3) mamba2-2.7b, zamba2-1.2b,
   paligemma-3b (256 prefix embeddings), seamless-m4t-medium (1024
   frames) and dbrx-132b (aux loss, bf16 AdamW state) at full width,
   depth cut only where params + grads + AdamW state (``train_bytes``)
   pass TRAIN_BUDGET of the card (dbrx 40 -> 1 layer; arctic-480b, 14 B
   parameters a layer, skipped and said why): two AdamW steps on a fixed
   batch, finite losses, every leaf's gradient norm above 0, the second
   loss below the first.
10c. dist: a process group of one rank (NCCL, a file store; NCCL takes
   one rank a card, so the multi-rank checks run on the CPU with gloo in
   tests/test_torch_dist.py) and ``make_host_mesh()``'s 1×1 mesh.  (x1)
   llama110m fp32 at full width with weights and KV caches as DTensors
   under the ``serve`` policy and the activation specs set, backend
   "cuda": 2 prompts of 512, 16 greedy decode steps, against the same
   run on plain tensors: launch counts (zeroed before each run, read
   after) equal, K1 and the prefill's attention kernel launched through
   the ``local_map`` routes, the same tokens, every step's logits within
   fp32's tolerance; both ITLs (median synchronized ms a decode step; the
   sharded one pays DTensor's dispatch).  (x2) ``make_int8_wire_train_
   step`` for llama110m fp32 (B 8 x S 128, backend "torch"): step 1's
   averaged gradient within one int8 level (scale1 + scale2) of the same
   reduction on the CPU (a gloo group beside NCCL), 8 steps on one batch
   lowering the loss, 20 steps timed against the plain train step.  (x3)
   qwen1.5-0.5b bf16 under ``fsdp_tp`` with DTensor params, AdamW state
   and batch, two steps; the first loss within bf16's 2e-2 of the
   unsharded step's (the first step's learning rate is the warmup's 0).
11. dispatch: the process-wide compile cache after the path phases
   (``Dispatcher.stats``: keys, matched, isax, pipelined, hit rate; each
   record's kernel, plan, ring depth and the model's gain); the 11 golden
   keys of ``tests/golden/dispatch_records.json`` on backend cuda, each
   with the golden impl, matched ISAXes and target; each trace spec's
   e-graph saturation in host ms (a fresh dispatcher); the median host µs
   of a cached ``lower()`` at the serve phase's keys (``SERVE_KEYS``).
12. evaluate: each of the seven target ISAXes' trace programs compiled
   (``compile_program``) and the offloaded program evaluated with the
   intrinsics bound to the CUDA kernels, against the software program
   under the numpy evaluators (``targets/cases.py``: exact for indices
   and the max-pool, atol 1e-5 / rtol 1e-4 for floats), with the kernels
   each launched.
13. route: at ROUTE_CASES (the shapes where K2/K3, K10/K11, K12/K13,
   K7/K8 and K4/K5 were measured against each other, the serve buckets at
   batch 1 and 8, (i2)'s projections; the families' hd 128 at S = T = 128
   and 512, hd 256 under the prefix mask, the full mask at 1024, zamba2's
   scan in fp32 and bf16), both kernels of the pair at their
   plans, each output held to the plain version, then timed cold in turns
   (A B B A, twice): the model's pick, its predicted µs of each, both
   medians, ``pick_is_faster`` and ``pick_within_3pct``.  A timing
   disagreement is printed, not raised.

Prints the seconds each phase took (``{"phase": "wall", ...}``), a
``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is visible or when run outside a checkout.
"""

from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,      # fp32 on the CUDA cores
              "tfloat32": 495e12,    # TF32 dense on the tensor cores
              "bfloat16": 989e12,    # bf16 dense on the tensor cores
              "float16": 989e12}     # fp16 dense on the tensor cores
# fp16 keeps 3 more mantissa bits than bf16 and is held to bf16's bound
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2),
       "float16": (2e-2, 2e-2)}
BUCKETS = (16, 32, 64, 128, 256, 512)
SSD_TOL = (5e-4, 1e-3)
# the reference's int8 GEMM tolerance (tests/test_kernels.py:69); the
# kernels' fp32 rows are held tighter, see int8_tol
INT8_TOL = {"float32": (1e-2, 2e-2), "bfloat16": (0.5, 2e-2),
            "float16": (0.5, 2e-2)}
INT8KV_TOL = {"float32": (2e-5, 1e-4), "bfloat16": TOL["bfloat16"],
              "float16": TOL["float16"]}
LLAMA_PROJ = ((768, 768), (768, 2048), (2048, 768), (768, 32000))  # (K, N)
# bf16 mamba2: backend "cuda" may be at most this many times as far from the
# fp32 answer as backend "torch" (both are bf16 rounding apart from it)
BF16_GAP_RATIO = 2.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scheduled(lw, op: str, shape, dtype):
    """The kernel the compile record of one op instance names (its
    schedule's), or None where the record keeps the plain version."""
    rec = lw.lower(op, shape, dtype)
    return rec.schedule["kernel"] if rec.impl == "isax" else None


def device_ms(fn, iters: int, spin: int = 200_000_000) -> float:
    """Device time of one call: CUDA events around ``iters`` calls queued
    behind a GPU spin of ``spin`` cycles (~0.1 s by default), so the host's
    launch overhead does not show."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)          # the host queues every call meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: Bytes of the card's L2; ``cold_ms`` rotates inputs through 4x that.
L2_BYTES = 50 * 1024 ** 2
#: Most calls ``cold_ms`` queues: the launch queue holds about a thousand,
#: and a host that blocks on a full queue would show in the time.
COLD_MAX_COPIES = 512


def cold_ms(fn, inputs, iters: int = 20) -> float:
    """Device time of one call whose inputs are not in L2: ``fn(*copy)``
    over a rotation of copies of ``inputs`` whose bytes pass 4x the 50 MB L2
    (at most COLD_MAX_COPIES copies: inputs under ~400 KB rotate through
    less than 4x the L2, and partly hit it), so each timed call reads from
    HBM inputs that ``device_ms``'s repeated call would find in L2; the
    spin is long enough for the host to queue every call."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    n = min(COLD_MAX_COPIES, max(2, -(-4 * L2_BYTES // nbytes)))
    copies = [[t.clone() for t in inputs] for _ in range(n)]
    calls = max(n, iters)
    k = [0]

    def step():
        fn(*copies[k[0] % n])
        k[0] += 1
    return device_ms(step, calls, spin=20_000_000 + 80_000 * calls)


def build_kernels() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build()
    report = {"build_s": round(time.perf_counter() - t0, 3)}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        report[name] = {"max_registers": max(regs, default=None),
                        "spill_store_bytes": sum(spills)}
    return report


def _check(name: str, got, want, dtype: str, tol=None) -> float:
    import torch
    atol, rtol = (tol or TOL)[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off "
                             f"(max abs err {float(err.max()):.3e}, "
                             f"atol {atol}, rtol {rtol})")
    return float(err.max())


def rmsnorm_case(R: int, d: int, dtype: str, gen,
                 alternatives: bool = False) -> dict:
    """K1 at (R, d) against its plain version; device times warm (``ms``)
    and with x out of L2 (``cold_ms``) for K1's plan, for its two-pass loop
    shape (the first design, ``loop_ms``) and for ``F.rms_norm``.  With
    ``alternatives``, also [warm, cold] of the row shapes of 1-4 vectors a
    thread and the rows shapes of 1-2 (``alt_plans_ms``, by (mode, vpt,
    threads)); shapes repeated across vpt are timed once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as k1
    dt = getattr(torch, dtype)
    x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    loop = k1.Plan(k1.LOOP, 0, k1.LOOP_THREADS)
    want = ref.rmsnorm_ref(x, g)
    got = k1.rmsnorm(x, g, eps=1e-6)
    got_loop = k1.rmsnorm(x, g, eps=1e-6, shape=loop)
    torch.cuda.synchronize()
    err = _check(f"rmsnorm R={R} d={d} {dtype}", got, want, dtype)
    _check(f"rmsnorm loop R={R} d={d} {dtype}", got_loop, want, dtype)
    g_lib = g.to(dt)
    run = lambda x: k1.rmsnorm(x, g, eps=1e-6)  # noqa: E731
    old = lambda x: k1.rmsnorm(x, g, eps=1e-6, shape=loop)  # noqa: E731
    lib = lambda x: F.rms_norm(x, (d,), g_lib, 1e-6)  # noqa: E731
    nbytes = 2 * R * d * x.element_size() + d * 4
    flops = 4 * R * d
    row = _row("rmsnorm", f"R={R} d={d} {dtype}", err,
               device_ms(lambda: run(x), 100),
               device_ms(lambda: ref.rmsnorm_ref(x, g, eps=1e-6), 100),
               device_ms(lambda: lib(x), 100), nbytes, flops, dtype)
    row.update(plan=list(k1.plan(R, d, x.element_size())),
               cold_ms=cold_ms(run, (x,)),
               loop_ms=device_ms(lambda: old(x), 100),
               loop_cold_ms=cold_ms(old, (x,)),
               library_cold_ms=cold_ms(lib, (x,)))
    if alternatives:
        nv = d // (16 // x.element_size())
        shapes = [k1.Plan(mode, vpt, 32 * -(-nv // (32 * vpt)))
                  for mode, vpts in ((k1.ROW, (1, 2, 3, 4)),
                                     (k1.ROWS, (1, 2)))
                  for vpt in vpts]
        alt = {}
        for shape in dict.fromkeys(shapes):
            if shape.threads > k1.MAX_ROW_THREADS:
                continue
            _check(f"rmsnorm {shape} R={R} d={d} {dtype}",
                   k1.rmsnorm(x, g, shape=shape), want, dtype)
            fn = lambda x, shape=shape: k1.rmsnorm(x, g, shape=shape)  # noqa: E731
            alt[str(tuple(shape))] = [device_ms(lambda: fn(x), 100),
                                      cold_ms(fn, (x,))]
        row["alt_plans_ms"] = alt
    return row


def _row(kernel, case, err, ms, plain_ms, library_ms, nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"kernel": kernel, "case": case, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dtype": dtype}


def flash_mask(kind: str, S: int, T: int):
    """(1, S, T) bool: ``causal`` (the diagonal ending at the last key);
    ``fully_masked_rows`` (tests/test_kernels.py:45); ``block_sparse``,
    causal keys of the query's own 64-key tile and of every even-numbered
    tile (a local + strided pattern: 24 of 64 tile pairs live at S = T =
    512, where causal has 36); ``full``, every key (the encoder's and the
    cross attention's mask); ``prefix<n>``, causal and every one of the
    first n keys (the vlm prefix-LM mask, ``layers.make_mask``)."""
    import torch
    from repro_torch.models.layers import make_mask
    if kind == "full":
        return make_mask("full", S, T, device="cuda")
    if kind.startswith("prefix"):
        return make_mask("prefix", S, T, n_prefix=int(kind[6:]),
                         device="cuda")
    mask = torch.tril(torch.ones((S, T), dtype=torch.bool, device="cuda"),
                      diagonal=T - S)[None]
    if kind == "fully_masked_rows":
        mask = torch.zeros((1, S, T), dtype=torch.bool, device="cuda")
        mask[:, :, :8] = True
        mask[:, :8, :] = False
    elif kind == "block_sparse":
        qt = (torch.arange(S, device="cuda") + T - S)[:, None] // 64
        kt = torch.arange(T, device="cuda")[None, :] // 64
        mask &= (kt == qt) | (kt % 2 == 0)
    return mask


def flash_shape_fields(kernel: str, dtype, hd: int, mask, B: int, H: int,
                       counted, depth: int = 0):
    """``blocks_per_sm`` the card reports for the kernel, and
    ``live_tiles``: [K/V tiles the kernel reports computing in one launch
    with a counter (``counted(live_count)``), all tile pairs], per (batch,
    head) of a (1,S,T) mask.  Fails where the kernel computed other tiles
    than those with a valid entry (``flash_attention.live_tiles``)."""
    import torch
    from repro_torch.kernels.flash_attention import blocks_per_sm, live_tiles
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    counted(count)
    computed = int(count)
    live, total = live_tiles(mask, hd)
    if computed != B * H * live:
        raise AssertionError(f"{kernel}: computed {computed} K/V tiles, the "
                             f"mask has {B * H * live} live")
    return {"blocks_per_sm": blocks_per_sm(kernel, dtype, hd, depth or None),
            "live_tiles": [computed // (B * H), total]}


#: Device times of the plain version and of SDPA by (B, S, T, H, K, hd,
#: dtype, mask kind): rows that differ only in the kernel or its ring depth
#: share one measurement of each.
_YARDSTICK_MS: dict[tuple, tuple[float, float]] = {}


def flash_case(kernel: str, S: int, T: int, H: int, K: int, dtype: str, gen,
               mask_kind: str = "causal", depth: int = 0, B: int = 1,
               hd: int = 64, cold: bool = True,
               scaled_tol: bool = False) -> dict:
    """K2 or K3 (at ring ``depth``) against the plain version; ``cold``
    times it with inputs out of L2 too.  ``scaled_tol`` holds the row to
    TOL's atol times the largest output, for outputs much smaller than 1
    (a long T averages the values over many keys)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pipeline import flash_attention_pipelined
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dt)
    mask = flash_mask(mask_kind, S, T)
    scale = hd ** -0.5
    if kernel == "flash_attention":
        call = lambda q, k, v, **kw: flash_attention(  # noqa: E731
            q, k, v, mask, sm_scale=scale, **kw)
    else:
        call = lambda q, k, v, **kw: flash_attention_pipelined(  # noqa: E731
            q, k, v, mask, sm_scale=scale, depth=depth, **kw)
    run = lambda: call(q, k, v)  # noqa: E731
    plain = lambda: ref.flash_attention_ref(q, k, v, mask, sm_scale=scale)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    case = ((f"B={B} " if B > 1 else "")
            + f"S={S} T={T} H={H} K={K} hd={hd} {dtype} {mask_kind}"
            + (f" depth={depth}" if depth else ""))
    want = plain()
    tol = None
    if scaled_tol:
        atol, rtol = TOL[dtype]
        tol = {dtype: (atol * float(want.float().abs().max()), rtol)}
    err = _check(f"{kernel} {case}", got, want, dtype, tol)
    dead = ~mask.expand(B, S, T).any(-1)
    if dead.any() and float(got[dead].abs().max()) != 0:
        raise AssertionError(f"{kernel}: fully-masked rows are not 0")
    # library yardstick (never called by the port): SDPA on (B,H,S,hd)
    # views with the K/V heads repeated for GQA outside the timed call
    kl = k.repeat_interleave(H // K, dim=2).transpose(1, 2)
    vl = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
    ql = q.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        ql, kl, vl, attn_mask=mask[:, None], scale=scale)
    nbytes = (2 * B * S * H + 2 * B * T * K) * hd * q.element_size() \
        + mask.numel()
    flops = 4 * hd * H * int(mask.expand(B, S, T).sum())
    iters = 20 if B * S >= 256 else 50
    key = (B, S, T, H, K, hd, dtype, mask_kind)
    if key not in _YARDSTICK_MS:
        _YARDSTICK_MS[key] = device_ms(plain, iters), device_ms(lib, iters)
    row = _row(kernel, case, err, device_ms(run, iters), *_YARDSTICK_MS[key],
               nbytes, flops, dtype)
    if tol:
        row["atol"] = tol[dtype][0]
    if cold:
        row["cold_ms"] = cold_ms(call, (q, k, v))
    row.update(flash_shape_fields(
        kernel, dt, hd, mask, B, H,
        lambda n: call(q, k, v, live_count=n), depth))
    return row


def kernel_phase() -> list[dict]:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for R in (8, *BUCKETS):                  # decode batch, prefill buckets
        rows.append(rmsnorm_case(R, 768, "float32", gen))
    for R in (1024, 4096):                   # (i1)'s groups of 8 at 128, 512
        rows.append(rmsnorm_case(R, 768, "float32", gen,
                                 alternatives=R == 4096))
    rows.append(rmsnorm_case(512, 768, "bfloat16", gen))
    rows.append(rmsnorm_case(512, 768, "float16", gen))
    for S in (16, 64, 256, 512):
        rows.append(flash_case("flash_attention", S, S, 12, 12, "float32", gen))
    rows.append(flash_case("flash_attention", 128, 128, 12, 4, "float32", gen))
    rows.append(flash_case("flash_attention", 128, 128, 12, 12, "float32", gen,
                           "fully_masked_rows"))
    rows.append(flash_case("flash_attention", 256, 256, 12, 12, "bfloat16",
                           gen))
    # (i1)'s static groups of 8 at buckets 64, 128 and 512: K2's since the
    # cost model; at 512 its largest shape on the main path
    for S in (64, 128, 512):
        rows.append(flash_case("flash_attention", S, S, 12, 12, "float32",
                               gen, B=8))
    for S in (256, 512):
        for depth in (2, 3, 4):
            rows.append(flash_case("flash_attention_pipelined", S, S, 12, 12,
                                   "float32", gen, depth=depth))
    rows.append(flash_case("flash_attention_pipelined", 128, 128, 12, 12,
                           "float32", gen, depth=2))
    rows.append(flash_case("flash_attention_pipelined", 128, 128, 12, 4,
                           "float32", gen, depth=2))
    rows.append(flash_case("flash_attention_pipelined", 128, 128, 12, 12,
                           "float32", gen, "fully_masked_rows", depth=2))
    rows.append(flash_case("flash_attention_pipelined", 256, 256, 12, 12,
                           "bfloat16", gen, depth=4))
    # (i1)'s static groups of 8 at buckets 128 and 512, where K3 ran
    # before the cost model sent them to K2
    rows.append(flash_case("flash_attention_pipelined", 128, 128, 12, 12,
                           "float32", gen, depth=2, B=8))
    rows.append(flash_case("flash_attention_pipelined", 512, 512, 12, 12,
                           "float32", gen, depth=4, B=8))
    # ... the same group at the other ring depths (``choose_depth`` takes
    # the one that leaves room for the most blocks an SM; warm times only
    # where it does not) and in bf16; a local + strided block-sparse mask;
    # a long T in bf16, where P is rounded to bf16 for p.v over 4096 keys
    for depth in (2, 3):
        rows.append(flash_case("flash_attention_pipelined", 512, 512, 12, 12,
                               "float32", gen, depth=depth, B=8,
                               cold=depth == 2))
    for depth in (2, 3, 4):
        rows.append(flash_case("flash_attention_pipelined", 512, 512, 12, 12,
                               "bfloat16", gen, depth=depth, B=8,
                               cold=depth == 2))
    rows.append(flash_case("flash_attention_pipelined", 512, 512, 12, 12,
                           "float32", gen, "block_sparse", depth=2, B=8))
    rows.append(flash_case("flash_attention", 512, 512, 12, 12, "float32",
                           gen, "block_sparse"))
    rows.append(flash_case("flash_attention_pipelined", 64, 4096, 12, 12,
                           "bfloat16", gen, depth=4, scaled_tol=True))
    # the instantiations the reference's lowering reaches beyond the main
    # path: head dims 80 and 96 (run at width 128), 256 with one KV head
    # (paligemma-3b's attention: 32-key tiles in K3), and fp16
    for kernel, depths in (("flash_attention", {}),
                           ("flash_attention_pipelined",
                            {(80, "float32"): 2, (96, "bfloat16"): 4,
                             (256, "float32"): 2, (256, "bfloat16"): 4,
                             (64, "float16"): 4})):
        for hd, H, K, dtype in ((80, 12, 12, "float32"),
                                (96, 12, 12, "bfloat16"),
                                (256, 8, 1, "float32"),
                                (256, 8, 1, "bfloat16"),
                                (64, 12, 12, "float16")):
            rows.append(flash_case(kernel, 256, 256, H, K, dtype, gen,
                                   depth=depths.get((hd, dtype), 0), hd=hd))
    rows += family_flash_rows(gen)
    for r in rows:
        print(json.dumps(r))
    return rows


#: The prefill attention the families phase gives K2/K3, bf16: (arch, B,
#: S, T, H, K, hd, mask).  granite and dbrx at the largest bucket (batch
#: 1), the static runs at their batch; zamba2's sites; paligemma's 256
#: prefix embeddings + 64 tokens under the prefix-LM mask; seamless's
#: encoder over 1024 frames and its cross attention (32 tokens to 1024).
FAMILY_FLASH = (
    ("granite-3-8b", 1, 512, 512, 32, 8, 128, "causal"),
    ("dbrx-132b", 1, 512, 512, 48, 8, 128, "causal"),
    ("yi-9b", 2, 128, 128, 32, 4, 128, "causal"),
    ("internlm2-20b", 2, 128, 128, 48, 8, 128, "causal"),
    ("qwen1.5-0.5b", 2, 128, 128, 16, 16, 64, "causal"),
    ("arctic-480b", 2, 64, 64, 56, 8, 128, "causal"),
    ("zamba2-1.2b", 4, 512, 512, 32, 32, 64, "causal"),
    ("paligemma-3b", 2, 320, 320, 8, 1, 256, "prefix256"),
    ("seamless-m4t-medium", 2, 1024, 1024, 16, 16, 64, "full"),
    ("seamless-m4t-medium", 2, 32, 1024, 16, 16, 64, "full"),
)


def family_flash_rows(gen) -> list[dict]:
    """K2, and K3 at the ring depth its schedule names where it has one,
    at FAMILY_FLASH's shapes, each row tagged with its arch."""
    import torch
    from repro_torch.kernels import schedule
    from repro_torch.kernels.pipeline import sm_count
    rows = []
    for arch, B, S, T, H, K, hd, kind in FAMILY_FLASH:
        sched = schedule.flash_schedule(B, S, H, K, T, hd, 2,
                                        sm_count(torch.device("cuda")))
        runs = [("flash_attention", 0)]
        if sched["pipe"]:
            runs.append(("flash_attention_pipelined", sched["pipe"]["depth"]))
        for kernel, depth in runs:
            row = flash_case(kernel, S, T, H, K, "bfloat16", gen, kind,
                             depth=depth, B=B, hd=hd)
            row["arch"] = arch
            row["pick"] = sched["kernel"]
            rows.append(row)
    return rows


def serve_phase() -> dict:
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.scheduler import (make_poisson_workload,
                                             pick_bucket)

    cfg = get_config("llama110m")
    out_lens = (8, 16, 32)
    eng = ContinuousEngine(cfg, max_batch=8, page_size=16,
                           max_len=BUCKETS[-1] + max(out_lens),
                           prompt_buckets=BUCKETS, seed=0,
                           lowering=LoweringConfig("cuda"), device="cuda")
    warm = make_poisson_workload(2, rate=2.0, vocab=cfg.vocab,
                                 prompt_lens=(20,), out_lens=(4,), seed=1)
    eng.run(warm)
    reqs = make_poisson_workload(
        16, rate=2.0, vocab=cfg.vocab,
        prompt_lens=(10, 24, 50, 100, 200, 400, 512), out_lens=out_lens,
        seed=0)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = _build.launch_counts()

    # every norm of every prefill and decode step is K1; each prefill layer
    # runs the attention kernel its bucket's compile record names (K2 or
    # K3); no other kernel runs
    L = cfg.n_layers
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    want = {n: 0 for n in launches}
    want["rmsnorm"] = (2 * L + 1) * (len(reqs) + stats.decode_steps)
    for r in reqs:
        b = pick_bucket(r.prompt_len, BUCKETS)
        want[scheduled(eng.lowering, "attention", (1, b, H, K, b, hd),
                       torch.float32)] += L
    if launches != want:
        raise AssertionError(f"launch counts {launches} != the records' "
                             f"{want}")
    for r in reqs:
        if (len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"request {r.rid}: bad output {r.out_tokens}")

    # first-token logits, backend "cuda" against "torch" on the same weights
    plain = get_model(cfg, lowering=LoweringConfig("torch"))
    by_bucket = {}
    for r in reqs:
        by_bucket.setdefault(pick_bucket(r.prompt_len, BUCKETS), r)
    worst = 0.0
    for bucket, r in sorted(by_bucket.items()):
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :r.prompt_len] = r.prompt
        batch = {"tokens": torch.from_numpy(tokens).cuda()}
        got, _ = eng.model.prefill_at(eng.params, batch, r.prompt_len)
        want, _ = plain.prefill_at(eng.params, batch, r.prompt_len)
        if float(got[0, r.out_tokens[0]]) < float(got[0].max()) - 1e-5:
            raise AssertionError(f"request {r.rid}: engine's first token is "
                                 f"not the prefill argmax")
        err = (got - want).abs()
        if not torch.isfinite(got).all() or bool(
                (err > 1e-4 + 1e-4 * want.abs()).any()):
            raise AssertionError(f"bucket {bucket}: cuda vs torch first-token "
                                 f"logits differ by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))

    steps = max(stats.decode_steps, 1)
    summary = {
        "phase": "serve", "arch": cfg.name, "requests": stats.n_requests,
        "tokens": stats.total_tokens, "decode_steps": stats.decode_steps,
        "wall_s": stats.wall_s, "tokens_per_s": stats.tokens_per_s,
        "mean_ttft_ms": stats.mean_ttft_s * 1e3,
        "mean_itl_ms": stats.mean_itl_s * 1e3,
        "buckets_used": sorted(by_bucket),
        "launches": launches,
        "rmsnorm_launches_per_decode_step": 2 * cfg.n_layers + 1,
        "first_token_logits_max_abs_err_vs_torch": worst,
    }
    print(json.dumps(summary))
    print(f"serve: {stats.n_requests} requests, {stats.total_tokens} tokens, "
          f"TTFT {stats.mean_ttft_s * 1e3:.2f} ms, ITL "
          f"{stats.mean_itl_s * 1e3:.3f} ms, {stats.tokens_per_s:.1f} tok/s, "
          f"launches {launches}")
    return launches


def sync_check_phase() -> dict:
    """One call of ``layers.attention_decode_paged`` at llama110m's full
    width (8 slots, 3 of them inactive) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any host
    sync; its output must equal the same call's outside that mode.  Then
    one whole ``decode_step_paged`` under the same mode, reported (not
    required): whether the step could be captured in a CUDA graph as it
    stands."""
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve.kv_cache import PagedKVCache
    cfg = get_config("llama110m")
    lw = LoweringConfig("cuda")
    model = get_model(cfg, lowering=lw)
    params = model.init(0, "cuda")
    cache = PagedKVCache(cfg, max_batch=8, page_size=16, n_pages=8 * 34,
                         max_len=544, device=torch.device("cuda"))
    for slot, n in ((0, 40), (2, 511), (3, 16), (5, 100), (6, 1)):
        cache.bind_slot(slot, n + 16)
        cache.seq_lens[slot] = n
    pt, sl, act = cache.device_views({0, 2, 3, 5, 6})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda")
    attn = layer_params(params["blocks"], 0)["attn"]
    kp, vp = cache.k_pages[0], cache.v_pages[0]
    pools = (kp.clone(), vp.clone())
    want, _, _ = layers.attention_decode_paged(attn, x, cfg, *pools, pt, sl,
                                               act, lowering=lw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _, _ = layers.attention_decode_paged(attn, x, cfg, kp, vp, pt,
                                                  sl, act, lowering=lw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the spare page (last) takes the inactive slots' colliding writes
    if not torch.equal(got, want) or not (
            torch.equal(kp[:-1], pools[0][:-1])
            and torch.equal(vp[:-1], pools[1][:-1])):
        raise AssertionError("attention_decode_paged under sync-debug "
                             "differs from the same call outside it")
    tokens = torch.randint(0, cfg.vocab, (8,), generator=gen, device="cuda")
    model.decode_paged(params, tokens, cache.k_pages, cache.v_pages, pt, sl,
                       act)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_paged(params, tokens, cache.k_pages, cache.v_pages, pt,
                           sl, act)
        step = "no host sync"
    except RuntimeError as e:
        step = "syncs: " + str(e).strip().splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    summary = {"phase": "sync_check", "attention_decode_paged": "no host sync",
               "decode_step_paged": step}
    print(json.dumps(summary))
    return summary


# -- point-cloud phase --------------------------------------------------------

PC_SHAPES = {  # B, N, M, k, C, radius
    "a": (2, 4096, 512, 16, 64, 0.9),   # benchmarks/bench_pointcloud.py full
    "b": (16, 1024, 512, 32, 64, 0.2),  # PointNet++ SSG ModelNet40 SA1
}
PC_FORMULA = {
    "fps": "bytes = B*N*3*itemsize + B*S*4; ops = 10*B*N*(S-1) "
           "(3 sub, 3 mul, 2 add, min, compare a point a step)",
    "ball_query": "bytes = (B*N + B*M)*3*itemsize + B*M*k*4; "
                  "ops = 10*B*M*N (3 sub, 3 mul, 2 add, 2 compares a pair)",
    "group_aggregate": "bytes = distinct gathered rows*C*itemsize + B*M*k*4 "
                       "+ B*M*C*itemsize; ops = B*M*k*C compares.  K13 "
                       "reads each row from HBM once (its cloud's tiles by "
                       "TMA, multicast to a cluster) and gathers the "
                       "B*M*k*C*itemsize bytes from shared memory; K12 "
                       "gathers them from L2 (l2_bound_us)",
}


PC_LIBRARY = {"group_aggregate": "F.embedding_bag(mode='max') over B*N rows"}


def pc_inputs(shape: str, dtype: str = "float32"):
    """(xyz, features, M, k, radius) on the card for one path shape, from
    numpy's seed 0."""
    import numpy as np
    import torch
    B, N, M, k, C, r = PC_SHAPES[shape]
    rng = np.random.default_rng(0)
    if shape == "a":
        xyz = rng.normal(size=(B, N, 3))
    else:                       # uniform in the unit ball
        u = rng.normal(size=(B, N, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        xyz = u * rng.uniform(size=(B, N, 1)) ** (1 / 3)
    feats = rng.normal(size=(B, N, C))
    dt = getattr(torch, dtype)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda().to(dt)  # noqa: E731
    return to(xyz), to(feats), M, k, r


def _pc_row(kernel, case, got, want, ms, plain_ms, nbytes, ops, dtype,
            library_ms=None, cold=None, design=None):
    import torch
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{kernel} {case}: {bad} elements differ from "
                             f"the plain version")
    if got.is_floating_point() and not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {case}: non-finite output")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["float32"] * 1e3
    row = {"kernel": kernel, "case": case, "max_abs_err": 0.0, "ms": ms,
           "cold_ms": cold_ms(*cold) if cold else None,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_note": PC_LIBRARY.get(kernel.replace("_pipelined", ""),
                                          "no single PyTorch call"),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_formula": PC_FORMULA[kernel.replace("_pipelined", "")],
           "dtype": dtype, **(design or {})}
    print(json.dumps(row))
    return row


def fps_timed(xyz, S: int, iters: int, plan=None) -> tuple[float, int]:
    """Warm device ms of K9 on ``xyz`` (``plan`` forced if given) and the
    SMs its blocks ran on in the timed calls, counted by the kernel
    (``sm_ids``: each block writes its ``%smid``)."""
    import torch
    from repro_torch.kernels.pipeline import fps_plan
    from repro_torch.pointcloud import kernels as pck
    B, N, _ = xyz.shape
    cluster = (plan or fps_plan(B, N))[0]
    ids = torch.full((B * cluster,), -1, dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: pck.fps(xyz, S, sm_ids=ids, _plan=plan), iters)
    if bool((ids < 0).any()):
        raise AssertionError(f"fps: a block wrote no SM id ({ids.tolist()})")
    return ms, int(ids.unique().numel())


def fps_design(B: int, N: int, dtype: str, sms: int, plan=None) -> dict:
    """The design fields of a K9 row: its plan (``fps_plan`` unless given),
    the SMs its blocks ran on (``fps_timed``) and the instantiation's
    registers and spills (its build log)."""
    from repro_torch.kernels.pipeline import fps_plan
    cluster, threads, ppt = plan or fps_plan(B, N)
    tag = (f"fps_kernelI{mangled_t(dtype)}Li{threads}ELi{ppt}"
           f"ELb{int(cluster > 1)}EE")
    hits = [v for k, v in ptxas_report("fps").items() if tag in k]
    if len(hits) != 1:
        raise AssertionError(f"{tag}: {len(hits)} kernels in the build log")
    return {"cluster": cluster, "threads": threads, "ppt": ppt,
            "sms_used": sms, "registers": hits[0][0],
            "spill_store_bytes": hits[0][1]}


def ball_visited(xyz, centers, k: int, r: float, idx) -> int:
    """Center-point pairs the exact result needs: for each center, the
    points up to its k-th hit (from the plain output ``idx``), or all N
    where it has fewer than k hits."""
    import torch
    from repro_torch.pointcloud import ref as pcref
    N = xyz.shape[1]
    hits = (pcref.sqdist(centers[:, :, None], xyz[:, None])
            <= pcref.squared_radius(r)).sum(-1)
    need = torch.where(hits >= k, idx[..., k - 1].long() + 1,
                       torch.full_like(hits, N))
    return int(need.sum())


def ball_design(xyz, centers, k: int, r: float, idx, depth: int = 0,
                plan=None) -> dict:
    """The design fields of a K10 (``depth`` 0) or K11 row: its plan
    (``ball_plan`` unless given: centers a warp, warps, split, depth), the
    instantiation's registers and spills (its build log), the share of the
    B·M·N pairs the exact result needs (``ball_visited``) and the bound
    over those pairs alone (PC_FORMULA's bytes, 10 ops a needed pair)."""
    from repro_torch.kernels import pipeline as pl
    B, N, _ = xyz.shape
    M = centers.shape[1]
    dtype = str(xyz.dtype).replace("torch.", "")
    cpw, warps, split, depth = plan or pl.ball_plan(
        B, N, M, k, xyz.element_size(), depth)
    lib = "ball_query_pipelined" if depth else "ball_query"
    tag = (f"{'ball_pipelined_kernel' if depth else 'ball_query_kernel'}"
           f"I{mangled_t(dtype)}Li{cpw}EE")
    hits = [v for name, v in ptxas_report(lib).items() if tag in name]
    if len(hits) != 1:
        raise AssertionError(f"{tag}: {len(hits)} kernels in the build log")
    visited = ball_visited(xyz, centers, k, r, idx)
    nbytes = (B * N + B * M) * 3 * xyz.element_size() + B * M * k * 4
    return {"cpw": cpw, "warps": warps, "split": split, "depth": depth,
            "registers": hits[0][0], "spill_store_bytes": hits[0][1],
            "visited_share": visited / (B * M * N),
            "bound_visited_ms": max(nbytes / HBM_BYTES_PER_S,
                                    10 * visited / PEAK_FLOPS["float32"]) * 1e3}


_L2_RATE: list = []


def l2_read_rate() -> float:
    """Bytes a second the card's L2 serves to a reduction: warm
    ``device_ms`` of a row sum (rows of 1024 floats) over an L2-resident
    16 MB fp32 tensor and over its first half; the rate is the 8 MB
    between them over the time between them, so the launch's fixed cost
    cancels.  A yardstick for a gather's floor only; the port never calls
    it."""
    import torch
    if not _L2_RATE:
        x = torch.ones(4 * 1024 ** 2, device="cuda")
        half = x[:x.numel() // 2]
        full_ms = device_ms(lambda: x.view(-1, 1024).sum(1), 200)
        half_ms = device_ms(lambda: half.view(-1, 1024).sum(1), 200)
        if full_ms <= half_ms:
            raise AssertionError(f"l2_read_rate: 16 MB in {full_ms} ms, "
                                 f"8 MB in {half_ms} ms")
        _L2_RATE.append(half.numel() * 4 / ((full_ms - half_ms) * 1e-3))
    return _L2_RATE[0]


def group_bytes(f, idx) -> int:
    """PC_FORMULA's bytes of one grouped aggregation: the distinct rows
    the indices name (clamped as the kernels clamp them), the indices and
    the output."""
    import torch
    from repro_torch.pointcloud import ref as pcref
    B, N, C = f.shape
    M, k = idx.shape[1], idx.shape[2]
    rows = pcref.neighbour_rows(idx, N) + N * torch.arange(
        B, device=idx.device)[:, None, None]
    distinct = int(torch.unique(rows).numel())
    return distinct * C * f.element_size() + B * M * k * 4 + B * M * C * (
        f.element_size())


def group_library_ms(f, idx, want, case: str) -> float:
    """Library yardstick of K12/K13 (never called by the port): one
    max-mode embedding bag a center over the batch-flattened rows, held
    exactly to the plain version first."""
    import torch
    import torch.nn.functional as F
    B, N, C = f.shape
    M, k = idx.shape[1], idx.shape[2]
    bags = (idx.long() + N * torch.arange(B, device="cuda")[:, None, None]
            ).view(B * M, k)
    table = f.view(B * N, C)
    lib = lambda: F.embedding_bag(bags, table, mode="max")  # noqa: E731
    if not torch.equal(lib().view(B, M, C), want):
        raise AssertionError(f"embedding_bag {case}: differs from the "
                             f"plain version")
    return device_ms(lib, 50)


def group_ptxas(kernel: str, dtype: str, plan, C: int) -> tuple[int, int]:
    """Registers and spill-store bytes of the K12 or K13 instantiation
    that ``plan`` launches, from the build log."""
    from repro_torch.pointcloud.kernels import group_ptxas as ptxas
    return ptxas(kernel, dtype, C, plan)


def group_design(kernel: str, f, idx, plan=None) -> dict:
    """The design fields of a K12/K13 row: its plan (``group_plan``
    unless given), the instantiation's registers and spills, the gathered
    bytes (B·M·k·C·itemsize), their reuse (gathered ÷ the distinct rows'
    bytes) and ``l2_bound_us`` (the gathered bytes at ``l2_read_rate``: the
    floor of a design that gathers from L2, as K12 does)."""
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.pointcloud import ref as pcref
    B, N, C = f.shape
    M, k = idx.shape[1], idx.shape[2]
    it = f.element_size()
    dtype = str(f.dtype).replace("torch.", "")
    if plan is None:
        plan = pl.group_plan(B, N, M, k, C, it,
                             0 if kernel == "group_aggregate" else None,
                             pl.sm_count(f.device))
    regs, spills = group_ptxas(kernel, dtype, plan, C)
    rows = pcref.neighbour_rows(idx, N) + N * torch.arange(
        B, device=idx.device)[:, None, None]
    gathered = B * M * k * C * it
    return {"plan": list(plan), "registers": regs,
            "spill_store_bytes": spills, "gathered_bytes": gathered,
            "reuse": gathered / (int(torch.unique(rows).numel()) * C * it),
            "l2_bound_us": gathered / l2_read_rate() * 1e6}


def pointcloud_kernel_phase() -> list[dict]:
    import torch
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    rows = []

    def clouds():
        """(case, xyz, centers, features, S/M, k, radius) per case."""
        for shape, dtype in (("a", "float32"), ("a", "bfloat16"),
                             ("a", "float16"), ("b", "float32")):
            xyz, feats, M, k, r = pc_inputs(shape, dtype)
            yield f"{shape} {dtype}", xyz, None, feats, M, k, r
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        B, N, M, k, C, _ = PC_SHAPES["a"]
        lattice = torch.randint(0, 16, (B, N, 3), generator=gen,
                                device="cuda").float()
        feats = torch.randn((B, N, C), generator=gen, device="cuda")
        yield "a lattice float32", lattice, None, feats, M, k, 1.0
        xyz, feats, M, k, r = pc_inputs("a")
        far = 4 * torch.randn((B, M, 3), generator=gen, device="cuda")
        yield "a empty-balls float32", xyz, far, feats, M, k, 0.3

    for case, xyz, centers, feats, M, k, r in clouds():
        B, N, _ = xyz.shape
        C = feats.shape[-1]
        it = xyz.element_size()
        dtype = str(xyz.dtype).replace("torch.", "")
        if centers is None:      # the path's own centers: the FPS samples
            sel = pcref.fps_ref(xyz, M)
            ms, sms = fps_timed(xyz, M, 10)
            rows.append(_pc_row(
                "fps", case, pck.fps(xyz, M), sel, ms,
                device_ms(lambda: pcref.fps_ref(xyz, M), 2),
                B * N * 3 * it + B * M * 4, 10 * B * N * (M - 1), dtype,
                cold=(lambda p: pck.fps(p, M), (xyz,), 10),
                design={"us_per_step": ms * 1e3 / (M - 1),
                        **fps_design(B, N, dtype, sms)}))
            centers = torch.gather(xyz, 1, sel.long()[..., None].expand(-1, -1, 3))
        if "empty" in case:
            n_hit = (pcref.sqdist(centers[:, :, None], xyz[:, None])
                     <= r * r).sum(-1)
            if not ((n_hit == 0).any() and (n_hit > 0).any()):
                raise AssertionError("empty-ball case has no empty ball")
        idx = pcref.ball_query_ref(xyz, centers, r, k)
        nbytes = (B * N + B * M) * 3 * it + B * M * k * 4
        plain = device_ms(lambda: pcref.ball_query_ref(xyz, centers, r, k), 5)
        rows.append(_pc_row(
            "ball_query", case, pck.ball_query(xyz, centers, r, k), idx,
            device_ms(lambda: pck.ball_query(xyz, centers, r, k), 20), plain,
            nbytes, 10 * B * M * N, dtype,
            cold=(lambda p, c: pck.ball_query(p, c, r, k), (xyz, centers)),
            design=ball_design(xyz, centers, k, r, idx)))
        for depth in (2, 3, 4):
            call = lambda p, c, depth=depth: pck.ball_query_pipelined(  # noqa: E731
                p, c, r, k, depth=depth)
            run = lambda: call(xyz, centers)  # noqa: E731
            rows.append(_pc_row(
                "ball_query_pipelined", f"{case} depth={depth}", run(), idx,
                device_ms(run, 20), plain, nbytes, 10 * B * M * N, dtype,
                cold=(call, (xyz, centers)),
                design=ball_design(xyz, centers, k, r, idx, depth)))
        f = feats.to(xyz.dtype)
        want = pcref.group_aggregate_ref(f, idx)
        plain = device_ms(lambda: pcref.group_aggregate_ref(f, idx), 20)
        lib_ms = group_library_ms(f, idx, want, case)
        nbytes = group_bytes(f, idx)
        for name, fn in (("group_aggregate", pck.group_aggregate),
                         ("group_aggregate_pipelined",
                          pck.group_aggregate_pipelined)):
            rows.append(_pc_row(
                name, case, fn(f, idx), want,
                device_ms(lambda: fn(f, idx), 50), plain, nbytes,
                B * M * k * C, dtype, lib_ms, cold=(fn, (f, idx)),
                design=group_design(name, f, idx)))
    print(json.dumps({"phase": "l2_read_rate", "bytes_per_s": l2_read_rate(),
                      "how": "row sums over 16 MB and 8 MB of an L2-resident "
                             "fp32 tensor: 8 MB over the time between them"}))
    return rows


#: K9's sweep: B, N, S.  (a) and (b) as the path runs them; a large cloud
#: on a cluster, alone, 8 and 16 of them (the rule halves the cluster where
#: the B clusters would not run at once: to 8 blocks in registers at B = 8,
#: to 4 on the scratch path at B = 16); one block's largest cloud and
#: twice it, either side of the rule's switch to clusters; the largest
#: cloud in registers (16 blocks of 1024 threads at 8 points); a cloud on
#: the scratch path.
FPS_SWEEP = {"a": (2, 4096, 512), "b": (16, 1024, 512),
             "large": (1, 65536, 128), "large-x8": (8, 65536, 128),
             "large-x16": (16, 65536, 128),
             "block": (1, 8192, 512), "two-blocks": (1, 16384, 256),
             "capacity": (1, 131072, 64), "scratch": (1, 200000, 32)}


def fps_sweep_phase() -> None:
    """K9 at every plan csrc/fps.cu is built for, at the shapes of
    FPS_SWEEP: each plan's indices held exactly to ``fps_ref``, its warm
    time, µs a step, SMs used, registers and spills, and the plan rule's
    pick beside the fastest, both timed again in turns (pick, fastest,
    fastest, pick, ...) for their spread."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    for name, (B, N, S) in FPS_SWEEP.items():
        if name in PC_SHAPES:
            xyz = pc_inputs(name)[0]
        else:
            xyz = torch.from_numpy(np.random.default_rng(0).normal(
                size=(B, N, 3)).astype(np.float32)).cuda()
        want = pcref.fps_ref(xyz, S)
        times = {}
        for c in pl.FPS_CLUSTERS:
            for t in pl.FPS_THREADS:
                plan = (c, t, pl.fps_ppt(-(-N // c), t))
                if not torch.equal(pck.fps(xyz, S, _plan=plan), want):
                    raise AssertionError(f"fps sweep {name} plan {plan}: "
                                         f"differs from fps_ref")
                times[plan], sms = fps_timed(xyz, S, 10, plan)
                print(json.dumps({"phase": "fps_sweep", "shape": name,
                                  "B": B, "N": N, "S": S, "plan": plan,
                                  "us": times[plan] * 1e3,
                                  "us_per_step": times[plan] * 1e3 / (S - 1),
                                  **fps_design(B, N, "float32", sms, plan)}))
        pick, best = pl.fps_plan(B, N), min(times, key=times.get)
        turns = {pick: [], best: []}
        for plan in (pick, best, best, pick) * 3:
            turns[plan].append(device_ms(
                lambda plan=plan: pck.fps(xyz, S, _plan=plan), 10) * 1e3)
        spread = {str(p): [min(v), float(np.median(v)), max(v)]
                  for p, v in turns.items()}
        print(json.dumps({"phase": "fps_sweep", "shape": name, "pick": pick,
                          "fastest": best, "us_min_median_max": spread,
                          "pick_within_spread": min(turns[pick])
                          <= max(turns[best])}))


#: Ball query's sweep: B, N, M, k, radius.  (a) and (b) as the path runs
#: them (the FPS samples as centers); a cloud larger than K10's shared
#: memory (4096 points a part) with a random subset of its points as
#: centers; (a)'s cloud with centers four times wider (many empty balls).
BALL_SWEEP = {"a": (2, 4096, 512, 16, 0.9), "b": (16, 1024, 512, 32, 0.2),
              "large": (1, 65536, 1024, 32, 0.2),
              "empty": (2, 4096, 512, 16, 0.3)}


def ball_sweep_inputs(name: str):
    """(xyz, centers) of one BALL_SWEEP shape on the card, from numpy's
    seed 0 (and 2 for the empty balls' centers)."""
    import numpy as np
    import torch
    from repro_torch.pointcloud import ref as pcref
    B, N, M, _, _ = BALL_SWEEP[name]
    if name in PC_SHAPES:
        xyz = pc_inputs(name)[0]
        sel = pcref.fps_ref(xyz, M).long()
        return xyz, torch.gather(xyz, 1, sel[..., None].expand(-1, -1, 3))
    if name == "empty":
        far = 4 * np.random.default_rng(2).normal(size=(B, M, 3))
        return (pc_inputs("a")[0],
                torch.from_numpy(far.astype(np.float32)).cuda())
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    centers = xyz[:, rng.choice(N, M, replace=False)]
    return torch.from_numpy(xyz).cuda(), torch.from_numpy(centers).cuda()


def ball_sweep_phase() -> None:
    """K10 at every plan it is built for and K11 at every plan and ring
    depth, fp32, at the shapes of BALL_SWEEP: each plan's indices held
    exactly to ``ball_query_ref``, its warm µs; the plan rule's pick (K11
    at the ring depth the route gives it) beside the fastest plan at that
    depth, both timed again in turns (pick, fastest, fastest, pick, ...)
    for their spread, and the fastest at any depth."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    for name, (B, N, M, k, r) in BALL_SWEEP.items():
        xyz, centers = ball_sweep_inputs(name)
        want = pcref.ball_query_ref(xyz, centers, r, k)
        n_hit = (pcref.sqdist(centers[:, :, None], xyz[:, None])
                 <= pcref.squared_radius(r)).sum(-1)
        visited = ball_visited(xyz, centers, k, r, want)
        for kernel in ("ball_query", "ball_query_pipelined"):
            def call(plan):
                if plan[3] == 0:
                    return pck.ball_query(xyz, centers, r, k, _plan=plan)
                return pck.ball_query_pipelined(xyz, centers, r, k,
                                                depth=plan[3], _plan=plan)
            route = (0 if kernel == "ball_query"
                     else min(max(pl.DEPTHS), -(-N // pl.BALL_TILE)))
            times = {}
            for depth in ((0,) if route == 0 else pl.DEPTHS):
                for plan in pl.ball_plans(B, N, M, k, 4, depth):
                    if not torch.equal(call(plan), want):
                        raise AssertionError(f"ball sweep {name} {kernel} "
                                             f"{plan}: differs from "
                                             f"ball_query_ref")
                    times[plan] = device_ms(lambda plan=plan: call(plan), 10,
                                            spin=4_000_000) * 1e3
            pick = pl.ball_plan(B, N, M, k, 4, route)
            best = min((p for p in times if p[3] == route), key=times.get)
            turns = {pick: [], best: []}
            for plan in (pick, best, best, pick) * 3:
                turns[plan].append(device_ms(
                    lambda plan=plan: call(plan), 10, spin=4_000_000) * 1e3)
            med = {p: float(np.median(v)) for p, v in turns.items()}
            print(json.dumps({
                "phase": "ball_sweep", "shape": name, "kernel": kernel,
                "B": B, "N": N, "M": M, "k": k, "radius": r,
                "empty_balls": int((n_hit == 0).sum()),
                "visited_share": visited / (B * M * N),
                "us": {str(p): t for p, t in sorted(times.items(),
                                                    key=lambda e: e[1])},
                "pick": pick, "fastest": best,
                "fastest_any_depth": min(times, key=times.get),
                "us_min_median_max": {str(p): [min(v), med[p], max(v)]
                                      for p, v in turns.items()},
                "pick_within_5pct": med[pick] <= 1.05 * med[best]}))


#: Grouped aggregation's sweep: B, N, M, k, C, dtype, radius.  (a) and (b)
#: as the path runs them (the FPS samples as centers, ball query's
#: indices); (b) in bf16; a PointNet++ SSG SA2-like stage (512 points,
#: 128 centers, r 0.4, 64 samples, 128 channels; points uniform in the
#: unit ball, FPS centers); one large cloud with random points as centers.
GROUP_SWEEP = {"a": (2, 4096, 512, 16, 64, "float32", 0.9),
               "b": (16, 1024, 512, 32, 64, "float32", 0.2),
               "b-bf16": (16, 1024, 512, 32, 64, "bfloat16", 0.2),
               "sa2": (16, 512, 128, 64, 128, "float32", 0.4),
               "large": (1, 65536, 1024, 32, 64, "float32", 0.2)}


def group_sweep_inputs(name: str):
    """(features, idx) of one GROUP_SWEEP shape on the card, from numpy's
    seed 0: ball query's indices (ascending, padded with the first hit)."""
    import numpy as np
    import torch
    from repro_torch.pointcloud import ref as pcref
    B, N, M, k, C, dtype, r = GROUP_SWEEP[name]
    shape = name.split("-")[0]
    if shape in PC_SHAPES:
        xyz, feats = pc_inputs(shape, dtype)[:2]
    else:
        rng = np.random.default_rng(0)
        if shape == "large":
            pts = rng.normal(size=(B, N, 3))
        else:
            u = rng.normal(size=(B, N, 3))
            u /= np.linalg.norm(u, axis=-1, keepdims=True)
            pts = u * rng.uniform(size=(B, N, 1)) ** (1 / 3)
        xyz = torch.from_numpy(pts.astype(np.float32)).cuda()
        feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(
            np.float32)).cuda().to(getattr(torch, dtype))
    if shape == "large":
        sel = torch.from_numpy(np.random.default_rng(1).choice(
            N, (B, M), replace=False)).cuda()
    else:
        sel = pcref.fps_ref(xyz, M).long()
    centers = torch.gather(xyz.float(), 1, sel[..., None].expand(-1, -1, 3))
    return feats, pcref.ball_query_ref(xyz.float(), centers, r, k)


def group_sweep_phase() -> None:
    """K12 at every plan it is built for and K13 at every plan
    (``group_plans``) at the shapes of GROUP_SWEEP: each plan held exactly
    to ``group_aggregate_ref``, its warm µs, registers and spills; the
    rule's pick beside the fastest, both timed again in turns (pick,
    fastest, fastest, pick, ...) for their spread; for K13 the fastest
    time at each slice width (16 to 128 bytes a row: the effect of shared
    memory's bank conflicts, which a 128-byte row cannot have); the
    fastest of each kernel beside the one the route sends the shape to (a
    kernel with no plan at a shape is left out there).  Then every plan of
    both kernels exact, untimed, at (a) and (b) in bf16 and fp16, in fp32
    with stray indices (negative and past the end, any order), and equal
    with NaN in the same places on features with NaNs in all three
    dtypes."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.kernels import schedule
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    kernels = (("group_aggregate", 0, pck.group_aggregate),
               ("group_aggregate_pipelined", None,
                pck.group_aggregate_pipelined))
    sms = pl.sm_count("cuda")
    for name, (B, N, M, k, C, dtype, _) in GROUP_SWEEP.items():
        f, idx = group_sweep_inputs(name)
        want = pcref.group_aggregate_ref(f, idx)
        it = f.element_size()
        fastest = {}
        for kernel, depth, fn in kernels:
            times, design = {}, {}
            plans = pl.group_plans(B, N, M, k, C, it, depth)
            if not plans:
                if pl.group_plan(B, N, M, k, C, it, depth, sms) is not None:
                    raise AssertionError(f"group sweep {name} {kernel}: "
                                         f"a pick but no plans")
                print(json.dumps({"phase": "group_sweep", "shape": name,
                                  "kernel": kernel, "plans": 0}))
                continue
            for plan in plans:
                if not torch.equal(fn(f, idx, _plan=plan), want):
                    raise AssertionError(f"group sweep {name} {kernel} "
                                         f"{plan}: differs from "
                                         f"group_aggregate_ref")
                times[plan] = device_ms(lambda plan=plan: fn(f, idx, _plan=plan),
                                        20, spin=4_000_000) * 1e3
                design[plan] = group_ptxas(kernel, dtype, plan, C)
            pick = pl.group_plan(B, N, M, k, C, it, depth, sms)
            best = min(times, key=times.get)
            fastest[kernel] = times[best]
            turns = {pick: [], best: []}
            for plan in (pick, best, best, pick) * 3:
                turns[plan].append(device_ms(
                    lambda plan=plan: fn(f, idx, _plan=plan), 20,
                    spin=4_000_000) * 1e3)
            med = {p: float(np.median(v)) for p, v in turns.items()}
            line = {
                "phase": "group_sweep", "shape": name, "kernel": kernel,
                "B": B, "N": N, "M": M, "k": k, "C": C, "dtype": dtype,
                "us": {str(p): t for p, t in sorted(times.items(),
                                                    key=lambda e: e[1])},
                "registers_spills": {str(p): v for p, v in design.items()},
                "pick": pick, "fastest": best,
                "us_min_median_max": {str(p): [min(v), med[p], max(v)]
                                      for p, v in turns.items()},
                "pick_within_3pct": med[pick] <= 1.03 * med[best]}
            if depth is None:
                line["slice_bytes_us"] = {
                    sb: min((t for p, t in times.items()
                             if p[1] * it == sb), default=None)
                    for sb in pl.GROUP_SLICE_BYTES}
            print(json.dumps(line))
        routed = schedule.group_schedule(B, N, M, k, C, it, sms)["kernel"]
        print(json.dumps({"phase": "group_sweep", "shape": name,
                          "fastest_us": fastest, "routed": routed,
                          "routed_is_faster": fastest[routed]
                          == min(fastest.values())}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    checked = 0
    for shape in ("a", "b"):
        f32, idx = group_sweep_inputs(shape)
        B, N, C = f32.shape
        M, k = idx.shape[1], idx.shape[2]
        stray = torch.randint(-2 * N, 2 * N, idx.shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        nan = f32.masked_fill(torch.rand(f32.shape, generator=gen,
                                         device="cuda") < 0.002,
                              float("nan"))
        for f, ii in ((f32.bfloat16(), idx), (f32.half(), idx),
                      (f32, stray), (nan, idx), (nan.bfloat16(), idx),
                      (nan.half(), idx)):
            want = pcref.group_aggregate_ref(f, ii)
            for kernel, depth, fn in kernels:
                for plan in pl.group_plans(B, N, M, k, C, f.element_size(),
                                           depth):
                    got = fn(f, ii, _plan=plan)
                    if not (torch.equal(got.isnan(), want.isnan())
                            and torch.equal(got.nan_to_num(0.0),
                                            want.nan_to_num(0.0))):
                        raise AssertionError(
                            f"group check ({shape}) {f.dtype} {kernel} "
                            f"{plan}: differs from group_aggregate_ref")
                    checked += 1
    print(json.dumps({"phase": "group_sweep", "exact_plans_checked": checked,
                      "cases": "(a), (b) x bf16, fp16, fp32 stray indices, "
                               "NaN features in fp32, bf16, fp16"}))


def pointcloud_path_phase() -> dict:
    """Runs (a)-(d) of the set-abstraction stage; returns the launch counts
    summed over the four."""
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.pointcloud import set_abstraction

    # (a) and (b) run the kernels their compile records name; (c) forces
    # the baselines (K10, K12), (d) the pipelined kernels (K11, K13)
    runs = (("a", "a", None), ("b", "b", None), ("c", "a", False),
            ("d", "a", True))
    cuda, plain = LoweringConfig("cuda"), LoweringConfig("torch")
    total = {n: 0 for n in _build.KERNELS}
    for label, shape, pipelined in runs:
        xyz, feats, M, k, r = pc_inputs(shape)
        B, N, _ = xyz.shape
        C = feats.shape[-1]
        stage = lambda: set_abstraction(  # noqa: E731
            cuda, xyz, feats, M, r, k, pipelined=pipelined)
        stage()                              # warm: first-call set-up
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stage()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        got = stage()
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        want = set_abstraction(plain, xyz, feats, M, r, k)
        names = ("sampled", "centers", "neighbours", "aggregated")
        shapes = ((B, M), (B, M, 3), (B, M, k), (B, M, C))
        for name, g, w, shp in zip(names, got, want, shapes):
            if tuple(g.shape) != shp or not torch.equal(g, w):
                raise AssertionError(f"pointcloud run ({label}): {name} "
                                     f"differs from backend torch")
        if not torch.isfinite(got[3]).all():
            raise AssertionError(f"pointcloud run ({label}): non-finite")
        if pipelined is None:
            kernels = {"fps", scheduled(cuda, "ball_query", (B, N, M, k),
                                        xyz.dtype),
                       scheduled(cuda, "group_aggregate", (B, N, M, k, C),
                                 feats.dtype)}
        else:
            kernels = {"fps", "ball_query" + "_pipelined" * pipelined,
                       "group_aggregate" + "_pipelined" * pipelined}
        expect = {n: int(n in kernels) for n in _build.KERNELS}
        if launches != expect:
            raise AssertionError(f"pointcloud run ({label}): launch counts "
                                 f"{launches} != expected {expect}")
        for n, c in launches.items():
            total[n] += c
        print(json.dumps({
            "phase": "pointcloud", "run": label,
            "shape": dict(zip("BNMkC", (B, N, M, k, C)), radius=r),
            "pipelined": pipelined, "launches": launches,
            "stage_wall_ms": sorted(walls)[len(walls) // 2],
            "stage_wall_ms_runs": walls}))
    for name in ("fps", "ball_query", "ball_query_pipelined",
                 "group_aggregate", "group_aggregate_pipelined"):
        if total[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"point-cloud path: {total}")
    print(f"pointcloud: runs (a)-(d) match backend torch; launches {total}")
    return total


# -- SSM phase -----------------------------------------------------------------

#: fp32-accurate products on the TF32 tensor cores take three passes
#: (3xTF32): the least that keeps the scan's fp32 accuracy
SSD_FLOPS = PEAK_FLOPS["tfloat32"] / 3
SSD_FORMULA = ("bytes = itemsize*(2*BT*H*S*P + BT*H*S + 2*BT*S*N) + 4*H "
               "(x, y, dt, B, C; A fp32) at 3.35 TB/s; ops = 4*BT*H*S*N*P "
               "at 495/3 TFLOP/s (3xTF32 on the tensor cores, the least "
               "that keeps fp32 accuracy; the math is fp32 in every I/O "
               "dtype): the least any form of the scan needs, one FMA a "
               "state element a position for the update and one for the "
               "output (the chunked form does both and its causal Q x Q "
               "products on top); one bound for K7 and K8")
SSD_MAIN = (4, 80, 512, 64, 128)     # BT, H, S, P, N of the serving prefill
SSD_SHORT = (4, 80, 16, 64, 128)     # run (s3): a one-chunk prompt, K7


def ssd_inputs(BT, H, S, P, N, seed, strong=False, dtype="float32"):
    """x, dt, A, B, C on the card from numpy's ``seed`` (dt and A in the
    ranges of tests/test_kernels.py, or a decay strong enough to overflow
    exp of the masked entries); x, dt, B, C in ``dtype``, A in fp32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dt_lo, dt_hi, a_lo, a_hi = (3.0, 5.0, 1.5, 2.0) if strong else \
        (0.1, 0.9, 0.5, 1.5)
    arrays = (rng.normal(size=(BT, H, S, P)),
              rng.uniform(dt_lo, dt_hi, size=(BT, H, S)),
              -rng.uniform(a_lo, a_hi, size=(H,)),
              rng.normal(size=(BT, S, N)), rng.normal(size=(BT, S, N)))
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a.astype(np.float32)).cuda().to(
        torch.float32 if i == 2 else dt) for i, a in enumerate(arrays)]


def ptxas_report(lib: str) -> dict:
    """Registers and spill-store bytes of every kernel of library ``lib``,
    by mangled name, from its build log (``_build.ptxas_report``)."""
    from repro_torch.kernels import _build
    return _build.ptxas_report(lib)


def mangled_t(dtype: str) -> str:
    """How a kernel template's type argument ``dtype`` is spelt in ptxas's
    mangled names."""
    from repro_torch.kernels import _build
    return _build.MANGLED_T[dtype]


def ssd_design(kernel: str, dtype: str, P: int, N: int,
               depth: int | None) -> dict:
    """The design fields of an SSD row: chunk, heads a block, blocks an SM
    (the occupancy query), and the instantiation's registers and spills
    (its build log)."""
    import torch
    from repro_torch.kernels.ssd_scan import CHUNK, blocks_per_sm
    tag = f"{kernel}_kernelI{mangled_t(dtype)}E"
    hits = [v for k, v in ptxas_report(kernel).items() if tag in k]
    if len(hits) != 1:
        raise AssertionError(f"{tag}: {len(hits)} kernels in the build log")
    return {"chunk": CHUNK, "heads_per_block": 1,
            "blocks_per_sm": blocks_per_sm(kernel, getattr(torch, dtype), P,
                                           N, depth),
            "registers": hits[0][0], "spill_store_bytes": hits[0][1]}


def ssd_case(kernel: str, shape, depth: int = 0, strong: bool = False,
             plain: bool = True, dtype: str = "float32") -> dict:
    """One K7/K8 row: the kernel against ``ssd_scan_ref``."""
    import torch
    from repro_torch.kernels import pipeline, ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    BT, H, S, P, N = shape
    args = ssd_inputs(BT, H, S, P, N, seed=S + BT, strong=strong, dtype=dtype)
    itemsize = args[0].element_size()
    if kernel == "ssd_scan":
        call = ssd_scan
    else:
        call = lambda *a: pipeline.ssd_scan_pipelined(  # noqa: E731
            *a, depth=depth)
    run = lambda: call(*args)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = ref.ssd_scan_ref(*args)
    atol, rtol = SSD_TOL if dtype == "float32" else TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    case = (f"BT={BT} H={H} S={S} P={P} N={N}" + (" strong" if strong else "")
            + (f" {dtype}" if dtype != "float32" else "")
            + (f" depth={depth}" if depth else ""))
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(f"{kernel} {case}: {int(bad.sum())} elements off "
                             f"(max abs err {float(err.max()):.3e})")
    nbytes = (itemsize * (2 * BT * H * S * P + BT * H * S + 2 * BT * S * N)
              + 4 * H)
    ops = 4 * BT * H * S * N * P
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SSD_FLOPS * 1e3
    plain_ms = device_ms(lambda: ref.ssd_scan_ref(*args), 2) if plain \
        else None
    row = {"kernel": kernel, "case": case, "max_abs_err": float(err.max()),
           "ms": device_ms(run, 20),
           "cold_ms": cold_ms(call, args),
           "plain_ms": plain_ms, "library_ms": None,
           "library_note": "no single PyTorch call",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_formula": SSD_FORMULA, "dtype": dtype,
           **ssd_design(kernel, dtype, P, N,
                        depth if kernel != "ssd_scan" else None)}
    print(json.dumps(row))
    return row


def ssm_kernel_phase() -> list[dict]:
    import torch
    from repro_torch.kernels import pipeline
    from repro_torch.kernels.ssd_scan import block_fits
    # K1 at the SSM path's widths (norm 2560, gate_norm 5120) and rows (a
    # 4 x 512 prefill, a decode step of 4), in fp32 (s1) and bf16 (s2, s3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = [rmsnorm_case(R, d, dtype, gen, alternatives=R > 4)
            for R in (2048, 4) for d in (2560, 5120)
            for dtype in ("float32", "bfloat16")]
    rows.append(rmsnorm_case(2048, 5120, "float16", gen))
    for r in rows:
        print(json.dumps(r))
    BT, H, S, P, N = SSD_MAIN
    # K7 at the one shape the path gives it, and at the 512-token shape
    # (which the router sends to K8) beside K8
    rows += [ssd_case("ssd_scan", SSD_SHORT), ssd_case("ssd_scan", SSD_MAIN)]
    depths = [d for d in pipeline.DEPTHS
              if block_fits(P, N, pipeline.ssd_ring_bytes(P, N, d))]
    for d in depths:
        rows.append(ssd_case("ssd_scan_pipelined", SSD_MAIN, depth=d))
    # S=1, below/around the chunks, ragged, strong decay; 8 heads
    # at the model's widths keep the plain recurrence quick
    for S_, strong in ((1, False), (15, False), (17, False), (31, False),
                       (33, False), (40, False), (63, False), (65, False),
                       (300, False), (256, True)):
        shape = (2, 8, S_, P, N)
        rows.append(ssd_case("ssd_scan", shape, strong=strong, plain=False))
        for d in depths:
            rows.append(ssd_case("ssd_scan_pipelined", shape, depth=d,
                                 strong=strong, plain=False))
    # zamba2-1.2b's scan (64 heads of 64, state 64, 4 x 512 tokens): K7
    # and K8 at its schedule's ring
    zamba = (4, 64, 512, 64, 64)
    rows.append(ssd_case("ssd_scan", zamba))
    rows.append(ssd_case("ssd_scan_pipelined", zamba,
                         depth=pipeline.ssd_plan(64, 64, 512, 4)))
    # the inputs the reference's lowering reaches beyond the path: bf16 and
    # fp16 at the model's widths, P = 6 (element loads, padded to 16 in the
    # block), N = 256 (two warps across the state); K8 at every depth that
    # fits
    for shape, dtype in (((2, 8, 300, P, N), "bfloat16"),
                         ((2, 8, 300, P, N), "float16"),
                         ((2, 8, 100, 6, N), "float32"),
                         ((2, 8, 100, 6, N), "bfloat16"),
                         ((2, 8, 100, P, 256), "float32"),
                         ((2, 8, 100, P, 256), "bfloat16")):
        rows.append(ssd_case("ssd_scan", shape, plain=False, dtype=dtype))
        it = 4 if dtype == "float32" else 2
        for d in pipeline.DEPTHS:
            if block_fits(shape[3], shape[4],
                          pipeline.ssd_ring_bytes(shape[3], shape[4], d, it)):
                rows.append(ssd_case("ssd_scan_pipelined", shape, depth=d,
                                     plain=False, dtype=dtype))
    return rows


def ssd_kernel(lw, cfg, S: int, BT: int = 4) -> str:
    """The scan kernel (K7 or K8) the compile record of a prefill of BT
    prompts of S tokens names (the model lowers the scan in fp32)."""
    import torch
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return scheduled(lw, "ssd_scan", (BT, S, d_in // s.head_dim, s.head_dim,
                                      s.d_state), torch.float32)


def _ssm_launches_ok(run: str, launches: dict, scan: str, n_prefills: int,
                     n_steps: int, L: int) -> None:
    want = {n: 0 for n in launches}
    want.update({scan: L * n_prefills,
                 "rmsnorm": (2 * L + 1) * (n_prefills + n_steps)})
    if launches != want:
        raise AssertionError(f"ssm run ({run}): launch counts {launches} != "
                             f"expected {want}")


def doublings(L: int) -> list[int]:
    """1, 2, 4, ... below L, then L."""
    out = [1]
    while out[-1] * 2 < L:
        out.append(out[-1] * 2)
    return out + [L] if L > 1 else out


def bf16_depth_sweep(run: str, cfg, params, entry: str, args,
                     depths) -> list[dict]:
    """Logits of the entry point ``entry`` (called with ``params, *args``)
    over the first ``depth`` layers of the bf16 model, at each of
    ``depths``: backend "cuda" and backend "torch" in bf16, each against
    backend "torch" computing in fp32 on the same weights (bf16 weights are
    exact in fp32, so that is the answer without bf16 rounding).  A fault
    of the kernel path in bf16 puts its logits farther from the fp32 answer
    than the plain path's; rounding alone puts both at about the same
    distance, growing with depth.  Fails at any depth where backend cuda is
    farther than BF16_GAP_RATIO times backend torch."""
    import dataclasses
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.models.registry import get_model

    def logits(c, lowering):
        model = get_model(c, lowering=LoweringConfig(lowering))
        return getattr(model, entry)(params, *args)[0].float()

    out = []
    for depth in depths:
        c = dataclasses.replace(cfg, n_layers=depth)
        got = logits(c, "cuda")
        plain = logits(c, "torch")
        exact = logits(dataclasses.replace(c, compute_dtype="float32"),
                       "torch")
        row = {"depth": depth,
               "cuda_vs_torch": float((got - plain).abs().max()),
               "cuda_vs_fp32": float((got - exact).abs().max()),
               "torch_vs_fp32": float((plain - exact).abs().max()),
               "logits_max_abs": float(exact.abs().max()),
               "argmax_agree": bool(torch.equal(got.argmax(-1),
                                                exact.argmax(-1)))}
        if not torch.isfinite(got).all() or (
                row["cuda_vs_fp32"] > BF16_GAP_RATIO * row["torch_vs_fp32"]):
            raise AssertionError(f"{run}: backend cuda in bf16 is farther "
                                 f"from the fp32 answer than "
                                 f"{BF16_GAP_RATIO} x backend torch's: {row}")
        out.append(row)
    return out


def ssm_serve_phase() -> dict:
    """Runs (s1)-(s3); returns the launch counts summed over them."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("mamba2-2.7b")
    L = cfg.n_layers
    total = {n: 0 for n in _build.KERNELS}
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 512), dtype=np.int32)
    forced = rng.integers(0, cfg.vocab, (4, 4), dtype=np.int32)

    # (s1) fp32 parity, backend cuda against torch on one set of weights
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    cuda_m = get_model(cfg32, lowering=LoweringConfig("cuda"))
    plain_m = get_model(cfg32, lowering=LoweringConfig("torch"))
    params = cuda_m.init(0, "cuda")
    batch = {"tokens": torch.from_numpy(prompts).cuda()}
    cuda_m.prefill(params, {"tokens": batch["tokens"][:, :64]})   # warm
    torch.cuda.synchronize()

    def teacher_forced(model):
        logits, caches = model.prefill(params, batch)
        out = [logits]
        for i in range(forced.shape[1]):
            tok = torch.from_numpy(forced[:, i]).cuda()
            logits, caches = model.decode_step(params, tok, caches, 512 + i)
            out.append(logits)
        return torch.stack(out)

    _build.reset_launch_counts()
    got = teacher_forced(cuda_m)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    _ssm_launches_ok("s1", launches, ssd_kernel(LoweringConfig("cuda"), cfg,
                                                512),
                     1, forced.shape[1], L)
    for n, c in launches.items():
        total[n] += c
    want = teacher_forced(plain_m)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > 1e-3 * scale:
        raise AssertionError(f"ssm run (s1): cuda vs torch logits differ by "
                             f"{err:.3e} (limit 1e-3 * {scale:.3e})")
    print(json.dumps({"phase": "ssm", "run": "s1", "dtype": "float32",
                      "prompts": list(prompts.shape), "decode_steps":
                      forced.shape[1], "launches": launches,
                      "logits_max_abs_err_vs_torch": err,
                      "logits_max_abs": scale}))
    del cuda_m, plain_m, params, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # (s2) bf16 serving through the static-batch engine
    eng = ServeEngine(cfg, seed=0, lowering=LoweringConfig("cuda"),
                      device="cuda", max_len=512 + 32)
    eng.generate({"tokens": prompts}, 2)                            # warm
    for run, (plen, n_new) in (("s2", (512, 32)), ("s3", (SSD_SHORT[2], 8))):
        p = prompts[:, :plen]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        toks, stats = eng.generate({"tokens": p}, n_new)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        _ssm_launches_ok(run, launches, ssd_kernel(eng.lowering, cfg, plen),
                         1, n_new - 1, L)
        for n, c in launches.items():
            total[n] += c
        if toks.shape != (4, n_new) or not ((toks >= 0)
                                            & (toks < cfg.vocab)).all():
            raise AssertionError(f"ssm run ({run}): bad tokens {toks}")
        summary = {"phase": "ssm", "run": run, "dtype": cfg.compute_dtype,
                   "prompts": list(p.shape), "new_tokens": n_new,
                   "launches": launches, "ttft_ms": stats.ttft_s * 1e3,
                   "itl_ms": stats.itl_s * 1e3,
                   "tokens_per_s": stats.tokens_per_s}
        if run == "s2":
            summary["bf16_depth_sweep"] = bf16_depth_sweep(
                "ssm run (s2)", cfg, eng.params, "prefill",
                ({"tokens": torch.from_numpy(p).cuda()},),
                doublings(cfg.n_layers))
        print(json.dumps(summary))
        print(f"ssm {run}: {p.shape[0]} x {plen} tokens, {n_new} new, TTFT "
              f"{stats.ttft_s * 1e3:.2f} ms, ITL {stats.itl_s * 1e3:.3f} ms, "
              f"{stats.tokens_per_s:.1f} tok/s")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- families phase ------------------------------------------------------------

#: The families phase: each config of the reference's registry not served
#: above, at full width (dbrx and arctic cut in depth only, which one card
#: forces), bf16, random weights from seed 0.  (arch, layers kept or None,
#: engine, B, S text tokens, new tokens, prefix embeddings)
FAMILY_RUNS = (
    ("granite-3-8b", None, "continuous", 0, 0, 0, 0),
    ("dbrx-132b", 4, "continuous", 0, 0, 0, 0),
    ("yi-9b", None, "static", 2, 128, 8, 0),
    ("internlm2-20b", None, "static", 2, 128, 8, 0),
    ("qwen1.5-0.5b", None, "static", 2, 128, 8, 0),
    ("arctic-480b", 1, "static", 2, 64, 8, 0),
    ("zamba2-1.2b", None, "static", 4, 512, 16, 0),
    ("paligemma-3b", None, "static", 2, 64, 8, 256),
    ("seamless-m4t-medium", None, "static", 2, 32, 8, 1024),
)
#: The continuous runs: 4 slots, pages of 16, buckets 16..512, 8 Poisson
#: requests with prompts of 10..512 tokens and 8 or 16 new.
FAMILY_SLOTS = 4
FAMILY_OUT_LENS = (8, 16)
FAMILY_PROMPT_LENS = (10, 24, 50, 100, 200, 400, 512)
def family_logits_check(run: str, cfg, params, checks) -> dict:
    """First-token logits of backend cuda and backend torch in bf16, each
    against backend torch in fp32 on the same weights, for each (entry
    point, args) of ``checks`` (``bf16_depth_sweep``): the first at every
    depth of ``doublings`` (where the plain gap is small next to the
    logits, a wrong path shows; deeper, how bf16 rounding grows), the rest
    at full depth.  Returns the worst of the full-depth rows and the
    first check's sweep."""
    sweeps = [bf16_depth_sweep(f"families {run}", cfg, params, entry, args,
                               doublings(cfg.n_layers) if i == 0
                               else (cfg.n_layers,))
              for i, (entry, args) in enumerate(checks)]
    full = [rows[-1] for rows in sweeps]
    worst = {k: max(r[k] for r in full)
             for k in ("cuda_vs_torch", "cuda_vs_fp32", "torch_vs_fp32",
                       "logits_max_abs")}
    worst["argmax_agree"] = all(r["argmax_agree"] for r in full)
    worst["depth_sweep"] = sweeps[0]
    return worst


def family_static_launches(lw, cfg, B: int, S: int, n_new: int,
                           n_prefix: int) -> dict:
    """Launch counts one ``ServeEngine.generate`` must make, from the
    compile records: K1 at every norm of the prefill and the n_new - 1
    decode steps, and each prefill attention's kernel (K2 or K3) and, for
    the hybrid, each Mamba2 layer's scan (K7 or K8); decode attention
    (one query row) and the SSM decode step run no kernel."""
    from repro_torch.kernels import _build
    from repro_torch.models import hybrid
    from repro_torch.models.layers import dtype_of
    dt = dtype_of(cfg.compute_dtype)
    L, H, K, hd = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim())
    want = {n: 0 for n in _build.KERNELS}

    def attn(S_, T_, n):
        want[scheduled(lw, "attention", (B, S_, H, K, T_, hd), dt)] += n

    if cfg.family == "hybrid":
        sites = hybrid.n_sites(cfg)
        norms = 2 * sites + 2 * L + 1
        attn(S, S, sites)
        want[ssd_kernel(lw, cfg, S, BT=B)] += L
    elif cfg.family == "encdec":
        norms = 3 * L + 1
        want["rmsnorm"] += 2 * L + 1             # the encoder's
        attn(n_prefix, n_prefix, L)              # encoder, full mask
        attn(S, S, L)                            # decoder self attention
        attn(S, n_prefix, L)                     # cross attention
    else:
        norms = 2 * L + 1
        attn(S + n_prefix, S + n_prefix, L)
    want["rmsnorm"] += norms * n_new
    return want


def families_phase() -> dict:
    """Serves each of FAMILY_RUNS at full width: launch counts exact
    against the compile records, every token in the vocab, first-token
    logits of backend cuda against torch (``family_logits_check``), the
    card's peak memory at init; returns the launch counts summed."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine
    from repro_torch.serve.scheduler import (make_poisson_workload,
                                             pick_bucket)
    total = {n: 0 for n in _build.KERNELS}
    for arch, cut, engine, B, S, n_new, n_prefix in FAMILY_RUNS:
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if cut:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lw = LoweringConfig("cuda")
        params = get_model(cfg, lowering=lw).init(0, "cuda")
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() - base
        weights = torch.cuda.memory_allocated() - base
        rng = np.random.default_rng(0)
        line = {"phase": "families", "arch": arch, "family": cfg.family,
                "layers": cfg.n_layers,
                "cut": (f"n_layers {full_layers} -> {cut}" if cut else None),
                "n_params": cfg.n_params(),
                "weights_gb": weights / 1e9,
                "init_peak_gb": init_peak / 1e9}
        if engine == "continuous":
            eng = ContinuousEngine(
                cfg, params, max_batch=FAMILY_SLOTS, page_size=16,
                max_len=BUCKETS[-1] + max(FAMILY_OUT_LENS),
                prompt_buckets=BUCKETS, lowering=lw, device="cuda")
            eng.run(make_poisson_workload(2, rate=2.0, vocab=cfg.vocab,
                                          prompt_lens=(20,), out_lens=(4,),
                                          seed=1))
            reqs = make_poisson_workload(
                8, rate=2.0, vocab=cfg.vocab, prompt_lens=FAMILY_PROMPT_LENS,
                out_lens=FAMILY_OUT_LENS, seed=0)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            stats = eng.run(reqs)
            torch.cuda.synchronize()
            launches = _build.launch_counts()
            L, H, K = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads
            hd = cfg.resolved_head_dim()
            want = {n: 0 for n in launches}
            want["rmsnorm"] = (2 * L + 1) * (len(reqs) + stats.decode_steps)
            for r in reqs:
                b = pick_bucket(r.prompt_len, BUCKETS)
                want[scheduled(lw, "attention", (1, b, H, K, b, hd),
                               cfg.compute_dtype)] += L
            tokens_ok = all(len(r.out_tokens) == r.max_new_tokens
                            and all(0 <= t < cfg.vocab for t in r.out_tokens)
                            for r in reqs)
            by_bucket = {}
            for r in reqs:
                by_bucket.setdefault(pick_bucket(r.prompt_len, BUCKETS), r)
            checks = []
            for bucket, r in sorted(by_bucket.items()):
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :r.prompt_len] = r.prompt
                checks.append(("prefill_at", (
                    {"tokens": torch.from_numpy(toks).cuda()}, r.prompt_len)))
            line.update(requests=stats.n_requests, tokens=stats.total_tokens,
                        decode_steps=stats.decode_steps,
                        buckets_used=sorted(by_bucket),
                        ttft_ms=stats.mean_ttft_s * 1e3,
                        itl_ms=stats.mean_itl_s * 1e3,
                        tokens_per_s=stats.tokens_per_s)
        else:
            batch = {"tokens": rng.integers(0, cfg.vocab, (B, S),
                                            dtype=np.int32)}
            if n_prefix:
                batch["prefix_embeds"] = rng.normal(
                    size=(B, n_prefix, cfg.d_model)).astype(np.float32)
            vlm_prefix = n_prefix if cfg.family == "vlm" else 0
            eng = ServeEngine(cfg, params, lowering=lw, device="cuda",
                              max_len=S + vlm_prefix + n_new + 8)
            eng.generate(batch, 2)                                  # warm
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            toks, stats = eng.generate(batch, n_new)
            torch.cuda.synchronize()
            launches = _build.launch_counts()
            want = family_static_launches(lw, cfg, B, S, n_new, n_prefix)
            tokens_ok = (toks.shape == (B, n_new)
                         and bool(((toks >= 0) & (toks < cfg.vocab)).all()))
            dev = {k: torch.as_tensor(v, device="cuda")
                   for k, v in batch.items()}
            checks = [("prefill", (dev,))]
            line.update(batch=[B, S], prefix=n_prefix, new_tokens=n_new,
                        ttft_ms=stats.ttft_s * 1e3, itl_ms=stats.itl_s * 1e3,
                        tokens_per_s=stats.tokens_per_s)
        if launches != want:
            raise AssertionError(f"families {arch}: launch counts "
                                 f"{launches} != the records' {want}")
        if not tokens_ok:
            raise AssertionError(f"families {arch}: a token outside the "
                                 f"vocab or a short output")
        line["launches"] = launches
        line["first_token_logits"] = family_logits_check(arch, cfg, params,
                                                         checks)
        line["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        line["wall_s"] = time.perf_counter() - t0
        for n, c in launches.items():
            total[n] += c
        print(json.dumps(line))
        print(f"families {arch}{' (' + line['cut'] + ')' if cut else ''}: "
              f"{engine}, TTFT {line['ttft_ms']:.2f} ms, ITL "
              f"{line['itl_ms']:.3f} ms, {line['tokens_per_s']:.1f} tok/s, "
              f"weights {line['weights_gb']:.2f} GB (init peak "
              f"{line['init_peak_gb']:.2f}), full-depth logits "
              f"{dict(list(line['first_token_logits'].items())[:5])}")
        del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


# -- int8 phases ---------------------------------------------------------------

INT8_FORMULA = ("bytes = M*K*itemsize + N*K + 4*N + M*N*itemsize (x, wq, "
                "scale, y); ops = 2*M*N*K*passes at 989 TFLOP/s (the bf16/"
                "fp16 tensor cores), passes = 3 for fp32 x (its three exact "
                "bf16 terms), 1 for bf16 and fp16; bound_ms = max(bytes / "
                "3.35 TB/s, ops / 989e12); bound_cuda_core_ms (fp32 rows) = "
                "max(bytes / 3.35 TB/s, 2*M*N*K / 67e12)")
_LIBRARY_INT8: dict = {}


def int8_library(x, wq, scale, want):
    """``aten._weight_int8pack_mm`` on these inputs (the same function, its
    scale in x's dtype, which that op requires), or None and the reason:
    this PyTorch build does not run it on CUDA for x's dtype, or its output
    is not within phase 8's tolerance of the plain version's ``want``."""
    import torch
    if x.dtype in _LIBRARY_INT8:
        return None, _LIBRARY_INT8[x.dtype]
    lib_scale = scale.to(x.dtype)
    lib = lambda: torch.ops.aten._weight_int8pack_mm(x, wq, lib_scale)  # noqa: E731
    try:
        got = lib()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        _LIBRARY_INT8[x.dtype] = ("aten._weight_int8pack_mm: "
                                  + str(e).strip().splitlines()[0][:200])
        return None, _LIBRARY_INT8[x.dtype]
    atol, rtol = INT8_TOL[str(x.dtype).replace("torch.", "")]
    err = (got.float() - want.float()).abs()
    if got.shape != want.shape or bool((err > atol + rtol * want.float().abs()).any()):
        return None, (f"aten._weight_int8pack_mm differs from the plain "
                      f"version by {float(err.max()):.3e}")
    return lib, "aten._weight_int8pack_mm (scale in x's dtype)"


def int8_tol(x, wq, scale) -> dict:
    """_check's tolerance for an int8 GEMM: in fp32, atol = K ulps (2^-23)
    of the largest product |x|·|scale·wq| and no rtol -- the rounding of a
    K-term fp32 sum in either version's order, which a TF32 (2^-11) or bf16
    (2^-8) rounding of x exceeds many times over; in bf16 and fp16, whose
    output rounding dominates, the reference's INT8_TOL."""
    dtype = str(x.dtype).replace("torch.", "")
    if dtype != "float32":
        return {dtype: INT8_TOL[dtype]}
    big = float(x.abs().max()) * float((scale[:, None] * wq).abs().max())
    return {dtype: (x.shape[1] * big * 2.0 ** -23, 0.0)}


def int8_bounds(M: int, N: int, K: int, itemsize: int) -> dict:
    """INT8_FORMULA's bounds (ms) for one int8 GEMM: at the rate of the
    tensor-core arithmetic the kernels run, and for fp32 x at the CUDA
    cores' 67 TFLOP/s beside it."""
    nbytes = M * K * itemsize + N * K + 4 * N + M * N * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    passes = 3 if itemsize == 4 else 1
    t_ops = 2 * M * N * K * passes / PEAK_FLOPS["bfloat16"] * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if itemsize == 4:
        out["bound_cuda_core_ms"] = max(
            t_bytes, 2 * M * N * K / PEAK_FLOPS["float32"] * 1e3)
    return out


#: The instantiation of each int8 kernel, by plan, in its build log.
_INT8_TEMPLATE = {"int8_matmul": (
                      "int8_mm_kernelI{t}Li{tile_n}ELi{c}E",
                      lambda tm, tn: {"tile_n": tn, "c": tm // 64}),
                  "int8_matmul_pipelined": (
                      "int8_mm_pipelined_kernelI{t}Li{mt}ELi{w}E",
                      lambda tm, tn: {"mt": tm // 8, "w": tn // 16})}


def int8_design(kernel: str, dtype: str, plan) -> dict:
    """The plan fields of an int8 row and its instantiation's registers and
    spill bytes (the build log)."""
    fmt, fields = _INT8_TEMPLATE[kernel]
    tile_m, tile_n, split, depth = plan
    tag = fmt.format(t=mangled_t(dtype), **fields(tile_m, tile_n))
    hits = [v for k, v in ptxas_report(kernel).items() if tag in k]
    if len(hits) != 1:
        raise AssertionError(f"{tag}: {len(hits)} kernels in the build log")
    return {"tile_m": tile_m, "tile_n": tile_n, "split": split,
            "depth": depth, "registers": hits[0][0],
            "spill_store_bytes": hits[0][1]}


def int8_case(kernel: str, M: int, N: int, K: int, dtype: str, gen) -> dict:
    import torch
    from repro_torch.kernels import pipeline, ref
    from repro_torch.kernels.int8_matmul import int8_matmul
    dt = getattr(torch, dtype)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 0.001 + 0.019 * torch.rand((N,), generator=gen, device="cuda")
    pipelined = kernel == "int8_matmul_pipelined"
    plan = pipeline.int8_plan(M, N, K, x.element_size(), pipelined=pipelined)
    if pipelined:
        call = lambda x, wq: pipeline.int8_matmul_pipelined(  # noqa: E731
            x, wq, scale)
    else:
        call = lambda x, wq: int8_matmul(x, wq, scale)  # noqa: E731
    run = lambda: call(x, wq)  # noqa: E731
    plain = lambda: ref.int8_matmul_ref(x, wq, scale)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    case = f"M={M} K={K} N={N} {dtype}"
    want = plain()
    tol = int8_tol(x, wq, scale)
    err = _check(f"{kernel} {case}", got, want, dtype, tol)
    lib, note = int8_library(x, wq, scale, want)
    iters = 20 if M * N * K >= 1 << 28 else 50
    spin = 40_000_000   # ~20 ms: enough to queue 50 of these calls
    nbytes = M * K * x.element_size() + N * K + 4 * N + M * N * x.element_size()
    # what int8 serving runs today: weights dequantized once, in x's dtype
    w_deq_t = (wq.float() * scale[:, None]).to(dt).t()
    row = _row(kernel, case, err, device_ms(run, iters, spin),
               device_ms(plain, iters, spin),
               device_ms(lib, max(3, iters // 4), spin) if lib else None,
               nbytes, 2 * M * N * K, dtype)
    row.update(int8_bounds(M, N, K, x.element_size()))
    row.update(library_note=note, bound_formula=INT8_FORMULA,
               atol=tol[dtype][0], rtol=tol[dtype][1],
               cold_ms=cold_ms(call, (x, wq)),
               dequant_mm_ms=device_ms(lambda: torch.mm(x, w_deq_t), iters,
                                       spin),
               **int8_design(kernel, dtype, plan))
    print(json.dumps(row))
    return row


def int8_sweep_phase() -> None:
    """K4 at M = 512 and K5 at M = 8 at every plan they are built for
    (``pipeline.int8_plans``), at the (i2) shapes in fp32 and bf16: each
    plan held to the plain version at phase 8's tolerance and timed warm;
    the plan rule's pick beside the fastest, both timed again in turns
    (pick, fastest, fastest, pick, ...) for their spread."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import int8_matmul
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for M, kernel in ((512, "int8_matmul"), (8, "int8_matmul_pipelined")):
        pipelined = kernel == "int8_matmul_pipelined"
        fn = pl.int8_matmul_pipelined if pipelined else int8_matmul
        for K, N in LLAMA_PROJ:
            for dtype in ("float32", "bfloat16"):
                x = torch.randn((M, K), generator=gen,
                                device="cuda").to(getattr(torch, dtype))
                wq = torch.randint(-127, 128, (N, K), generator=gen,
                                   device="cuda", dtype=torch.int8)
                scale = 0.001 + 0.019 * torch.rand((N,), generator=gen,
                                                   device="cuda")
                want = ref.int8_matmul_ref(x, wq, scale)
                tol = int8_tol(x, wq, scale)
                itemsize = x.element_size()
                pick = pl.int8_plan(M, N, K, itemsize, pipelined=pipelined)
                times = {}
                # K5: rows of x a block past M's are idle, so only the pick's
                for plan in pl.int8_plans(M, N, K, itemsize,
                                          pipelined=pipelined):
                    if pipelined and plan[0] != pick[0]:
                        continue
                    _check(f"int8 sweep {kernel} M={M} K={K} N={N} {dtype} "
                           f"{plan}", fn(x, wq, scale, _plan=plan), want,
                           dtype, tol)
                    times[plan] = device_ms(
                        lambda plan=plan: fn(x, wq, scale, _plan=plan), 10,
                        spin=4_000_000) * 1e3
                best = min(times, key=times.get)
                turns = {pick: [], best: []}
                for plan in (pick, best, best, pick) * 3:
                    turns[plan].append(device_ms(
                        lambda plan=plan: fn(x, wq, scale, _plan=plan), 10,
                        spin=4_000_000) * 1e3)
                print(json.dumps({
                    "phase": "int8_sweep", "kernel": kernel, "M": M, "K": K,
                    "N": N, "dtype": dtype,
                    "us": {str(p): t for p, t in times.items()},
                    "pick": pick, "fastest": best,
                    "us_min_median_max": {
                        str(p): [min(v), float(np.median(v)), max(v)]
                        for p, v in turns.items()},
                    "pick_within_spread": min(turns[pick])
                    <= max(turns[best])}))


#: The K4 repeat check: (N, K) of llama110m's square projection, and the
#: runs of each plan.
K4_REPEAT_NK = (768, 768)
K4_REPEATS = 500


def k4_repeat_phase() -> None:
    """K4 at every plan at which the occupancy query puts two or more
    blocks on one SM, 500 runs each at an M of at least 2 x SMs blocks
    (tiles x split; without a split the kernel is persistent, at most one
    block an SM, and two share an SM only where the scheduler puts them
    there), in fp32, bf16 and fp16: the first run within ``int8_tol`` of
    the plain version, and every run with the first run's bits.  K4's ring
    releases a stage with one arrival a warp, the pattern that gave wrong
    tiles in a K5 design where blocks shared an SM."""
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.kernels import ref
    from repro_torch.kernels.int8_matmul import int8_matmul, k4_blocks_per_sm
    N, K = K4_REPEAT_NK
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    shared = 0
    for dtype in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, dtype)
        itemsize = torch.tensor([], dtype=dt).element_size()
        for plan in pl.int8_plans(1, N, K, itemsize, pipelined=False):
            per_sm = k4_blocks_per_sm(plan, dt)
            if per_sm < 2:
                continue
            tile_m, tile_n, split, _ = plan
            M = tile_m * -(-2 * sms // (split * -(-N // tile_n)))
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            wq = torch.randint(-127, 128, (N, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            scale = 0.001 + 0.019 * torch.rand((N,), generator=gen,
                                               device="cuda")
            first = int8_matmul(x, wq, scale, _plan=plan)
            _check(f"k4 repeat {dtype} {plan}", first,
                   ref.int8_matmul_ref(x, wq, scale), dtype,
                   int8_tol(x, wq, scale))
            differ = sum(not torch.equal(int8_matmul(x, wq, scale, _plan=plan),
                                         first)
                         for _ in range(K4_REPEATS - 1))
            tiles = -(-M // tile_m) * -(-N // tile_n)
            print(json.dumps({
                "phase": "k4_repeat", "dtype": dtype, "plan": plan, "M": M,
                "N": N, "K": K, "blocks_per_sm": per_sm,
                "blocks": min(tiles, sms) if split == 1 else tiles * split,
                "repeats": K4_REPEATS, "runs_differing": differ}))
            if differ:
                raise AssertionError(f"K4 {dtype} {plan}: {differ} of "
                                     f"{K4_REPEATS} runs differ from the "
                                     f"first")
            shared += 1
    print(json.dumps({"phase": "k4_repeat", "plans_sharing_an_sm": shared}))


#: K6's rows: S = T, H, K, q dtype, mask kind, head dim.  llama110m's
#: attention at its longest and shortest prompt bucket, a GQA case, fully
#: masked rows, bf16 q; head dims 80, 96 and 256 (one KV head) and fp16 q.
INT8KV_SHAPES = ((512, 12, 12, "float32", "causal", 64),
                 (64, 12, 12, "float32", "causal", 64),
                 (128, 12, 4, "float32", "causal", 64),
                 (128, 12, 12, "float32", "fully_masked_rows", 64),
                 (512, 12, 12, "bfloat16", "causal", 64),
                 (64, 12, 12, "bfloat16", "causal", 64),
                 (256, 12, 12, "float32", "causal", 80),
                 (256, 12, 12, "bfloat16", "causal", 96),
                 (256, 8, 1, "float32", "causal", 256),
                 (256, 12, 12, "float16", "causal", 64))
INT8KV_FORMULA = ("bytes = 2*B*S*H*hd*itemsize + 2*B*T*K*hd + 8*K + mask bytes "
                  "(q, out, int8 K/V, scales, mask); ops = 4*hd*H*valid pairs "
                  "* passes at 989 TFLOP/s (bf16/fp16 tensor cores), passes = "
                  "3 for fp32 q (its three exact bf16 terms), 1 for bf16 and "
                  "fp16; bound_ms = max(bytes / 3.35 TB/s, ops time); "
                  "bound_cuda_core_ms = the same with 4*hd*H*pairs at the "
                  "CUDA cores' 67 TFLOP/s")


def int8kv_case_name(S: int, H: int, K: int, dtype: str, kind: str,
                     hd: int) -> str:
    return f"S={S} T={S} H={H} K={K} hd={hd} {dtype} {kind}"


def int8kv_inputs(S: int, H: int, K: int, dtype: str, gen,
                  mask_kind: str = "causal", hd: int = 64):
    """q, the float K/V, their int8 quantization with per-head scales
    (tests/test_kernels.py:111) and the (1, S, S) mask of one K6 row."""
    import torch
    dt = getattr(torch, dtype)
    B, T = 1, S
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    kf = torch.randn((B, T, K, hd), generator=gen, device="cuda")
    vf = torch.randn((B, T, K, hd), generator=gen, device="cuda")
    ks = kf.abs().amax(dim=(0, 1, 3)) / 127.0
    vs = vf.abs().amax(dim=(0, 1, 3)) / 127.0
    k8 = torch.round(kf / ks[None, None, :, None]).clamp(-127, 127).to(torch.int8)
    v8 = torch.round(vf / vs[None, None, :, None]).clamp(-127, 127).to(torch.int8)
    mask = flash_mask("causal", S, T)
    if mask_kind == "fully_masked_rows":
        mask[:, :8, :] = False
    return q, kf, vf, k8, v8, ks, vs, mask


def int8kv_bounds(q, k8, mask) -> dict:
    """INT8KV_FORMULA's bounds (ms) for one K6 call."""
    B, S, H, hd = q.shape
    T, K = k8.shape[1], k8.shape[2]
    nbytes = (2 * B * S * H * hd * q.element_size() + 2 * B * T * K * hd
              + 8 * K + mask.numel())
    flops = 4 * hd * H * int(mask.expand(B, S, T).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    passes = 3 if q.element_size() == 4 else 1
    t_tc = flops * passes / PEAK_FLOPS["bfloat16"] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bound_tensor_core_ms": max(t_bytes, t_tc),
            "bound_cuda_core_ms": max(t_bytes,
                                      flops / PEAK_FLOPS["float32"] * 1e3)}


def int8kv_design(dtype: str, hd: int, plan) -> dict:
    """The plan fields of a K6 row and its instantiation's registers and
    spill bytes (the build log)."""
    from repro_torch.kernels.flash_attention import padded_head_dim
    tag = f"int8kv_kernelILi{padded_head_dim(hd)}E{mangled_t(dtype)}E"
    hits = [v for k, v in ptxas_report("flash_attention_int8kv").items()
            if tag in k]
    if len(hits) != 1:
        raise AssertionError(f"{tag}: {len(hits)} kernels in the build log")
    return {"plan": list(plan), "split": plan[0], "depth": plan[1],
            "registers": hits[0][0], "spill_store_bytes": hits[0][1]}


def int8kv_case(S: int, H: int, K: int, dtype: str, gen,
                mask_kind: str = "causal", hd: int = 64) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import pipeline, ref
    from repro_torch.kernels.flash_attention import flash_attention_int8kv
    dt = getattr(torch, dtype)
    q, kf, vf, k8, v8, ks, vs, mask = int8kv_inputs(S, H, K, dtype, gen,
                                                    mask_kind, hd)
    B, T = 1, S
    scale = hd ** -0.5
    call = lambda q, k8, v8, **kw: flash_attention_int8kv(  # noqa: E731
        q, k8, v8, ks, vs, mask, sm_scale=scale, **kw)
    run = lambda: call(q, k8, v8)  # noqa: E731
    plain = lambda: ref.flash_attention_int8kv_ref(  # noqa: E731
        q, k8, v8, ks, vs, mask, sm_scale=scale)
    got = run()
    torch.cuda.synchronize()
    case = int8kv_case_name(S, H, K, dtype, mask_kind, hd)
    err = _check(f"flash_attention_int8kv {case}", got, plain(), dtype,
                 INT8KV_TOL)
    fp_err = float((got.float() - ref.flash_attention_ref(
        q, kf, vf, mask, sm_scale=scale).float()).abs().max())
    if fp_err >= 0.1:
        raise AssertionError(f"flash_attention_int8kv {case}: {fp_err:.3e} "
                             f"from the fp oracle (limit 0.1)")
    if mask_kind == "fully_masked_rows" and float(got[0, :8].abs().max()) != 0:
        raise AssertionError("flash_attention_int8kv: fully-masked rows are "
                             "not 0")
    iters = 20 if S >= 256 else 50
    spin = 50_000_000   # ~25 ms: enough to queue 50 plain versions
    # a yardstick the port never calls: SDPA on K/V dequantized once in q's
    # dtype, heads repeated for GQA, outside the timed call
    rep = H // K
    kl = ((k8.float() * ks[None, None, :, None]).to(dt)
          .repeat_interleave(rep, dim=2).transpose(1, 2))
    vl = ((v8.float() * vs[None, None, :, None]).to(dt)
          .repeat_interleave(rep, dim=2).transpose(1, 2))
    ql = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        ql, kl, vl, attn_mask=mask[:, None], scale=scale)
    bounds = int8kv_bounds(q, k8, mask)
    row = _row("flash_attention_int8kv", case, err, device_ms(run, iters, spin),
               device_ms(plain, iters, spin), None, bounds.pop("bytes"),
               bounds.pop("flops"), dtype)
    row.update(bounds)   # at the tensor cores' rate the kernel runs
    row.update(library_note="no one-call counterpart (SDPA takes no int8 "
                            "K/V with per-head scales)",
               bound_formula=INT8KV_FORMULA,
               dequant_sdpa_ms=device_ms(sdpa, iters, spin),
               dequant_sdpa_note="SDPA on K/V dequantized once in q's dtype: "
                                 "a yardstick, not a one-call counterpart",
               max_abs_err_vs_fp_oracle=fp_err,
               cold_ms=cold_ms(call, (q, k8, v8)),
               **int8kv_design(dtype, hd, pipeline.int8kv_plan(
                   B, S, T, H, K, hd, dt, pipeline.sm_count(q.device))),
               **flash_shape_fields(
                   "flash_attention_int8kv", dt, hd, mask, B, H,
                   lambda n: call(q, k8, v8, live_count=n)))
    print(json.dumps(row))
    return row


def int8kv_sweep_phase() -> None:
    """K6 at every plan it takes (``pipeline.int8kv_plans``) at its ten
    rows (INT8KV_SHAPES): each plan held to the plain version at INT8KV_TOL
    and timed warm; the plan rule's pick beside the fastest, both timed
    again in turns (pick, fastest, fastest, pick, ...) for their spread."""
    import numpy as np
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_int8kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for S, H, K, dtype, kind, hd in INT8KV_SHAPES:
        q, _, _, k8, v8, ks, vs, mask = int8kv_inputs(S, H, K, dtype, gen,
                                                      kind, hd)
        scale = hd ** -0.5
        want = ref.flash_attention_int8kv_ref(q, k8, v8, ks, vs, mask,
                                              sm_scale=scale)

        def call(plan):
            return flash_attention_int8kv(q, k8, v8, ks, vs, mask,
                                          sm_scale=scale, _plan=plan)
        case = int8kv_case_name(S, H, K, dtype, kind, hd)
        times = {}
        for plan in pl.int8kv_plans(1, S, S, H, K, hd, q.dtype):
            _check(f"int8kv sweep {case} {plan}", call(plan), want, dtype,
                   INT8KV_TOL)
            times[plan] = device_ms(lambda plan=plan: call(plan), 20,
                                    spin=4_000_000) * 1e3
        pick = pl.int8kv_plan(1, S, S, H, K, hd, q.dtype,
                              pl.sm_count(q.device))
        best = min(times, key=times.get)
        turns = {pick: [], best: []}
        for plan in (pick, best, best, pick) * 3:
            turns[plan].append(device_ms(lambda plan=plan: call(plan), 20,
                                         spin=4_000_000) * 1e3)
        print(json.dumps({
            "phase": "int8kv_sweep", "case": case,
            "us": {str(p): t for p, t in times.items()},
            "pick": pick, "fastest": best,
            "us_min_median_max": {str(p): [min(v), float(np.median(v)),
                                           max(v)]
                                  for p, v in turns.items()},
            "pick_within_spread": min(turns[pick]) <= max(turns[best])}))


#: K6's repeat check: runs of each split plan.
INT8KV_REPEATS = 50


def int8kv_repeat_phase() -> None:
    """K6 at every plan that splits a q tile's keys over a cluster, at the
    main case (S = T = 512, hd 64) in fp32, bf16 and fp16 and at hd 256 with
    one KV head in fp32: 50 runs each with the first run's bits (the
    partial states are combined in rank order)."""
    import torch
    from repro_torch.kernels import pipeline as pl
    from repro_torch.kernels.flash_attention import flash_attention_int8kv
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    for S, H, K, dtype, hd in ((512, 12, 12, "float32", 64),
                               (512, 12, 12, "bfloat16", 64),
                               (512, 12, 12, "float16", 64),
                               (256, 8, 1, "float32", 256)):
        q, _, _, k8, v8, ks, vs, mask = int8kv_inputs(S, H, K, dtype, gen,
                                                      "causal", hd)
        for plan in pl.int8kv_plans(1, S, S, H, K, hd, q.dtype):
            if plan[0] == 1:
                continue

            def call():
                return flash_attention_int8kv(q, k8, v8, ks, vs, mask,
                                              sm_scale=hd ** -0.5, _plan=plan)
            first = call()
            differ = sum(not torch.equal(call(), first)
                         for _ in range(INT8KV_REPEATS - 1))
            print(json.dumps({
                "phase": "int8kv_repeat",
                "case": int8kv_case_name(S, H, K, dtype, "causal", hd),
                "plan": plan, "repeats": INT8KV_REPEATS,
                "runs_differing": differ}))
            if differ:
                raise AssertionError(f"K6 {dtype} hd {hd} {plan}: {differ} "
                                     f"of {INT8KV_REPEATS} runs differ from "
                                     f"the first")


def int8_kernel_phase() -> list[dict]:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    rows = []
    for K, N in LLAMA_PROJ:
        for M in (512, 8):
            for dtype in ("float32", "bfloat16"):
                for kernel in ("int8_matmul", "int8_matmul_pipelined"):
                    rows.append(int8_case(kernel, M, N, K, dtype, gen))
    for M in (1, 7, 100):
        for kernel in ("int8_matmul", "int8_matmul_pipelined"):
            rows.append(int8_case(kernel, M, 1000, 768, "float32", gen))
        rows.append(int8_case("int8_matmul", M, 1000, 100, "float32", gen))
    for kernel in ("int8_matmul", "int8_matmul_pipelined"):
        rows.append(int8_case(kernel, 8, 1000, 768, "float16", gen))
    rows.append(int8_case("int8_matmul", 100, 1000, 100, "float16", gen))
    for S, H, K, dtype, kind, hd in INT8KV_SHAPES:
        rows.append(int8kv_case(S, H, K, dtype, gen, kind, hd))
    return rows


def int8_serve_phase():
    """Run (i1); returns its launch counts and the int8 tree of its weights."""
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import (StaticBatchEngine, quantization_error,
                                          quantize_params_int8)
    from repro_torch.serve.scheduler import make_poisson_workload

    cfg = get_config("llama110m")
    L = cfg.n_layers
    out_lens = (8, 16, 32)
    raw = get_model(cfg).init(0, "cuda")
    qtree, dequant = quantize_params_int8(raw)
    qerr = quantization_error(raw, qtree, dequant)
    eng = StaticBatchEngine(cfg, raw, batch=8, max_len=BUCKETS[-1] + max(out_lens),
                            prompt_buckets=BUCKETS, quantize=True,
                            lowering=LoweringConfig("cuda"), device="cuda")
    del raw
    warm = make_poisson_workload(2, rate=2.0, vocab=cfg.vocab,
                                 prompt_lens=(20,), out_lens=(4,), seed=1)
    eng.run(warm)
    reqs = make_poisson_workload(
        16, rate=2.0, vocab=cfg.vocab,
        prompt_lens=(10, 24, 50, 100, 200, 400, 512), out_lens=out_lens,
        seed=0)
    prefills = []                    # (tokens, logits) of every group
    engine_prefill = eng._prefill

    def recording(p, b):
        logits, caches = engine_prefill(p, b)
        prefills.append((b["tokens"], logits.clone()))
        return logits, caches

    eng._prefill = recording
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    stats = eng.run(reqs)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    eng._prefill = engine_prefill

    buckets = [t.shape[1] for t, _ in prefills]
    want = {n: 0 for n in launches}
    want["rmsnorm"] = (2 * L + 1) * (len(prefills) + stats.decode_steps)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    for tokens, _ in prefills:
        B, b = tokens.shape
        want[scheduled(eng.lowering, "attention", (B, b, H, K, b, hd),
                       torch.float32)] += L
    if launches != want:
        raise AssertionError(f"int8 run (i1): launch counts {launches} != "
                             f"expected {want}")
    for r in reqs:
        if (len(r.out_tokens) != r.max_new_tokens
                or not all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"int8 run (i1): request {r.rid}: bad output "
                                 f"{r.out_tokens}")
    # first-token logits of every group, backend "cuda" against "torch" on
    # the same dequantized weights
    plain = get_model(cfg, lowering=LoweringConfig("torch"))
    worst = 0.0
    for tokens, got in prefills:
        want_l, _ = plain.prefill(eng.params, {"tokens": tokens}, eng.max_len)
        err = (got - want_l).abs()
        if not torch.isfinite(got).all() or bool(
                (err > 1e-4 + 1e-4 * want_l.abs()).any()):
            raise AssertionError(f"int8 run (i1): bucket {tokens.shape[1]}: "
                                 f"cuda vs torch first-token logits differ by "
                                 f"{float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
    summary = {
        "phase": "int8_serve", "run": "i1", "arch": cfg.name,
        "engine": "StaticBatchEngine(quantize=True)", "batch": eng.batch,
        "requests": stats.n_requests, "tokens": stats.total_tokens,
        "groups": len(prefills), "buckets": buckets,
        "decode_steps": stats.decode_steps, "wall_s": stats.wall_s,
        "tokens_per_s": stats.tokens_per_s,
        "mean_ttft_ms": stats.mean_ttft_s * 1e3,
        "mean_itl_ms": stats.mean_itl_s * 1e3,
        "quantization_error": qerr, "launches": launches,
        "first_token_logits_max_abs_err_vs_torch": worst}
    print(json.dumps(summary))
    print(f"int8 serve (i1): {stats.n_requests} requests in {len(prefills)} "
          f"groups, {stats.total_tokens} tokens, TTFT "
          f"{stats.mean_ttft_s * 1e3:.2f} ms, ITL {stats.mean_itl_s * 1e3:.3f} "
          f"ms, {stats.tokens_per_s:.1f} tok/s, quantization error "
          f"{qerr:.6f}, launches {launches}")
    return launches, qtree


def quantized_projections(qtree) -> list:
    """(name, wq (N, K) int8, scale (N,) fp32) of every projection of every
    layer and of the unembedding, laid out for ``int8_matmul``."""
    blocks = qtree["blocks"]

    def per_layer(leaf, i, to_nk):
        wq = to_nk(leaf["q"][i]).contiguous()
        return wq, leaf["scale"].expand(wq.shape[0]).contiguous()

    in_proj = lambda w: w.reshape(w.shape[0], -1).T  # noqa: E731  (d,H,hd)
    out_proj = lambda w: w.reshape(-1, w.shape[-1]).T  # noqa: E731  (H,hd,d)
    layout = (("attn", "wq", in_proj), ("attn", "wk", in_proj),
              ("attn", "wv", in_proj), ("attn", "wo", out_proj),
              ("mlp", "wi_gate", lambda w: w.T), ("mlp", "wi_up", lambda w: w.T),
              ("mlp", "wo", lambda w: w.T))
    out = []
    for i in range(blocks["attn"]["wq"]["q"].shape[0]):
        for group, name, to_nk in layout:
            out.append((f"{group}.{name}[{i}]",
                        *per_layer(blocks[group][name], i, to_nk)))
    un = qtree["unembed"]["w"]
    out.append(("unembed.w", un["q"].contiguous(),
                un["scale"].expand(un["q"].shape[0]).contiguous()))
    return out


def int8_gemm_phase(qtree) -> dict:
    """Run (i2); returns the launch counts summed over its two row counts."""
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.kernels import _build, ref
    projections = quantized_projections(qtree)
    if len(projections) != 85:
        raise AssertionError(f"int8 run (i2): {len(projections)} projections")
    lw = LoweringConfig("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    total = {n: 0 for n in _build.KERNELS}
    for M in (512, 8):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda")
              for K in {w.shape[1] for _, w, _ in projections}}
        for name, wq, scale in projections:       # warm: first-call set-up
            lw.int8_matmul(xs[wq.shape[1]], wq, scale)
        torch.cuda.synchronize()
        # the 85 calls queued behind a GPU spin: the host's time to issue
        # them (µs a call) and the card's time to run them back to back
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _build.reset_launch_counts()
        torch.cuda._sleep(40_000_000)
        start.record()
        t0 = time.perf_counter()
        outs = [lw.int8_matmul(xs[wq.shape[1]], wq, scale)
                for _, wq, scale in projections]
        host_us = (time.perf_counter() - t0) * 1e6 / len(projections)
        end.record()
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        device_us = start.elapsed_time(end) * 1e3
        # and their wall time with nothing queued before them
        t0 = time.perf_counter()
        for _, wq, scale in projections:
            lw.int8_matmul(xs[wq.shape[1]], wq, scale)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        want = {n: 0 for n in launches}
        for _, wq, _ in projections:
            want[scheduled(lw, "int8_matmul", (M, wq.shape[1], wq.shape[0]),
                           torch.float32)] += 1
        if launches != want:
            raise AssertionError(f"int8 run (i2) M={M}: launch counts "
                                 f"{launches} != the records' {want}")
        worst = 0.0
        for (name, wq, scale), got in zip(projections, outs):
            N, K = wq.shape
            if got.shape != (M, N):
                raise AssertionError(f"int8 run (i2) {name}: shape {got.shape}")
            worst = max(worst, _check(f"int8 run (i2) M={M} {name}", got,
                                      ref.int8_matmul_ref(xs[K], wq, scale),
                                      "float32", int8_tol(xs[K], wq, scale)))
        for n, c in launches.items():
            total[n] += c
        print(json.dumps({"phase": "int8_gemm", "run": "i2", "M": M,
                          "gemms": len(projections), "launches": launches,
                          "wall_ms_85_gemms": wall_ms,
                          "device_us_85_gemms": device_us,
                          "host_us_a_call": host_us,
                          "max_abs_err_vs_plain": worst}))
    print(f"int8 gemm (i2): 85 projections at M=512 and M=8 through the "
          f"kernels their records name match the plain version; launches "
          f"{total}")
    return total


# -- the compiler's phases: dispatch, evaluate, route ---------------------------

# ---------------------------------------------------------------------------
# train: the port's Trainer on the card (plain torch ops, no kernel)
# ---------------------------------------------------------------------------

#: (t1) llama110m fp32 at full width, TrainConfig's batch 8 x seq 128.
TRAIN_T1 = {"steps": 20, "fail_at": 12, "ckpt_every": 5, "lr": 1e-3,
            "grad_rtol": 1e-4, "restart_rtol": 1e-4, "decrease_updates": 8}
#: (t2) qwen1.5-0.5b bf16 at full width, B 4 x S 512, two steps a policy.
TRAIN_T2 = {"arch": "qwen1.5-0.5b", "batch": 4, "seq": 512,
            "policies": ("none", "dots", "full")}
#: (t3) one family a run at full width (depth cut only where the reckoned
#: bytes exceed TRAIN_BUDGET of the card): arch, batch, seq (vlm's counts
#: its 256-token prefix), AdamW state dtype.  lr TRAIN_T3_LR: the
#: Trainer's first moving step at its defaults (lr 3e-4 x warmup_cosine at
#: step 1 of a 20-step warmup).  AdamW's first step moves every weight by
#: ~lr; at d 6144 and ff 10752 a larger one overshoots: dbrx's loss rose
#: 12.05 -> 25.61 at 3e-4 and -> 18.82 at 1e-4, where mamba2's fell.
TRAIN_T3_LR = 3e-4 / 20
TRAIN_T3 = (("mamba2-2.7b", 2, 128, "float32"),
            ("zamba2-1.2b", 2, 128, "float32"),
            ("paligemma-3b", 2, 320, "float32"),
            ("seamless-m4t-medium", 2, 128, "float32"),
            ("dbrx-132b", 2, 128, "bfloat16"),
            ("arctic-480b", 2, 64, "bfloat16"))
#: Share of the card's memory the reckoned params + grads + AdamW state may
#: take; the rest holds activations and the update's fp32 slices.
TRAIN_BUDGET = 0.6


def train_bytes(cfg, state_dtype: str) -> int:
    """Params + grads (the param dtype) + AdamW's m and v (the state dtype)
    at ``n_params``: 12 bytes a bf16 parameter with fp32 state, 8 with
    bf16 state, 16 in fp32."""
    p = 2 if cfg.param_dtype == "bfloat16" else 4
    s = 2 if state_dtype == "bfloat16" else 4
    return cfg.n_params() * (2 * p + 2 * s)


def train_depth(cfg, state_dtype: str, budget: float) -> int:
    """The most layers (full depth first) whose ``train_bytes`` fit
    ``budget`` bytes; 0 where not even one layer does."""
    import dataclasses
    for n in range(cfg.n_layers, 0, -1):
        if train_bytes(dataclasses.replace(cfg, n_layers=n),
                       state_dtype) <= budget:
            return n
    return 0


def _rel_dist(a, b) -> float:
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def _leaf_norms(grads) -> list[float]:
    import torch
    from repro_torch.tree import tree_leaves
    return [float(torch.linalg.vector_norm(g.float())) for g in
            tree_leaves(grads)]


def _free_card():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_t1() -> dict:
    """(t1): 20 steps under run_with_restarts with a failure at step 12,
    against a run with no failure; step 1's gradients against the CPU's;
    8 updates on the step-0 batch; the guard under backend cuda."""
    import statistics
    import tempfile
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_state)
    from repro_torch.train.fault_tolerance import (FailureInjector,
                                                   run_with_restarts)
    from repro_torch.train.trainer import TrainConfig, Trainer, loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map
    t = TRAIN_T1
    cfg = get_config("llama110m")
    opt = AdamWConfig(lr=t["lr"])
    line = {"phase": "train", "run": "t1", "arch": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "dtype": cfg.param_dtype}

    # step 1's gradients on the card against the port on the CPU
    tc = TrainConfig(ckpt_dir=None, total_steps=t["steps"], optimizer=opt)
    line.update(batch=tc.batch, seq=tc.seq)
    tr = Trainer(cfg, tc, device="cuda")
    batch = tr._device_batch(0)
    loss, grads = loss_and_grads(tr.model, tr.params, batch)
    cpu_model = get_model(cfg, lowering=LoweringConfig("torch"))
    cpu_loss, cpu_grads = loss_and_grads(
        cpu_model, tree_map(lambda p: p.cpu(), tr.params),
        {k: v.cpu() for k, v in batch.items()})
    dists = [_rel_dist(a, b) for a, b in zip(tree_leaves(grads),
                                             tree_leaves(cpu_grads))]
    norms = _leaf_norms(grads)
    line.update(step1_loss=float(loss), step1_cpu_loss=float(cpu_loss),
                grad_leaves=len(dists), grad_max_rel_dist=max(dists),
                grad_min_leaf_norm=min(norms))
    if max(dists) > t["grad_rtol"] or min(norms) <= 0:
        raise AssertionError(f"t1 step-1 gradients: {line}")

    # the guard: a loss under backend cuda refuses autograd
    live = tree_map(lambda p: p.detach().requires_grad_(True), tr.params)
    try:
        get_model(cfg, lowering=LoweringConfig("cuda")).loss(
            live, batch).backward()
    except RuntimeError as e:
        if "no gradient" not in str(e):
            raise
        line["guard"] = str(e).split(":")[0] + ": raised"
    else:
        raise AssertionError("t1: a loss under backend cuda did not raise")
    del live

    # 8 updates on the step-0 batch
    params = tree_map(lambda p: p.clone(), tr.params)
    state = init_state(params, opt)
    losses = []
    for _ in range(t["decrease_updates"]):
        loss, g = loss_and_grads(tr.model, params, batch)
        losses.append(float(loss))
        params, state, _ = apply_updates(params, g, state, opt)
    after = float(loss_and_grads(tr.model, params, batch)[0])
    line.update(fixed_batch_loss_start=losses[0], fixed_batch_loss_after=after)
    if not after < losses[0]:
        raise AssertionError(f"t1: loss did not fall: {line}")
    del params, state, grads, cpu_grads, g, tr
    _free_card()

    # the no-failure run, timed
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ref = Trainer(cfg, tc, device="cuda")
    ref.train(t["steps"])
    peak = torch.cuda.max_memory_allocated() - base
    ms = [m["step_time"] * 1e3 for m in ref.metrics_log[2:]]
    med = statistics.median(ms)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
    line.update(warm_median_step_ms=med,
                tokens_per_s=tc.batch * tc.seq / (med / 1e3),
                max_memory_allocated_gb=peak / 1e9,
                loss_first=ref.metrics_log[0]["loss"],
                loss_last=ref.metrics_log[-1]["loss"])
    del ref
    _free_card()

    # the run with a failure at step 12 under run_with_restarts
    with tempfile.TemporaryDirectory() as d:
        tcf = TrainConfig(ckpt_dir=d, ckpt_every=t["ckpt_every"],
                          total_steps=t["steps"], optimizer=opt)
        inj = FailureInjector({t["fail_at"]})
        built = []

        def make():
            built.append(1)
            return Trainer(cfg, tcf, failure_injector=inj, device="cuda")

        t0 = time.perf_counter()
        tr = run_with_restarts(make, t["steps"])
        line["restart_run_s"] = time.perf_counter() - t0
        restarts = len(built) - 1
        post = tr.metrics_log
        worst = max(abs(m["loss"] - ref_losses[m["step"]])
                    / abs(ref_losses[m["step"]]) for m in post)
        line.update(final_step=tr.step, restarts=restarts,
                    resumed_from=post[0]["step"], post_restart_steps=len(post),
                    post_restart_max_rel=worst)
        if (tr.step != t["steps"] or restarts != 1
                or worst > t["restart_rtol"]):
            raise AssertionError(f"t1 restart: {line}")
        del tr
    _free_card()
    return line


def train_t2() -> dict:
    """(t2): qwen1.5-0.5b in bf16 under each remat policy, two steps (the
    first's loss, the second's time, warm): the steps' peak memory above
    the weights and AdamW state falls under dots and full, the first loss
    the same under all three."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.train.trainer import TrainConfig, Trainer
    t = TRAIN_T2
    base_cfg = get_config(t["arch"])
    line = {"phase": "train", "run": "t2", "arch": base_cfg.name,
            "layers": base_cfg.n_layers, "dtype": base_cfg.param_dtype,
            "config_remat": base_cfg.remat, "batch": t["batch"],
            "seq": t["seq"], "policies": {}}
    for policy in t["policies"]:
        cfg = dataclasses.replace(base_cfg, remat=policy)
        tr = Trainer(cfg, TrainConfig(batch=t["batch"], seq=t["seq"],
                                      total_steps=2), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr.train(2)
        torch.cuda.synchronize()
        line["policies"][policy] = {
            "loss": tr.metrics_log[0]["loss"],
            "first_step_s": tr.metrics_log[0]["step_time"],
            "step_ms": tr.metrics_log[1]["step_time"] * 1e3,
            "weights_and_state_gb": base / 1e9,
            "step_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
        del tr
        _free_card()
    p = line["policies"]
    loss = p["none"]["loss"]
    same = all(abs(p[k]["loss"] - loss) <= 2e-2 * abs(loss) for k in p)
    if not (p["full"]["step_peak_gb"] < p["none"]["step_peak_gb"]
            and p["dots"]["step_peak_gb"] < p["none"]["step_peak_gb"]
            and same):
        raise AssertionError(f"t2: {line}")
    return line


def train_t3() -> list[dict]:
    """(t3): each family at full width (depth cut only by TRAIN_BUDGET),
    two AdamW steps on a fixed batch: finite losses, every leaf's
    gradient norm above 0, the second loss below the first."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
    from repro_torch.train.trainer import TrainConfig, Trainer, loss_and_grads
    budget = TRAIN_BUDGET * torch.cuda.get_device_properties(0).total_memory
    lines = []
    for arch, B, S, state_dtype in TRAIN_T3:
        cfg = get_config(arch)
        full = cfg.n_layers
        depth = train_depth(cfg, state_dtype, budget)
        line = {"phase": "train", "run": "t3", "arch": arch,
                "family": cfg.family, "state_dtype": state_dtype,
                "batch": B, "seq": S, "remat": cfg.remat,
                "reckoned_gb_full_depth": train_bytes(cfg, state_dtype) / 1e9,
                "budget_gb": budget / 1e9}
        if depth == 0:
            one = dataclasses.replace(cfg, n_layers=1)
            line.update(skipped=(
                f"one layer ({one.n_params() / 1e9:.2f} B parameters) "
                f"reckons {train_bytes(one, state_dtype) / 1e9:.1f} GB of "
                f"params, grads and AdamW state, over the "
                f"{budget / 1e9:.1f} GB budget; not cut in width"))
            print(json.dumps(line), flush=True)
            lines.append(line)
            continue
        if depth < full:
            cfg = dataclasses.replace(cfg, n_layers=depth)
            line["cut"] = f"n_layers {full} -> {depth}"
        line.update(layers=cfg.n_layers, n_params=cfg.n_params(),
                    reckoned_gb=train_bytes(cfg, state_dtype) / 1e9)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        opt = AdamWConfig(lr=TRAIN_T3_LR, state_dtype=state_dtype)
        tr = Trainer(cfg, TrainConfig(batch=B, seq=S, optimizer=opt),
                     device="cuda")
        batch = tr._device_batch(0)
        params, state = tr.params, init_state(tr.params, opt)
        losses = []
        for _ in range(2):
            loss, grads = loss_and_grads(tr.model, params, batch)
            losses.append(float(loss))
            norms = _leaf_norms(grads)
            params, state, _ = apply_updates(params, grads, state, opt)
            del grads
        line.update(losses=losses, min_leaf_grad_norm=min(norms),
                    leaves=len(norms),
                    max_memory_allocated_gb=(
                        torch.cuda.max_memory_allocated() / 1e9),
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if not (all(math.isfinite(x) for x in losses) and min(norms) > 0
                and losses[1] < losses[0]):
            raise AssertionError(f"t3 {arch}: {line}")
        del tr, params, state
        _free_card()
        lines.append(line)
    return lines


def train_phase() -> None:
    """(t1)-(t3) through the port's Trainer, TF32 off, kernel launch
    counts zeroed before and read after: the training path launches no
    kernel (backend "torch"; the kernels have no gradient)."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    t1 = train_t1()
    print(json.dumps(t1), flush=True)
    t2 = train_t2()
    print(json.dumps(t2), flush=True)
    train_t3()
    launches = _build.launch_counts()
    print(json.dumps({"phase": "train", "kernel_launches": launches}))
    if any(launches.values()):
        raise AssertionError(f"the training path launched kernels: "
                             f"{launches}")


#: (x1) llama110m fp32 served on a 1×1 mesh: prompts, the bucket they are
#: padded to, greedy decode steps.
DIST_X1 = {"arch": "llama110m", "batch": 2, "bucket": 512, "steps": 16}
#: (x2) the int8-wire DP step at world size 1: llama110m fp32, backend
#: torch, B x S; updates on one batch; timed steps against the Trainer's.
DIST_X2 = {"arch": "llama110m", "batch": 8, "seq": 128, "decrease_steps": 8,
           "timed_steps": 20, "lr": 1e-3}
#: (x3) qwen1.5-0.5b bf16 under fsdp_tp on the 1×1 mesh: B x S, steps; the
#: first loss within bf16's tolerance (TOL) of the unsharded step's.
DIST_X3 = {"arch": "qwen1.5-0.5b", "batch": 4, "seq": 512, "steps": 2}


def dist_group() -> None:
    """An NCCL process group of one rank on the card, through a file store
    (no port)."""
    import tempfile
    import torch
    import torch.distributed as dist
    store = pathlib.Path(tempfile.mkdtemp(prefix="dist_smoke_")) / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            device_id=torch.device(
                                "cuda", torch.cuda.current_device()))


def _placed(tree, shardings):
    """``tree``'s tensors as DTensors placed by ``shardings``, each rank
    slicing its shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t, s: distribute_tensor(
        t.detach().clone(), s.mesh, list(s.placements), src_data_rank=None),
        tree, shardings)


def _full(x):
    from repro_torch.models.layers import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def _sync() -> None:
    import torch
    torch.cuda.synchronize()


def _greedy(model, params, prompt, steps: int, shard=None):
    """Prefill ``prompt`` padded to room for ``steps`` more, then greedy
    decode steps; ``shard(caches)`` places the caches (sharded run).
    Returns (tokens (B, steps + 1), every step's logits, decode ms)."""
    import torch
    S = prompt.shape[1]
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": prompt},
                                       pad_to=S + steps)
        if shard is not None:
            caches = shard(caches)
        logits = _full(logits)
        out, toks, ms = [logits], [logits.argmax(-1)], []
        for i in range(steps):
            _sync()
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, toks[-1], caches,
                                               S + i)
            logits = _full(logits)
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
            toks.append(logits.argmax(-1))
    return torch.stack(toks, 1), out, ms


def dist_x1(mesh, card: str) -> dict:
    """(x1): llama110m served with weights and caches as DTensors on the
    1×1 mesh under the ``serve`` policy, activation specs set, backend
    cuda: K1 and the prefill attention kernel through the ``local_map``
    routes, launch counts equal to the unsharded run's, the same greedy
    tokens, logits within fp32's tolerance, both ITLs."""
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.sharding import policies as pol
    x1 = DIST_X1
    device = torch.device("cuda")
    cfg = get_config(x1["arch"])
    B, S, n = x1["batch"], x1["bucket"], x1["steps"]
    lw = LoweringConfig("cuda")
    model = get_model(cfg, lowering=lw)
    params = model.init(0, device)
    axes = model.param_axes()
    dparams = _placed(params, pol.param_shardings(cfg, mesh, axes, params,
                                                  "serve"))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S),
                                           dtype=np.int64)).to(device)

    def shard(caches):
        sh = pol.cache_shardings(cfg, mesh, caches, policy="serve")
        return {k: v.redistribute(mesh, sh[k].placements)
                for k, v in caches.items()}

    def run(p, sharded: bool):
        if sharded:
            layers.set_activation_shardings(
                pol.activation_specs(cfg, mesh, B, "serve"))
        try:
            _greedy(model, p, prompt, n, shard if sharded else None)  # warm
            _sync()
            _build.reset_launch_counts()
            toks, logits, ms = _greedy(model, p, prompt, n,
                                       shard if sharded else None)
            _sync()
            return toks, logits, ms, _build.launch_counts()
        finally:
            layers.set_activation_shardings(None)

    toks_p, logits_p, ms_p, launches_p = run(params, False)
    toks_d, logits_d, ms_d, launches_d = run(dparams, True)
    atol, rtol = TOL["float32"]
    err = max(float((a - b).abs().max()) for a, b in zip(logits_d, logits_p))
    bad = any(bool(((a - b).abs() > atol + rtol * b.abs()).any())
              for a, b in zip(logits_d, logits_p))
    attn = scheduled(lw, "attention", (B, S, cfg.n_heads, cfg.n_kv_heads, S,
                                       cfg.resolved_head_dim()),
                     torch.float32)
    line = {"phase": "dist", "run": "x1", "arch": cfg.name, "batch": B,
            "bucket": S, "decode_steps": n, "policy": "serve",
            "mesh": list(mesh.shape), "tokens_equal": bool(
                torch.equal(toks_d, toks_p)),
            "logits_max_abs_err": err, "launches": launches_d,
            "launches_unsharded": launches_p, "attention_kernel": attn,
            "itl_ms": statistics.median(ms_d),
            "itl_unsharded_ms": statistics.median(ms_p),
            "itl_note": "median host ms a decode step, synchronized; the "
                        "sharded one includes DTensor's dispatch",
            "card": card}
    print(json.dumps(line), flush=True)
    if (not line["tokens_equal"] or bad or launches_d != launches_p
            or not launches_d.get("rmsnorm") or not launches_d.get(attn)):
        raise AssertionError(f"x1: {line}")
    return launches_d


def dist_x2(mesh, card: str) -> dict:
    """(x2): ``make_int8_wire_train_step`` for llama110m fp32 at world size
    1, backend torch: step 1's averaged gradient within one int8 level
    (scale1 + scale2) of the same step by the port on the CPU (a gloo
    group beside the card's), the loss falling over updates on one batch,
    the step timed against the plain train step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.optim.wire_compression import (_flatten_grads, dp_group,
                                                    init_err_state,
                                                    int8_wire_allreduce,
                                                    make_int8_wire_train_step)
    from repro_torch.train.trainer import (TrainConfig, loss_and_grads,
                                           make_train_step)
    from repro_torch.tree import tree_map
    x2 = DIST_X2
    device = torch.device("cuda")
    cfg = get_config(x2["arch"])
    B, S = x2["batch"], x2["seq"]
    model = get_model(cfg, lowering=LoweringConfig("torch"))
    params = model.init(0, device)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
             "labels": torch.from_numpy(toks[:, 1:]).to(device)}
    group = dp_group(mesh, ("data",))
    cpu_group = dist.new_group([0], backend="gloo")

    # step 1's averaged gradient: card against CPU
    _, grads = loss_and_grads(model, params, batch)
    flat, _ = _flatten_grads(grads)
    mean, _ = int8_wire_allreduce(flat, torch.zeros_like(flat), group)
    cpu_model = get_model(cfg, lowering=LoweringConfig("torch"))
    _, cgrads = loss_and_grads(cpu_model, tree_map(lambda p: p.cpu(), params),
                               {k: v.cpu() for k, v in batch.items()})
    cflat, _ = _flatten_grads(cgrads)
    cmean, _ = int8_wire_allreduce(cflat, torch.zeros_like(cflat), cpu_group)
    scale1 = float(cflat.abs().max()) / 127.0
    scale2 = float((torch.round(cflat / scale1) * scale1).abs().max()) / 127.0
    diff = float((mean.cpu() - cmean).abs().max())
    line = {"phase": "dist", "run": "x2", "arch": cfg.name, "batch": B,
            "seq": S, "step1_mean_grad_max_abs_diff": diff,
            "int8_level": scale1 + scale2, "grad_elements": flat.numel()}
    del grads, cgrads

    opt = AdamWConfig(lr=x2["lr"])
    p = tree_map(lambda t: t.clone(), params)
    state, err = init_state(p, opt), init_err_state(p)
    step = make_int8_wire_train_step(model, opt, mesh, ("data",))
    losses = []
    for _ in range(x2["decrease_steps"]):
        p, state, err, m = step(p, state, err, batch)
        losses.append(float(m["loss"]))
    line.update(loss_first=losses[0], loss_last=losses[-1])

    def timed(fn, n):
        ms = []
        for i in range(n + 2):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            if i >= 2:
                ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    box = [p, state, err]

    def wire():
        box[0], box[1], box[2], _ = step(*box, batch)

    plain_step = make_train_step(model, opt, TrainConfig(optimizer=opt))
    q = tree_map(lambda t: t.clone(), params)
    qbox = [q, init_state(q, opt)]

    def plain():
        qbox[0], qbox[1], _ = plain_step(*qbox, batch)

    line.update(wire_step_ms=timed(wire, x2["timed_steps"]),
                plain_step_ms=timed(plain, x2["timed_steps"]),
                timed_steps=x2["timed_steps"],
                time_note="median host ms a step, synchronized", card=card)
    print(json.dumps(line), flush=True)
    if diff > scale1 + scale2 or not losses[-1] < losses[0]:
        raise AssertionError(f"x2: {line}")
    dist.destroy_process_group(cpu_group)
    return line


def dist_x3(mesh, card: str) -> dict:
    """(x3): qwen1.5-0.5b bf16 under ``fsdp_tp`` on the 1×1 mesh, two
    train steps with DTensor params, state and batch; the first loss
    within bf16's tolerance of the unsharded step's."""
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.sharding import policies as pol
    from repro_torch.train.trainer import TrainConfig, make_train_step
    from repro_torch.tree import tree_map
    x3 = DIST_X3
    device = torch.device("cuda")
    cfg = get_config(x3["arch"])
    B, S = x3["batch"], x3["seq"]
    model = get_model(cfg, lowering=LoweringConfig("torch"))
    params = model.init(0, device)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(device),
             "labels": torch.from_numpy(toks[:, 1:]).to(device)}
    opt = AdamWConfig()
    step = make_train_step(model, opt, TrainConfig(optimizer=opt))
    psh = pol.param_shardings(cfg, mesh, model.param_axes(), params,
                              "fsdp_tp")
    dparams = _placed(params, psh)
    dbatch = _placed(batch, pol.batch_sharding(cfg, mesh, batch, "fsdp_tp"))
    dstate = init_state(dparams, opt)
    layers.set_activation_shardings(
        pol.activation_specs(cfg, mesh, B, "fsdp_tp"))
    losses, ms = [], []
    try:
        for _ in range(x3["steps"]):
            _sync()
            t0 = time.perf_counter()
            dparams, dstate, m = step(dparams, dstate, dbatch)
            losses.append(float(_full(m["loss"])))
            _sync()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        layers.set_activation_shardings(None)
    del dparams, dstate
    _sync()
    t0 = time.perf_counter()
    _, _, m = step(params, init_state(params, opt), batch)
    plain = float(m["loss"])
    _sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    atol, rtol = TOL["bfloat16"]
    line = {"phase": "dist", "run": "x3", "arch": cfg.name, "batch": B,
            "seq": S, "policy": "fsdp_tp", "mesh": list(mesh.shape),
            "losses": losses, "unsharded_first_loss": plain,
            "step_ms": ms, "unsharded_first_step_ms": plain_ms,
            "time_note": "host ms a step, synchronized; the first step of "
                         "each includes its first-call costs", "card": card}
    print(json.dumps(line), flush=True)
    if (abs(losses[0] - plain) > atol + rtol * abs(plain)
            or not all(np.isfinite(losses))):
        raise AssertionError(f"x3: {line}")
    return line


def dist_phase(card: str) -> dict:
    """(x1)-(x3) on a process group of one rank and a 1×1 mesh on the card
    (NCCL allows one rank a card; the multi-rank checks run on the CPU
    with gloo in tests/test_torch_dist.py).  Returns (x1)'s launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist_group()
    try:
        mesh = make_host_mesh()
        launches = dist_x1(mesh, card)
        _free_card()
        dist_x2(mesh, card)
        _free_card()
        dist_x3(mesh, card)
    finally:
        dist.destroy_process_group()
    return launches


GOLDEN_RECORDS = ROOT / "tests" / "golden" / "dispatch_records.json"
#: Lowering keys the serve phase's engine looks up (llama110m: 12 heads of
#: 64, d 768, 8 slots, pages of 16, buckets 16..512): a decode step's norms,
#: its paged attention and its GEMMs, and a bucket's prefill.
SERVE_KEYS = (("rmsnorm", (8, 768)), ("attention_paged", (8, 1, 12, 12, 544, 64)),
              ("matmul", (8, 768, 2048)), ("attention", (1, 128, 12, 12, 128, 64)),
              ("rmsnorm", (128, 768)))


def dispatch_phase() -> None:
    """The compile cache after the path phases: its stats (keys, matched,
    isax, pipelined, hit rate) and records (each key's kernel, plan and
    ring depth); the 11 golden keys on backend cuda against their golden
    impl, matched and target; each trace spec's saturation (host ms, a
    fresh dispatcher); the median host µs of a cached lookup at the serve
    phase's keys."""
    import torch
    from repro_torch.compile import (Dispatcher, LoweringConfig, OpKey,
                                     get_dispatcher)
    from repro_torch.targets import default_registry
    st = get_dispatcher().stats()
    records = [{k: r[k] for k in ("op", "shape", "dtype", "backend", "impl",
                                  "hits")}
               | ({k: r["schedule"][k] for k in ("kernel", "pipelined",
                                                 "plan", "depth",
                                                 "pipeline_gain")}
                  if r["schedule"] and "kernel" in r["schedule"] else {})
               for r in st["ops"]]
    print(json.dumps({"phase": "dispatch",
                      **{k: v for k, v in st.items() if k != "ops"},
                      "records": records}))
    golden = json.loads(GOLDEN_RECORDS.read_text())
    disp = Dispatcher()
    for g in golden:
        rec = disp.lower(OpKey(g["op"], tuple(g["shape"]), g["dtype"], "cuda"))
        got = (rec.impl, list(rec.matched), rec.target)
        if got != (g["impl"], g["matched"], g["target"]):
            raise AssertionError(f"golden key {g['op']}{tuple(g['shape'])}: "
                                 f"{got} != the golden record's")
    saturation_ms = {}
    fresh = Dispatcher()
    for spec in default_registry().specs():
        if spec.ops:
            t0 = time.perf_counter()
            fresh.match_outcome(spec)
            saturation_ms[spec.name] = (time.perf_counter() - t0) * 1e3
    lw = LoweringConfig("cuda")
    lookup_us, key_us = {}, {}
    for op, shape in SERVE_KEYS:
        lw.lower(op, shape, torch.float32)
        runs, kruns = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(2000):
                lw.lower(op, shape, torch.float32)
            runs.append((time.perf_counter() - t0) * 1e6 / 2000)
            t0 = time.perf_counter()
            for _ in range(2000):
                lw.dispatcher.lower(OpKey(op, shape, "float32", "cuda"))
            kruns.append((time.perf_counter() - t0) * 1e6 / 2000)
        lookup_us[f"{op}{shape}"] = sorted(runs)[2]
        key_us[f"{op}{shape}"] = sorted(kruns)[2]
    print(json.dumps({"phase": "dispatch", "golden_keys": len(golden),
                      "golden_ok": True, "saturation_host_ms": saturation_ms,
                      "cached_lookup_host_us": lookup_us,
                      "cached_lookup_host_us_median":
                          sorted(lookup_us.values())[len(lookup_us) // 2],
                      "opkey_lookup_host_us": key_us}))
    print(f"dispatch: {st['n_keys']} keys, {st['matched_keys']} matched, "
          f"{st['isax_keys']} isax, {st['pipelined_keys']} pipelined, hit "
          f"rate {st['hit_rate']:.4f}; golden keys OK; a cached lookup "
          f"{sorted(lookup_us.values())[len(lookup_us) // 2]:.3f} µs")


#: The kernels an ISAX's intrinsic may reach on the card (one of a pair).
EVAL_KERNELS = {
    "flash_attention": {"flash_attention", "flash_attention_pipelined"},
    "int8_matvec": {"int8_matmul", "int8_matmul_pipelined"},
    "ssd_step": {"ssd_scan", "ssd_scan_pipelined"},
    "rmsnorm": {"rmsnorm"}, "fps": {"fps"},
    "ball_query": {"ball_query", "ball_query_pipelined"},
    "group_agg": {"group_aggregate", "group_aggregate_pipelined"}}


def evaluate_phase() -> None:
    """Each of the seven target ISAXes behind the e-graph's extraction on
    the card: its trace program compiled (``compile_program``), the
    offloaded program evaluated with the intrinsics bound to the CUDA
    kernels, held to the software program under the numpy evaluators
    (``targets/cases.py``: exact for indices and the max-pool, the
    reference's atol 1e-5 / rtol 1e-4 for floats); the kernels it ran."""
    import torch
    from repro_torch.core.offload import compile_program, evaluate
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import kernel_intrinsics
    from repro_torch.pointcloud.ops import pointcloud_intrinsics
    from repro_torch.targets import cases, default_registry
    reg = default_registry()
    intrinsics = {**kernel_intrinsics("cuda"), **pointcloud_intrinsics("cuda")}
    for kind, (isax, _, _) in cases.CASES.items():
        prog = reg.spec_for_kind(kind).trace_program()
        res = compile_program(prog, reg.isaxes(), case=kind)
        if isax not in res.stats.matched_isaxes:
            raise AssertionError(f"evaluate {kind}: {isax} not matched")
        sw = cases.environment(kind)
        hw = cases.copy_env(sw)
        evaluate(prog, sw)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        evaluate(res.program, hw, intrinsics=intrinsics)
        torch.cuda.synchronize()
        ran = {n: c for n, c in _build.launch_counts().items() if c}
        if not ran or not set(ran) <= EVAL_KERNELS[isax]:
            raise AssertionError(f"evaluate {kind}: launches {ran}, want "
                                 f"one of {EVAL_KERNELS[isax]}")
        print(json.dumps({"phase": "evaluate", "trace": kind, "isax": isax,
                          "matched": res.stats.matched_isaxes,
                          "launches": ran,
                          "max_abs_err": cases.compare(kind, sw, hw)}))


#: Shapes at which the route phase times both kernels of a pair: the
#: Motivation's (K2/K3 at batch 1, K10/K11 and K12/K13 at (a), (b), (b)
#: bf16 and an SA2-like stage, K7/K8 at the SSM prefill), the serve buckets
#: at batch 1 and 8, (i2)'s projections at both row counts, the 40-token
#: prefill (the model moved it from K7 to K8) and K5/K4 at M = 8 in bf16.
ROUTE_CASES = (
    *[("attention", (B, S, 12, 12, S, 64), "float32")
      for B in (1, 8) for S in (128, 256, 512)],
    ("ball_query", "a", "float32"), ("ball_query", "b", "float32"),
    ("group_aggregate", "a", "float32"), ("group_aggregate", "b", "float32"),
    ("group_aggregate", "b-bf16", "bfloat16"),
    ("group_aggregate", "sa2", "float32"),
    ("ssd_scan", (4, 512, 80, 64, 128), "float32"),
    ("ssd_scan", (4, 40, 80, 64, 128), "float32"),
    *[("int8_matmul", (M, K, N), "float32")
      for M in (8, 512) for K, N in ((768, 2048), (768, 32000))],
    ("int8_matmul", (8, 768, 2048), "bfloat16"),
    # the families' new shapes: hd 128 GQA (granite), hd 256 with one KV
    # head under the prefix-LM mask (paligemma), the full mask over 1024
    # frames (seamless's encoder), zamba2's scan (fp32 as its model lowers
    # it, and bf16)
    *[("attention", (1, S, 32, 8, S, 128), "bfloat16") for S in (128, 512)],
    ("attention", (2, 320, 8, 1, 320, 256), "bfloat16", "prefix256"),
    ("attention", (2, 1024, 16, 16, 1024, 64), "bfloat16", "full"),
    ("ssd_scan", (4, 512, 64, 64, 64), "float32"),
    ("ssd_scan", (4, 512, 64, 64, 64), "bfloat16"),
)


def route_inputs(op: str, shape, dtype: str, gen, mask: str = "causal"):
    """(key shape, inputs, route call f(*inputs, pipelined=...), plain
    version g(*inputs)) of one route case on the card (attention under
    ``flash_mask(mask)``)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.pointcloud import ops as pcops
    from repro_torch.pointcloud import ref as pcref
    dt = getattr(torch, dtype)
    if op == "attention":
        B, S, H, K, T, hd = shape
        ins = [torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt),
               *[torch.randn((B, T, K, hd), generator=gen,
                             device="cuda").to(dt) for _ in range(2)],
               flash_mask(mask, S, T)]
        return (shape, ins,
                lambda q, k, v, m, **kw: kops.flash_attention_gqa(
                    q, k, v, m, sm_scale=hd ** -0.5, **kw),
                lambda q, k, v, m: kref.flash_attention_ref(
                    q, k, v, m, sm_scale=hd ** -0.5))
    if op == "ball_query":
        B, N, M, k, r = BALL_SWEEP[shape]
        return ((B, N, M, k), list(ball_sweep_inputs(shape)),
                lambda x, c, **kw: pcops.kernel_ball_query(x, c, r, k, **kw),
                lambda x, c: pcref.ball_query_ref(x, c, r, k))
    if op == "group_aggregate":
        B, N, M, k, C, _, _ = GROUP_SWEEP[shape]
        return ((B, N, M, k, C), list(group_sweep_inputs(shape)),
                pcops.kernel_group_aggregate, pcref.group_aggregate_ref)
    if op == "ssd_scan":
        BT, S, H, P, N = shape
        return (shape, ssd_inputs(BT, H, S, P, N, seed=1, dtype=dtype),
                kops.ssd_scan, kref.ssd_scan_ref)
    M, K, N = shape
    ins = [torch.randn((M, K), generator=gen, device="cuda").to(dt),
           torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                         dtype=torch.int8),
           torch.rand((N,), generator=gen, device="cuda") * 0.01 + 0.001]
    return shape, ins, kops.int8_matmul, kref.int8_matmul_ref


def route_phase() -> None:
    """At each ROUTE_CASES shape, both kernels of the pair at their plans
    (the route forced each way), each output held to the plain version,
    then timed cold in turns (A B B A, twice): the model's pick, its
    predicted µs for each kernel, both medians, and whether the pick is the
    faster (or within 3 %).  A timing disagreement is printed, not raised;
    a wrong output fails."""
    import numpy as np
    import torch
    from repro_torch.compile import LoweringConfig
    from repro_torch.core.interface_model import H100_CLOCK_HZ
    lw = LoweringConfig("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    summary = []
    for op, shape, dtype, *mask in ROUTE_CASES:
        key, ins, route, plain = route_inputs(op, shape, dtype, gen, *mask)
        rec = lw.lower(op, key, getattr(torch, dtype))
        sched = rec.schedule
        want = plain(*ins)
        flags = (False, True) if sched["pipe"] else (False,)
        for flag in flags:
            got = route(*ins, schedule=sched, pipelined=flag)
            if op in ("ball_query", "group_aggregate"):
                if not torch.equal(got, want):
                    raise AssertionError(f"route {op} {shape} pipelined="
                                         f"{flag}: differs from the plain "
                                         f"version")
                continue
            tol = (int8_tol(*ins) if op == "int8_matmul" else
                   {dtype: SSD_TOL} if op == "ssd_scan"
                   and dtype == "float32" else None)
            _check(f"route {op} {shape} pipelined={flag}", got, want, dtype,
                   tol)
        times = {f: [] for f in flags}
        for flag in (flags + flags[::-1]) * 2:
            times[flag].append(cold_ms(
                lambda *a, f=flag: route(*a, schedule=sched, pipelined=f),
                ins) * 1e3)
        med = {f: float(np.median(v)) for f, v in times.items()}
        pick = sched["pipelined"]
        line = {"phase": "route", "op": op, "shape": list(key),
                "case": shape if isinstance(shape, str) else None,
                "mask": mask[0] if mask else None,
                "dtype": dtype, "pick": sched["kernel"],
                "base": sched["base"]["kernel"],
                "pipe": sched["pipe"] and sched["pipe"]["kernel"],
                "plans": {"base": sched["base"]["plan"],
                          "pipe": sched["pipe"] and sched["pipe"]["plan"]},
                "predicted_us": {
                    "base": sched["est_serial_cycles"] / H100_CLOCK_HZ * 1e6,
                    "pipe": (sched["est_pipe_cycles"] / H100_CLOCK_HZ * 1e6
                             if sched["pipe"] else None)},
                "pipeline_gain": sched["pipeline_gain"],
                "cold_us": {"base": med[False], "pipe": med.get(True)},
                "cold_us_runs": {"base": times[False],
                                 "pipe": times.get(True)}}
        if sched["pipe"]:
            line["pick_is_faster"] = med[pick] <= med[not pick]
            line["pick_within_3pct"] = med[pick] <= 1.03 * med[not pick]
        print(json.dumps(line))
        summary.append((op, shape, dtype, line.get("pick_within_3pct")))
    missed = [s for s in summary if s[3] is False]
    print(f"route: {len(summary)} shapes, the pick within 3 % of the faster "
          f"kernel at {len(summary) - len(missed)}; missed {missed}")


def kernel_summary(rows: list[dict], launches: dict) -> list[dict]:
    """One entry per kernel: its main-path representative case (the shape
    where the main path gives it most work; for K6, which no path launches,
    the reference's main case) and the largest error over its cases in the
    main case's dtype."""
    import torch
    from repro_torch.kernels import _build, schedule
    from repro_torch.kernels.pipeline import sm_count, ssd_depth
    # granite-3-8b's prefill at bucket 512 (FAMILY_FLASH's first row)
    granite = schedule.flash_schedule(1, 512, 32, 8, 512, 128, 2,
                                      sm_count(torch.device("cuda")))
    main_case = {"rmsnorm": "R=2048 d=5120 bfloat16",   # (s2)'s gate_norm
                 # (i1)'s largest group: 8 prompts at bucket 512
                 "flash_attention":
                     "B=8 S=512 T=512 H=12 K=12 hd=64 float32 causal",
                 # the families phase's bf16 prefills, where the model
                 # picks it (llama110m's fp32 paths take K2)
                 "flash_attention_pipelined":
                     "S=512 T=512 H=32 K=8 hd=128 bfloat16 causal "
                     f"depth={granite['pipe']['depth']}",
                 # shape (a) for K9-K12 (K12 as run (c) takes it), (b) for
                 # K13
                 "fps": "a float32",
                 "ball_query": "a float32",
                 "ball_query_pipelined": "a float32 depth=4",
                 "group_aggregate": "a float32",
                 "group_aggregate_pipelined": "b float32",
                 "ssd_scan": "BT=4 H=80 S=16 P=64 N=128",
                 "ssd_scan_pipelined": "BT=4 H=80 S=512 P=64 N=128 "
                                       f"depth={ssd_depth(64, 128, 512)}",
                 # (i2)'s largest GEMM: the unembedding at each row count
                 "int8_matmul": "M=512 K=768 N=32000 float32",
                 "int8_matmul_pipelined": "M=8 K=768 N=32000 float32",
                 "flash_attention_int8kv":
                     "S=512 T=512 H=12 K=12 hd=64 float32 causal"}
    out = []
    for name, kern in _build.KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["case"] == main_case[name])
        err = max(r["max_abs_err"] for r in rows
                  if r["kernel"] == name and r["dtype"] == row["dtype"])
        out.append({"name": name, "route": "cuda", "source": kern.source,
                    "replaces": kern.replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": row["ms"],
                    "cold_ms": row.get("cold_ms"),
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "library_note": row.get("library_note"),
                    "case": row["case"]})
        for key in ("blocks_per_sm", "live_tiles", "chunk", "heads_per_block",
                    "cluster", "threads", "ppt", "us_per_step", "sms_used",
                    "cpw", "warps", "visited_share", "bound_visited_ms",
                    "tile_m", "tile_n", "split", "depth",
                    "bound_cuda_core_ms", "bound_tensor_core_ms",
                    "dequant_mm_ms", "dequant_sdpa_ms", "plan",
                    "gathered_bytes", "reuse", "l2_bound_us",
                    "registers", "spill_store_bytes"):
            if key in row:
                out[-1][key] = row[key]
    return out


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {"start": time.perf_counter() - t_start}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out
    print(json.dumps({"phase": "build", **timed("build", build_kernels)}))
    rows = timed("kernels", kernel_phase)
    launches = timed("serve", serve_phase)
    timed("sync_check", sync_check_phase)
    rows += timed("pointcloud_kernels", pointcloud_kernel_phase)
    timed("fps_sweep", fps_sweep_phase)
    timed("ball_sweep", ball_sweep_phase)
    timed("group_sweep", group_sweep_phase)
    pc_launches = timed("pointcloud", pointcloud_path_phase)
    rows += timed("ssm_kernels", ssm_kernel_phase)
    ssm_launches = timed("ssm", ssm_serve_phase)
    family_launches = timed("families", families_phase)
    rows += timed("int8_kernels", int8_kernel_phase)
    timed("int8_sweep", int8_sweep_phase)
    timed("k4_repeat", k4_repeat_phase)
    timed("int8kv_sweep", int8kv_sweep_phase)
    timed("int8kv_repeat", int8kv_repeat_phase)
    i1_launches, qtree = timed("int8_serve", int8_serve_phase)
    i2_launches = timed("int8_gemm", int8_gemm_phase, qtree)
    timed("train", train_phase)
    dist_launches = timed("dist", dist_phase, card)
    timed("dispatch", dispatch_phase)
    timed("evaluate", evaluate_phase)
    timed("route", route_phase)
    runs = (launches, pc_launches, ssm_launches, family_launches,
            i1_launches, i2_launches, dist_launches)
    launches = {n: sum(d.get(n, 0) for d in runs)
                for n in set().union(*runs)}
    print(json.dumps({"phase": "wall", "seconds": seconds,
                      "total_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernel_summary(rows, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
