#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, then
serves full-width llama110m through the continuous-batching engine and
runs the point-cloud set-abstraction stage, and checks that each path went
through every one of its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. card: ``nvidia-smi`` name and power limit; TF32 off for fp32 parity.
2. build: every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, all at
   once.
3. kernels: K1 rmsnorm, K2 flash attention, K3 pipelined flash attention at
   the main path's shapes against their plain versions (fp32 atol 2e-5 /
   rtol 2e-4, bf16 2e-2: the reference's tests/test_kernels.py:18), one JSON
   line per case with device times (CUDA events around back-to-back
   launches queued behind a GPU spin, so host overhead is excluded), the
   plain version's and one PyTorch library call's time as a yardstick, and
   the bound: max(bytes / 3.35 TB/s, flops / peak), with fp32 work on the
   67 TFLOP/s CUDA-core rate and bf16 on the 989 TFLOP/s tensor cores.
4. serve: llama110m (12 layers, d 768, 12 heads, vocab 32000, fp32, random
   weights from seed 0) through ``ContinuousEngine`` on backend "cuda":
   16 Poisson requests, prompts up to 512, buckets 16..512, 8 slots, pages
   of 16.  Launch counts are zeroed just before the run and read just after;
   each of K1-K3 must have launched.  First-token logits of one request per
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
   theirs is null.  Then the set-abstraction stage (fps → gather
   → ball query → group aggregate) through ``LoweringConfig("cuda")``,
   held exactly against backend "torch", in three runs, each with launch
   counts zeroed just before and read just after: (a) the bench's full size
   (B=2, N=4096, M=512, k=16, C=64, r=0.9, normal(0,1) from seed 0);
   (b) PointNet++ SSG ModelNet40 SA1 (Qi et al., NeurIPS 2017: 1024 points,
   512 centers, r=0.2, 32 samples) at batch 16, C=64, points uniform in
   the unit ball; (c) run (a) with ``pipelined=False``.  Across the three,
   every one of K9-K13 must have launched.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without printing a
result when no CUDA device is visible or when run outside a checkout.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,      # fp32 on the CUDA cores
              "bfloat16": 989e12}    # bf16 dense on the tensor cores
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}
BUCKETS = (16, 32, 64, 128, 256, 512)
SERVE_KERNELS = ("rmsnorm", "flash_attention", "flash_attention_pipelined")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int) -> float:
    """Device time of one call: CUDA events around ``iters`` calls queued
    behind a GPU spin, so the host's launch overhead does not show."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s: the host queues every call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def _check(name: str, got, want, dtype: str) -> float:
    import torch
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off "
                             f"(max abs err {float(err.max()):.3e}, "
                             f"atol {atol}, rtol {rtol})")
    return float(err.max())


def rmsnorm_case(R: int, d: int, dtype: str, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    dt = getattr(torch, dtype)
    x = torch.randn((R, d), generator=gen, device="cuda").to(dt)
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    got = rmsnorm(x, g, eps=1e-6)
    torch.cuda.synchronize()
    err = _check(f"rmsnorm R={R} {dtype}", got, ref.rmsnorm_ref(x, g), dtype)
    g_lib = g.to(dt)
    nbytes = 2 * R * d * x.element_size() + d * 4
    flops = 4 * R * d
    return _row("rmsnorm", f"R={R} d={d} {dtype}", err,
                device_ms(lambda: rmsnorm(x, g, eps=1e-6), 100),
                device_ms(lambda: ref.rmsnorm_ref(x, g, eps=1e-6), 100),
                device_ms(lambda: F.rms_norm(x, (d,), g_lib, 1e-6), 100),
                nbytes, flops, dtype)


def _row(kernel, case, err, ms, plain_ms, library_ms, nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"kernel": kernel, "case": case, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dtype": dtype}


def flash_case(kernel: str, S: int, T: int, H: int, K: int, dtype: str, gen,
               mask_kind: str = "causal", depth: int = 0) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pipeline import flash_attention_pipelined
    dt = getattr(torch, dtype)
    B, hd = 1, 64
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dt)
    mask = torch.tril(torch.ones((S, T), dtype=torch.bool, device="cuda"),
                      diagonal=T - S)[None]
    if mask_kind == "fully_masked_rows":    # tests/test_kernels.py:45
        mask = torch.zeros((1, S, T), dtype=torch.bool, device="cuda")
        mask[:, :, :8] = True
        mask[:, :8, :] = False
    scale = hd ** -0.5
    if kernel == "flash_attention":
        run = lambda: flash_attention(q, k, v, mask, sm_scale=scale)  # noqa: E731
    else:
        run = lambda: flash_attention_pipelined(  # noqa: E731
            q, k, v, mask, sm_scale=scale, depth=depth)
    plain = lambda: ref.flash_attention_ref(q, k, v, mask, sm_scale=scale)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    case = (f"S={S} T={T} H={H} K={K} hd={hd} {dtype} {mask_kind}"
            + (f" depth={depth}" if depth else ""))
    err = _check(f"{kernel} {case}", got, plain(), dtype)
    if mask_kind == "fully_masked_rows" and float(got[0, :8].abs().max()) != 0:
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
    iters = 20 if S >= 256 else 50
    return _row(kernel, case, err, device_ms(run, iters),
                device_ms(plain, iters), device_ms(lib, iters), nbytes, flops,
                dtype)


def kernel_phase() -> list[dict]:
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for R in (8, *BUCKETS):                  # decode batch, prefill buckets
        rows.append(rmsnorm_case(R, 768, "float32", gen))
    rows.append(rmsnorm_case(512, 768, "bfloat16", gen))
    for S in (16, 64, 256, 512):
        rows.append(flash_case("flash_attention", S, S, 12, 12, "float32", gen))
    rows.append(flash_case("flash_attention", 128, 128, 12, 4, "float32", gen))
    rows.append(flash_case("flash_attention", 128, 128, 12, 12, "float32", gen,
                           "fully_masked_rows"))
    rows.append(flash_case("flash_attention", 256, 256, 12, 12, "bfloat16",
                           gen))
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
    for r in rows:
        print(json.dumps(r))
    return rows


def serve_phase() -> dict:
    import numpy as np
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import BLOCK_K
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

    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path: {launches}")
    # every norm of every prefill and decode step is K1; each prefill layer
    # runs K2 when its bucket is one 64-key tile and K3 when it is more;
    # no other kernel runs
    L = cfg.n_layers
    n_k3 = sum(-(-pick_bucket(r.prompt_len, BUCKETS) // BLOCK_K) >= 2
               for r in reqs)
    want = {n: 0 for n in launches}
    want.update({"rmsnorm": (2 * L + 1) * (len(reqs) + stats.decode_steps),
                 "flash_attention": L * (len(reqs) - n_k3),
                 "flash_attention_pipelined": L * n_k3})
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
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
                       "+ B*M*C*itemsize; ops = B*M*k*C compares",
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
            library_ms=None):
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
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_note": PC_LIBRARY.get(kernel.replace("_pipelined", ""),
                                          "no single PyTorch call"),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_formula": PC_FORMULA[kernel.replace("_pipelined", "")],
           "dtype": dtype}
    print(json.dumps(row))
    return row


def pointcloud_kernel_phase() -> list[dict]:
    import torch
    import torch.nn.functional as F
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    rows = []

    def clouds():
        """(case, xyz, centers, features, S/M, k, radius) per case."""
        for shape, dtype in (("a", "float32"), ("a", "bfloat16"),
                             ("b", "float32")):
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
            rows.append(_pc_row(
                "fps", case, pck.fps(xyz, M), sel,
                device_ms(lambda: pck.fps(xyz, M), 10),
                device_ms(lambda: pcref.fps_ref(xyz, M), 2),
                B * N * 3 * it + B * M * 4, 10 * B * N * (M - 1), dtype))
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
            nbytes, 10 * B * M * N, dtype))
        for depth in (2, 3, 4):
            run = lambda: pck.ball_query_pipelined(  # noqa: E731
                xyz, centers, r, k, depth=depth)
            rows.append(_pc_row(
                "ball_query_pipelined", f"{case} depth={depth}", run(), idx,
                device_ms(run, 20), plain, nbytes, 10 * B * M * N, dtype))
        f = feats.to(xyz.dtype)
        want = pcref.group_aggregate_ref(f, idx)
        rows_read = int(torch.unique(
            idx.long() + N * torch.arange(B, device="cuda")[:, None, None]).numel())
        nbytes = rows_read * C * it + B * M * k * 4 + B * M * C * it
        plain = device_ms(lambda: pcref.group_aggregate_ref(f, idx), 20)
        # library yardstick (never called by the port): one max-mode
        # embedding bag a center over the batch-flattened rows
        bags = (idx.long() + N * torch.arange(B, device="cuda")[:, None, None]
                ).view(B * M, k)
        table = f.view(B * N, C)
        lib = lambda: F.embedding_bag(bags, table, mode="max")  # noqa: E731
        if not torch.equal(lib().view(B, M, C), want):
            raise AssertionError(f"embedding_bag {case}: differs from the "
                                 f"plain version")
        lib_ms = device_ms(lib, 50)
        rows.append(_pc_row(
            "group_aggregate", case, pck.group_aggregate(f, idx), want,
            device_ms(lambda: pck.group_aggregate(f, idx), 50), plain,
            nbytes, B * M * k * C, dtype, lib_ms))
        for depth in (2, 3, 4):
            run = lambda: pck.group_aggregate_pipelined(f, idx, depth=depth)  # noqa: E731
            rows.append(_pc_row(
                "group_aggregate_pipelined", f"{case} depth={depth}", run(),
                want, device_ms(run, 50), plain, nbytes, B * M * k * C, dtype,
                lib_ms))
    return rows


def pointcloud_path_phase() -> dict:
    """Runs (a), (b), (c) of the set-abstraction stage; returns the launch
    counts summed over the three."""
    import torch
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.pointcloud import set_abstraction

    runs = (("a", "a", None), ("b", "b", None), ("c", "a", False))
    want_kernels = {
        "a": {"fps", "ball_query_pipelined", "group_aggregate"},
        "b": {"fps", "ball_query_pipelined", "group_aggregate_pipelined"},
        "c": {"fps", "ball_query", "group_aggregate"}}
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
        expect = {n: int(n in want_kernels[label]) for n in _build.KERNELS}
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
    print(f"pointcloud: runs (a), (b), (c) match backend torch; launches "
          f"{total}")
    return total


def kernel_summary(rows: list[dict], launches: dict) -> list[dict]:
    """One entry per kernel: its main-path representative case (the
    largest shape the main path gives it) and the largest fp32 error over
    all its cases."""
    from repro_torch.kernels import _build
    main_case = {"rmsnorm": "R=512 d=768 float32",
                 "flash_attention": "S=64 T=64 H=12 K=12 hd=64 float32 causal",
                 "flash_attention_pipelined":
                     "S=512 T=512 H=12 K=12 hd=64 float32 causal depth=4",
                 # shape (a) for K9-K12, (b) for K13, as the path takes them
                 "fps": "a float32",
                 "ball_query": "a float32",
                 "ball_query_pipelined": "a float32 depth=4",
                 "group_aggregate": "a float32",
                 "group_aggregate_pipelined": "b float32 depth=2"}
    out = []
    for name, kern in _build.KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and r["case"] == main_case[name])
        err = max(r["max_abs_err"] for r in rows
                  if r["kernel"] == name and r["dtype"] == "float32")
        out.append({"name": name, "route": "cuda", "source": kern.source,
                    "replaces": kern.replaces, "launches": launches[name],
                    "max_abs_err": err, "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "case": row["case"]})
    return out


def main() -> int:
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
    print(json.dumps({"phase": "build", **build_kernels()}))
    rows = kernel_phase()
    launches = serve_phase()
    rows += pointcloud_kernel_phase()
    pc_launches = pointcloud_path_phase()
    launches = {n: launches.get(n, 0) + pc_launches.get(n, 0)
                for n in set(launches) | set(pc_launches)}
    print(json.dumps({"kernels": kernel_summary(rows, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
