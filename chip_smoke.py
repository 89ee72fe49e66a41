#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, then
serves full-width llama110m through the continuous-batching engine and
checks that the main path went through every kernel.

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

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path: {launches}")
    # every norm of every prefill and decode step is K1; each prefill layer
    # runs K2 when its bucket is one 64-key tile and K3 when it is more
    L = cfg.n_layers
    n_k3 = sum(-(-pick_bucket(r.prompt_len, BUCKETS) // BLOCK_K) >= 2
               for r in reqs)
    want = {"rmsnorm": (2 * L + 1) * (len(reqs) + stats.decode_steps),
            "flash_attention": L * (len(reqs) - n_k3),
            "flash_attention_pipelined": L * n_k3}
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


def kernel_summary(rows: list[dict], launches: dict) -> list[dict]:
    """One entry per kernel: its main-path representative case (the
    largest shape the main path gives it) and the largest fp32 error over
    all its cases."""
    from repro_torch.kernels import _build
    main_case = {"rmsnorm": "R=512 d=768 float32",
                 "flash_attention": "S=64 T=64 H=12 K=12 hd=64 float32 causal",
                 "flash_attention_pipelined":
                     "S=512 T=512 H=12 K=12 hd=64 float32 causal depth=4"}
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
    print(json.dumps({"kernels": kernel_summary(rows, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
