"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``.

``--continuous`` drives the paged-KV continuous-batching engine on a mixed-
length Poisson workload; the default drives the static-batch engine on a
uniform batch.  ``--int8`` quantizes every ≥2-D weight to int8 per tensor
and dequantizes it once, at load.  Runs on the card (``--device cuda``, the
default) unless ``--device cpu`` is given; TF32 is switched off so fp32
matmuls stay fp32.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compile.config import VALID_BACKENDS, LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import available_configs, get_config
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import make_poisson_workload


def continuous_buckets(prompt_len: int, page_size: int,
                       max_len: int) -> tuple[int, ...]:
    """Page-multiple prompt buckets, doubling until ``prompt_len`` is
    covered (a rounded-up page multiple closes the gap if doubling
    overshoots ``max_len``)."""
    buckets, m = [], 1
    while page_size * m <= max_len:
        buckets.append(page_size * m)
        if page_size * m >= prompt_len:
            break
        m *= 2
    if buckets[-1] < prompt_len:
        buckets.append(prompt_len + (-prompt_len) % page_size)
    return tuple(buckets)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=available_configs())
    ap.add_argument("--backend", default="cuda", choices=VALID_BACKENDS,
                    help="'cuda': the hand-written kernels; 'torch': plain "
                         "PyTorch versions everywhere")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights (per-tensor), dequantized at load")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a Poisson workload")
    ap.add_argument("--requests", type=int, default=16,
                    help="workload size for --continuous")
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    lowering = LoweringConfig(args.backend)

    if args.continuous:
        ps = args.page_size
        max_len = max(128, args.prompt_len + args.tokens + 16)
        max_len += (-max_len) % ps
        prompt_lens = tuple(sorted({max(4, args.prompt_len // 2),
                                    args.prompt_len}))
        out_lens = tuple(sorted({max(2, args.tokens // 4),
                                 max(2, args.tokens // 2), args.tokens}))
        eng = ContinuousEngine(
            cfg, max_batch=args.batch, page_size=ps, max_len=max_len,
            prompt_buckets=continuous_buckets(args.prompt_len, ps, max_len),
            quantize=args.int8, lowering=lowering, device=args.device)
        reqs = make_poisson_workload(args.requests, rate=2.0, vocab=cfg.vocab,
                                     prompt_lens=prompt_lens,
                                     out_lens=out_lens)
        stats = eng.run(reqs)
        print(f"arch={cfg.name} continuous int8={args.int8} "
              f"backend={args.backend} device={eng.device} "
              f"requests={stats.n_requests} "
              f"tokens={stats.total_tokens} "
              f"TTFT={stats.mean_ttft_s * 1e3:.1f}ms "
              f"ITL={stats.mean_itl_s * 1e3:.2f}ms "
              f"({stats.tokens_per_s:.1f} tok/s, "
              f"{stats.decode_steps} decode steps)")
        return stats

    eng = ServeEngine(cfg, max_len=args.prompt_len + args.tokens + 8,
                      quantize=args.int8, lowering=lowering,
                      device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    toks, stats = eng.generate({"tokens": prompts}, args.tokens)
    print(f"arch={cfg.name} int8={args.int8} backend={args.backend} "
          f"device={eng.device} out={toks.shape} TTFT={stats.ttft_s * 1e3:.1f}ms "
          f"ITL={stats.itl_s * 1e3:.2f}ms ({stats.tokens_per_s:.1f} tok/s)")
    return stats


if __name__ == "__main__":
    main()
