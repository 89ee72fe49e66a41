"""Batched serving on the PyTorch port (paper §6.5): prefill + decode with a
KV cache, TTFT/ITL, fp against int8 weights (``ServeEngine``), then the
same prompts as requests to the continuous-batching engine (paged KV
cache, rolling admissions).  ``--ckpt-dir`` restores the weights of the
newest checkpoint there through ``repro_torch.train.checkpoint``, so it
serves what either package's trainer wrote.

    PYTHONPATH=src python examples/torch/serve_llm.py --smoke --device cpu --tokens 16
"""

import argparse

import numpy as np
import torch

from repro_torch.compile.config import VALID_BACKENDS, LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.scheduler import Request
from repro_torch.train import checkpoint as ckpt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama110m")
    ap.add_argument("--backend", default=None, choices=VALID_BACKENDS,
                    help="kernel lowering backend (default: "
                         "REPRO_ATTENTION_IMPL / REPRO_BACKEND env or "
                         "'cuda', the hand-written kernels)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--int8", action="store_true",
                    help="serve the continuous-batching section with int8 "
                         "weights (the fp/int8 comparison above always runs "
                         "both)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(f"{cfg.name} ({cfg.family}) needs 'prefix_embeds' "
                         f"beside its tokens; this example makes none")
    lowering = LoweringConfig(args.backend)
    params = None
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, mf = ckpt.load(args.ckpt_dir, device=args.device)
        params = tree["params"]
        print(f"restored step-{mf['step']} weights from {args.ckpt_dir}")
    max_len = args.prompt_len + args.tokens + 8
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)

    for mode, quant in (("fp", False), ("int8", True)):
        eng = ServeEngine(cfg, params=params, max_len=max_len,
                          quantize=quant, lowering=lowering,
                          device=args.device)
        toks, stats = eng.generate(
            {"tokens": torch.from_numpy(prompts)}, args.tokens)
        print(f"[{mode:5s}] TTFT {stats.ttft_s * 1e3:8.1f} ms | "
              f"ITL {stats.itl_s * 1e3:7.2f} ms | "
              f"{stats.tokens_per_s:7.1f} tok/s | out {tuple(toks.shape)}")

    # Continuous batching: the same prompts arrive as individual requests
    # (staggered arrivals, mixed output lengths) and share decode slots
    # through the paged KV cache.
    if cfg.family not in ("dense", "moe"):
        print(f"[cont ] skipped: no paged decode path for {cfg.family}")
        return
    bucket = args.prompt_len + (-args.prompt_len) % 16
    cmax_len = max(128, max_len, bucket + args.tokens)
    cmax_len += (-cmax_len) % 16
    ceng = ContinuousEngine(cfg, params=params, max_batch=args.batch,
                            page_size=16, max_len=cmax_len,
                            prompt_buckets=(16, 32, 64, bucket),
                            quantize=args.int8, lowering=lowering,
                            device=args.device)
    reqs = [Request(rid=i, prompt=prompts[i],
                    max_new_tokens=max(2, args.tokens // (1 + i % 3)),
                    arrival_step=2 * i)
            for i in range(args.batch)]
    wstats = ceng.run(reqs)
    print(f"[cont ] TTFT {wstats.mean_ttft_s * 1e3:8.1f} ms | "
          f"ITL {wstats.mean_itl_s * 1e3:7.2f} ms | "
          f"{wstats.tokens_per_s:7.1f} tok/s | "
          f"{wstats.total_tokens} tokens in {wstats.decode_steps} steps")


if __name__ == "__main__":
    main()
