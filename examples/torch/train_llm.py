"""End-to-end training on the PyTorch port: the paper's §6.5 model
(Llama-2-110M arch) on synthetic data with checkpointing, straggler
monitoring and auto-resume (``repro_torch.train``).

Full run on the card (the real 110M config):
    PYTHONPATH=src python examples/torch/train_llm.py --steps 300

Smoke run on the CPU (reduced config, seconds):
    PYTHONPATH=src python examples/torch/train_llm.py --smoke --device cpu --steps 30

The checkpoints it writes load in either package's trainer and in
``examples/torch/serve_llm.py --ckpt-dir``.
"""

import argparse
import json
import os

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import run_with_restarts
from repro_torch.train.trainer import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama110m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="runs/train_llm_torch")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tc = TrainConfig(
        batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        ckpt_every=25, total_steps=args.steps, warmup=min(20, args.steps // 5),
        optimizer=AdamWConfig(lr=3e-4, compress_grads=args.compress_grads))

    trainer = run_with_restarts(
        lambda: Trainer(cfg, tc, device=args.device), args.steps)
    log_path = os.path.join(args.ckpt_dir, "metrics.jsonl")
    os.makedirs(args.ckpt_dir, exist_ok=True)
    with open(log_path, "a") as f:
        for m in trainer.metrics_log:
            f.write(json.dumps(m) + "\n")
    first = trainer.metrics_log[0] if trainer.metrics_log else {}
    last = trainer.metrics_log[-1] if trainer.metrics_log else {}
    print(f"trained {args.arch}{' (reduced)' if args.smoke else ''} to step "
          f"{trainer.step} on {trainer.device}")
    print(f"loss {first.get('loss', float('nan')):.4f} -> "
          f"{last.get('loss', float('nan')):.4f}; "
          f"stragglers flagged: {len(trainer.monitor.events)}")
    print(f"metrics: {log_path}; checkpoints: {args.ckpt_dir}")


if __name__ == "__main__":
    main()
