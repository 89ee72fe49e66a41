"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

The port's ``Trainer`` under ``run_with_restarts`` (auto-resume from the
newest checkpoint in ``--ckpt-dir``).  Runs on the card (``--device cuda``,
the default) unless ``--device cpu`` is given; TF32 is switched off so
fp32 matmuls stay fp32.  ``--smoke`` takes the reduced config.
``--compress-grads`` turns on AdamW's local int8 error-feedback
compression (``optim.adamw.compress_int8``); no gradient crosses a wire
here.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import available_configs, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import run_with_restarts
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=available_configs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    tc = TrainConfig(batch=args.batch, seq=args.seq,
                     microbatches=args.microbatches,
                     ckpt_dir=args.ckpt_dir, total_steps=args.steps,
                     optimizer=AdamWConfig(
                         lr=args.lr, compress_grads=args.compress_grads))
    tr = run_with_restarts(lambda: Trainer(cfg, tc, device=args.device),
                           args.steps)
    last = tr.metrics_log[-1] if tr.metrics_log else {}
    print(f"done: step={tr.step} loss={last.get('loss', float('nan')):.4f} "
          f"step_time={last.get('step_time', 0.0) * 1e3:.0f}ms")
    return tr


if __name__ == "__main__":
    main()
