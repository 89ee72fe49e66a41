"""Where a training step of the port's ``Trainer`` spends its time on the
card.

Builds the Trainer (backend "torch", TF32 off) on a full-width config,
runs ``--warmup`` steps, then:

* ``phases``: ``--steps`` steps split by ``torch.cuda.synchronize`` into
  the forward + backward (``loss_and_grads``) and the AdamW update
  (``apply_updates``), wall ms each (median);
* ``profile``: ``--steps`` more under ``torch.profiler`` (CPU and CUDA
  activities): the device's busy ms a step (the kernels' summed self
  time), the host's wall ms a step, the device's idle share (1 − busy /
  wall), kernel launches a step, and the ``--top`` ops by device time.

    PYTHONPATH=src python tools/train_profile.py [--arch llama110m]

Prints one JSON line a part; run it on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama110m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.optim import schedule
    from repro_torch.optim.adamw import apply_updates
    from repro_torch.train.trainer import TrainConfig, Trainer, loss_and_grads

    cfg = get_config(args.arch)
    tc = TrainConfig(batch=args.batch, seq=args.seq)
    tr = Trainer(cfg, tc, device="cuda")
    tr.train(args.warmup)
    batch = tr._device_batch(0)

    fwd_bwd, update = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(tr.model, tr.params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lr = schedule.warmup_cosine(tr.opt_state["step"], warmup=tc.warmup,
                                    total=tc.total_steps)
        tr.params, tr.opt_state, _ = apply_updates(
            tr.params, grads, tr.opt_state, tc.optimizer, lr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fwd_bwd.append((t1 - t0) * 1e3)
        update.append((t2 - t1) * 1e3)
        del grads
    print(json.dumps({"part": "phases", "arch": cfg.name,
                      "batch": args.batch, "seq": args.seq,
                      "forward_backward_ms": statistics.median(fwd_bwd),
                      "adamw_ms": statistics.median(update),
                      "card": torch.cuda.get_device_name(0)}))

    from torch.profiler import ProfilerActivity, profile
    step = tr._step_fn
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tr.params, tr.opt_state, m = step(tr.params, tr.opt_state, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
        / args.steps
    ops = sorted(prof.key_averages(), key=_device_us, reverse=True)
    top = [{"op": e.key, "device_ms_a_step": _device_us(e) / 1e3 / args.steps,
            "calls_a_step": e.count / args.steps}
           for e in ops[:args.top] if _device_us(e) > 0]
    print(json.dumps({"part": "profile", "arch": cfg.name,
                      "wall_ms_a_step": wall_ms,
                      "device_busy_ms_a_step": busy_ms,
                      "device_idle_share": (1 - busy_ms / wall_ms
                                            if wall_ms else None),
                      "kernel_launches_a_step": len(kernels) / args.steps,
                      "top": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
