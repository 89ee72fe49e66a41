"""Point-cloud set abstraction launcher:
``python -m repro_torch.launch.pointcloud [--batch B --points N ...]``.

The port of ``examples/pointcloud.py`` ``system_side``: sample centers
(fps), gather them, group their neighbours (ball_query) and max-pool the
neighbours' features (group_aggregate), all through
``LoweringConfig("cuda")``; then check the result against the same stage
on backend ``torch`` and print each op's lowering decision and the kernels
it launched.  Runs on the card (``--device cuda``, the default) unless
``--device cpu`` is given, where the kernel wrappers compute their plain
versions.  Points and features are ``normal(0, 1)`` from numpy's seed 1,
as in the example.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.kernels import _build

PIPELINED = {"auto": None, "on": True, "off": False}


def set_abstraction(lowering: LoweringConfig, xyz, features, n_centers: int,
                    radius: float, k: int, *, pipelined: bool | None = None):
    """One set-abstraction stage: returns (sampled indices, centers,
    neighbour indices, aggregated features)."""
    sel = lowering.fps(xyz, n_centers)
    centers = torch.gather(
        xyz, 1, sel.long()[..., None].expand(-1, -1, xyz.shape[-1]))
    idx = lowering.ball_query(xyz, centers, radius, k, pipelined=pipelined)
    agg = lowering.group_aggregate(features, idx, pipelined=pipelined)
    return sel, centers, idx, agg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--points", type=int, default=128)
    ap.add_argument("--centers", type=int, default=32)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--radius", type=float, default=1.2)
    ap.add_argument("--pipelined", default="auto", choices=sorted(PIPELINED),
                    help="'auto': pipeline from two streamed tiles up; "
                         "'on'/'off' force the choice where the kernel runs")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass --device cpu to run "
                           "the plain versions on the CPU")

    B, N, M, K, C = (args.batch, args.points, args.centers, args.k,
                     args.channels)
    rng = np.random.default_rng(1)
    xyz = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32))
    xyz, feats = xyz.to(args.device), feats.to(args.device)

    lw = LoweringConfig("cuda")
    before = _build.launch_counts()
    got = set_abstraction(lw, xyz, feats, M, args.radius, K,
                          pipelined=PIPELINED[args.pipelined])
    launched = {n: c - before.get(n, 0)
                for n, c in _build.launch_counts().items()
                if c - before.get(n, 0)}
    want = set_abstraction(LoweringConfig("torch"), xyz, feats, M,
                           args.radius, K)
    ok = all(torch.equal(g, w) for g, w in zip(got, want))

    print(f"set abstraction on {args.device}: sample({M} of {N}) -> "
          f"group(k={K}, r={args.radius}) -> aggregate({C}ch), batch {B}: "
          f"parity vs backend torch {'OK' if ok else 'FAIL'}")
    for op, shape, dtype in (("fps", (B, N, M), xyz.dtype),
                             ("ball_query", (B, N, M, K), xyz.dtype),
                             ("group_aggregate", (B, N, M, K, C), feats.dtype)):
        rec = lw.lower(op, shape, dtype)
        print(f"  {op:16s} impl={rec.impl} ({rec.note})")
    print(f"  kernels launched: {launched or 'none (plain versions on CPU)'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
