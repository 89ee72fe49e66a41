#!/usr/bin/env python3
"""Host and device cost of the quantized-GEMM entry point
``LoweringConfig("cuda").int8_matmul`` on the card, at the 85 projections
of run (i2) in ``chip_smoke.py`` (llama110m's 12 layers x (4 of 768 -> 768,
2 of 768 -> 2048, 1 of 2048 -> 768) and the 768 -> 32000 unembedding; int8
weights and fp32 scales drawn from seed 0, fp32 x) at M = 512 and M = 8.

    python tools/int8_host_cost.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(default: this checkout's), so that two trees can be compared in one
process launch each on one card.  For each M it prints, as the median of
seven rounds: the host's µs a call (the 85 calls queued behind a GPU spin,
so the host never waits on the card), the card's µs for the 85 calls back
to back (CUDA events around them), and the wall ms of the 85 calls and a
synchronize with nothing queued before them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

SHAPES = [(768, 768)] * 4 + [(768, 2048)] * 2 + [(2048, 768)]  # (K, N)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("int8_host_cost: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.compile.config import LoweringConfig
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = SHAPES * 12 + [(768, 32000)]
    weights = [(torch.randint(-127, 128, (N, K), generator=gen,
                              device="cuda", dtype=torch.int8),
                0.001 + 0.019 * torch.rand((N,), generator=gen,
                                           device="cuda"))
               for K, N in shapes]
    lw = LoweringConfig("cuda")
    for M in (512, 8):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda")
              for K in (768, 2048)}

        def run():
            return [lw.int8_matmul(xs[wq.shape[1]], wq, scale)
                    for wq, scale in weights]
        run()
        torch.cuda.synchronize()
        host, device, wall = [], [], []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(40_000_000)
            start.record()
            t0 = time.perf_counter()
            run()
            host.append((time.perf_counter() - t0) * 1e6 / len(weights))
            end.record()
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end) * 1e3)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"src": args.src, "M": M, "gemms": len(weights),
                          "host_us_a_call": statistics.median(host),
                          "device_us_85_gemms": statistics.median(device),
                          "wall_ms_85_gemms": statistics.median(wall),
                          "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
