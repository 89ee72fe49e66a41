"""Host time of the lowering decision and of the route it feeds, for the
``repro_torch`` of this tree or of another tree (``--src``: the ``src``
directory of an extracted tree), so that two trees can be compared on one
machine, in turns.

* ``us_a_lookup``: a repeated ``LoweringConfig("cuda").lower(op, shape,
  torch.float32)`` at the serve phase's keys (``chip_smoke.SERVE_KEYS``),
  after one lookup that warms it, as a continuous-batching step makes it.
  Median of 5 runs of 2000 lookups, µs a lookup, a key and over the keys.
* ``i2`` (where a card is at hand): run (i2)'s 85 int8 GEMMs (llama110m's
  7 projections a layer × 12 and the unembedding, random int8 weights)
  through ``LoweringConfig("cuda").int8_matmul`` at M = 512 and M = 8:
  the host µs a call of issuing the 85 behind a GPU spin, as
  ``chip_smoke.int8_gemm_phase`` times it, median of 21 rounds.

    PYTHONPATH=src python tools/lower_host_cost.py [--src _checkout/<tree>/src]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (K, N) of llama110m's projections and how many of each run (i2) has
I2_GEMMS = (((768, 768), 48), ((768, 2048), 24), ((2048, 768), 12),
            ((768, 32000), 1))


def i2_host_us(lw, rounds: int = 21) -> dict:
    """Median host µs a call of run (i2)'s 85 GEMMs at M = 512 and 8."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    weights = [(torch.randint(-127, 128, (N, K), generator=gen,
                              device="cuda", dtype=torch.int8),
                torch.rand((N,), generator=gen, device="cuda") * 0.01)
               for (K, N), n in I2_GEMMS for _ in range(n)]
    out = {}
    for M in (512, 8):
        xs = {K: torch.randn((M, K), generator=gen, device="cuda")
              for (K, _), _ in I2_GEMMS}
        for wq, scale in weights:                 # warm: first-call set-up
            lw.int8_matmul(xs[wq.shape[1]], wq, scale)
        torch.cuda.synchronize()
        runs = []
        for _ in range(rounds):
            torch.cuda._sleep(40_000_000)
            t0 = time.perf_counter()
            for wq, scale in weights:
                lw.int8_matmul(xs[wq.shape[1]], wq, scale)
            runs.append((time.perf_counter() - t0) * 1e6 / len(weights))
            torch.cuda.synchronize()
        out[f"M={M}"] = sorted(runs)[len(runs) // 2]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--lookups", type=int, default=2000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, args.src)
    import torch
    from chip_smoke import SERVE_KEYS
    from repro_torch.compile.config import LoweringConfig
    lw = LoweringConfig("cuda")
    per_key = {}
    for op, shape in SERVE_KEYS:
        lw.lower(op, shape, torch.float32)
        runs = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            for _ in range(args.lookups):
                lw.lower(op, shape, torch.float32)
            runs.append((time.perf_counter() - t0) * 1e6 / args.lookups)
        per_key[f"{op}{shape}"] = sorted(runs)[len(runs) // 2]
    vals = sorted(per_key.values())
    result = {"src": args.src, "us_a_lookup": per_key,
              "median_us": vals[len(vals) // 2]}
    if torch.cuda.is_available():
        result["i2_host_us_a_call"] = i2_host_us(lw)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
