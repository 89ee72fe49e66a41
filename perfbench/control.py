"""Readings that a cell's correctness limits are set from: for each seed,
one run of the cell's timed path at its own load (set-up, ramp,
``--seconds`` of window), the numbers its check compares (``logit_gap``
over the served sample, ``kv_error`` of the cache at the close), and, for
the first ``--control`` seeds, the control's: the fp32 reference at fp8
put in the program's place, read at the same prompts and served tokens
(the gap of the token fp8 puts first; its K and V).  ``--fault`` plants
one of ``yardstick/faults.py``'s faults in the program for every seed.
All seeds run in one process.

    python3 perfbench/control.py --workload granite8b-chat --seconds 40 \\
        --control 3 --seeds 11 12 13 14
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "perfbench", ROOT / "src"):
        sys.path.insert(0, str(p))
    import torch
    from yardstick.cell import load_spec, metrics, passed, run_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = load_spec(json.loads((ROOT / "BENCHMARK.json").read_text()),
                     args.workload)
    if args.fault:
        from yardstick.faults import plant
        plant(args.fault)
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = run_cell(spec, seed, args.seconds, False, t0, device="cuda",
                       quant_control=k < args.control)
        print(json.dumps({
            "seed": seed, "fault": args.fault,
            "correct": passed(out["checks"]),
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "control": out["control"], "report": out["report"],
            "metrics": {k: v["value"] for k, v in
                        metrics(spec, out["run"], False).items()},
            "s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
