"""Find a continuous cell's knee: at each rate in turn, a fresh engine on
the same weights serves the cell's open-loop mix (ramp, then the window),
and one JSON line a rate gives the cell's own readers' TTFT and ITL tails
and tokens a second, and whether the backlog grew: requests waiting at
the window's open and close, and the median TTFT of the window's first
and second halves.  The cell's fixed rate is set once from this, at
about four fifths of the highest rate whose backlog does not grow.

    python3 perfbench/sweep.py --workload granite8b-chat --seed 1 \\
        --seconds 30 --rates 2 3 4 5
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "perfbench", ROOT / "src"):
        sys.path.insert(0, str(p))
    import torch
    from yardstick import drivers, traffic, weights
    from yardstick.cell import Run, build_engine, load_spec, model_config, \
        reader
    from yardstick.tracing import Tracer
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = load_spec(json.loads((ROOT / "BENCHMARK.json").read_text()),
                     args.workload)
    m = spec.config["port"]
    dev = torch.device("cuda")
    params = weights.draw(m, args.seed, dev)
    print(f"set-up {time.perf_counter() - T_BEGIN:.1f} s", file=sys.stderr)
    ramp = spec.cell["ramp_s"]
    for rate in args.rates:
        eng = build_engine(spec, model_config(m), params, dev)
        plan = traffic.open_schedule(spec.mix, rate, ramp, args.seconds,
                                     args.seed, m["vocab"])
        t0 = time.perf_counter()
        t_open, t_close = t0 + ramp, t0 + ramp + args.seconds
        reqs, steps = drivers.serve_open(eng, plan, t0, t_close,
                                         Tracer(False, dev), t_close, False)
        run = Run(m, spec.cell, args.seconds, t_open, t_close, t_close, 0.0,
                  reqs, steps)
        line = {"rate": rate, "due": len(run.due_in_window())}
        line.update({k: reader(k)(run) for k in (
            "ttft_p90_ms", "itl_p95_ms", "out_tokens_per_s")})
        mid = (t_open + t_close) / 2
        line["ttft_p50_halves_ms"] = [
            1e3 * statistics.median(h) for h in (
                [(min(r.t_first or t_close, t_close)) - r.due
                 for r in run.due_in_window() if (r.due < mid) == first]
                for first in (True, False)) if h]
        line["waiting_at_open_close"] = [
            sum(r.due <= t and (r.t_first is None or r.t_first > t)
                for r in reqs) for t in (t_open, t_close)]
        line["active_at_close"] = len(eng.scheduler.slots)
        line["steps"] = len(steps)
        print(json.dumps(line), flush=True)
        del eng
        gc.collect()   # the engine's decode closure holds it in a cycle
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
