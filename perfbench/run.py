"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA
cards.  Run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It finds the cell in ``BENCHMARK.json`` and the cell's files under
``perfbench/`` by name (``yardstick/cell.py``), sets the program up from
the seed, offers the cell's traffic for ``--seconds``, checks the served
tokens against the plain fp32 reference, and prints one JSON line last on
standard output: the end-to-end metrics with ``--trace 0``, the
per-layer metrics (and the device's busy time in a traced slice) with
``--trace 1``.  The numbers the check compares come last on standard
error and last in that line.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), and where the process holds
JAX or the JAX package once the window has closed.  Build and kernel
caches stay inside the checkout.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"
#: Top-level module names that may not be loaded (the JAX package is
#: ``repro``; the port, ``repro_torch``, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(spec, out: dict, trace: bool, kind: str) -> dict:
    """The result's JSON object, ``checks`` last."""
    from yardstick.cell import metrics, passed
    run = out["run"]
    result = {"correct": passed(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics(spec, run, trace),
              "device": {"platform": "gpu", "kind": kind,
                         "count": spec.chips,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    for p in (ROOT / "perfbench", ROOT / "src"):
        sys.path.insert(0, str(p))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    from yardstick.cell import load_spec, run_cell
    spec = load_spec(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        _say(f"{args.workload} needs {spec.chips} CUDA card(s); this "
             f"machine has {torch.cuda.device_count()}: no result")
        return 2
    import repro_torch  # noqa: F401  (fails here where the program is absent)

    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), T_BEGIN,
                   device="cuda")
    result = result_line(spec, out, bool(args.trace),
                         torch.cuda.get_device_name(0))

    bad = forbidden_modules()
    if bad:
        _say(f"the process holds {', '.join(bad)}: no result")
        return 3
    _say(f"card: {power_limit()}")
    for line in out["report"]:
        _say(line)
    for name, c in result["checks"].items():
        _say(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
