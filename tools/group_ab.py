"""A/B of K12 and K13 (grouped aggregation) against earlier sources, on one
card in one process.

The earlier sources are PR 7's design (fp16 added later): K12 a thread an
output element, K13 the gathered rows through a ``cp.async`` ring, in
``group_tile.cuh``, ``group_aggregate.cu`` and
``group_aggregate_pipelined.cu`` in one directory, with the entry points
``group_aggregate_launch(f, idx, out, B, N, M, k, C, dtype, device,
stream)`` and ``group_aggregate_pipelined_launch(..., C, depth, dtype,
device, stream)``.  They are built beside this tree's kernels (the earlier
``group_tile.cuh`` found first, ``common.cuh`` from this tree), both sides
are held exactly to ``group_aggregate_ref``, then timed on the same inputs
in turns, A B B A five times (10 timings a side): warm
(``chip_smoke.device_ms``, 20 calls) and cold (``chip_smoke.cold_ms``,
inputs rotated past 4x the L2).  The cases are the set-abstraction
stage's, fp32, ball query's indices on the FPS samples: K12 and K13 at (a)
and (b), the earlier K13 at the ring depth its route gave it (2), the new
ones at their plans (``group_plan``).  Prints one JSON line a case: median
and min-max µs of each side, warm and cold, and the ratio of the medians.
Needs a Hopper card and nvcc:

    mkdir -p <ignored dir>/old_group
    for f in group_tile.cuh group_aggregate.cu group_aggregate_pipelined.cu; do
      git show <commit>:src/repro_torch/kernels/csrc/$f > <ignored dir>/old_group/$f
    done
    PYTHONPATH=src python tools/group_ab.py <ignored dir>/old_group
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: kernel, path shape
CASES = (("group_aggregate", "a"), ("group_aggregate", "b"),
         ("group_aggregate_pipelined", "a"),
         ("group_aggregate_pipelined", "b"))
OLD_DEPTH = 2


def build_old(src_dir: pathlib.Path) -> dict:
    """The earlier K12 and K13 entry points, built from ``src_dir``."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, extra in (("group_aggregate", []),
                        ("group_aggregate_pipelined", [I])):
        lib = _build.BUILD_DIR / f"lib{name}_ab_old.so"
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-1],
                            "-shared", "-I", str(src_dir), "-I",
                            str(_build.CSRC), "-o", str(lib),
                            str(src_dir / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc refused {name}.cu:\n{r.stdout}{r.stderr}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.argtypes = [P, P, P, I, I, I, I, I, *extra, I, I, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("group_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, cold_ms, device_ms, group_sweep_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    old_fns = build_old(pathlib.Path(sys.argv[1]))

    def old(name, f, idx):
        B, N, C = f.shape
        M, k = idx.shape[1], idx.shape[2]
        out = torch.empty((B, M, C), dtype=f.dtype, device=f.device)
        ring = [OLD_DEPTH] if name == "group_aggregate_pipelined" else []
        err = old_fns[name](_build.ptr(f), _build.ptr(idx), _build.ptr(out),
                            B, N, M, k, C, *ring, DTYPE_CODES[f.dtype],
                            f.device.index, _build.stream_of(f))
        if err:
            raise RuntimeError(f"earlier {name}: CUDA error {err}")
        return out

    def new(name, f, idx):
        return getattr(pck, name)(f, idx)

    card = card_line()
    for name, shape in CASES:
        f, idx = group_sweep_inputs(shape)
        want = pcref.group_aggregate_ref(f, idx)
        sides = {"old": old, "new": new}
        for side, fn in sides.items():
            if not torch.equal(fn(name, f, idx), want):
                raise AssertionError(f"group_ab {name} ({shape}): {side} "
                                     f"differs from group_aggregate_ref")
        us = {f"{s}_{t}": [] for s in sides for t in ("warm", "cold")}
        for side in ("old", "new", "new", "old") * 5:
            fn = sides[side]
            us[f"{side}_warm"].append(device_ms(
                lambda: fn(name, f, idx), 20) * 1e3)
            us[f"{side}_cold"].append(cold_ms(
                lambda a, b: fn(name, a, b), (f, idx)) * 1e3)
        B, N, C = f.shape
        row = {"kernel": name, "shape": shape, "old_depth": OLD_DEPTH
               if name == "group_aggregate_pipelined" else None,
               "B": B, "N": N, "M": idx.shape[1], "k": idx.shape[2], "C": C,
               "card": card}
        for key, v in us.items():
            row[f"{key}_us_median"] = statistics.median(v)
            row[f"{key}_us_min_max"] = [min(v), max(v)]
        for t in ("warm", "cold"):
            row[f"speedup_{t}"] = (row[f"old_{t}_us_median"]
                                   / row[f"new_{t}_us_median"])
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
