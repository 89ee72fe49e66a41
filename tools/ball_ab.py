"""A/B of K10 and K11 (ball query) against earlier sources, on one card in
one process.

The earlier sources are PR 7's one-warp-a-center design (fp16 added later):
``ball_tile.cuh``, ``ball_query.cu`` and ``ball_query_pipelined.cu`` in one
directory, with the entry points ``ball_query_launch(xyz, centers, out, B,
N, M, k, r2, dtype, device, stream)`` and
``ball_query_pipelined_launch(..., r2, depth, dtype, device, stream)``.
They are built beside this tree's kernels (the earlier ``ball_tile.cuh``
found first, ``common.cuh`` from this tree), both sides are held exactly to
``ball_query_ref``, then timed on the same inputs in turns, A B B A five
times: warm (``chip_smoke.device_ms``, 20 calls) and cold
(``chip_smoke.cold_ms``, inputs rotated past 4x the L2).  The cases are
the set-abstraction stage's: K11 at (a) and (b) at the ring depth the
route gives it (4), K10 at (a) (run (c)), fp32, the FPS samples as
centers.  Prints one JSON line a case: median and min-max µs of each side,
warm and cold, and the ratio of the medians.  Needs a Hopper card and nvcc:

    mkdir -p <ignored dir>/old_ball
    for f in ball_tile.cuh ball_query.cu ball_query_pipelined.cu; do
      git show <commit>:src/repro_torch/kernels/csrc/$f > <ignored dir>/old_ball/$f
    done
    PYTHONPATH=src python tools/ball_ab.py <ignored dir>/old_ball
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: kernel, path shape, ring depth (0: K10)
CASES = (("ball_query_pipelined", "a", 4), ("ball_query_pipelined", "b", 4),
         ("ball_query", "a", 0))


def build_old(src_dir: pathlib.Path) -> dict:
    """The earlier K10 and K11 entry points, built from ``src_dir``."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for name, extra in (("ball_query", []), ("ball_query_pipelined", [I])):
        lib = _build.BUILD_DIR / f"lib{name}_ab_old.so"
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-1],
                            "-shared", "-I", str(src_dir), "-I",
                            str(_build.CSRC), "-o", str(lib),
                            str(src_dir / f"{name}.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc refused {name}.cu:\n{r.stdout}{r.stderr}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.argtypes = [P, P, P, I, I, I, I, F, *extra, I, I, P]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ball_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cold_ms, device_ms, pc_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    old_fns = build_old(pathlib.Path(sys.argv[1]))

    def old(name, xyz, centers, r, k, depth):
        B, N, _ = xyz.shape
        M = centers.shape[1]
        out = torch.empty((B, M, k), dtype=torch.int32, device=xyz.device)
        ring = [depth] if depth else []
        err = old_fns[name](_build.ptr(xyz), _build.ptr(centers),
                            _build.ptr(out), B, N, M, k,
                            pcref.squared_radius(r), *ring,
                            DTYPE_CODES[xyz.dtype], xyz.device.index,
                            _build.stream_of(xyz))
        if err:
            raise RuntimeError(f"earlier {name}: CUDA error {err}")
        return out

    def new(name, xyz, centers, r, k, depth):
        if depth:
            return pck.ball_query_pipelined(xyz, centers, r, k, depth=depth)
        return pck.ball_query(xyz, centers, r, k)

    for name, shape, depth in CASES:
        xyz, _, M, k, r = pc_inputs(shape)
        sel = pcref.fps_ref(xyz, M).long()
        centers = torch.gather(xyz, 1, sel[..., None].expand(-1, -1, 3))
        want = pcref.ball_query_ref(xyz, centers, r, k)
        sides = {"old": old, "new": new}
        for side, fn in sides.items():
            if not torch.equal(fn(name, xyz, centers, r, k, depth), want):
                raise AssertionError(f"ball_ab {name} ({shape}): {side} "
                                     f"differs from ball_query_ref")
        us = {f"{s}_{t}": [] for s in sides for t in ("warm", "cold")}
        for side in ("old", "new", "new", "old") * 5:
            fn = sides[side]
            us[f"{side}_warm"].append(device_ms(
                lambda: fn(name, xyz, centers, r, k, depth), 20) * 1e3)
            us[f"{side}_cold"].append(cold_ms(
                lambda p, c: fn(name, p, c, r, k, depth), (xyz, centers)) * 1e3)
        row = {"kernel": name, "shape": shape, "depth": depth,
               "B": xyz.shape[0], "N": xyz.shape[1], "M": M, "k": k,
               "card": torch.cuda.get_device_name(0)}
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
