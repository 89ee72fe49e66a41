"""A/B of K9 (farthest-point sampling) against an earlier ``fps.cu``, on one
card in one process.

The earlier source is the one-block design, with the entry point
``fps_launch(xyz, out, scratch, B, N, S, dtype, device, stream)`` that
keeps the distances in registers up to 8192 points and in ``scratch``
(B·N floats) above.  It is built beside this tree's kernel, both are held
exactly to ``fps_ref``, then timed on the same inputs in turns, A B B A
five times (``chip_smoke.device_ms``, 10 calls each), at the
set-abstraction shapes (a) and (b) and a large cloud.  Prints one JSON
line a shape: median and min-max warm µs of each, and the ratio of the
medians.  Needs a Hopper card and nvcc:

    git show <commit>:src/repro_torch/kernels/csrc/fps.cu > <ignored dir>/fps_old.cu
    PYTHONPATH=src python tools/fps_ab.py <ignored dir>/fps_old.cu
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: B, N, S: (a), (b) and a large cloud.
SHAPES = {"a": (2, 4096, 512), "b": (16, 1024, 512),
          "large": (1, 65536, 128)}
#: The earlier kernel's register capacity (one block of 1024 threads at 8
#: points a thread); above it its wrapper passed B·N floats of scratch.
OLD_REGISTER_POINTS = 8192


def build_old(src: pathlib.Path):
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "libfps_ab_old.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-1],
                        "-shared", "-I", str(_build.CSRC), "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc refused {src}:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).fps_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import numpy as np
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fps_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, pc_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    old_launch = build_old(pathlib.Path(sys.argv[1]))

    def old(xyz, S):
        B, N, _ = xyz.shape
        out = torch.empty((B, S), dtype=torch.int32, device=xyz.device)
        scratch = (torch.empty((B, N), dtype=torch.float32, device=xyz.device)
                   if N > OLD_REGISTER_POINTS else out)
        err = old_launch(_build.ptr(xyz), _build.ptr(out), _build.ptr(scratch),
                         B, N, S, DTYPE_CODES[xyz.dtype], xyz.device.index,
                         _build.stream_of(xyz))
        if err:
            raise RuntimeError(f"earlier fps: CUDA error {err}")
        return out

    for name, (B, N, S) in SHAPES.items():
        if name in ("a", "b"):
            xyz = pc_inputs(name)[0]
        else:
            xyz = torch.from_numpy(np.random.default_rng(0).normal(
                size=(B, N, 3)).astype(np.float32)).cuda()
        want = pcref.fps_ref(xyz, S)
        sides = {"old": lambda: old(xyz, S), "new": lambda: pck.fps(xyz, S)}
        for side, fn in sides.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"fps_ab {name}: {side} differs from "
                                     f"fps_ref")
        us = {"old": [], "new": []}
        for side in ("old", "new", "new", "old") * 5:
            us[side].append(device_ms(sides[side], 10) * 1e3)
        row = {"shape": name, "B": B, "N": N, "S": S,
               "card": torch.cuda.get_device_name(0)}
        for side, v in us.items():
            row[f"{side}_us_median"] = statistics.median(v)
            row[f"{side}_us_min_max"] = [min(v), max(v)]
        row["speedup"] = row["old_us_median"] / row["new_us_median"]
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
