"""A/B of the TMA rings' ``fence.proxy.async`` against an earlier tree's
sources without it, on one card in one process.

K4 (``int8_matmul.cu``), K5 (``int8_matmul_pipelined.cu``), K8
(``ssd_scan_pipelined.cu``) and K11 (``ball_query_pipelined.cu``) refill a
ring slot by TMA after the block's generic loads have read it; each now
fences the async proxy before the refill (``tools/int8_ring_race.py``
shows a ring without the fence giving wrong tiles).  The earlier
sources (every file of ``csrc/`` of one commit, in one directory;
``--extract COMMIT DIR`` writes them with ``git show``: the card's
machine has no git) are built into libraries of their own, and each of
the four kernels runs through this tree's own wrapper with its entry
point swapped to the earlier library's (the C signatures are the same),
at the main path's shapes:

- K4 at run (i2)'s four projections at M = 512 and K5 at M = 8 (K x N
  768 x 768, 768 x 2048, 2048 x 768, 768 x 32000), fp32 and bf16, the
  plan rule's plan;
- K8 at the mamba2-2.7b serving prefill (``chip_smoke.SSD_MAIN``) and
  zamba2-1.2b's scan, fp32 and bf16, at ``ssd_plan``'s depth;
- K11 at set-abstraction shapes (a) and (b), fp32, ring depth 4.

Both sides' outputs must be the same bits (K11's also equal to
``ball_query_ref``); then warm (``chip_smoke.device_ms``, 20 calls) and
cold (``chip_smoke.cold_ms``, inputs rotated past 4x the L2) µs in turns,
before, after, after, before, five times.  Prints one JSON line a case
(median and min-max µs of each side, the card's name and power limit)
and exits 1 if any case's bits differ.  Needs a Hopper card and nvcc:

    python tools/ring_fence_ab.py --extract <commit> <ignored dir>/fence_before
    PYTHONPATH=src python tools/ring_fence_ab.py <ignored dir>/fence_before
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
#: The libraries whose rings gained the fence.
LIBS = ("int8_matmul", "int8_matmul_pipelined", "ssd_scan_pipelined",
        "ball_query_pipelined")
#: Run (i2)'s projections: (K, N).
I2_SHAPES = ((768, 768), (768, 2048), (2048, 768), (768, 32000))


def extract(commit: str, out_dir: pathlib.Path) -> None:
    """Every file of ``csrc/`` as of ``commit`` into ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    names = subprocess.run(
        ["git", "ls-tree", "--name-only", f"{commit}:{CSRC}"], cwd=ROOT,
        check=True, capture_output=True, text=True).stdout.split()
    for f in names:
        text = subprocess.run(["git", "show", f"{commit}:{CSRC}/{f}"],
                              cwd=ROOT, check=True, capture_output=True,
                              text=True).stdout
        (out_dir / f).write_text(text)


def build_before(src_dir: pathlib.Path) -> dict:
    """The earlier libraries, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    out = src_dir / "_ab_build"
    out.mkdir(exist_ok=True)
    procs = {}
    for name in LIBS:
        lib = out / f"lib{name}_before.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(src_dir), "-o", str(lib), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc refused the earlier {name}.cu:\n{log}")
        dll = ctypes.CDLL(str(lib))
        dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
        dll.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = dll
    return libs


def entries(kernel, before_lib) -> dict:
    """This tree's and the earlier library's (lib, entry point) of one
    ``_build.CudaKernel``."""
    after = kernel._entry()
    fn = getattr(before_lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return {"before": (before_lib, fn), "after": after}


def cases():
    """(case, kernel name, inputs, call, the reference's output or None)
    of every case, inputs on the card."""
    import torch

    from chip_smoke import SSD_MAIN, pc_inputs, ssd_inputs
    from repro_torch.kernels import pipeline
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.pointcloud import kernels as pck
    from repro_torch.pointcloud import ref as pcref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        for M, kname in ((512, "int8_matmul"), (8, "int8_matmul_pipelined")):
            for K, N in I2_SHAPES:
                ins = (torch.randn((M, K), generator=gen,
                                   device="cuda").to(dtype),
                       torch.randint(-127, 128, (N, K), generator=gen,
                                     device="cuda", dtype=torch.int8),
                       0.001 + 0.019 * torch.rand((N,), generator=gen,
                                                  device="cuda"))
                pipelined = kname == "int8_matmul_pipelined"
                plan = pipeline.int8_plan(M, N, K, ins[0].element_size(),
                                          pipelined=pipelined)
                call = (pipeline.int8_matmul_pipelined if pipelined
                        else int8_matmul)
                yield (dict(M=M, K=K, N=N, dtype=dname, plan=list(plan)),
                       kname, ins,
                       lambda x, w, s, c=call, p=plan: c(x, w, s, _plan=p),
                       None)
    for BT, H, S, P, N in (SSD_MAIN, (4, 64, 512, 64, 64)):
        for dname in ("float32", "bfloat16"):
            ins = ssd_inputs(BT, H, S, P, N, seed=S + BT, dtype=dname)
            depth = pipeline.ssd_plan(P, N, S, ins[0].element_size())
            yield (dict(BT=BT, H=H, S=S, P=P, N=N, dtype=dname, depth=depth),
                   "ssd_scan_pipelined", ins,
                   lambda *a, d=depth: pipeline.ssd_scan_pipelined(*a, depth=d),
                   None)
    for shape in ("a", "b"):
        xyz, _, M, k, r = pc_inputs(shape)
        sel = pcref.fps_ref(xyz, M).long()
        centers = torch.gather(xyz, 1, sel[..., None].expand(-1, -1, 3))
        yield (dict(shape=shape, B=xyz.shape[0], N=xyz.shape[1], M=M, k=k,
                    depth=4),
               "ball_query_pipelined", (xyz, centers),
               lambda p, c, r=r, k=k: pck.ball_query_pipelined(p, c, r, k,
                                                               depth=4),
               pcref.ball_query_ref(xyz, centers, r, k))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", help="directory of the earlier csrc/")
    ap.add_argument("--extract", nargs=2, metavar=("COMMIT", "DIR"))
    args = ap.parse_args()
    if args.extract:
        extract(args.extract[0], pathlib.Path(args.extract[1]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ring_fence_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.src is None:
        ap.error("the directory of the earlier sources is required")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, cold_ms, device_ms
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    before = build_before(pathlib.Path(args.src))
    card = card_line()
    differ = 0
    for case, kname, ins, call, want in cases():
        kernel = _build.KERNELS[kname]
        sides = entries(kernel, before[kernel.lib])
        outs = {}
        for side, entry in sides.items():
            kernel._fn = entry
            outs[side] = call(*ins)
        torch.cuda.synchronize()
        same = torch.equal(outs["before"], outs["after"]) and (
            want is None or torch.equal(outs["after"], want))
        differ += not same
        us = {f"{s}_{t}": [] for s in sides for t in ("warm", "cold")}
        for side in ("before", "after", "after", "before") * 5:
            kernel._fn = sides[side]
            us[f"{side}_warm"].append(device_ms(lambda: call(*ins), 20,
                                                spin=20_000_000) * 1e3)
            us[f"{side}_cold"].append(cold_ms(call, ins) * 1e3)
        kernel._fn = sides["after"]
        row = {"kernel": kname, **case, "bits_equal": same, "card": card}
        for key, v in us.items():
            row[f"{key}_us_median"] = statistics.median(v)
            row[f"{key}_us_min_max"] = [min(v), max(v)]
        print(json.dumps(row), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
