#!/usr/bin/env python3
"""Where a K6 block's time goes: SM cycles between the phases of
``src/repro_torch/kernels/csrc/int8kv_tile.cuh``'s kernel, on the card.

The probe builds a copy of K6's sources into
``src/repro_torch/kernels/_build/probe/int8kv_trace/`` in which thread 0 of
every block reads ``clock64()`` at each phase boundary (text edits of the
kernel, checked to apply) and writes the readings to a device array:
kernel start, q's and the guessed tile's copies issued, the mask scan, the
prologue (tile 0 landed, q split, tile 0 widened), each K/V tile of the
block, and, under a split, the partial state stored, the first cluster
barrier, the combine and the last barrier.  It runs the instrumented K6 on
``chip_smoke.py``'s rows at every split plan and prints,
for the slowest block of each launch, the cycles of each phase.  The
readings are taken without a barrier, so a phase's cycles are those of
warp 0; the extra stores cost a few cycles a point.

    PYTHONPATH=src python tools/int8kv_phase_trace.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
POINTS = 64

EDITS = (  # (anchor, text inserted after it)
    ("namespace i8kv {\n",
     "__device__ unsigned long long g_trace[1 << 20];\n"
     "#define TR() do { if (threadIdx.x == 0 && tp < 63) tr[tp] = clock64(); ++tp; } while (0)\n"),
    ("  const int split = gridDim.z;\n",
     "  unsigned long long* tr = g_trace + ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x) * 64;\n  int tp = 0;\n  TR();\n"),
    ("  cp_async_commit();\n  Tile<HD, T> tile;\n", "  TR();\n"),
    ("    const int n = scan ? ll.n : 1;\n", "    TR();\n"),
    ("      widen(0);\n    }\n", "    TR();\n"),
    ("                [&] { widen(i + 1); });\n", "      TR();\n"),
    ("  if (live && threadIdx.x == 0) atomicAdd(live, computed);\n", "  TR();\n"),
    ("    tile.finalize(out, b, h, q0, S, H, hd, vs);\n", "    TR();\n    if (threadIdx.x == 0) tr[63] = tp;\n"),
    ("  tile.store_partial(acc_s, m_s, l_s);\n", "  TR();\n"),
    ("  cooperative_groups::this_cluster().sync();  // every rank's partial is written\n", "  TR();\n"),
    ("    combine<HD, T, 4>(acc_s, m_s, l_s, out, b, h, q0, S, H, hd, vs, rank);\n", "  TR();\n"),
    ("  cooperative_groups::this_cluster().sync();  // no rank's partial is still read\n",
     "  TR();\n  if (threadIdx.x == 0) tr[63] = tp;\n"),
)


def build(out_dir: pathlib.Path):
    """The instrumented K6, as (launch entry point, trace reader)."""
    from repro_torch.kernels import _build
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(_build.CSRC, out_dir)
    header = (out_dir / "int8kv_tile.cuh").read_text()
    for anchor, text in EDITS:
        if header.count(anchor) != 1:
            raise SystemExit(f"int8kv_phase_trace: {anchor.strip()!r} is not "
                             f"in the kernel once")
        header = header.replace(anchor, anchor + text)
    (out_dir / "int8kv_tile.cuh").write_text(header)
    cu = out_dir / "flash_attention_int8kv.cu"
    cu.write_text(cu.read_text() + (
        "\nREPRO_EXPORT int k6_trace_read(void* dst, int n) {\n"
        "  return cudaMemcpyFromSymbol(dst, i8kv::g_trace, n * sizeof(unsigned long long));\n"
        "}\n"))
    so = out_dir / "libk6_trace.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-1], "-shared",
                        "-o", str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc refused the instrumented K6:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.flash_attention_int8kv_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.k6_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return fn, lib.k6_trace_read


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("int8kv_phase_trace: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (INT8KV_SHAPES, card_line, int8kv_case_name,
                            int8kv_inputs)
    from repro_torch.kernels import _build, pipeline
    from repro_torch.kernels.flash_attention import DTYPE_CODES
    fn, read = build(_build.BUILD_DIR / "probe" / "int8kv_trace")
    card = card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for S, H, K, dtype, kind, hd in INT8KV_SHAPES:
        q, _, _, k8, v8, ks, vs, mask = int8kv_inputs(S, H, K, dtype, gen,
                                                      kind, hd)
        for plan in pipeline.int8kv_plans(1, S, S, H, K, hd, q.dtype):
            out = torch.empty_like(q)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            for _ in range(3):
                if fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(),
                      vs.data_ptr(), mask.data_ptr(), out.data_ptr(), 1, S, S, H,
                      K, hd, 1, hd ** -0.5, None, plan[0], DTYPE_CODES[q.dtype], 0,
                      stream):
                    raise RuntimeError("instrumented K6 refused the launch")
            torch.cuda.synchronize()
            blocks = H * -(-S // 64) * plan[0]
            buf = np.zeros(blocks * POINTS, dtype=np.uint64)
            if read(buf.ctypes.data, blocks * POINTS):
                raise RuntimeError("reading the trace failed")
            t = buf.reshape(blocks, POINTS).astype(np.int64)
            spans = [np.diff(t[i, :int(t[i, -1])]) for i in range(blocks)]
            total = [int(s.sum()) for s in spans]
            worst = int(np.argmax(total))
            tail = (["loop end", "finalize"] if plan[0] == 1 else
                    ["loop end", "partial stored", "first cluster barrier",
                     "combine", "last cluster barrier"])
            phases = spans[worst].tolist()
            n_tiles = len(phases) - 3 - len(tail)
            names = (["copies issued", "scan", "prologue"]
                     + [f"tile {i}" for i in range(n_tiles)] + tail)
            print(json.dumps({
                "case": int8kv_case_name(S, H, K, dtype, kind, hd),
                "plan": plan, "blocks": blocks,
                "slowest_block_cycles": total[worst],
                "median_block_cycles": float(np.median(total)),
                "phases_of_slowest": dict(zip(names, phases)),
                "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
