"""Fault 2 of ROADMAP queue 3: the wrong tiles of an earlier K5.

Commit a5ed5d9's K5 (``csrc/int8_matmul_pipelined.cu``: a producer warp
keeps a TMA ring of wq tiles full, each consumer warp releases a slot
with one arrival on an ``empty`` mbarrier) gave wrong tiles now and then
where two or more blocks shared an SM (K = 2048, M > 8).  K4 still
releases its slots one arrival a warp on the same ``csrc/tma.cuh``
helpers.  This tool rebuilds that K5 from its own sources, as it was and
in variants that each remove one candidate cause, and counts the wrong
launches of every variant at the shapes where the card's tests failed:

- ``as_is``: the earlier K5 unchanged;
- ``drain``: the producer thread waits for its own last ``depth`` copies
  to land before it leaves, so no warp exits with bulk copies in flight;
- ``inval``: the whole block stays to the end and thread 0 invalidates
  every mbarrier (``mbarrier.inval``) before the block exits;
- ``lockstep``: the consumer warps meet at a named barrier before each
  release, so no waiter can fall a whole phase behind (parity aliasing);
- ``tags``: the producer writes the stage's number beside its slot before
  the copy and every consumer counts the waits that returned on another
  stage's phase (a detector of parity aliasing; the kernel is unchanged
  otherwise);
- ``sync_after_wait``: the consumer warps meet at a named barrier after
  each wait on a full slot, before any of them reads it (the block
  barrier there is what today's K5 has);
- ``one_block``: each block asks for the most dynamic shared memory, so
  that one block runs an SM (a control: the kernel is unchanged);
- ``proxy``: ``fence.proxy.async`` between the consumers' generic reads of
  a slot and its release, and between the producer's wait and the TMA
  write that refills the slot;
- ``proxy_consumer`` / ``proxy_producer``: only the consumers' fence, or
  only the producer's;
- ``fence_cta``: ``fence.acq_rel.cta`` (a fence of the generic proxy
  alone) where ``proxy`` puts its fences, a control for a fence's delay;
- ``converge``: the producer warp reconverges (``__syncwarp``) before the
  block barrier ahead of the split-K epilogue: ``__syncthreads`` is
  ``bar.sync``, an ``.aligned`` barrier that the whole warp must execute
  together, and the earlier K5 reached it with lane 0 still in its
  issuing loop.

Each variant runs every K5 plan the earlier tree built (tile_m 8/16/32,
tile_n 64/128, split 1/2/4/8, depth 2/3/4/6/8, those whose shared memory
fits) at M 100 and 513, N 1000 and 32000, K 2048, in fp32, bf16 and fp16,
``--repeats`` times each, against ``kernels/ref.int8_matmul_ref`` at the
card tests' tolerance (fp32: K ulps of the largest product; bf16 and
fp16: atol 0.5, rtol 2e-2), with the plan's blocks an SM from the
occupancy query.  Prints one JSON line a variant and dtype, then one
summary line a variant (launches, wrong launches, wrong launches at one
block an SM and at two or more, the plans that were wrong, and
``misses``: the waits ``tags`` found on another stage's phase).
Exits 1 if ``as_is`` shows no wrong launch (the fault not reproduced).

``--shape M,N,K``, ``--dtype`` and ``--plan tm,tn,split,depth`` keep one
case.  ``--sanitize`` runs ``as_is`` at one case that failed (M 100, N
1000, K 2048, fp32, plan 8,128,4,2; one launch) under ``compute-sanitizer
--tool racecheck`` and ``--tool synccheck``, and a one-element torch op
under each as a control, and prints the sanitizer's own lines (those it
starts with ``=========``) and exit code as one JSON line a run.

The card's machine has no git: extract the earlier sources first, in a
checkout, into a directory ``.gitignore`` lists; then on the card:

    python tools/int8_ring_race.py --extract a5ed5d9 _checkout/ring_a5ed5d9
    PYTHONPATH=src python tools/int8_ring_race.py _checkout/ring_a5ed5d9
    PYTHONPATH=src python tools/int8_ring_race.py --sanitize _checkout/ring_a5ed5d9

(``tools/ring_fence_ab.py`` times today's kernels with the fence against
the same sources without it.)
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = ("int8_matmul_pipelined.cu", "int8_matmul.cu", "common.cuh",
           "int8_tile.cuh", "tma.cuh", "wgmma.cuh")
K5 = "int8_matmul_pipelined.cu"

TILE_M, TILE_N, SPLITS, DEPTHS = (8, 16, 32), (64, 128), (1, 2, 4, 8), \
    (2, 3, 4, 6, 8)
SHAPES = ((100, 1000, 2048), (100, 32000, 2048), (513, 1000, 2048),
          (513, 32000, 2048))
DTYPES = {"float32": 0, "bfloat16": 1, "float16": 2}

# -- the variants: (anchor, replacement) edits of the earlier K5 -----------

PRODUCER_LOOP_END = """\
        tma::load_2d(ring + s * G::kStage, &wmap, (t0 + i) * kBK, n0, full + s);
      }
"""
PRODUCER_EMPTY_WAIT = """\
        if (i >= depth) tma::mbar_wait(empty + s, ((i / depth) - 1) & 1);
"""
PRODUCER_SPLIT = """\
    if (split > 1) {
      __syncthreads();  // with the consumers' barrier before their partials
"""
PRODUCER_RETURN = """\
                                              n0, M, N, split, rank);
    }
    return;
  }
"""
CONSUMER_WAIT = """\
      tma::mbar_wait(full + s, (i / depth) & 1);
"""
CONSUMER_RELEASE = """\
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(empty + s);  // the stage is in registers
"""
CONSUMER_SPLIT1_RETURN = """\
          out[static_cast<size_t>(m) * N + n] = from_f32<T>(v[j][e] * __ldg(scale + n));
      }
    return;
  }
"""
KERNEL_END = """\
  split_reduce<T, TM, TN, G::kPartStride>(part, scale, out, m0, n0, M, N, split, rank);
}
"""
INVAL = """\
  if (tid == 0)
    for (int s = 0; s < depth; ++s) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\\n" ::"r"(tma::smem_u32(full + s)) : "memory");
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];\\n" ::"r"(tma::smem_u32(empty + s)) : "memory");
    }
"""
PROXY_FENCE = '      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
CTA_FENCE = '      asm volatile("fence.acq_rel.cta;\\n" ::: "memory");\n'

VARIANTS: dict[str, list[tuple[str, str]]] = {
    "as_is": [],
    "drain": [(PRODUCER_LOOP_END, PRODUCER_LOOP_END + """\
      for (int i = nt > depth ? nt - depth : 0; i < nt; ++i)
        tma::mbar_wait(full + i % depth, (i / depth) & 1);
""")],
    "inval": [
        (PRODUCER_SPLIT, "    __syncwarp();\n" + PRODUCER_SPLIT),
        (PRODUCER_RETURN, """\
                                              n0, M, N, split, rank);
    } else {
      __syncthreads();  // the block ends together
    }
    return;
  }
"""),
        (CONSUMER_SPLIT1_RETURN, """\
          out[static_cast<size_t>(m) * N + n] = from_f32<T>(v[j][e] * __ldg(scale + n));
      }
    __syncthreads();  // the block ends together
""" + INVAL + """\
    return;
  }
"""),
        (KERNEL_END, KERNEL_END[:-2] + INVAL + "}\n")],
    "lockstep": [(CONSUMER_RELEASE, "      consumers_sync<W>();\n"
                  + CONSUMER_RELEASE)],
    "tags": [
        (PRODUCER_EMPTY_WAIT, PRODUCER_EMPTY_WAIT
         + "        g_ring_tag[TAG_BASE + s] = i;\n"),
        (CONSUMER_WAIT, CONSUMER_WAIT
         + "      if (reinterpret_cast<volatile int*>(g_ring_tag)[TAG_BASE + s] != i)\n"
           "        atomicAdd(&g_ring_misses, 1u);\n")],
    "sync_after_wait": [(CONSUMER_WAIT, CONSUMER_WAIT
                         + "      consumers_sync<W>();\n")],
    "one_block": [("  cfg.dynamicSmemBytes = smem;\n",
                   "  cfg.dynamicSmemBytes = kMaxSmem;\n")],
    "proxy": [
        (CONSUMER_RELEASE, PROXY_FENCE + CONSUMER_RELEASE),
        (PRODUCER_EMPTY_WAIT, PRODUCER_EMPTY_WAIT + "  " + PROXY_FENCE)],
    "proxy_consumer": [(CONSUMER_RELEASE, PROXY_FENCE + CONSUMER_RELEASE)],
    "proxy_producer": [(PRODUCER_EMPTY_WAIT,
                        PRODUCER_EMPTY_WAIT + "  " + PROXY_FENCE)],
    "fence_cta": [
        (CONSUMER_RELEASE, CTA_FENCE + CONSUMER_RELEASE),
        (PRODUCER_EMPTY_WAIT, PRODUCER_EMPTY_WAIT + "  " + CTA_FENCE)],
    "converge": [(PRODUCER_SPLIT, "    __syncwarp();\n" + PRODUCER_SPLIT)],
}

# Declared ahead of the kernel in every variant: ``tags``' count and its
# tags, one a slot of every block.
PRELUDE = """\
__device__ unsigned int g_ring_misses;
__device__ int g_ring_tag[1 << 22];
#define TAG_BASE \\
  (((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * kMaxDepth)

"""

# Appended to every variant: the occupancy query the earlier tree lacked,
# and ``tags``' count.
EXPORTS = """
namespace {
template <typename T, int MT, int W>
int blocks_per_sm(int split, int depth, int K) {
  using G = Cfg<T, MT, W>;
  const int tps = cdiv(cdiv(K, kBK), split);
  const size_t smem = smem_bytes<T, MT, W>(depth, split, panel_stages(G::kTerms, G::TM, tps));
  auto kern = int8_mm_pipelined_kernel<T, MT, W>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, G::kThreads + 32, smem) !=
      cudaSuccess)
    return -1;
  return n;
}
}  // namespace

REPRO_EXPORT int ring_race_blocks_per_sm(int tile_m, int tile_n, int split, int depth,
                                         int dtype, int K) {
#define RR_OCC(T, MT, W) \\
  if (tile_m == 8 * MT && tile_n == 16 * W) return blocks_per_sm<T, MT, W>(split, depth, K);
#define RR_ALL(T) \\
  RR_OCC(T, 1, 4) RR_OCC(T, 2, 4) RR_OCC(T, 4, 4) RR_OCC(T, 1, 8) RR_OCC(T, 2, 8) RR_OCC(T, 4, 8)
  if (dtype == kFloat32) { RR_ALL(float) }
  if (dtype == kBFloat16) { RR_ALL(__nv_bfloat16) }
  if (dtype == kFloat16) { RR_ALL(__half) }
#undef RR_ALL
#undef RR_OCC
  return 0;
}

// The waits that returned on another stage's phase since the last call.
REPRO_EXPORT int ring_race_misses() {
  unsigned int h = 0, z = 0;
  cudaMemcpyFromSymbol(&h, g_ring_misses, sizeof(h));
  cudaMemcpyToSymbol(g_ring_misses, &z, sizeof(z));
  return static_cast<int>(h);
}
"""


def variant_source(text: str, name: str) -> str:
    """The earlier K5's source with variant ``name``'s edits and the
    exports; every anchor must occur exactly once."""
    for anchor, new in VARIANTS[name]:
        if text.count(anchor) != 1:
            raise ValueError(f"{name}: anchor found {text.count(anchor)} "
                             f"times:\n{anchor}")
        text = text.replace(anchor, new)
    # the detectors' globals are read inside the kernel: declare them ahead
    return text.replace("namespace {\n", PRELUDE + "namespace {\n", 1) + EXPORTS


def extract(commit: str, out_dir: pathlib.Path) -> None:
    """The earlier K5 and the headers it includes, as of ``commit``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in SOURCES:
        text = subprocess.run(
            ["git", "show", f"{commit}:src/repro_torch/kernels/csrc/{f}"],
            cwd=ROOT, check=True, capture_output=True, text=True).stdout
        (out_dir / f).write_text(text)


def build(src_dir: pathlib.Path, names) -> dict:
    """One library a variant, all nvcc runs started together."""
    from repro_torch.kernels import _build
    out = src_dir / "_race_build"
    out.mkdir(exist_ok=True)
    text = (src_dir / K5).read_text()
    procs = {}
    for name in names:
        src = out / f"k5_{name}.cu"
        src.write_text(variant_source(text, name))
        lib = out / f"libk5_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(src_dir), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"k5_{name}.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc refused variant {name}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        dll.int8_matmul_pipelined_launch.argtypes = [P] * 4 + [I] * 9 + [P]
        dll.int8_matmul_pipelined_launch.restype = I
        dll.int8_matmul_pipelined_smem.argtypes = [I] * 6
        dll.int8_matmul_pipelined_smem.restype = I
        dll.ring_race_blocks_per_sm.argtypes = [I] * 6
        dll.ring_race_blocks_per_sm.restype = I
        dll.ring_race_misses.argtypes = []
        dll.ring_race_misses.restype = I
        libs[name] = dll
    return libs


def plans(lib, K: int, dtype: int):
    """Every plan the earlier K5 is built for and whose shared memory fits."""
    from repro_torch.kernels._build import MAX_SMEM
    for plan in itertools.product(TILE_M, TILE_N, SPLITS, DEPTHS):
        tm, tn, split, depth = plan
        if split > -(-K // 64):
            continue
        smem = lib.int8_matmul_pipelined_smem(tm, tn, split, depth, dtype, K)
        if 0 < smem <= MAX_SMEM:
            yield plan


def tolerance(x, wq, scale) -> dict:
    """The card tests' tolerance (``tests/test_torch_cuda.py _int8_tol``)."""
    import torch
    if x.dtype != torch.float32:
        return dict(atol=0.5, rtol=2e-2)
    big = float(x.abs().max()) * float((scale[:, None] * wq).abs().max())
    return dict(atol=x.shape[1] * big * 2.0 ** -23, rtol=0.0)


def run_variant(lib, repeats: int, gen, shapes=SHAPES, dtypes=tuple(DTYPES),
                only_plan=None) -> list[dict]:
    import torch
    from repro_torch.kernels import ref
    rows = []
    for dname in dtypes:
        code = DTYPES[dname]
        dtype = getattr(torch, dname)
        row = dict(dtype=dname, launches=0, wrong=0, wrong_1=0, wrong_2=0,
                   wrong_plans=[], misses=0, plans_2=0)
        for M, N, K in shapes:
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            wq = torch.randint(-127, 128, (N, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            scale = 0.001 + 0.019 * torch.rand((N,), generator=gen,
                                               device="cuda")
            want = ref.int8_matmul_ref(x, wq, scale).float()
            tol = tolerance(x, wq, scale)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            for plan in ([only_plan] if only_plan else plans(lib, K, code)):
                bps = lib.ring_race_blocks_per_sm(*plan, code, K)
                row["plans_2"] += bps >= 2
                bad = 0
                for _ in range(repeats):
                    out = torch.empty((M, N), device="cuda", dtype=dtype)
                    err = lib.int8_matmul_pipelined_launch(
                        x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), M, N, K, *plan, code, 0, stream)
                    if err:
                        raise RuntimeError(f"launch {plan}: CUDA error {err}")
                    far = ((out.float() - want).abs()
                           > tol["atol"] + tol["rtol"] * want.abs())
                    row["launches"] += 1
                    if bool(far.any()):
                        bad += 1
                torch.cuda.synchronize()
                row["misses"] += lib.ring_race_misses()
                if bad:
                    row["wrong"] += bad
                    row["wrong_2" if bps >= 2 else "wrong_1"] += bad
                    row["wrong_plans"].append(
                        dict(shape=[M, N, K], plan=list(plan),
                             blocks_per_sm=bps, wrong=bad))
        rows.append(row)
    return rows


SANITIZED = dict(shape="100,1000,2048", dtype="float32", plan="8,128,4,2")


def sanitize(src: str) -> None:
    """``as_is`` at one failing case, and a control, under the sanitizer's
    racecheck and synccheck; one JSON line a run."""
    import shutil
    tool = (shutil.which("compute-sanitizer")
            or "/usr/local/cuda/bin/compute-sanitizer")
    me = [sys.executable, str(pathlib.Path(__file__).resolve()), src,
          "--variants", "as_is", "--repeats", "1",
          *[f"--{k}={v}" for k, v in SANITIZED.items()]]
    control = [sys.executable, "-c",
               "import torch; print(float(torch.ones(1, device='cuda').sum()))"]
    for check in ("racecheck", "synccheck"):
        for what, cmd in (("control", control), ("as_is", me)):
            out = subprocess.run([tool, "--tool", check, *cmd],
                                 capture_output=True, text=True, timeout=300)
            lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                     if ln.startswith("=========")]
            print(json.dumps({"sanitizer": check, "run": what,
                              "rc": out.returncode, "lines": lines}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", nargs="?", help="directory of the earlier sources")
    ap.add_argument("--extract", nargs=2, metavar=("COMMIT", "DIR"))
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--shape", help="M,N,K: this case only")
    ap.add_argument("--dtype", choices=tuple(DTYPES), help="this dtype only")
    ap.add_argument("--plan", help="tile_m,tile_n,split,depth: this plan only")
    ap.add_argument("--sanitize", action="store_true",
                    help="one failing case under compute-sanitizer")
    args = ap.parse_args()
    if args.extract:
        extract(args.extract[0], pathlib.Path(args.extract[1]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("int8_ring_race: no CUDA device", file=sys.stderr)
        return 2
    if args.src is None:
        ap.error("the directory of the earlier sources is required")
    if args.sanitize:
        sanitize(args.src)
        return 0
    keep = dict(
        shapes=([tuple(map(int, args.shape.split(",")))] if args.shape
                else SHAPES),
        dtypes=[args.dtype] if args.dtype else list(DTYPES),
        only_plan=(tuple(map(int, args.plan.split(","))) if args.plan
                   else None))
    names = args.variants.split(",")
    libs = build(pathlib.Path(args.src), names)
    torch.backends.cuda.matmul.allow_tf32 = False
    summary = {}
    for name in names:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        rows = run_variant(libs[name], args.repeats, gen, **keep)
        for row in rows:
            print(json.dumps(dict(variant=name, **row)), flush=True)
        summary[name] = {k: sum(r[k] for r in rows) for k in
                         ("launches", "wrong", "wrong_1", "wrong_2", "misses")}
    print(json.dumps({"ring_race": summary,
                      "card": torch.cuda.get_device_name(0)}))
    return 0 if summary.get("as_is", {}).get("wrong", 1) else 1


if __name__ == "__main__":
    sys.exit(main())
