"""Time one block barrier and one cluster barrier on the card: the floor of
a step of K9 (``src/repro_torch/kernels/csrc/fps.cu``), which makes one
such barrier a step.

One cluster of C blocks (C = 1, 2, 4, 8, 16) of 256, 512 or 1024 threads
runs 100000 back-to-back barriers: ``__syncthreads`` (C = 1 only) or
``barrier.cluster.arrive.release`` / ``wait.acquire``, as K9 makes them.
CUDA events around one launch give µs a barrier.  Prints one JSON line a
(barrier, cluster, threads), then a markdown table, then the clusters of
each size the card runs at once with one block an SM
(``cudaOccupancyMaxActiveClusters``), which ``fps_plan`` takes as
``FPS_CLUSTERS_AT_ONCE``.  Needs a Hopper card
and nvcc; the probe builds into ``src/repro_torch/kernels/_build/``.

    PYTHONPATH=src python tools/fps_barrier_probe.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(1024, 1) barrier_probe(int kind, int steps) {
  for (int s = 0; s < steps; ++s) {
    if (kind == 0) {
      __syncthreads();
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  }
}

// Clusters of `cluster` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory each that the card runs at once (`*n`), then, if
// steps > 0, one such cluster launched on the legacy default stream.
// Returns 0 or the CUDA error (cudaErrorLaunchOutOfResources where no
// such cluster fits).
extern "C" int probe_launch(int kind, int cluster, int threads, int smem,
                            int steps, int* n) {
  cudaError_t e = cudaFuncSetAttribute(
      barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(barrier_probe,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(n, barrier_probe, &cfg);
  if (e != cudaSuccess) return e;
  if (*n <= 0) return cudaErrorLaunchOutOfResources;
  if (steps == 0) return 0;
  e = cudaLaunchKernelEx(&cfg, barrier_probe, kind, steps);
  return e != cudaSuccess ? e : cudaGetLastError();
}
"""

CLUSTERS = (1, 2, 4, 8, 16)
THREADS = (256, 512, 1024)
STEPS = 100_000
#: Dynamic shared memory that leaves room for one block an SM (an SM has
#: 228 KB), as K9's register plans of 512 and 1024 threads are run.
ONE_BLOCK_AN_SM = 120 * 1024


def build():
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "fps_barrier_probe.cu"
    lib = _build.BUILD_DIR / "libfps_barrier_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).probe_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int

    def launch(kind, cluster, threads, steps, smem=0):
        n = ctypes.c_int(0)
        err = fn(kind, cluster, threads, smem, steps, ctypes.byref(n))
        return err, n.value
    return launch


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fps_barrier_probe: no CUDA device", file=sys.stderr)
        return 2
    launch = build()
    us = {}
    for kind, clusters in ((0, (1,)), (1, CLUSTERS)):
        for c in clusters:
            for t in THREADS:
                if launch(kind, c, t, 10)[0]:   # first launch: load, check
                    raise RuntimeError(f"probe {kind} {c} {t} refused")
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = launch(kind, c, t, STEPS)[0]
                end.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"probe {kind} {c} {t}: error {err}")
                us[kind, c, t] = start.elapsed_time(end) * 1e3 / STEPS
                print(json.dumps({
                    "barrier": "__syncthreads" if kind == 0 else "cluster",
                    "cluster": c, "threads": t, "us": us[kind, c, t]}))
    print("| threads | `__syncthreads` | "
          + " | ".join(f"cluster {c}" for c in CLUSTERS) + " |")
    print("|---" * (2 + len(CLUSTERS)) + "|")
    for t in THREADS:
        print(f"| {t} | {us[0, 1, t]:.4f} | "
              + " | ".join(f"{us[1, c, t]:.4f}" for c in CLUSTERS) + " |")
    at_once = {}
    for c in CLUSTERS:
        err, at_once[c] = launch(1, c, 1024, 0, ONE_BLOCK_AN_SM)
        if err:
            raise RuntimeError(f"occupancy query at cluster {c}: error {err}")
    print(json.dumps({"clusters_at_once": at_once,
                      "threads": 1024, "smem": ONE_BLOCK_AN_SM}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
