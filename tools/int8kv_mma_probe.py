#!/usr/bin/env python3
"""mma.sync against wgmma for K6's tile, on the card: the probe behind K6's
choice of instruction (``src/repro_torch/kernels/csrc/int8kv_tile.cuh``).

K6's main case (llama110m's attention, S = T = 512, hd 64, fp32 q) folds
64 x 64 tiles of scores over a depth of 64, three bf16 passes each (the
terms of fp32 q), and as much again for P V.  The probe runs that S tile
alone, back to back in one warpgroup a block, with bf16 operands and fp32
accumulators, two ways:

- ``mma.sync`` m16n8k16: each warp's 16 rows of q in registers, K's
  fragments by ``ldmatrix`` from a padded 16-bit tile in shared memory, as
  K6 takes them;
- ``wgmma`` m64n64k16 (``csrc/wgmma.cuh``): q in registers, K from a
  128-byte-swizzled tile through a descriptor, as K4 takes its B.

Each runs ``ITERS`` tiles a block on 132, 264 and 396 blocks (1-3 an SM);
CUDA events around one launch give TFLOP/s (2 · 64 · 64 · 64 · 3 flops a
tile).  Then K6 itself at the main case, with the time its 2 products
would take at each instruction's best rate beside it.  Needs a Hopper card
and nvcc; the probe builds into ``src/repro_torch/kernels/_build/``.

K6 built with wgmma in the kernel (at widths 64 and 128) was compared with
mma.sync by this probe's version at commit f754d01, whose K6 still had a
wgmma path; PERF.md gives the numbers.

    PYTHONPATH=src python tools/int8kv_mma_probe.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 4096

SOURCE = r"""
#include "flash_tile.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

constexpr int kWS = 72;  // K6's padded 16-bit row at hd 64

// One warpgroup: S (64 x 64) += Q (64 x 64) K^T, three passes, `iters` times.
__global__ void __launch_bounds__(128) mma_sync_tile(int iters, float* out) {
  __shared__ __align__(16) __nv_bfloat16 k_s[64 * kWS];
  for (int i = threadIdx.x; i < 64 * kWS; i += 128) k_s[i] = __float2bfloat16(1e-3f * (i % 7));
  __syncthreads();
  const int lane = threadIdx.x % 32;
  uint32_t a[4][3][4];
  for (int kd = 0; kd < 4; ++kd)
    for (int t = 0; t < 3; ++t)
      for (int e = 0; e < 4; ++e) a[kd][t][e] = 0x3c003c00u + kd + t + e + threadIdx.x;
  float s[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        flash::ldsm_x4(b, k_s + (8 * j + 8 * (lane / 16) + lane % 8) * kWS + 16 * kd +
                              8 * ((lane / 8) % 2));
#pragma unroll
        for (int t = 2; t >= 0; --t) {
          flash::mma16816<__nv_bfloat16>(s[j], a[kd][t], b[0], b[1]);
          flash::mma16816<__nv_bfloat16>(s[j + 1], a[kd][t], b[2], b[3]);
        }
      }
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) sum += s[j][e];
  out[blockIdx.x * 128 + threadIdx.x] = sum;
}

__global__ void __launch_bounds__(128) wgmma_tile(int iters, float* out) {
  __shared__ __align__(1024) __nv_bfloat16 k_s[64 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += 128) k_s[i] = __float2bfloat16(1e-3f * (i % 7));
  tma::fence_proxy_async();
  __syncthreads();
  uint32_t a[4][3][4];
  for (int kd = 0; kd < 4; ++kd)
    for (int t = 0; t < 3; ++t)
      for (int e = 0; e < 4; ++e) a[kd][t][e] = 0x3c003c00u + kd + t + e + threadIdx.x;
  float d[32] = {};
  const uint64_t desc = wg::make_desc_sw128(k_s);
  for (int it = 0; it < iters; ++it) {
    wg::fence();
#pragma unroll
    for (int kd = 0; kd < 4; ++kd)
#pragma unroll
      for (int t = 2; t >= 0; --t) wg::Mma<64, false>::run(d, a[kd][t], desc + 2 * kd, 1);
    wg::commit();
    wg::wait<0>();
  }
  float sum = 0.f;
  for (int j = 0; j < 32; ++j) sum += d[j];
  out[blockIdx.x * 128 + threadIdx.x] = sum;
}

// kind 0: mma.sync, 1: wgmma; `blocks` blocks on the current stream.
extern "C" int probe_launch(int kind, int blocks, int iters, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_sync_tile<<<blocks, 128, 0, s>>>(iters, out);
  else wgmma_tile<<<blocks, 128, 0, s>>>(iters, out);
  return cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("int8kv_mma_probe: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, cold_ms, int8kv_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_int8kv
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "int8kv_mma_probe.cu", out_dir / "libint8kv_mma_probe.so"
    cu.write_text(SOURCE)
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-1], "-shared",
                        "-I", str(_build.CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stdout + r.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(str(so)).probe_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    card = card_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flops_tile = 2 * 64 * 64 * 64 * 3
    best = {}
    for kind, name in ((0, "mma.sync m16n8k16"), (1, "wgmma m64n64k16")):
        for per_sm in (1, 2, 3):
            blocks = per_sm * sms
            out = torch.empty(blocks * 128, device="cuda")
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            for _ in range(2):
                if fn(kind, blocks, ITERS, ctypes.c_void_p(out.data_ptr()), stream):
                    raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn(kind, blocks, ITERS, ctypes.c_void_p(out.data_ptr()), stream)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1)
            tflops = flops_tile * ITERS * blocks / ms / 1e9
            best[name] = max(best.get(name, 0.0), tflops)
            print(json.dumps({"probe": name, "blocks_per_sm": per_sm,
                              "blocks": blocks, "tiles_a_block": ITERS,
                              "ms": ms, "tflops": tflops, "card": card}))
    # K6 at the main case: both products, three passes each, over the
    # causal tiles it computes (36 of 64 tile pairs a head)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q, _, _, k8, v8, ks, vs, mask = int8kv_inputs(512, 12, 12, "float32", gen)
    k6_ms = cold_ms(lambda q, k8, v8: flash_attention_int8kv(
        q, k8, v8, ks, vs, mask, sm_scale=0.125), (q, k8, v8))
    tc_flops = 2 * flops_tile * 36 * 12
    print(json.dumps({
        "k6_main_case_cold_us": k6_ms * 1e3,
        "its_tensor_core_flops": tc_flops,
        "us_at_best_rate": {n: tc_flops / (t * 1e12) * 1e6
                            for n, t in best.items()},
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
