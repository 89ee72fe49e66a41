// K3: GQA flash attention with the live K/V tiles streamed through a
// `depth`-stage cp.async ring in shared memory (depth 2-4).
//
// Replaces: src/repro/kernels/pipeline.py::flash_attention_pipelined
// (_flash_pipelined_kernel driven by BurstPipeline.stream_step), the
// Pallas TPU kernel that keeps K/V in HBM and streams them into a rotating
// VMEM buffer with explicit async copies and DMA semaphores.
//
// Bound on an H100: K2's work, 4*hd flops per valid (query, key) pair and
// head.  In fp32 (the served path: llama110m's prefill buckets 128-512 and
// run (i1)'s groups of 8 at 512, hd 64) that is the 67 TFLOP/s of the CUDA
// cores; half the pairs of a causal mask are masked.  In bf16/fp16 the
// tensor cores (989 TFLOP/s) leave it bound by bytes and latency.
//
// Design: flash::flash_kernel (flash_tile.cuh) with a DEPTH-stage ring.
// The block lists its live K/V tiles from its mask rows (at S = T = 512,
// causal, 36 of the 64 (q tile, K/V tile) pairs), and the ring walks that
// list with BurstPipeline.stream_step's schedule over list positions: fill
// depth-1 tiles, then at position p wait for tile p, sync, start the copy
// of tile p+depth-1 (K, V and, for a partial tile, its mask bytes; 16-byte
// cp.async, rows past T zero-filled by the copy) into the slot position
// p-1 just left, and compute tile p while later copies fly.  Blocks start
// with the heaviest q tile.  fp32 rows run on the CUDA cores (fp32 FFMA, no
// TF32) with 256 threads; at hd 64 a depth-2 ring takes 110 KB, so two
// blocks share an SM (kernels/pipeline.choose_depth picks the deepest ring
// that leaves room for a second block).  bf16/fp16 rows run on the tensor
// cores (mma.sync m16n8k16, fp32 accumulators) with 128 threads, K/V kept
// 16-bit in the ring.  At the padded width 256 the tiles are 32 keys.
//
// Head dims that are not whole 16-byte vectors (hd * itemsize % 16 != 0)
// cannot take 16-byte cp.async copies; their tiles are copied into the
// ring slot element by element by the same threads at the same point of
// the schedule (the slot is free then), so the ring protocol is unchanged
// and only the overlap is lost.  Likewise the mask bytes where T % 16 != 0.
#include "flash_tile.cuh"

// The bf16 and fp16 kernels are compiled apart, in
// flash_attention_pipelined.bf16.cu and .f16.cu (kernels/_build.py links
// a library's parts), so that the three dtypes build in parallel.
FLASH_RING_INSTANCE(extern template, __nv_bfloat16);
FLASH_RING_INSTANCE(extern template, __half);

// As flash_attention_launch (flash_attention.cu), plus `depth` in {2, 3, 4}:
// the number of K/V ring stages.  A depth whose ring does not fit in 227 KB
// of shared memory returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int flash_attention_pipelined_launch(
    const void* q, const void* k, const void* v, const void* mask, void* out, int B,
    int S, int T_len, int H, int K, int hd, int mask_b, float sm_scale, void* live,
    int depth, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       flash::dispatch_ring<T>(hd, depth, q, k, v, mask, out, B, S, T_len, H,
                                               K, mask_b, sm_scale, static_cast<int*>(live),
                                               s));
}

// Blocks of K3 resident on one SM at head dim hd, ring depth and `dtype`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -error.
REPRO_EXPORT int flash_attention_pipelined_occupancy(int hd, int depth, int dtype,
                                                     int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dtype < kFloat32 || dtype > kFloat16) return -static_cast<int>(cudaErrorInvalidValue);
  REPRO_DISPATCH_FLOAT(dtype, T, flash::occupancy_ring<T>(hd, depth));
}
