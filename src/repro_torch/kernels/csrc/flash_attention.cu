// K2: GQA flash attention with an explicit boolean mask (baseline).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel with _online_softmax_update, _init_flash_scratch and
// _finalize_flash_output), the Pallas TPU kernel whose sequential last
// grid dimension walks the K/V tiles while the running max, denominator and
// accumulator sit in VMEM scratch.
//
// Bound on an H100: 4*hd flops per valid (query, key) pair and head
// against (2*S*H + 2*T*K)*hd*itemsize bytes.  In fp32 (the served path:
// llama110m's prefill buckets of 16-64 tokens, hd 64) that is the 67
// TFLOP/s of the CUDA cores from S ~ 80 up; at the served S <= 64 one
// block per (q tile, head) runs a single K/V tile, so the time is the
// latency of one load-compute-store chain.  In bf16/fp16 the tensor cores
// (989 TFLOP/s) leave it bound by bytes and latency.
//
// Design: flash::flash_kernel (flash_tile.cuh) with one K/V stage: the
// block lists its live K/V tiles from its mask rows (skipping wholly
// masked ones; a one-tile sweep is not scanned), and for each live tile
// copies K, V and, where the tile is partial, its mask bytes into shared
// memory (16-byte cp.async), waits, and folds the tile in: fp32 rows on
// the CUDA cores (fp32 FFMA, no TF32), bf16/fp16 rows on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators).
#include "flash_tile.cuh"

// q: (B,S,H,hd), k/v: (B,T,K,hd), out: (B,S,H,hd), all contiguous of
// `dtype` (fp32, bf16, fp16); mask: (mask_b,S,T) contiguous bool with
// mask_b in {1, B}.  1 <= hd <= 256; H % K == 0.  `live`: null, or one
// int to which every block adds the K/V tiles it computed.  Returns
// cudaGetLastError().
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int S,
                                        int T_len, int H, int K, int hd, int mask_b,
                                        float sm_scale, void* live, int dtype,
                                        int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       flash::dispatch_baseline<T>(hd, q, k, v, mask, out, B, S, T_len, H,
                                                   K, mask_b, sm_scale,
                                                   static_cast<int*>(live), s));
}

// Blocks of K2 resident on one SM at head dim hd and `dtype`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -error.
REPRO_EXPORT int flash_attention_occupancy(int hd, int dtype, int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dtype < kFloat32 || dtype > kFloat16) return -static_cast<int>(cudaErrorInvalidValue);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       [&]() -> int {
                         FLASH_DISPATCH_HD(hd, -static_cast<int>(cudaErrorInvalidValue),
                                           (flash::occupancy<W, T, 1>(hd)));
                       }());
}
