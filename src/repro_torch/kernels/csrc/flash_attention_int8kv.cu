// K6: GQA flash attention over int8 K/V with one fp32 scale per KV head,
// dequantized inside the tile.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_int8kv
// (_flash_kernel_int8kv), the Pallas TPU kernel that streams K/V HBM -> VMEM
// as int8 and multiplies each tile by its KV head's scale before the
// online-softmax update, so a float K/V cache is never materialised.
//
// Bound on an H100: K2's work (4*hd flops per valid pair and head) against
// a quarter of K2's fp32 K/V bytes: compute-bound on the fp32 CUDA-core
// rate at llama110m's long prompts, memory-bound at short ones.
//
// Design: K2's kernel (flash::flash_kernel in flash_tile.cuh, one K/V
// stage, wholly masked tiles skipped) with the int8 K/V loader: each live
// tile arrives as int8 in 16-byte loads, is turned into fp32 and multiplied
// by the KV head's scale in registers (widen_rows), and lands in fp32
// shared memory, where the fp32 tile (flash::F32Tile, fp32 FFMA) runs the
// online softmax: masked scores selected to -1e30 and their p to 0, a
// fully masked row 0.  q of any float type is widened to fp32 the same
// way.  Query head h reads KV head h / (H/K) and that head's two scales.
#include "flash_tile.cuh"

// q: (B,S,H,hd) of `dtype`; k8/v8: (B,T,K,hd) int8; k_scale/v_scale: (K,)
// fp32; mask: (mask_b,S,T) bool with mask_b in {1, B}; out: (B,S,H,hd) of
// `dtype` (fp32, bf16, fp16); all contiguous, k8/v8 16-byte aligned.
// 1 <= hd <= 256; H % K == 0.  `live`: null, or one int to which every
// block adds the K/V tiles it computed.  Returns cudaGetLastError().
REPRO_EXPORT int flash_attention_int8kv_launch(
    const void* q, const void* k8, const void* v8, const void* k_scale,
    const void* v_scale, const void* mask, void* out, int B, int S, int T_len, int H,
    int K, int hd, int mask_b, float sm_scale, void* live, int dtype, int device,
    void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       flash::dispatch_baseline<T, int8_t>(hd, q, k8, v8, ks, vs, mask,
                                                           out, B, S, T_len, H, K,
                                                           mask_b, sm_scale,
                                                           static_cast<int*>(live), s));
}

// Blocks of K6 resident on one SM at head dim hd and q `dtype`, or -error.
REPRO_EXPORT int flash_attention_int8kv_occupancy(int hd, int dtype, int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dtype < kFloat32 || dtype > kFloat16) return -static_cast<int>(cudaErrorInvalidValue);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       [&]() -> int {
                         FLASH_DISPATCH_HD(hd, -static_cast<int>(cudaErrorInvalidValue),
                                           (flash::occupancy<W, T, int8_t, 1>(hd)));
                       }());
}
