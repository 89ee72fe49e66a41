// K6: GQA flash attention over int8 K/V with one fp32 scale per KV head,
// dequantized inside the tile.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_int8kv
// (_flash_kernel_int8kv), the Pallas TPU kernel that streams K/V HBM -> VMEM
// as int8 and multiplies each tile by its KV head's scale before the
// online-softmax update, so a float K/V cache is never materialised.
//
// Bound on an H100: K2's work (4*S*T*hd flops per head over the causal
// pairs) against a quarter of K2's fp32 K/V bytes: compute-bound on the fp32
// CUDA-core rate at llama110m's long prompts, memory-bound at short ones.
//
// Design: K2's kernel (flash::baseline_kernel in flash_tile.cuh) with the
// int8 K/V tile loader: each tile arrives as int8 in 16-byte loads, is
// turned into fp32 and multiplied by the KV head's scale in registers, and
// lands in fp32 shared memory, from where flash::tile_update runs the
// unchanged online softmax: masked scores selected to -1e30 and their p to
// 0, a fully masked row 0.  Query head h reads KV head h / (H/K) and that
// head's two scales.  Shared memory is K2's: 68 KB at hd = 64.
#include "flash_tile.cuh"

// q: (B,S,H,hd) of `dtype`; k8/v8: (B,T,K,hd) int8; k_scale/v_scale: (K,)
// fp32; mask: (mask_b,S,T) bool with mask_b in {1, B}; out: (B,S,H,hd) of
// `dtype` (fp32, bf16, fp16); all contiguous, k8/v8 16-byte aligned.
// 1 <= hd <= 256; H % K == 0.  Returns cudaGetLastError().
REPRO_EXPORT int flash_attention_int8kv_launch(
    const void* q, const void* k8, const void* v8, const void* k_scale,
    const void* v_scale, const void* mask, void* out, int B, int S, int T_len, int H,
    int K, int hd, int mask_b, float sm_scale, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       flash::dispatch_baseline<T, int8_t>(hd, q, k8, v8, ks, vs, mask,
                                                           out, B, S, T_len, H, K,
                                                           mask_b, sm_scale, s));
}
