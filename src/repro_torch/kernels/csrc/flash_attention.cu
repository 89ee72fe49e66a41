// K2: GQA flash attention with an explicit boolean mask (baseline).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel with _online_softmax_update, _init_flash_scratch and
// _finalize_flash_output), the Pallas TPU kernel whose sequential last
// grid dimension walks the K/V tiles while the running max, denominator and
// accumulator sit in VMEM scratch.
//
// Bound on an H100: at the prefill buckets of llama110m (S = T <= 512,
// hd = 64, fp32) the work is 4*S*T*hd flops per head against
// (2*S + 2*T)*hd*4 bytes, i.e. ~S/4 flop/byte: compute-bound on the fp32
// CUDA-core rate (67 TFLOP/s) once S passes ~80, memory-bound below.
//
// Design: flash::baseline_kernel (flash_tile.cuh) with K/V of q's type
// (fp32, bf16 or fp16; any head dim up to 256, built at the padded widths
// 16 ... 256): each 64-row K/V tile is loaded with 16-byte vector loads and
// converted to fp32 in shared memory, and flash::tile_update folds it into the running
// state (fp32 FFMA, no TF32: parity with the fp32 reference is the point
// of this first version; tensor cores come later).
#include "flash_tile.cuh"

// q: (B,S,H,hd), k/v: (B,T,K,hd), out: (B,S,H,hd), all contiguous of
// `dtype` (fp32, bf16, fp16); mask: (mask_b,S,T) contiguous bool with
// mask_b in {1, B}.  1 <= hd <= 256; H % K == 0.  Returns
// cudaGetLastError().
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int S,
                                        int T_len, int H, int K, int hd, int mask_b,
                                        float sm_scale, int dtype, int device,
                                        void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       flash::dispatch_baseline<T, T>(hd, q, k, v, nullptr, nullptr,
                                                      mask, out, B, S, T_len, H, K,
                                                      mask_b, sm_scale, s));
}
