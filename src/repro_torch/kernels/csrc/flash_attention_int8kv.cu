// K6: GQA flash attention over int8 K/V with one fp32 scale per KV head,
// on the tensor cores (the kernel body and its design: int8kv_tile.cuh).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_int8kv
// (_flash_kernel_int8kv), the Pallas TPU kernel that streams K/V HBM -> VMEM
// as int8 and multiplies each tile by its KV head's scale before the
// online-softmax update, so a float K/V cache is never materialised.
//
// Bound on an H100: 4*hd flops per valid (query, key) pair and head at the
// bf16/fp16 tensor cores' rate, three passes for fp32 q, against the bytes
// of q, out, int8 K/V and the mask: at llama110m's S = T = 512 in fp32 the
// two are about equal (1.2 us each), at short prompts bytes bound it.  The
// design keeps K/V int8 in shared memory (a quarter of fp32's bytes to copy)
// and splits a q tile's keys over a cluster where q tiles alone leave SMs
// idle.
#include "int8kv_tile.cuh"

// q: (B,S,H,hd) of `dtype`; k8/v8: (B,T,K,hd) int8; k_scale/v_scale: (K,)
// fp32; mask: (mask_b,S,T) bool with mask_b in {1, B}; out: (B,S,H,hd) of
// `dtype` (fp32, bf16, fp16); all contiguous, k8/v8 16-byte aligned.
// 1 <= hd <= 256; H % K == 0.  The plan: `split` blocks of a cluster share
// a q tile's keys (1, 2, 4).
// `live`: null, or one int to which every block adds the K/V tiles it
// computed.  Returns cudaGetLastError() (cudaErrorInvalidValue without
// launching for a plan the kernel does not take).
REPRO_EXPORT int flash_attention_int8kv_launch(
    const void* q, const void* k8, const void* v8, const void* k_scale,
    const void* v_scale, const void* mask, void* out, int B, int S, int T_len, int H,
    int K, int hd, int mask_b, float sm_scale, void* live, int split, int dtype, int device,
    void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0 ||
      (S + flash::BQ - 1) / flash::BQ > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  int* lv = static_cast<int*>(live);
  REPRO_DISPATCH_FLOAT(dtype, T, [&]() -> cudaError_t {
    FLASH_DISPATCH_HD(hd, cudaErrorInvalidValue,
                      (i8kv::launch<W, T>(q, k8, v8, ks, vs, mask, out, B, S, T_len, H, K, hd,
                                          mask_b, sm_scale, split, lv, s)));
  }());
}

// Blocks of K6 resident on one SM at head dim hd and q `dtype`, or -error.
REPRO_EXPORT int flash_attention_int8kv_occupancy(int hd, int dtype, int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dtype < kFloat32 || dtype > kFloat16) return -static_cast<int>(cudaErrorInvalidValue);
  REPRO_DISPATCH_FLOAT(dtype, T, [&]() -> int {
    FLASH_DISPATCH_HD(hd, -static_cast<int>(cudaErrorInvalidValue),
                      (i8kv::occupancy<W, T>()));
  }());
}

// Shared memory of one K6 block (bytes) at head dim hd and q `dtype`, or
// -1; kernels/pipeline.py int8kv_smem_bytes mirrors it.
REPRO_EXPORT int flash_attention_int8kv_smem(int hd, int dtype) {
  if (dtype < kFloat32 || dtype > kFloat16) return -1;
  REPRO_DISPATCH_FLOAT(dtype, T, [&]() -> int {
    FLASH_DISPATCH_HD(hd, -1, (i8kv::Layout<W, T>::kBytes));
  }());
}
