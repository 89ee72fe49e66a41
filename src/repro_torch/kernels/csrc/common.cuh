// Shared helpers of the port's CUDA kernels: the C export macro, the error
// string entry point every library carries, and fp32 <-> storage-type
// conversion for the element types the kernels take (fp32 and bf16; the
// int8 GEMMs also fp16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes passed from Python (see kernels/_build.py callers).
enum ReproDtype : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// Weak: a library linked from several sources (kernels/_build.py parts)
// carries one copy.
REPRO_EXPORT __attribute__((weak)) const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Load 16 bytes (4 fp32, 8 bf16 or 8 fp16) at a 16-byte-aligned address as
// fp32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Store 4 fp32 or 8 bf16/fp16 values (given as fp32) at a 16-byte-aligned
// address.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(__half* p, const float* v) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// 4 consecutive elements at an address aligned to 4 elements, as fp32
// (16 bytes of fp32, 8 of bf16 or fp16), and the matching store.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
  return make_float4(to_f32(e[0]), to_f32(e[1]), to_f32(e[2]), to_f32(e[3]));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  uint2 u;
  T* e = reinterpret_cast<T*>(&u);
  e[0] = from_f32<T>(v.x);
  e[1] = from_f32<T>(v.y);
  e[2] = from_f32<T>(v.z);
  e[3] = from_f32<T>(v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// Launch `fn<T>()` for the dtype code of a float tensor (fp32, bf16, fp16);
// cudaErrorInvalidValue for another code.
#define REPRO_DISPATCH_FLOAT(dtype, T, ...)                 \
  do {                                                     \
    if ((dtype) == kFloat32) {                             \
      using T = float;                                     \
      return __VA_ARGS__;                                  \
    }                                                      \
    if ((dtype) == kBFloat16) {                            \
      using T = __nv_bfloat16;                             \
      return __VA_ARGS__;                                  \
    }                                                      \
    if ((dtype) == kFloat16) {                             \
      using T = __half;                                    \
      return __VA_ARGS__;                                  \
    }                                                      \
    return cudaErrorInvalidValue;                          \
  } while (0)

// Four int8 values packed in a 32-bit word (byte i = element i) as fp32,
// exactly: each byte is biased to unsigned (xor 0x80), spliced into the
// mantissa of 2^23 (one byte permute) and 2^23 + 128 is subtracted.  Two
// full-rate instructions an element instead of a slow I2F conversion.
// Shared by the int8 kernels (K4, K5, K6).
__device__ __forceinline__ void i8x4_to_f32(unsigned w, float* out) {
  const unsigned b = w ^ 0x80808080u;
  out[0] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7540)) - 8388736.f;
  out[1] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7541)) - 8388736.f;
  out[2] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7542)) - 8388736.f;
  out[3] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7543)) - 8388736.f;
}

// cp.async (sm_80+): a 16-byte global -> shared copy that bypasses
// registers and L1.  `src_bytes` (0..16) bytes are read from `gmem_src` and
// the rest of the 16 are written as zeros, so a ragged edge or a masked row
// is filled by the copy itself.  Both addresses must be 16-byte aligned.
// Used by K3's ring (flash_tile.cuh).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The cluster barrier in two halves, for every thread of every block of a
// thread-block cluster: each block arrives as it starts and waits before
// its first access to another block's shared memory or mbarriers, which
// are valid only once that block runs (and, for mbarriers, once it has
// initialised them); the work issued in between overlaps the wait.
// Shared by ball query (K10, K11: ball_tile.cuh) and K13.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Set the device the caller's tensors live on; the ctypes route has no
// device guard of its own.
static inline cudaError_t repro_set_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}
