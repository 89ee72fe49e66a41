// The grouped-aggregation pieces shared by K12 (group_aggregate.cu) and K13
// (group_aggregate_pipelined.cu): the index rule and the max-pool steps.
//
// The port of _group_update (src/repro/pointcloud/kernels.py:218).  The TPU
// kernel gathers rows as a one-hot matmul per streamed feature tile (the
// MXU's spelling of a gather) into a running max.  On this card the gather
// is a direct indexed load, which is exact, and the max runs on 16-byte
// chunks in the features' own type (max16), or one element at a time in
// fp32 registers (pool_max), through which a bf16 or fp16 value passes
// unchanged.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace group {

constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The row a neighbour index names, as the reference's JAX gather takes it
// (group_aggregate_ref: f[idx]): a negative index counts from the end, and
// anything still outside [0, N) is clamped to the nearest row.  On the
// point-cloud path every index is in range; this keeps a stray one from
// ever reading outside the array.
__device__ __forceinline__ int row_of(int i, int N) {
  if (i < 0) i += N;
  return min(max(i, 0), N - 1);
}

// max(acc, v) as jnp.max takes it: a NaN wins and stays.  Starting from
// -inf, the result is exactly the largest value seen.
__device__ __forceinline__ float pool_max(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// Running maxima of 16 bytes of T (4 fp32, 8 bf16 or 8 fp16), kept in T:
// a max only selects, so it is exact in the storage type, and one packed
// max.NaN takes a 4-byte word (two bf16 or fp16 values) at a time.  A NaN
// wins and stays, as jnp.max and torch.amax take it.
__device__ __forceinline__ unsigned max_nan(unsigned a, unsigned b, const float*) {
  unsigned d;
  asm("max.NaN.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned max_nan(unsigned a, unsigned b, const __nv_bfloat16*) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned max_nan(unsigned a, unsigned b, const __half*) {
  unsigned d;
  asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// -inf in every element of 16 bytes of T.
template <typename T>
__device__ __forceinline__ uint4 neg_inf16() {
  const unsigned w = sizeof(T) == 4 ? 0xff800000u
                     : std::is_same<T, __half>::value ? 0xfc00fc00u : 0xff80ff80u;
  return make_uint4(w, w, w, w);
}

// acc = max(acc, v) element by element.
template <typename T>
__device__ __forceinline__ void max16(uint4& acc, const uint4& v) {
  const T* tag = nullptr;
  acc.x = max_nan(acc.x, v.x, tag);
  acc.y = max_nan(acc.y, v.y, tag);
  acc.z = max_nan(acc.z, v.z, tag);
  acc.w = max_nan(acc.w, v.w, tag);
}

}  // namespace group
