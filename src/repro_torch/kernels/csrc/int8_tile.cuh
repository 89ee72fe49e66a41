// What the int8-weight GEMMs K4 (int8_matmul.cu, wgmma) and K5
// (int8_matmul_pipelined.cu, mma.sync) share: y[M,N] = (x[M,K] @
// f32(wq[N,K])^T) * scale[N], accumulated in fp32 and written in x's type --
// the counterpart of _int8_mm_kernel and _int8_mm_pipelined_kernel in
// src/repro/kernels/{int8_matmul,pipeline}.py -- on the tensor cores.
#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

namespace i8mm {

// Every int8 value is exact in bf16 and in fp16, and so is its product
// with a bf16 or fp16 value (8 x 8 or 8 x 11 significant bits fit fp32's
// 24).  An fp32 x is cut into three bf16 terms by masking bits, hi + mid +
// lo == x, so x*w is three exact products and only the fp32 sums round.

// The top 16 bits of an fp32 pattern as a bf16 pattern pair: the low half
// of the result from `a`, the high half from `b`.
__device__ __forceinline__ uint32_t pack_hi16(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// v = hi + mid + lo, each an fp32 pattern whose low 16 bits are zero (a
// bf16): hi keeps v's sign, exponent and top 7 mantissa bits, mid those
// of the exact remainder v - hi, lo the rest.  No rounding and no
// overflow (hi <= |v|, also at FLT_MAX); exact for |v| >= 2^-110, below
// which a remainder turns subnormal and masking drops its last bits (the
// error stays under 2^-133).
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xFFFF0000u;
  const float r = __fsub_rn(v, __uint_as_float(hi));
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid))) & 0xFFFF0000u;
}

// Four int8 values packed in a word (byte i = element i) as two pairs of
// bf16 (kF16 false) or fp16 (true), exactly: p0 holds elements 0, 1 and p1
// elements 2, 3, the lower element in the low half.  bf16: i8x4_to_f32,
// whose floats have zero low halves; fp16: each byte biased to unsigned is
// spliced under fp16's 1024 (0x64) and 1152 = 1024 + 128 subtracted.
template <bool kF16>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& p0, uint32_t& p1) {
  if constexpr (kF16) {
    const uint32_t b = w ^ 0x80808080u;
    uint32_t u0 = __byte_perm(b, 0x64646464u, 0x4140);
    uint32_t u1 = __byte_perm(b, 0x64646464u, 0x4342);
    const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
    const __half2 h0 = __hsub2(*reinterpret_cast<const __half2*>(&u0), bias);
    const __half2 h1 = __hsub2(*reinterpret_cast<const __half2*>(&u1), bias);
    p0 = *reinterpret_cast<const uint32_t*>(&h0);
    p1 = *reinterpret_cast<const uint32_t*>(&h1);
  } else {
    float f[4];
    i8x4_to_f32(w, f);
    p0 = pack_hi16(__float_as_uint(f[0]), __float_as_uint(f[1]));
    p1 = pack_hi16(__float_as_uint(f[2]), __float_as_uint(f[3]));
  }
}

// One int8 as a bf16 or fp16 pattern (the element-copy paths).
template <bool kF16>
__device__ __forceinline__ uint16_t widen1(int8_t v) {
  if constexpr (kF16) return __half_as_ushort(__float2half_rn(static_cast<float>(v)));
  return static_cast<uint16_t>(__float_as_uint(static_cast<float>(v)) >> 16);
}

// Sum of element `idx` of the fp32 partial tile `part` over the `split`
// blocks of this block's cluster, in rank order (the same bits on every
// call: the split-K sum is deterministic).
__device__ __forceinline__ float cluster_sum(float* part, int idx, int split) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  float v = 0.f;
  for (int q = 0; q < split; ++q) v += *cl.map_shared_rank(part + idx, q);
  return v;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace i8mm
