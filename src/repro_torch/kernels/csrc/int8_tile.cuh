// The int8-weight GEMM tile shared by K4 (int8_matmul.cu) and K5
// (int8_matmul_pipelined.cu): y[M,N] = (x[M,K] @ f32(wq[N,K])^T) * scale[N],
// accumulated in fp32 and written in x's type -- the counterpart of
// _int8_mm_kernel and _int8_mm_pipelined_kernel in
// src/repro/kernels/{int8_matmul,pipeline}.py.
//
// Shared-memory tiles hold the operands as they lie in device memory: x as
// fp32, bf16 or fp16 (BM rows of BK values), wq as int8 (BN rows of BK bytes).
// Each row is padded by 16 bytes, so rows stay 16-byte aligned (cp.async)
// and the 16-byte weight loads of neighbouring rows start in different
// banks.  Thread (ty, tx) = (tid / CT, tid % CT) of a block of RT x CT = 256
// threads owns output rows ty + RT*i (i < TM) and columns tx + CT*j
// (j < TN).  Each step of 16 k-values reads a column's 16 int8 weights with
// one 16-byte load and turns them into fp32 in registers (i8x4_to_f32); the
// products are fp32 FMAs on the CUDA cores (no TF32, no tensor cores), each
// output summed in k order.
#pragma once

#include "common.cuh"

namespace i8mm {

constexpr int kThreads = 256;
constexpr int BK = 64;  // k-values per tile step (a multiple of 16)

// Row strides (elements) of the shared x and wq tiles.
template <typename T>
struct XLayout {
  static constexpr int kStride = BK + 16 / static_cast<int>(sizeof(T));
};
constexpr int kWStride = BK + 16;

template <int RT, int CT, int TM, int TN>
struct Shape {
  static_assert(RT * CT == kThreads, "one output tile per 256-thread block");
  static constexpr int BM = RT * TM;
  static constexpr int BN = CT * TN;
  template <typename T>
  __host__ __device__ static constexpr int x_elems() {
    return BM * XLayout<T>::kStride;
  }
  static constexpr int kWBytes = BN * kWStride;
};

// 16 consecutive x values of a shared row as fp32 (16-byte aligned).
__device__ __forceinline__ void lds_x16(const float* p, float* v) {
  load16(p, v);
  load16(p + 4, v + 4);
  load16(p + 8, v + 8);
  load16(p + 12, v + 12);
}
__device__ __forceinline__ void lds_x16(const __nv_bfloat16* p, float* v) {
  load16(p, v);
  load16(p + 8, v + 8);
}
__device__ __forceinline__ void lds_x16(const __half* p, float* v) {
  load16(p, v);
  load16(p + 8, v + 8);
}

// acc[i][j] += sum_k x_s[row i][k] * w_s[col j][k] over one BK-wide step.
template <int RT, int CT, int TM, int TN, typename T>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN], const T* x_s,
                                         const int8_t* w_s) {
  constexpr int XS = XLayout<T>::kStride;
  const int tx = threadIdx.x % CT;
  const int ty = threadIdx.x / CT;
#pragma unroll 1
  for (int kk = 0; kk < BK; kk += 16) {
    float xv[TM][16];
#pragma unroll
    for (int i = 0; i < TM; ++i) lds_x16(x_s + (ty + RT * i) * XS + kk, xv[i]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float wv[16];
      load16(w_s + (tx + CT * j) * kWStride + kk, wv);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float a = acc[i][j];
#pragma unroll
        for (int e = 0; e < 16; ++e) a = fmaf(xv[i][e], wv[e], a);
        acc[i][j] = a;
      }
    }
  }
}

// out[m, n] = acc * scale[n] in T for this thread's outputs inside (M, N).
template <int RT, int CT, int TM, int TN, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN],
                                           const float* __restrict__ scale,
                                           T* __restrict__ out, int m0, int n0,
                                           int M, int N) {
  const int tx = threadIdx.x % CT;
  const int ty = threadIdx.x / CT;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + RT * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + CT * j;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] = from_f32<T>(acc[i][j] * __ldg(scale + n));
    }
  }
}

}  // namespace i8mm
