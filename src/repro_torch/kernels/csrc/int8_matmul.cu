// K4: int8-weight GEMM, y[M,N] = (x[M,K] @ f32(wq[N,K])^T) * scale[N] (baseline).
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (_int8_mm_kernel),
// the Pallas TPU kernel whose sequential k grid dimension accumulates an fp32
// (bm, bn) tile in VMEM scratch while BlockSpec copies bring the x and int8
// weight tiles in.
//
// Bound on an H100: at llama110m's prefill rows (M = 512, K and N of 768 to
// 32000) the work is 2*M*N*K fp32 operations against ~N*K weight bytes, i.e.
// ~2*M flop/byte: compute-bound on the fp32 CUDA-core rate (67 TFLOP/s);
// in the decode regime (M <= 64) the int8 weight stream sets the pace, and
// the router sends that regime to K5.
//
// Design: one block of 256 threads per 64 x 64 output tile; the TPU's
// sequential k dimension becomes a loop inside the block over 64-wide k
// steps.  Each step copies the x and wq tiles into shared memory as they are
// (16-byte vector copies where rows are 16-byte aligned, element copies on a
// ragged edge, zeros past M, N and K), synchronises, and each thread folds a
// 4 x 4 sub-tile into fp32 registers (i8mm::tile_fma).  The epilogue scales by
// scale[n] and writes x's type.  Any M, N and K >= 1 are taken.
#include "int8_tile.cuh"

namespace {

using namespace i8mm;
using S4 = Shape<16, 16, 4, 4>;  // 64 x 64 output tile

template <typename E>
__device__ __forceinline__ E zero_elem() { return E(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
template <>
__device__ __forceinline__ __half zero_elem<__half>() {
  return __ushort_as_half(0);
}

// Copy rows [r0, r0 + rows) x k-values [k0, k0 + BK) of a row-major (R, K)
// matrix of E into shared rows of `stride` elements, zeros past R and K.
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, int stride, int rows,
                                          const E* __restrict__ src, int R, int K,
                                          int r0, int k0, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  constexpr int kChunks = BK / V;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int kk = (c % kChunks) * V;
    const int gr = r0 + r;
    const int gk = k0 + kk;
    E* d = dst + r * stride + kk;
    const E* s = src + static_cast<size_t>(gr) * K + gk;
    if (vec && gr < R && gk + V <= K) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (gr < R && gk + e < K) ? s[e] : zero_elem<E>();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, T* __restrict__ out, int M, int N,
               int K) {
  __shared__ __align__(16) T x_s[S4::x_elems<T>()];
  __shared__ __align__(16) int8_t w_s[S4::kWBytes];
  const int m0 = blockIdx.y * S4::BM;
  const int n0 = blockIdx.x * S4::BN;
  // 16-byte copies need every row start 16-byte aligned
  const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (static_cast<size_t>(K) * sizeof(T)) % 16 == 0;
  const bool vw = reinterpret_cast<uintptr_t>(wq) % 16 == 0 && K % 16 == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tiles
    load_rows<T>(x_s, XLayout<T>::kStride, S4::BM, x, M, K, m0, k0, vx);
    load_rows<int8_t>(w_s, kWStride, S4::BN, wq, N, K, n0, k0, vw);
    __syncthreads();
    tile_fma<16, 16, 4, 4, T>(acc, x_s, w_s);
  }
  store_tile<16, 16, 4, 4, T>(acc, scale, out, m0, n0, M, N);
}

template <typename T>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + S4::BN - 1) / S4::BN, (M + S4::BM - 1) / S4::BM);
  int8_mm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) contiguous of `dtype` (fp32, bf16 or fp16); wq: (N, K)
// contiguous int8; scale: (N,) fp32; out: (M, N) of `dtype`.  M, N, K >= 1.
// Returns cudaGetLastError().
REPRO_EXPORT int int8_matmul_launch(const void* x, const void* wq, const void* scale,
                                    void* out, int M, int N, int K, int dtype,
                                    int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0 || K <= 0 || (M + S4::BM - 1) / S4::BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(x, wq, scale, out, M, N, K, s);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, wq, scale, out, M, N, K, s);
  if (dtype == kFloat16) return launch<__half>(x, wq, scale, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
