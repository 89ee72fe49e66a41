// K1: fused RMSNorm, out = x * rsqrt(mean(x^2) + eps) * g.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel), the
// Pallas TPU kernel that normalises blocks of <= 256 rows in VMEM.
//
// Bound on an H100: memory.  Per row it reads d elements of x and writes d
// of out (plus g once, which stays in L1/L2): 2*R*d elements against ~3 flops
// per element, far below the card's ~20 flop/byte fp32 balance point.
//
// Design: one block of 128 threads per row; 16-byte vector loads of x
// (4 fp32 or 8 bf16 per thread per step, neighbouring threads on
// neighbouring addresses), an fp32 sum of squares reduced with warp
// shuffles and one shared-memory step across the 4 warps, then a second
// pass that re-reads the row (an L1 hit at d = 768) and writes
// x * inv_rms * g in x's dtype.  Statistics are fp32 whatever the dtype, as
// in the reference.  Rows that are not 16-byte aligned take a scalar path.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
               T* __restrict__ out, int d, float eps, int vec) {
  constexpr int V = Vec16<T>::N;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * V; i < d; i += kThreads * V) {
      float v[V];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }

  __shared__ float part[kThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += part[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = threadIdx.x * V; i < d; i += kThreads * V) {
      float v[V];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = v[j] * inv * g[i + j];
      store16(orow + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f32<T>(to_f32(xr[i]) * inv * g[i]);
  }
}

}  // namespace

// x, out: (rows, d) contiguous, dtype `dtype`; g: (d,) fp32.  `vec` = 1 when
// every row starts 16-byte aligned (d * itemsize % 16 == 0 and x, out
// aligned).  Returns cudaGetLastError() after the launch.
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* g, void* out,
                                int rows, int d, float eps, int dtype, int vec,
                                int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(out), d, eps, vec);
  } else if (dtype == kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(out), d, eps, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
