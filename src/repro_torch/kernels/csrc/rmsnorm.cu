// K1: fused RMSNorm, out = x * rsqrt(mean(x^2) + eps) * g.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel), the
// Pallas TPU kernel that normalises blocks of <= 256 rows in VMEM.
//
// Bound on an H100: memory.  Per row it reads d elements of x and writes d
// of out (plus g once, which stays in L1/L2): 2*R*d elements against ~3 flops
// per element, far below the card's ~20 flop/byte fp32 balance point.  So
// the design's one aim is to keep HBM busy: every byte of x read once,
// every load of a thread in flight before its first use.
//
// Design (kernels/rmsnorm.py `plan` picks one of three shapes; the choice
// is measured, PERF.md §6):
//
//   * row: one block a row.  Thread t holds vectors t, t + blockDim.x, ...
//     of the row (16 bytes each: 4 fp32 or 8 bf16/fp16), VPT of them, a
//     compile-time count, so the loads are unrolled, predicated on the
//     row's end and all issued before the first FMA.  The raw vectors stay
//     in registers (4 a vector whatever the dtype); the sum of squares goes
//     through four independent FMA chains, a warp shuffle reduction and one
//     shared-memory step (one barrier), and the output is formed from the
//     same registers: one read of x from HBM, one write of out.
//   * rows: the row shape with the grid cut to the blocks that stay
//     resident; each block walks rows blockIdx.x, + gridDim.x, ... and
//     loads the next row's vectors into a second register set before it
//     reduces the current one, so one row's load overlaps the previous
//     row's statistic and stores, and reads g once a block instead of once
//     a row.  That pays where g's bytes outweigh x's (fp32 g, 16-bit x)
//     and each block walks several rows.
//   * loop: a row too wide for registers (more than 8 vectors a thread of a
//     1024-thread block) or rows that are not 16-byte aligned take the
//     two-pass loop of the first version (128 threads a row; the second
//     pass re-reads x from L1/L2).
//
// g is read as 16-byte fp32 vectors (__ldg: it is shared by every row and
// stays in L1), with x where a thread holds at most 16 of its values, else
// once the statistic is known.  Statistics are fp32 whatever the dtype and
// the output is (x * inv) * g rounded once to x's dtype, as in the
// reference.
#include "common.cuh"

namespace {

constexpr int kMaxVpt = 8;            // 16-byte vectors a thread holds
constexpr int kMaxRowsVpt = 4;        // ... in each register set of `rows`
constexpr int kMaxRowThreads = 1024;  // threads of a row block
constexpr int kLoopThreads = 128;     // threads a row of the loop kernel

enum Mode : int { kLoop = 0, kRow = 1, kRows = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 16-byte vector as its V values in fp32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  load16(reinterpret_cast<const T*>(&u), out);
}

// Sum over the block of the squares of this thread's VPT raw vectors; four
// independent FMA chains, then the warps meet in `part` (one barrier).
template <typename T, int VPT>
__device__ __forceinline__ float block_sumsq(const uint4 (&raw)[VPT], float* part) {
  constexpr int V = Vec16<T>::N;
  float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    float v[V];
    unpack<T>(raw[i], v);
#pragma unroll
    for (int e = 0; e < V; ++e) p4[e % 4] = fmaf(v[e], v[e], p4[e % 4]);
  }
  const float ss = warp_sum((p4[0] + p4[1]) + (p4[2] + p4[3]));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (blockDim.x >> 5); ++w) total += part[w];
  return total;
}

// out row = x * inv * g for this thread's vectors j = threadIdx.x + i *
// blockDim.x below nv; g from `gv` (VPT * V / 4 float4s) when GIN, else
// loaded here.
template <typename T, int VPT, bool GIN>
__device__ __forceinline__ void store_row(const uint4 (&raw)[VPT], const float4* gv,
                                          const float4* __restrict__ g4, float inv,
                                          int nv, T* __restrict__ orow) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nv) {
      float v[V], gf[V];
      unpack<T>(raw[i], v);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 g = GIN ? gv[i * (V / 4) + q] : __ldg(g4 + j * (V / 4) + q);
        gf[4 * q] = g.x;
        gf[4 * q + 1] = g.y;
        gf[4 * q + 2] = g.z;
        gf[4 * q + 3] = g.w;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = v[e] * inv * gf[e];
      store16(orow + j * V, v);
    }
  }
}

// Load this thread's VPT vectors of row `row` (zero past the row's end or
// when `ok` is false).
template <typename T, int VPT>
__device__ __forceinline__ void load_row(uint4 (&raw)[VPT], const T* __restrict__ x,
                                         int row, int d, int nv, bool ok) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    raw[i] = ok && j < nv ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// This thread's g vectors, the same for every row.
template <typename T, int VPT>
__device__ __forceinline__ void load_g(float4* gv, const float4* __restrict__ g4,
                                       int nv) {
  constexpr int V = Vec16<T>::N;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      gv[i * (V / 4) + q] = j < nv ? __ldg(g4 + j * (V / 4) + q)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The row shape: one block a row.
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxRowThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   T* __restrict__ out, int d, float eps) {
  constexpr int V = Vec16<T>::N;
  // g rides along with x where it costs at most 16 registers a thread
  constexpr bool kGIn = VPT * V <= 16;
  __shared__ float part[32];
  const int nv = d / V;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  uint4 raw[VPT];
  float4 gv[kGIn ? VPT * V / 4 : 1];
  load_row<T, VPT>(raw, x, blockIdx.x, d, nv, true);
  if constexpr (kGIn) load_g<T, VPT>(gv, g4, nv);
  const float inv = rsqrtf(block_sumsq<T, VPT>(raw, part) / static_cast<float>(d) + eps);
  store_row<T, VPT, kGIn>(raw, gv, g4, inv, nv,
                          out + static_cast<size_t>(blockIdx.x) * d);
}

// The rows shape: a resident grid walks the rows, one row ahead.  Two
// shared slots of warp sums alternate, so one barrier a row suffices.
template <typename T, int VPT>
__global__ void __launch_bounds__(kMaxRowThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    T* __restrict__ out, int rows, int d, float eps) {
  constexpr int V = Vec16<T>::N;
  __shared__ float part[2][32];
  const int nv = d / V;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4 gv[VPT * V / 4];
  uint4 cur[VPT], nxt[VPT];
  int row = blockIdx.x;
  load_row<T, VPT>(cur, x, row, d, nv, true);
  load_g<T, VPT>(gv, g4, nv);
  for (int it = 0; row < rows; ++it, row += gridDim.x) {
    const int next = row + gridDim.x;
    load_row<T, VPT>(nxt, x, next, d, nv, next < rows);
    const float inv =
        rsqrtf(block_sumsq<T, VPT>(cur, part[it & 1]) / static_cast<float>(d) + eps);
    store_row<T, VPT, true>(cur, gv, g4, inv, nv, out + static_cast<size_t>(row) * d);
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

// The two-pass loop kernel: one block of 128 threads a row; 16-byte vectors
// where the row is aligned (`vec`), else one element a thread a step.
template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
rmsnorm_loop_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    T* __restrict__ out, int d, float eps, int vec) {
  constexpr int V = Vec16<T>::N;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (vec) {
    for (int i = threadIdx.x * V; i < d; i += kLoopThreads * V) {
      float v[V];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) ss = fmaf(v[j], v[j], ss);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }

  __shared__ float part[kLoopThreads / 32];
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kLoopThreads / 32; ++w) total += part[w];
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  if (vec) {
    for (int i = threadIdx.x * V; i < d; i += kLoopThreads * V) {
      float v[V];
      load16(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = v[j] * inv * __ldg(g + i + j);
      store16(orow + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kLoopThreads)
      orow[i] = from_f32<T>(to_f32(xr[i]) * inv * g[i]);
  }
}

template <typename T>
cudaError_t launch(const void* xv, const void* gv, void* ov, int rows, int d,
                   float eps, int mode, int vpt, int threads, int blocks,
                   cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const float* g = static_cast<const float*>(gv);
  T* out = static_cast<T*>(ov);
  constexpr int V = Vec16<T>::N;
  if (mode == kLoop) {
    const int vec = (d % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0);
    rmsnorm_loop_kernel<T><<<rows, kLoopThreads, 0, s>>>(x, g, out, d, eps, vec);
    return cudaGetLastError();
  }
  // The register shapes need aligned rows and every vector of a row held.
  if (d % V != 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(g)) % 16 != 0 ||
      vpt < 1 || vpt > (mode == kRows ? kMaxRowsVpt : kMaxVpt) || threads % 32 != 0 ||
      threads < 32 || threads > kMaxRowThreads ||
      static_cast<long long>(vpt) * threads * V < d)
    return cudaErrorInvalidValue;
  if (mode == kRow) {
    switch (vpt) {
#define REPRO_VPT(n) \
      case n: rmsnorm_row_kernel<T, n><<<rows, threads, 0, s>>>(x, g, out, d, eps); break;
      REPRO_VPT(1) REPRO_VPT(2) REPRO_VPT(3) REPRO_VPT(4)
      REPRO_VPT(5) REPRO_VPT(6) REPRO_VPT(7) REPRO_VPT(8)
#undef REPRO_VPT
    }
  } else if (mode == kRows) {
    if (blocks < 1 || blocks > rows) return cudaErrorInvalidValue;
    switch (vpt) {
#define REPRO_VPT(n)                                                                 \
      case n:                                                                        \
        rmsnorm_rows_kernel<T, n><<<blocks, threads, 0, s>>>(x, g, out, rows, d, eps); \
        break;
      REPRO_VPT(1) REPRO_VPT(2) REPRO_VPT(3) REPRO_VPT(4)
#undef REPRO_VPT
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous, dtype `dtype` (fp32, bf16, fp16); g: (d,)
// fp32.  `mode` 0 (loop), 1 (row: one block of `threads` a row) or 2
// (rows: `blocks` blocks of `threads` walk the rows), with `vpt` vectors a
// thread (1..8 for row, 1..4 for rows); kernels/rmsnorm.py `plan` chooses
// them.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a shape that does not cover the row.
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* g, void* out,
                                int rows, int d, float eps, int dtype, int mode,
                                int vpt, int threads, int blocks, int device,
                                void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       launch<T>(x, g, out, rows, d, eps, mode, vpt, threads, blocks,
                                 s));
}
