// K9: farthest-point sampling, starting at index 0.
//
// Replaces: src/repro/pointcloud/kernels.py::fps (_fps_kernel), the Pallas
// TPU kernel that keeps the whole cloud and its running min-distance in VMEM
// and walks the samples in a fori_loop, one argmax per step.
//
// Bound on an H100: neither bytes nor operations.  The cloud is read once
// (12 bytes a point) and each step does ~10 fp32 operations a point, but
// step s+1 needs the argmax of step s, so the S steps form one chain of
// block-wide reductions, and only B blocks (one per cloud) are busy.  The
// roofline bound ignores that chain; the gap to it is the chain's length
// times the latency of one step (two block barriers and ten warp shuffles).
//
// Design: one block of 1024 threads per cloud.  Thread t owns points t,
// t + 1024, ...; for clouds of up to 8192 points (PPT <= 8 a thread) their
// coordinates (as fp32) and running min-distances stay in registers; above
// that (PPT = 0) the distances live in a global scratch array and the
// coordinates are re-read from L2 every step.  Each step:
//   1. every thread updates its points' distances to the last sample and
//      keeps its best (distance, index, coordinates), strict > in ascending
//      index order so that the first occurrence wins;
//   2. a warp argmax over (distance, -index) with shuffles, then the 32 warp
//      winners through shared memory and a second warp argmax in warp 0;
//   3. the winner's index and coordinates go back through shared memory.
// Exactness: d^2 is ((dx*dx + dy*dy) + dz*dz) on p - p[last], each product
// and sum rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction), in
// the order of the reference (pointcloud/ref.py), so the indices match it
// bit for bit.  Distances start at 1e30, as the reference's do.
#include <float.h>
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Best {
  float d;
  int i;
  float x, y, z;
};

// a beats b: larger distance, or the same distance at a lower index.
__device__ __forceinline__ bool beats(float da, int ia, float db, int ib) {
  return da > db || (da == db && ia < ib);
}

__device__ __forceinline__ Best warp_argmax(Best b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.d = __shfl_down_sync(kFull, b.d, off);
    o.i = __shfl_down_sync(kFull, b.i, off);
    o.x = __shfl_down_sync(kFull, b.x, off);
    o.y = __shfl_down_sync(kFull, b.y, off);
    o.z = __shfl_down_sync(kFull, b.z, off);
    if (beats(o.d, o.i, b.d, b.i)) b = o;
  }
  return b;
}

// Squared distance in the reference's order, without FMA contraction.
__device__ __forceinline__ float sqdist(float px, float py, float pz, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <typename T, int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const T* __restrict__ xyz, int* __restrict__ out,
           float* __restrict__ dscr, int N, int S) {
  __shared__ Best part[kWarps];
  __shared__ Best win;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* p = xyz + static_cast<size_t>(b) * N * 3;
  float* dist = dscr + static_cast<size_t>(b) * N;  // PPT == 0 only

  float px[PPT > 0 ? PPT : 1], py[PPT > 0 ? PPT : 1], pz[PPT > 0 ? PPT : 1],
      pd[PPT > 0 ? PPT : 1];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int i = tid + q * kThreads;
      const bool ok = i < N;
      px[q] = ok ? to_f32(p[3 * i]) : 0.f;
      py[q] = ok ? to_f32(p[3 * i + 1]) : 0.f;
      pz[q] = ok ? to_f32(p[3 * i + 2]) : 0.f;
      pd[q] = ok ? 1e30f : -FLT_MAX;  // a padded slot never wins
    }
  } else {
    for (int i = tid; i < N; i += kThreads) dist[i] = 1e30f;
  }
  float lx = to_f32(p[0]), ly = to_f32(p[1]), lz = to_f32(p[2]);
  int last = 0;

  for (int s = 0; s < S; ++s) {
    if (tid == 0) out[static_cast<size_t>(b) * S + s] = last;
    if (s == S - 1) break;
    Best best{-FLT_MAX, INT_MAX, 0.f, 0.f, 0.f};
    if constexpr (PPT > 0) {
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const int i = tid + q * kThreads;
        if (i < N) {
          pd[q] = fminf(pd[q], sqdist(px[q], py[q], pz[q], lx, ly, lz));
          if (pd[q] > best.d) best = Best{pd[q], i, px[q], py[q], pz[q]};
        }
      }
    } else {
      for (int i = tid; i < N; i += kThreads) {
        const float x = to_f32(p[3 * i]), y = to_f32(p[3 * i + 1]),
                    z = to_f32(p[3 * i + 2]);
        const float d = fminf(dist[i], sqdist(x, y, z, lx, ly, lz));
        dist[i] = d;
        if (d > best.d) best = Best{d, i, x, y, z};
      }
    }
    best = warp_argmax(best);
    if (lane == 0) part[warp] = best;
    __syncthreads();  // every warp's winner is in `part`
    if (warp == 0) {
      best = warp_argmax(part[lane]);
      if (lane == 0) win = best;
    }
    __syncthreads();  // `win` holds this step's sample
    last = win.i;
    lx = win.x;
    ly = win.y;
    lz = win.z;
  }
}

template <typename T>
cudaError_t launch(const void* xyz, void* out, void* dscr, int B, int N, int S,
                   cudaStream_t stream) {
  const int ppt = (N + kThreads - 1) / kThreads;
  const T* x = static_cast<const T*>(xyz);
  int* o = static_cast<int*>(out);
  float* d = static_cast<float*>(dscr);
#define REPRO_FPS(P) fps_kernel<T, P><<<B, kThreads, 0, stream>>>(x, o, d, N, S)
  if (ppt <= 1) REPRO_FPS(1);
  else if (ppt <= 2) REPRO_FPS(2);
  else if (ppt <= 4) REPRO_FPS(4);
  else if (ppt <= 8) REPRO_FPS(8);
  else REPRO_FPS(0);
#undef REPRO_FPS
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) fp32, bf16 or fp16, contiguous; out (B, S) int32.  1 <= S <= N.
// Above 8 * 1024 points `dscr` must hold B * N floats of scratch (it is not
// touched at or below that size).
// Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int fps_launch(const void* xyz, void* out, void* dscr, int B, int N,
                            int S, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || S <= 0 || S > N) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(xyz, out, dscr, B, N, S, s));
}
