// K13: grouped feature aggregation with the gathered neighbour rows
// streamed through a `depth`-stage cp.async ring in shared memory (depth
// 2-4).
//
// Replaces: src/repro/pointcloud/kernels.py::group_aggregate_pipelined
// (_group_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps the features in HBM and streams feature tiles into
// a rotating VMEM buffer with explicit async copies.
//
// Bound on an H100: the same work as K12 (group_aggregate.cu): bytes.
//
// Design: a block owns 4 centers of one cloud and C channels of each.  It
// loads the 4 * k neighbour indices once (clamped as K12 does), then
// streams the neighbours in stages of 16: stage t holds rows
// idx[m, 16t .. 16t+15] of its 4 centers, copied as 16-byte cp.async chunks
// of each row into ring slot t % depth.  The schedule is K3's
// (BurstPipeline.stream_step): fill depth-1 stages; at step t wait for stage
// t, sync, start stage t+depth-1 into the slot step t-1 finished with, and
// fold stage t into the running max while the later copies fly.  Each of
// the 256 threads keeps up to 4 (center, channel) maxima in fp32 registers,
// so 4 * C <= 1024, and a row must be a whole number of 16-byte chunks.
#include "group_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCenters = 4;   // centers per block
constexpr int kChunk = 16;    // neighbours per stage
constexpr int kPairs = 4;     // (center, channel) maxima per thread

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
group_pipelined_kernel(const T* __restrict__ f, const int* __restrict__ idx,
                       T* __restrict__ out, int M, int N, int k, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Vec16<T>::N;
  const int stage = kCenters * kChunk * C;  // elements of one slot
  T* ring = reinterpret_cast<T*>(smem);
  int* idx_s = reinterpret_cast<int*>(smem + static_cast<size_t>(DEPTH) * stage * sizeof(T));
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kCenters;
  const int nc = min(kCenters, M - m0);
  const T* fb = f + static_cast<size_t>(b) * N * C;

  for (int e = threadIdx.x; e < kCenters * k; e += kThreads) {
    const int cc = e / k;
    idx_s[e] = cc < nc ? group::row_of(idx[(static_cast<size_t>(b) * M + m0) * k + e], N)
                       : 0;
  }
  __syncthreads();

  const int cv = C / V;  // 16-byte chunks a row
  const int nt = (k + kChunk - 1) / kChunk;
  auto issue = [&](int t) {
    T* slot = ring + (t % DEPTH) * stage;
    for (int q = threadIdx.x; q < kCenters * kChunk * cv; q += kThreads) {
      const int cc = q / (kChunk * cv);
      const int r = q % (kChunk * cv);
      const int jj = r / cv;
      const int v = r % cv;
      const int j = t * kChunk + jj;
      const bool ok = cc < nc && j < k;
      const T* src = ok ? fb + static_cast<size_t>(idx_s[cc * k + j]) * C + v * V : fb;
      cp_async16(slot + (cc * kChunk + jj) * C + v * V, src, ok ? 16 : 0);
    }
  };

  float acc[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) acc[p] = -INFINITY;

#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of stage t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nt) issue(t + DEPTH - 1);
    cp_async_commit();
    const T* slot = ring + (t % DEPTH) * stage;
    const int nj = min(kChunk, k - t * kChunk);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int pair = threadIdx.x + p * kThreads;
      if (pair < nc * C) {
        const int cc = pair / C;
        const int c = pair % C;
        for (int jj = 0; jj < nj; ++jj)
          acc[p] = group::pool_max(acc[p], to_f32(slot[(cc * kChunk + jj) * C + c]));
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
    const int pair = threadIdx.x + p * kThreads;
    if (pair < nc * C)
      out[(static_cast<size_t>(b) * M + m0) * C + pair] = from_f32<T>(acc[p]);
  }
}

template <typename T>
size_t smem_bytes(int depth, int k, int C) {
  return static_cast<size_t>(depth) * kCenters * kChunk * C * sizeof(T) +
         static_cast<size_t>(kCenters) * k * sizeof(int);
}

template <typename T, int DEPTH>
cudaError_t launch(const void* f, const void* idx, void* out, int B, int N, int M,
                   int k, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(DEPTH, k, C);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  auto kern = group_pipelined_kernel<T, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((M + kCenters - 1) / kCenters, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(f),
                                         static_cast<const int*>(idx),
                                         static_cast<T*>(out), M, N, k, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_depth(int depth, const void* f, const void* idx, void* out, int B,
                           int N, int M, int k, int C, cudaStream_t s) {
  if ((C * sizeof(T)) % 16 != 0 || kCenters * C > kPairs * kThreads)
    return cudaErrorInvalidValue;
  switch (depth) {
    case 2: return launch<T, 2>(f, idx, out, B, N, M, k, C, s);
    case 3: return launch<T, 3>(f, idx, out, B, N, M, k, C, s);
    case 4: return launch<T, 4>(f, idx, out, B, N, M, k, C, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As group_aggregate_launch (group_aggregate.cu), plus `depth` in {2, 3, 4}:
// the number of ring stages.  Takes C * sizeof(T) a multiple of 16 and
// C <= 256, with `f` 16-byte aligned; a ring that does not fit in 227 KB of
// shared memory returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int group_aggregate_pipelined_launch(const void* f, const void* idx,
                                                  void* out, int B, int N, int M, int k,
                                                  int C, int depth, int dtype,
                                                  int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(f) & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch_depth<T>(depth, f, idx, out, B, N, M, k, C, s));
}
