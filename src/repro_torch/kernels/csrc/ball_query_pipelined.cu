// K11: ball query with X tiles streamed through a `depth`-stage cp.async
// ring in shared memory (depth 2-4).
//
// Replaces: src/repro/pointcloud/kernels.py::ball_query_pipelined
// (_ball_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps X in HBM and streams its tiles into a rotating VMEM
// buffer with explicit async copies.
//
// Bound on an H100: the same work as K10 (ball_query.cu), so the same
// bound: operations, ~10 fp32 a center-point pair.
//
// Design: K10's warp-per-center body (ball_tile.cuh); what differs is how
// a tile arrives.  A tile of 256 points is one contiguous run of
// 256 * 3 elements, so it is copied as raw 16-byte cp.async chunks: the
// copy starts at the 16-byte boundary at or below the tile's first byte,
// and the tile is read from the slot at that offset.  The last chunk of the
// array reads only the bytes inside it (cp.async zero-fills the rest).  The
// schedule is K3's (BurstPipeline.stream_step): fill depth-1 tiles; at step
// t wait for tile t, sync the block, start tile t+depth-1 into the slot
// that step t-1 finished with, and update from tile t while later copies
// fly.  One commit group per tile (empty past the end).
#include "ball_tile.cuh"

namespace {

using namespace ball;

// Bytes of one ring slot: a tile plus the up-to-15-byte lead of its
// aligned start, rounded up to 16.
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return (kTile * 3 * static_cast<int>(sizeof(T)) + 16 + 15) / 16 * 16;
}

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
ball_pipelined_kernel(const T* __restrict__ xyz, const T* __restrict__ centers,
                      int* __restrict__ out, int B, int N, int M, int k, float r2) {
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int kSlot = slot_bytes<T>();
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = m < M;
  const char* x_end = reinterpret_cast<const char*>(xyz + static_cast<size_t>(B) * N * 3);
  const T* xb = xyz + static_cast<size_t>(b) * N * 3;
  int* row = out + (static_cast<size_t>(b) * M + m) * k;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) load_center(centers + (static_cast<size_t>(b) * M + m) * 3, cx, cy, cz);
  State st = init_state();
  const int nt = (N + kTile - 1) / kTile;

  // Byte offset of tile t's first point inside its slot.
  auto lead = [&](int t) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(xb + t * kTile * 3) & 15);
  };
  auto issue = [&](int t) {
    const char* first = reinterpret_cast<const char*>(xb + t * kTile * 3);
    const char* start = first - lead(t);
    const int n = min(kTile, N - t * kTile);
    const int chunks = (lead(t) + n * 3 * static_cast<int>(sizeof(T)) + 15) / 16;
    unsigned char* slot = ring + (t % DEPTH) * kSlot;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const char* src = start + 16 * c;
      const long left = static_cast<long>(x_end - src);
      const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(slot + 16 * c, bytes > 0 ? src : start, bytes);
    }
  };

#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nt) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of tile t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nt) issue(t + DEPTH - 1);
    cp_async_commit();
    const T* pts = reinterpret_cast<const T*>(ring + (t % DEPTH) * kSlot + lead(t));
    if (active)
      tile_update(st, pts, min(kTile, N - t * kTile), t * kTile, cx, cy, cz, r2, k, row);
  }
  cp_async_wait<0>();
  if (active) finalize(st, k, row);
}

template <typename T, int DEPTH>
cudaError_t launch(const void* xyz, const void* centers, void* out, int B, int N,
                   int M, int k, float r2, cudaStream_t stream) {
  const int smem = DEPTH * slot_bytes<T>();
  auto kern = ball_pipelined_kernel<T, DEPTH>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((M + kWarps - 1) / kWarps, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(xyz),
                                         static_cast<const T*>(centers),
                                         static_cast<int*>(out), B, N, M, k, r2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_depth(int depth, const void* xyz, const void* centers, void* out,
                           int B, int N, int M, int k, float r2, cudaStream_t s) {
  switch (depth) {
    case 2: return launch<T, 2>(xyz, centers, out, B, N, M, k, r2, s);
    case 3: return launch<T, 3>(xyz, centers, out, B, N, M, k, r2, s);
    case 4: return launch<T, 4>(xyz, centers, out, B, N, M, k, r2, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As ball_query_launch (ball_query.cu), plus `depth` in {2, 3, 4}: the
// number of X ring stages.  xyz must be 16-byte aligned.
REPRO_EXPORT int ball_query_pipelined_launch(const void* xyz, const void* centers,
                                             void* out, int B, int N, int M, int k,
                                             float r2, int depth, int dtype, int device,
                                             void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xyz) & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch_depth<T>(depth, xyz, centers, out, B, N, M, k, r2, s));
}
