// K10: ball query, X tiles loaded synchronously.
//
// Replaces: src/repro/pointcloud/kernels.py::ball_query (_ball_kernel), the
// Pallas TPU kernel that streams X tiles over the sequential grid axis
// while the per-center selection state stays in VMEM scratch.
//
// Semantics (pointcloud/ref.py): per center, the first k point indices with
// d^2 <= r^2 in ascending order; slots past the hits hold the first hit; a
// center with an empty ball gets its nearest point (first occurrence).
// r^2 is passed in as the fp32 value the reference compares against.
//
// Bound on an H100: operations (~10 fp32 a center-point pair: 3 sub, 3 mul,
// 2 add, 2 compares) against 12 bytes a point read once; at the bench's
// shape that is 0.6 us of fp32 work against 0.05 us of bytes.
//
// Design: a block holds 8 centers, one warp each (ball_tile.cuh), and sweeps
// all N points in tiles of 256.  Each tile is copied element by element
// into shared memory by all 256 threads, the block syncs, every warp
// updates its center from the tile, and the block syncs again before the
// next copy: copy and compute do not overlap (K11 overlaps them).
#include "ball_tile.cuh"

namespace {

using namespace ball;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const T* __restrict__ xyz, const T* __restrict__ centers,
                  int* __restrict__ out, int N, int M, int k, float r2) {
  __shared__ __align__(16) unsigned char tile_raw[kTile * 3 * sizeof(T)];
  T* tile = reinterpret_cast<T*>(tile_raw);
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool active = m < M;  // a tail warp still joins every barrier
  const T* xb = xyz + static_cast<size_t>(b) * N * 3;
  int* row = out + (static_cast<size_t>(b) * M + m) * k;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) load_center(centers + (static_cast<size_t>(b) * M + m) * 3, cx, cy, cz);
  State st = init_state();

  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int n = min(kTile, N - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int e = threadIdx.x; e < n * 3; e += kThreads) tile[e] = xb[t0 * 3 + e];
    __syncthreads();
    if (active) tile_update(st, tile, n, t0, cx, cy, cz, r2, k, row);
  }
  if (active) finalize(st, k, row);
}

template <typename T>
cudaError_t launch(const void* xyz, const void* centers, void* out, int N, int M, int k,
                   float r2, dim3 grid, cudaStream_t s) {
  ball_query_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(xyz),
                                                 static_cast<const T*>(centers),
                                                 static_cast<int*>(out), N, M, k, r2);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) and centers (B, M, 3), fp32, bf16 or fp16, contiguous;
// out (B, M, k) int32; r2 the squared radius as the reference rounds it.
// Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int ball_query_launch(const void* xyz, const void* centers, void* out,
                                   int B, int N, int M, int k, float r2, int dtype,
                                   int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kWarps - 1) / kWarps, B);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(xyz, centers, out, N, M, k, r2, grid, s));
}
