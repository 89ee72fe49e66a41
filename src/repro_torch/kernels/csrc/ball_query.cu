// K10: ball query, the block's part of the cloud held in shared memory as
// fp32.
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
// shape that is 0.6 us of fp32 work against 0.05 us of bytes.  What the
// card spends is instruction issue and, where few centers leave SMs idle,
// the latency of one warp's walk over the cloud.
//
// Design (ball_tile.cuh): a block of `warps` warps, C centers a warp, one
// part of the cloud (a block of a cluster where the plan splits it).  All
// threads copy the part into shared memory once (16-byte loads), converted
// to fp32 as three coordinate arrays (one 4-byte load a coordinate, no
// bank conflicts, no conversion in the sweep), up to kResident points at a
// time; the block
// syncs once, and every warp sweeps the whole part without another barrier,
// stopping at its centers' k-th hits.  A part larger than kResident points
// goes through in tiles of kResident, the block stopping once all its
// centers are full (__syncthreads_and).  The plan (centers a warp, warps,
// split) is kernels/pipeline.py ball_plan's.
#include "ball_tile.cuh"

namespace {

using namespace ball;

// Most points of a part held at once (48 KB of fp32 coordinates).
constexpr int kResident = 4096;

// n points (3n elements from src) into xs/ys/zs as fp32, by the whole
// block: 16-byte loads (4 fp32 or 8 bf16/fp16) from the first 16-byte
// boundary on, single elements at the ragged ends.
template <typename T>
__device__ __forceinline__ void load_points(const T* __restrict__ src, int n, float* xs,
                                            float* ys, float* zs) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int total = 3 * n;
  const int head = min(total, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) &
                                               15) / static_cast<int>(sizeof(T)));
  const int nvec = (total - head) / V, tail = head + nvec * V;
  auto put = [&](int e, float v) {
    const int j = e / 3, d = e - 3 * j;
    (d == 0 ? xs : d == 1 ? ys : zs)[j] = v;
  };
  for (int e = threadIdx.x; e < head; e += blockDim.x) put(e, to_f32(src[e]));
  for (int e = tail + threadIdx.x; e < total; e += blockDim.x) put(e, to_f32(src[e]));
#pragma unroll 2
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load16(src + head + i * V, v);
#pragma unroll
    for (int u = 0; u < V; ++u) put(head + i * V + u, v[u]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(256)
ball_query_kernel(const T* __restrict__ xyz, const T* __restrict__ centers,
                  int* __restrict__ out, int N, int M, int k, float r2, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int split = gridDim.z, rank = blockIdx.z, b = blockIdx.y;
  const int centers_blk = warps * C;
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + cap;
  float* zs = ys + cap;
  int* inbox = reinterpret_cast<int*>(zs + cap);  // split > 1

  if (split > 1) cluster_arrive();
  const T* xb = xyz + static_cast<size_t>(b) * N * 3;
  const T* cb = centers + static_cast<size_t>(b) * M * 3;
  int* out_b = out + static_cast<size_t>(b) * M * k;
  const int m_base = blockIdx.x * centers_blk;
  const int m0 = m_base + warp * C;
  __shared__ Empties empties;
  if (threadIdx.x == 0) empties.n = 0;  // a block barrier comes before any use
  Centers<C> st;
  st.load(cb, m0, M, k);
  aim(st, out_b + static_cast<size_t>(m0) * k, inbox, centers_blk, k, split, rank);

  const int per = part_points(N, split);
  const int p0 = min(N, rank * per), p1 = min(N, p0 + per);
  if (split > 1) cluster_wait();  // the inboxes can take hits
  for (int t0 = p0; t0 < p1; t0 += cap) {
    const int n = min(cap, p1 - t0);
    load_points(xb + static_cast<size_t>(t0) * 3, n, xs, ys, zs);
    __syncthreads();
    sweep(st, n, t0, r2, k, [&](int j, float& x, float& y, float& z) {
      x = xs[j];
      y = ys[j];
      z = zs[j];
    });
    // every warp is done with the tile; stop once every center is full
    if (__syncthreads_and(st.full(k))) break;
  }
  if (split == 1) {
    pad_rows(st, m0, M, k, empties);
  } else {
    send_counts(st, inbox, centers_blk, split, rank);
    merge_parts(inbox, centers_blk, m_base, M, k, split, rank, out_b, empties);
  }
  fill_empty(empties, xb, cb, N, k, out_b);
}

// Points the block holds at once, and its shared memory.
inline int tile_points(int N, int split) {
  return min(min(part_points(N, split), N), kResident);
}
inline int smem_bytes(int N, int k, int warps, int cpw, int split) {
  return 12 * tile_points(N, split) + list_bytes(warps * cpw, k, split);
}

template <typename T, int C>
cudaError_t launch(const void* xyz, const void* centers, void* out, int B, int N, int M,
                   int k, float r2, int warps, int split, cudaStream_t s) {
  static bool attr_set = false;
  return launch_split(ball_query_kernel<T, C>, attr_set, C, B, M, warps, split,
                      smem_bytes(N, k, warps, C, split), s, static_cast<const T*>(xyz),
                      static_cast<const T*>(centers), static_cast<int*>(out), N, M, k, r2,
                      tile_points(N, split));
}

template <typename T>
cudaError_t dispatch(int cpw, const void* xyz, const void* centers, void* out, int B, int N,
                     int M, int k, float r2, int warps, int split, cudaStream_t s) {
  BALL_DISPATCH_C(cpw, (launch<T, C>(xyz, centers, out, B, N, M, k, r2, warps, split, s)));
  return cudaErrorInvalidValue;
}

}  // namespace

// xyz (B, N, 3) and centers (B, M, 3), fp32, bf16 or fp16, contiguous;
// out (B, M, k) int32; r2 the squared radius as the reference rounds it.
// The plan: cpw centers a warp (1, 2, 4, 8), warps a block (2, 4, 8),
// split parts of the cloud (1, 2, 4, 8; at most its 256-point tiles)
// whose shared memory fits.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue without launching for a plan
// it does not take).
REPRO_EXPORT int ball_query_launch(const void* xyz, const void* centers, void* out,
                                   int B, int N, int M, int k, float r2, int cpw,
                                   int warps, int split, int dtype, int device,
                                   void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || B > 65535 || !plan_ok(N, cpw, warps, split) ||
      smem_bytes(N, k, warps, cpw, split) > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch<T>(cpw, xyz, centers, out, B, N, M, k, r2, warps, split, s));
}

// Shared memory of one block of the plan (bytes); kernels/pipeline.py
// ball_smem_bytes mirrors it.
REPRO_EXPORT int ball_query_smem(int N, int k, int cpw, int warps, int split) {
  return smem_bytes(N, k, warps, cpw, split);
}
