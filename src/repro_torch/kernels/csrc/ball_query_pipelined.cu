// K11: ball query with X tiles streamed through a `depth`-stage ring of TMA
// bulk copies in shared memory (depth 2-4).
//
// Replaces: src/repro/pointcloud/kernels.py::ball_query_pipelined
// (_ball_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps X in HBM and streams its tiles into a rotating VMEM
// buffer with explicit async copies.
//
// Bound on an H100: the same work as K10 (ball_query.cu), so the same
// bound: operations, ~10 fp32 a center-point pair.
//
// Design: K10's block (C centers a warp, the cloud split over a cluster
// where the plan says; ball_tile.cuh); what differs is how the points
// arrive.  A tile of 256 points is one contiguous run of 256 * 3 elements,
// so one thread copies it with one 1-D bulk copy (cp.async.bulk, the TMA
// unit computes the addresses) that completes on the slot's mbarrier: the
// copy starts at the 16-byte boundary at or below the tile's first byte and
// the tile is read from the slot at that offset.  The copy stops at the last
// 16-byte boundary of the array; the few bytes past it (the array's last
// tile only) are copied by that thread with plain loads.  Warps read the
// raw tile (x, y, z interleaved: stride-3 loads, no bank conflicts) and
// convert as they go.  The schedule is K3's (BurstPipeline.stream_step):
// `depth` tiles in flight; at step t every thread waits on tile t's
// mbarrier, the warps sweep it, and the block's barrier releases the slot
// (block-synchronous: no per-warp release), after which the thread refills
// it with tile t + depth, after a fence.proxy.async that orders the warps'
// generic reads of the slot before the TMA write.  The barrier also asks whether every center is
// full (__syncthreads_and); if so no more tiles are issued, and the copies
// in flight are waited for before the block moves on.
#include "ball_tile.cuh"
#include "tma.cuh"

namespace {

using namespace ball;

// Bytes of one ring slot: a tile plus the up-to-15-byte lead of its
// aligned start, rounded up to 16.
template <typename T>
__host__ __device__ constexpr int slot_bytes() {
  return (kTile * 3 * static_cast<int>(sizeof(T)) + 16 + 15) / 16 * 16;
}
constexpr int kBarBytes = 32;  // one mbarrier a stage, four stages

template <typename T, int C>
__global__ void __launch_bounds__(256)
ball_pipelined_kernel(const T* __restrict__ xyz, const T* __restrict__ centers,
                      int* __restrict__ out, int B, int N, int M, int k, float r2,
                      int depth) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kSlot = slot_bytes<T>();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int split = gridDim.z, rank = blockIdx.z, b = blockIdx.y;
  const int centers_blk = warps * C;
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + depth * kSlot);
  int* inbox = reinterpret_cast<int*>(smem + depth * kSlot + kBarBytes);  // split > 1

  if (split > 1) cluster_arrive();
  const char* x_end = reinterpret_cast<const char*>(xyz + static_cast<size_t>(B) * N * 3);
  const char* x_lim = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(x_end) &
                                                    ~static_cast<uintptr_t>(15));
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

  // this block's tiles: [q0, q0 + nt) of the cloud's
  const int per = part_points(N, split) / kTile;
  const int q0 = rank * per;
  const int nt = max(0, min(cdiv(N, kTile), q0 + per) - q0);

  auto first_byte = [&](int t) {
    return reinterpret_cast<const char*>(xb + static_cast<size_t>(q0 + t) * kTile * 3);
  };
  auto lead = [&](int t) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(first_byte(t)) & 15);
  };
  auto points = [&](int t) { return min(kTile, N - (q0 + t) * kTile); };
  // thread 0: tile t into slot t % depth
  auto issue = [&](int t) {
    const char* first = first_byte(t);
    const char* start = first - lead(t);
    const char* stop = first + points(t) * 3 * static_cast<int>(sizeof(T));
    const char* bend = start + (stop - start + 15) / 16 * 16;
    if (bend > x_lim) bend = x_lim > start ? x_lim : start;
    unsigned char* slot = ring + (t % depth) * kSlot;
    const uint32_t bulk = static_cast<uint32_t>(bend - start);
    // the warps' generic reads of the slot's last tile (before the block
    // barrier that released it), ordered before this TMA write
    // (tools/int8_ring_race.py: a ring without the fence gave wrong tiles)
    tma::fence_proxy_async();
    for (const char* p = bend > first ? bend : first; p < stop; ++p) slot[p - start] = *p;
    tma::mbar_expect(full + t % depth, bulk);
    if (bulk) tma::load_1d(slot, start, bulk, full + t % depth);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) tma::mbar_init(full + s, 1);
    tma::fence_barrier_init();
    for (int t = 0; t < min(depth, nt); ++t) issue(t);
  }
  __syncthreads();  // the barriers and any plain-copied bytes are visible
  if (split > 1) cluster_wait();  // the inboxes can take hits
  int issued = min(depth, nt), t = 0;
  for (; t < nt; ++t) {
    tma::mbar_wait(full + t % depth, (t / depth) & 1);
    const T* pts = reinterpret_cast<const T*>(ring + (t % depth) * kSlot + lead(t));
    sweep(st, points(t), (q0 + t) * kTile, r2, k,
          [&](int j, float& x, float& y, float& z) {
            x = to_f32(pts[3 * j]);
            y = to_f32(pts[3 * j + 1]);
            z = to_f32(pts[3 * j + 2]);
          });
    // every warp is done with slot t % depth; stop once every center is full
    if (__syncthreads_and(st.full(k))) {
      ++t;
      break;
    }
    if (t + depth < nt) {
      if (threadIdx.x == 0) issue(t + depth);
      ++issued;
    }
  }
  // copies still in flight land before the block's shared memory is reused
  if (threadIdx.x == 0)
    for (int u = t; u < issued; ++u) tma::mbar_wait(full + u % depth, (u / depth) & 1);

  if (split == 1) {
    pad_rows(st, m0, M, k, empties);
  } else {
    send_counts(st, inbox, centers_blk, split, rank);
    merge_parts(inbox, centers_blk, m_base, M, k, split, rank, out_b, empties);
  }
  fill_empty(empties, xb, cb, N, k, out_b);
}

template <typename T>
int smem_bytes(int k, int warps, int cpw, int split, int depth) {
  return depth * slot_bytes<T>() + kBarBytes + list_bytes(warps * cpw, k, split);
}

template <typename T, int C>
cudaError_t launch(const void* xyz, const void* centers, void* out, int B, int N, int M,
                   int k, float r2, int warps, int split, int depth, cudaStream_t s) {
  static bool attr_set = false;
  return launch_split(ball_pipelined_kernel<T, C>, attr_set, C, B, M, warps, split,
                      smem_bytes<T>(k, warps, C, split, depth), s,
                      static_cast<const T*>(xyz), static_cast<const T*>(centers),
                      static_cast<int*>(out), B, N, M, k, r2, depth);
}

template <typename T>
cudaError_t dispatch(int cpw, const void* xyz, const void* centers, void* out, int B, int N,
                     int M, int k, float r2, int warps, int split, int depth,
                     cudaStream_t s) {
  if (depth < 2 || depth > 4 || smem_bytes<T>(k, warps, cpw, split, depth) > kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  BALL_DISPATCH_C(cpw,
                  (launch<T, C>(xyz, centers, out, B, N, M, k, r2, warps, split, depth, s)));
  return cudaErrorInvalidValue;
}

}  // namespace

// As ball_query_launch (ball_query.cu), plus `depth` in {2, 3, 4}: the
// number of ring stages.  xyz must be 16-byte aligned.
REPRO_EXPORT int ball_query_pipelined_launch(const void* xyz, const void* centers,
                                             void* out, int B, int N, int M, int k,
                                             float r2, int cpw, int warps, int split,
                                             int depth, int dtype, int device,
                                             void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || B > 65535 || !plan_ok(N, cpw, warps, split))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(xyz) & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(
      dtype, T, dispatch<T>(cpw, xyz, centers, out, B, N, M, k, r2, warps, split, depth, s));
}

// Shared memory of one block of the plan (bytes); kernels/pipeline.py
// ball_smem_bytes mirrors it.
REPRO_EXPORT int ball_query_pipelined_smem(int k, int cpw, int warps, int split, int depth,
                                           int dtype) {
  if (dtype == kFloat32) return smem_bytes<float>(k, warps, cpw, split, depth);
  return smem_bytes<__half>(k, warps, cpw, split, depth);
}
