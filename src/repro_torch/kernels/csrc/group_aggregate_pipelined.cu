// K13: grouped feature aggregation with a channel slice of the cloud copied
// whole into shared memory in feature tiles by TMA, each row read from
// device memory once and gathered from shared memory.
//
// Replaces: src/repro/pointcloud/kernels.py::group_aggregate_pipelined
// (_group_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps the features in HBM and streams feature tiles into
// a rotating VMEM buffer with explicit async copies; every tile serves
// every center whose neighbours fall in it.
//
// Bound on an H100: the same work as K12 (group_aggregate.cu): bytes, the
// distinct rows read once.  What limits this design is the gather out of
// shared memory: B·M·k rows of the slice at 128 bytes a clock an SM.
//
// Design: a block owns cloud b, a slice of CS channels (16 L bytes of a
// row, L = 1, 2, 4 or 8) and, where the plan splits the cloud's centers
// over a cluster of `split` blocks, a share of its centers.  The cloud's
// slice lies whole in shared memory: it copies the rows [t bn, (t + 1) bn)
// x CS of each of the nt = ceil(N / bn) tiles into slot t, a 2-D TMA box
// over the features as a (B N, C) matrix, completing on the slot's
// mbarrier.  No slot is refilled, so nothing is released and no block
// waits on another.  Under a split each block copies 1/split of every
// tile's rows with one multicast, which lands in every block of the
// cluster, so a row crosses from L2 once a cluster.  A cloud whose
// narrowest slice does not fit a block takes K12 (the plan rule:
// kernels/pipeline.py group_plan).
//
// The gather: L lanes take one center at a time (a lane group; each group
// keeps up to kCpg centers), lane l the 16-byte chunk l of the slice row,
// into running maxima kept in the features' type (group::max16: one
// packed max.NaN a 4-byte word).  The block's centers' neighbours are
// loaded first (kIdxBatch loads in flight a thread, overlapping the
// tiles' copies), clamped (group::row_of) and stored as byte offsets of
// their rows, in 16-byte chunks of four (entries past k repeat the first:
// a max takes a repeat unchanged).  The slots hold the slice in row order:
// the block waits for all of them and each group folds its centers' k rows
// in one pass, 8 at a time (two chunks of offsets, then 8 rows, then the
// maxima), with no test on any entry.  Correctness assumes no order of the
// indices.
//
// Layout and bank conflicts: slice rows lie unpadded, 16 L bytes apart, as
// the TMA box lands them.  A quarter-warp's 16-byte loads are one
// shared-memory wavefront when its 8 addresses fall in distinct 16-byte
// bank groups.  A center's offsets take an odd number of 16-byte chunks,
// so the groups of a warp reading chunk j of consecutive centers hit
// distinct bank groups.  With 128-byte rows (L = 8) a quarter-warp reads
// one whole row: conflict-free for any index.  Narrower rows put 8 / L
// random rows in one wavefront, which conflict as their rows collide
// modulo 128 bytes; no padding or swizzle removes a conflict between
// random rows, so chip_smoke.py's sweep reports the time of each slice
// width, and the plan rule weighs it against the copies a slice needs.
#include <type_traits>

#include "group_tile.cuh"
#include "tma.cuh"

namespace {

using group::cdiv;

constexpr int kThreads = 512;
constexpr int kCpg = 4;        // most centers a lane group keeps
constexpr int kIdxBatch = 8;   // index loads a thread has in flight
constexpr int kMaxSmem = 232448;

// Byte offsets in a block's dynamic shared memory, and its total.
// kernels/pipeline.py group_smem_bytes mirrors it.
struct Layout {
  int offs, bars, total;
  __host__ __device__ Layout(int bn, int row_bytes, int nt, int mb, int k) {
    offs = nt * bn * row_bytes;                  // the slots: a multiple of 1 KB
    bars = offs + 16 * mb * (cdiv(k, 4) | 1);    // an odd count of 16-byte chunks a center
    total = bars + 8 * nt;
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
group_tiled_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ idx,
                   T* __restrict__ out, int N, int M, int k, int C, int bn, int mb) {
  constexpr int V = Vec16<T>::N;
  constexpr int CS = L * V;          // channels of the slice
  constexpr int kRowBytes = 16 * L;  // bytes of a slice row
  constexpr int G = kThreads / L;    // lane groups
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = gridDim.x, rank = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int nt = cdiv(N, bn), sq = cdiv(k, 4) | 1;
  const Layout lay(bn, kRowBytes, nt, mb, k);
  unsigned char* slice = smem;
  int* offs = reinterpret_cast<int*>(smem + lay.offs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int m_lo = rank * mb;
  const int nm = max(0, min(mb, M - m_lo));
  const int part = bn / split;  // rows of a tile this block copies
  const uint32_t tile_bytes = static_cast<uint32_t>(bn) * kRowBytes;

  // thread 0: tile t into slot t, this block's part of its rows to every
  // block of the cluster
  auto issue = [&](int t) {
    uint64_t* bar = full + t;
    tma::mbar_expect(bar, tile_bytes);
    unsigned char* dst = slice + (static_cast<size_t>(t) * bn + rank * part) * kRowBytes;
    const int row = b * N + t * bn + rank * part;
    if (split == 1)
      tma::load_2d(dst, &map, s * CS, row, bar);
    else
      tma::load_2d_multicast(dst, &map, s * CS, row, bar,
                             static_cast<uint16_t>((1u << split) - 1));
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < nt; ++i) tma::mbar_init(full + i, 1);
    tma::fence_barrier_init();
  }
  // warp 0 starts the copies as soon as every block's mbarriers exist; the
  // other warps meet the cluster barrier after their share of the indices
  if (split > 1) cluster_arrive();
  if (threadIdx.x < 32) {
    if (split > 1) cluster_wait();
    if (threadIdx.x == 0)
      for (int t = 0; t < nt; ++t) issue(t);
  }

  // The block's centers' neighbours as byte offsets of their rows in the
  // slice (clamped: group::row_of), center c's in 16-byte chunks of four
  // at offs[4 (c sq + j)]; entries past k repeat entry 0 (a max takes a
  // repeat unchanged), so every chunk is whole.  kIdxBatch loads in flight
  // a thread, of four indices each where k is a multiple of 4; the center
  // of entry e is e / k by a float product, exact at these sizes.
  const int* ib = idx + (static_cast<size_t>(b) * M + m_lo) * k;
  const int kq = cdiv(k, 4);
  int4* offs4 = reinterpret_cast<int4*>(offs);
  if (k % 4 == 0) {
    const int4* ib4 = reinterpret_cast<const int4*>(ib);
    const int total = nm * kq;
    const float inv = 1.0f / static_cast<float>(kq);
    for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kIdxBatch) {
      int4 v[kIdxBatch];
#pragma unroll
      for (int u = 0; u < kIdxBatch; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = e < total ? __ldg(ib4 + e) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kIdxBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int c = static_cast<int>((static_cast<float>(e) + 0.5f) * inv);
        if (e < total)
          offs4[c * sq + e - c * kq] =
              make_int4(group::row_of(v[u].x, N) * kRowBytes, group::row_of(v[u].y, N) * kRowBytes,
                        group::row_of(v[u].z, N) * kRowBytes, group::row_of(v[u].w, N) * kRowBytes);
      }
    }
  } else {
    const int total = nm * k;
    const float inv = 1.0f / static_cast<float>(k);
    for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kIdxBatch) {
      int v[kIdxBatch];
#pragma unroll
      for (int u = 0; u < kIdxBatch; ++u) {
        const int e = e0 + u * kThreads;
        v[u] = e < total ? __ldg(ib + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kIdxBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int c = static_cast<int>((static_cast<float>(e) + 0.5f) * inv);
        if (e < total) offs[c * 4 * sq + e - c * k] = group::row_of(v[u], N) * kRowBytes;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nm; c += kThreads)
      for (int j = k; j < 4 * kq; ++j) offs[c * 4 * sq + j] = offs[c * 4 * sq];
  }
  if (split > 1 && threadIdx.x >= 32) cluster_wait();
  __syncthreads();  // the offsets are in place; the mbarriers are visible

  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const unsigned char* mine = slice + lane * 16;  // this lane's chunk of row 0
  uint4 acc[kCpg];
#pragma unroll
  for (int i = 0; i < kCpg; ++i) acc[i] = group::neg_inf16<T>();
  // the slots are the slice in row order, so once all have landed each
  // center's k rows are one pass, 8 at a time (two chunks of offsets, then
  // the rows, then the maxima)
  for (int t = 0; t < nt; ++t) tma::mbar_wait(full + t, 0);
#pragma unroll
  for (int i = 0; i < kCpg; ++i) {
    const int c = g + i * G;
    if (c >= nm) continue;
    const int4* q = reinterpret_cast<const int4*>(offs) + c * sq;
    for (int j = 0; j < kq; j += 2) {
      const int4 a = q[j];
      const int4 z = j + 1 < kq ? q[j + 1] : a;
      const int o[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = *reinterpret_cast<const uint4*>(mine + o[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) group::max16<T>(acc[i], v[u]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCpg; ++i) {
    const int c = g + i * G;
    if (c < nm)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * M + m_lo + c) * C + s * CS +
                                lane * V) = acc[i];
  }
}

template <typename T, int L>
cudaError_t launch(const void* f, const void* idx, void* out, int B, int N, int M, int k,
                   int C, int bn, int split, cudaStream_t stream) {
  constexpr int CS = L * Vec16<T>::N;
  const int mb = cdiv(M, split);
  if (C % CS || cdiv(mb, kThreads / L) > kCpg) return cudaErrorInvalidValue;
  const int smem = Layout(bn, 16 * L, cdiv(N, bn), mb, k).total;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  auto kern = group_tiled_kernel<T, L>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap map;
  const CUtensorMapDataType type = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = tma::make_map_2d(&map, type, sizeof(T), f, B * N, C, CS, bn / split,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, C / CS, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, map, static_cast<const int*>(idx), static_cast<T*>(out), N,
                         M, k, C, bn, mb);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cs, const void* f, const void* idx, void* out, int B, int N, int M,
                     int k, int C, int bn, int split, cudaStream_t s) {
  if ((C * sizeof(T)) % 16) return cudaErrorInvalidValue;
  switch (cs * static_cast<int>(sizeof(T))) {
    case 16: return launch<T, 1>(f, idx, out, B, N, M, k, C, bn, split, s);
    case 32: return launch<T, 2>(f, idx, out, B, N, M, k, C, bn, split, s);
    case 64: return launch<T, 4>(f, idx, out, B, N, M, k, C, bn, split, s);
    case 128: return launch<T, 8>(f, idx, out, B, N, M, k, C, bn, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As group_aggregate_launch (group_aggregate.cu), with K13's plan: tiles of
// `bn` rows (64, 128 or 256), slices of `cs` channels (16, 32, 64 or 128
// bytes of a row, dividing C), the centers split over a cluster of `split`
// blocks (1, 2, 4 or 8; bn / split >= 8 rows a part) and `depth` slots,
// which must be the tiles, ceil(N / bn): the whole slice lies in shared
// memory.  Takes C * sizeof(T) a multiple of 16 and `f` 16-byte
// aligned; a block that does not fit in 227 KB of shared memory returns
// cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int group_aggregate_pipelined_launch(const void* f, const void* idx,
                                                  void* out, int B, int N, int M, int k,
                                                  int C, int bn, int cs, int split, int depth,
                                                  int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0 || k <= 0 || C <= 0 || cs <= 0)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * N > 0x7fffffff) return cudaErrorInvalidValue;
  if (bn != 64 && bn != 128 && bn != 256) return cudaErrorInvalidValue;
  if (split != 1 && split != 2 && split != 4 && split != 8) return cudaErrorInvalidValue;
  const int nt = cdiv(N, bn);
  if (bn / split < 8 || depth != nt || C / cs > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(f) & 15) return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch<T>(cs, f, idx, out, B, N, M, k, C, bn, split, s));
}
