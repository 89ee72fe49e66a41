// The ball-query body shared by K10 (ball_query.cu) and K11
// (ball_query_pipelined.cu): a warp's sweep of its centers over points in
// shared memory, the merge of a cloud split over a thread-block cluster,
// and the nearest-point pass of an empty ball.
//
// The port of _ball_select_update (src/repro/pointcloud/kernels.py:79).
// Where the TPU kernel ranks hits with a (bm, bn) cumsum and a (bm, k, bn)
// one-hot, a warp here takes 32 points at a time: __ballot_sync of
// d^2 <= r^2 gives the hit mask, and a hit's rank is the running count plus
// __popc of the hits in lower lanes.  Ranks below k are written straight to
// the center's list, so "the first k hits in ascending index order" stays
// exact across tiles with no cumsum and no per-k state.
//
// What a pair costs (the work is bound by instruction issue and by the
// latency of a warp's walk): a warp holds C centers in registers and tests
// each point it loads against all of them, so one point load serves C
// pairs; per pair only the eight-op distance and one compare remain, and
// one vote a step of two groups skips the ballots, ranks and stores where
// no center has a hit.  Points past the end are NaN, so no lane mask
// either.  A center stops at its k-th hit (exact: past it only the first
// hit is used, for padding); a warp stops when all its centers have.  The
// nearest point, needed only by an empty ball, is not tracked in the
// sweep: a center that ends with no hit gets a second, block-wide pass
// over the cloud for its first-occurrence argmin.
//
// Cloud split: where B * M / C warps leave SMs idle, the cloud is cut into
// `split` parts of whole kTile tiles, one block of a cluster each (grid z,
// cluster (1, 1, split)).  Each center's hits go straight, through
// distributed shared memory, to the inbox of the block that merges it
// (block r merges every split-th center), its count after the sweep;
// after one cluster barrier each block merges from its own shared memory:
// a prefix of the parts' counts says which part holds output slot s, so
// the result is the same on every run.
#pragma once

#include <cooperative_groups.h>
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace ball {

constexpr int kTile = 256;  // points a K11 ring slot; parts are whole tiles
constexpr int kMaxSplit = 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Points of one part of a cloud of N points split `split` ways.
__host__ __device__ inline int part_points(int N, int split) {
  return cdiv(cdiv(N, kTile), split) * kTile;
}

// Bytes of shared memory for a split's inbox (none without a split): a
// count and the first k hits from every part for each center this block
// merges.
__host__ __device__ inline int list_bytes(int centers, int k, int split) {
  if (split == 1) return 0;
  return 4 * cdiv(centers, split) * split * (1 + k);
}

// d^2 of point (x, y, z) from center (cx, cy, cz): the reference computes
// diff = c - x and sums diff*diff left to right, each step rounded on its
// own (no FMA contraction).
__device__ __forceinline__ float sqdist(float cx, float cy, float cz, float x,
                                        float y, float z) {
  const float dx = __fsub_rn(cx, x);
  const float dy = __fsub_rn(cy, y);
  const float dz = __fsub_rn(cz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A warp's C centers: coordinates, hits so far (k or more: full; an idle
// center past M starts full) and where each center's hits go: its output
// row, or with a split its slot in the inbox of the block that merges it.
// Every field is the same in every lane.
template <int C>
struct Centers {
  float x[C], y[C], z[C];
  int count[C];
  int* dst[C];

  template <typename T>
  __device__ __forceinline__ void load(const T* centers, int m0, int M, int k) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool on = m0 + c < M;
      const T* p = centers + 3 * static_cast<size_t>(on ? m0 + c : 0);
      x[c] = to_f32(p[0]);
      y[c] = to_f32(p[1]);
      z[c] = to_f32(p[2]);
      count[c] = on ? 0 : k;
    }
  }

  __device__ __forceinline__ bool full(int k) const {
    int least = count[0];
#pragma unroll
    for (int c = 1; c < C; ++c) least = min(least, count[c]);
    return least >= k;
  }
};

// NaN coordinates for a lane past the points: d^2 is NaN, never <= r^2.
__device__ __forceinline__ float no_point() { return __int_as_float(0x7fffffff); }

// kSteps groups of 32 points, one point a lane in each: (x[u], y[u], z[u])
// is point j0 + 32 u + lane (NaN past the points).  All distances first
// (independent chains), each lane or-ing its own compares, then one vote
// for the whole step: where no center has a hit, nothing else runs (per
// pair the eight-op distance and one compare); where one has, each
// center's ballot, ranks, stores and count are predicated, not branched,
// so the centers' chains overlap (a loop over only the ballots with hits
// was slower).  Returns whether any center had a hit (then the counts may
// have changed).
constexpr int kSteps = 2;

template <int C>
__device__ __forceinline__ bool step_update(Centers<C>& st, const float (&x)[kSteps],
                                            const float (&y)[kSteps],
                                            const float (&z)[kSteps], int j0, float r2,
                                            int k) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  float d2[kSteps][C];
  bool near = false;
#pragma unroll
  for (int u = 0; u < kSteps; ++u)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      d2[u][c] = sqdist(st.x[c], st.y[c], st.z[c], x[u], y[u], z[u]);
      near = near || d2[u][c] <= r2;
    }
  if (!__any_sync(kFull, near)) return false;  // the common case skips the rest
#pragma unroll
  for (int u = 0; u < kSteps; ++u)  // groups in index order: ranks stay exact
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const unsigned h = __ballot_sync(kFull, d2[u][c] <= r2);
      const int before = st.count[c];
      const int rank = before + __popc(h & lower);  // >= k once full: no store
      if (((h >> lane) & 1u) && rank < k) st.dst[c][rank] = j0 + 32 * u + lane;
      st.count[c] = before < k ? before + __popc(h) : before;
    }
  return true;
}

// The warp's sweep over n points whose global indices start at g0;
// `point(j, x, y, z)` reads local point j as fp32.  kSteps groups a step,
// all loaded first; a full center takes no more hits, and the warp stops
// once every center is full.
template <int C, typename Point>
__device__ __forceinline__ void sweep(Centers<C>& st, int n, int g0, float r2, int k,
                                      Point point) {
  const int lane = threadIdx.x & 31;
  bool full = st.full(k);
  for (int g = 0; g < n && !full; g += 32 * kSteps) {
    float x[kSteps], y[kSteps], z[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int j = g + 32 * u + lane;
      x[u] = y[u] = z[u] = no_point();
      if (j < n) point(j, x[u], y[u], z[u]);
    }
    if (step_update(st, x, y, z, g0 + g, r2, k)) full = st.full(k);
  }
}

// The empty balls of a block (static shared memory): the centers queued
// after the sweep (without a split) or the merge (with one), and the warps'
// partial argmins.
constexpr int kMaxWarps = 8;
constexpr int kMaxCenters = 64;  // 8 warps of 8 centers
struct Empties {
  int n;
  int m[kMaxCenters];
  float best[kMaxWarps];
  int idx[kMaxWarps];
};

// The least (d^2, index) over the warp, into every lane.
__device__ __forceinline__ void argmin_warp(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// Every row queued in `e` gets, in all k slots, the index of the point of
// cloud `xb` (N points, x, y, z interleaved) nearest to its center, first
// occurrence.  The whole block takes one center at a time: each thread
// walks points t, t + blockDim, ..., eight loaded before any is compared
// (a strict < in index order keeps a thread's first occurrence), then the
// least (d^2, index) over the warps.  Every thread of the block calls this.
template <typename T>
__device__ void fill_empty(Empties& e, const T* __restrict__ xb, const T* __restrict__ cb,
                           int N, int k, int* __restrict__ out_b) {
  constexpr int kAhead = 8;
  __syncthreads();  // every empty ball is queued
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, n = e.n;
  for (int q = 0; q < n; ++q) {
    const int m = e.m[q];
    const T* c = cb + 3 * static_cast<size_t>(m);
    const float cx = to_f32(c[0]), cy = to_f32(c[1]), cz = to_f32(c[2]);
    float best = INFINITY;
    int idx = 0;
    for (int j0 = threadIdx.x; j0 < N; j0 += blockDim.x * kAhead) {
      float x[kAhead], y[kAhead], z[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + blockDim.x * u;
        x[u] = y[u] = z[u] = no_point();
        if (j < N) {
          x[u] = to_f32(xb[3 * j]);
          y[u] = to_f32(xb[3 * j + 1]);
          z[u] = to_f32(xb[3 * j + 2]);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float d2 = sqdist(cx, cy, cz, x[u], y[u], z[u]);
        if (d2 < best) {
          best = d2;
          idx = j0 + blockDim.x * u;
        }
      }
    }
    argmin_warp(best, idx);
    if (lane == 0) {
      e.best[warp] = best;
      e.idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < warps ? e.best[lane] : INFINITY;
      idx = lane < warps ? e.idx[lane] : 0;
      argmin_warp(best, idx);
      for (int s = lane; s < k; s += 32) out_b[static_cast<size_t>(m) * k + s] = idx;
    }
    __syncthreads();  // e.best and e.idx are free again
  }
}

// Without a split, after the sweep: the hits are already in the output
// rows (dst); every slot past them gets the first hit (the row's slot 0),
// and an empty ball is queued for fill_empty.
template <int C>
__device__ __forceinline__ void pad_rows(const Centers<C>& st, int m0, int M, int k,
                                         Empties& e) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the warp's hits are in the rows
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (m0 + c >= M) continue;
    if (st.count[c] == 0) {
      if (lane == 0) e.m[atomicAdd(&e.n, 1)] = m0 + c;
      continue;
    }
    const int pad = st.dst[c][0];
    for (int s = min(st.count[c], k) + lane; s < k; s += 32) st.dst[c][s] = pad;
  }
}

// Where the warp's centers send their hits: without a split, their output
// rows; with one, local center i's slot in the inbox of block i % split,
// (i / split) * split + rank, after the inbox's counts (inbox layout:
// boxes counts, then boxes lists of k).
template <int C>
__device__ __forceinline__ void aim(Centers<C>& st, int* out_rows, int* inbox, int centers,
                                    int k, int split, int rank) {
  const int warp = threadIdx.x >> 5;
  const int boxes = cdiv(centers, split) * split;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (split == 1) {
      st.dst[c] = out_rows + static_cast<size_t>(c) * k;
    } else {
      const int i = warp * C + c;
      st.dst[c] = cooperative_groups::this_cluster().map_shared_rank(inbox, i % split) +
                  boxes + ((i / split) * split + rank) * k;
    }
  }
}

// With a split, after the sweep: each center's count to its inbox slot.
template <int C>
__device__ __forceinline__ void send_counts(const Centers<C>& st, int* inbox, int centers,
                                            int split, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = warp * C + c;
    if (lane == 0)
      cooperative_groups::this_cluster().map_shared_rank(inbox, i % split)
          [(i / split) * split + rank] = st.count[c];
  }
}

// With a split: once every block of the cluster has sent its parts (one
// cluster barrier), block `rank` writes the output rows of its local
// centers rank, rank + split, ..., one warp a center, from its inbox, and
// queues the empty balls for fill_empty.  Every thread of every block
// calls this.
__device__ inline void merge_parts(const int* inbox, int centers, int m_base, int M, int k,
                                   int split, int rank, int* __restrict__ out_b, Empties& e) {
  cooperative_groups::this_cluster().sync();  // every part is in its inbox
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int boxes = cdiv(centers, split) * split;
  const int* lists = inbox + boxes;
  for (int o = warp; o * split + rank < centers; o += warps) {
    const int m = m_base + o * split + rank;
    if (m >= M) break;
    const int* box = inbox + o * split;
    const int cnt = lane < split ? box[lane] : 0;
    int pre = cnt;  // inclusive prefix over the parts
#pragma unroll
    for (int off = 1; off < kMaxSplit; off <<= 1) {
      const int v = __shfl_up_sync(kFull, pre, off);
      if (lane >= off) pre += v;
    }
    const int total = __shfl_sync(kFull, pre, kMaxSplit - 1);
    int ex[kMaxSplit], cn[kMaxSplit];
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) {
      ex[p] = __shfl_sync(kFull, pre - cnt, p);
      cn[p] = __shfl_sync(kFull, cnt, p);
    }
    const int* part = lists + static_cast<size_t>(o * split) * k;  // part p at p * k
    const unsigned some = __ballot_sync(kFull, cnt > 0);
    if (!some) {  // an empty ball: fill_empty writes its row
      if (lane == 0) e.m[atomicAdd(&e.n, 1)] = m;
      continue;
    }
    const int pad = part[(__ffs(some) - 1) * k];
    int* row = out_b + static_cast<size_t>(m) * k;
    for (int s = lane; s < k; s += 32) {
      int v = pad;
      if (s < total) {
#pragma unroll
        for (int p = 0; p < kMaxSplit; ++p)
          if (s >= ex[p] && s < ex[p] + cn[p]) v = part[p * k + (s - ex[p])];
      }
      row[s] = v;
    }
  }
}

// Dynamic shared memory a block may use: 1 KB is left for its static
// shared memory (Empties, 324 bytes, laid out by the compiler with padding).
constexpr int kMaxDynamicSmem = 232448 - 1024;
static_assert(sizeof(Empties) <= 1024, "Empties must fit the static share");

// Launch `kern` on grid (cdiv(M, warps * C), B, split) of `warps` warps,
// a cluster of `split` blocks along z when split > 1.  `attr_set` is the
// caller's flag (one a kernel) that the shared-memory limit is raised.
template <typename Kern, typename... Args>
cudaError_t launch_split(Kern kern, bool& attr_set, int C, int B, int M, int warps,
                         int split, int smem, cudaStream_t stream, Args... args) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(M, warps * C), B, split);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = split;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Dispatch on centers a warp (1, 2, 4, 8): `CALL` sees C as a constexpr.
#define BALL_DISPATCH_C(cpw, CALL)                    \
  do {                                                \
    switch (cpw) {                                    \
      case 1: { constexpr int C = 1; return CALL; }   \
      case 2: { constexpr int C = 2; return CALL; }   \
      case 4: { constexpr int C = 4; return CALL; }   \
      case 8: { constexpr int C = 8; return CALL; }   \
      default: return cudaErrorInvalidValue;          \
    }                                                 \
  } while (0)

// The plan checks both entry points share: centers a warp 1/2/4/8, warps
// a block 2/4/8, split 1/2/4/8 and no more parts than tiles.
__host__ inline bool plan_ok(int N, int cpw, int warps, int split) {
  return (cpw == 1 || cpw == 2 || cpw == 4 || cpw == 8) &&
         (warps == 2 || warps == 4 || warps == 8) &&
         (split == 1 || split == 2 || split == 4 || split == 8) && split <= cdiv(N, kTile);
}

}  // namespace ball
