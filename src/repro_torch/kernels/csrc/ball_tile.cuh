// The ball-query tile body shared by K10 (ball_query.cu) and K11
// (ball_query_pipelined.cu): one warp's update of its center's selection
// state over one X tile in shared memory, and the final padding.
//
// The port of _ball_select_update (src/repro/pointcloud/kernels.py:79).
// Where the TPU kernel ranks hits with a (bm, bn) cumsum and a (bm, k, bn)
// one-hot, a warp here takes 32 points at a time: __ballot_sync of
// d^2 <= r^2 gives the hit mask, and a hit's rank is the running count plus
// __popc of the hits in lower lanes.  Ranks below k are written straight to
// the output row, so "the first k hits in ascending index order" stays exact
// across tiles with no cumsum and no per-k state.  The count, the first hit
// and the nearest point (strict <, so the first occurrence wins) carry over
// in registers.
#pragma once

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace ball {

constexpr int kWarps = 8;               // centers per block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 256;              // points per X tile
constexpr unsigned kFull = 0xffffffffu;

struct State {
  int count;     // hits so far
  int first;     // index of the first hit (valid when count > 0)
  float best;    // least d^2 so far ...
  int best_idx;  // ... and its index (first occurrence)
};

__device__ __forceinline__ State init_state() { return State{0, 0, INFINITY, 0}; }

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

// One warp, one tile: `pts` holds n points (x, y, z interleaved, type T)
// whose global indices start at `base`.  `row` is the center's output row
// of k slots.  Every lane of the warp calls this with the same arguments.
template <typename T>
__device__ __forceinline__ void tile_update(State& st, const T* pts, int n,
                                            int base, float cx, float cy,
                                            float cz, float r2, int k,
                                            int* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  for (int g = 0; g < n; g += 32) {
    const int j = g + lane;
    const bool ok = j < n;
    float d2 = INFINITY;
    if (ok)
      d2 = sqdist(cx, cy, cz, to_f32(pts[3 * j]), to_f32(pts[3 * j + 1]),
                  to_f32(pts[3 * j + 2]));
    const bool in = ok && d2 <= r2;
    const unsigned hits = __ballot_sync(kFull, in);
    if (in) {
      const int rank = st.count + __popc(hits & lower);
      if (rank < k) row[rank] = base + j;
    }
    if (st.count == 0 && hits) st.first = base + g + __ffs(hits) - 1;
    st.count += __popc(hits);
    if (ok && d2 < st.best) {
      st.best = d2;
      st.best_idx = base + j;
    }
  }
}

// After the last tile: the nearest point over the whole warp, then every
// slot past the hits gets the first hit, or the nearest point if the ball
// is empty.
__device__ __forceinline__ void finalize(State st, int k, int* __restrict__ row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, st.best, off);
    const int oi = __shfl_xor_sync(kFull, st.best_idx, off);
    if (ob < st.best || (ob == st.best && oi < st.best_idx)) {
      st.best = ob;
      st.best_idx = oi;
    }
  }
  const int pad = st.count > 0 ? st.first : st.best_idx;
  for (int s = min(st.count, k) + lane; s < k; s += 32) row[s] = pad;
}

// This warp's center, as fp32.
template <typename T>
__device__ __forceinline__ void load_center(const T* c, float& cx, float& cy,
                                            float& cz) {
  cx = to_f32(c[0]);
  cy = to_f32(c[1]);
  cz = to_f32(c[2]);
}

}  // namespace ball
