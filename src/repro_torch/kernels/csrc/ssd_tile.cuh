// The chunk step shared by K7 (ssd_scan.cu) and K8 (ssd_scan_pipelined.cu):
// one thread block walks the chunks of one (batch, head) in order and keeps
// the (N, P) fp32 state in shared memory from chunk to chunk.  Per chunk of
// Q positions (positions past the sequence carry dt = 0: zero input, unit
// decay, so they add nothing):
//
//   acum  = cumsum(dt * A)
//   M     = [k <= q] (C_q . B_k) exp(acum_q - acum_k) dt_k        (Q x Q)
//   y     = exp(acum_q) (C_q . h) + M x                            (Q x P)
//   h    <- exp(acum_last) h + sum_k exp(acum_last - acum_k) dt_k B_k (x) x_k
//
// The mask is a select: exp(acum_q - acum_k) for k > q has a positive
// exponent and may be inf, so it is never computed (inf * 0 would be NaN).
// All arithmetic is fp32 on the CUDA cores, whatever the I/O dtype (fp32,
// bf16 or fp16: inputs are widened as they land in shared memory and y is
// rounded once to x's dtype, as the reference's .astype(f32) ... .astype(
// y.dtype) does).  Each of the four products is a 4 x 4 register tile a
// thread over shared-memory operands read as float4 (`tile_mma`); a tile's
// rows are interleaved (r, r + R/4, ...) and its columns contiguous, so a
// warp's reads of the column operand are consecutive and those of the row
// operand are broadcasts.
//
// P and N need not be multiples of 4: shared memory holds them padded to
// PP = round_up(P, 4) and NP = round_up(N, 4) with the padding zero-filled,
// which adds nothing to any product, and only the first P columns of y are
// stored.  Rows that are whole 4-element groups load and store 4 at a time;
// other rows element by element (the kernels' ALIGNED instantiation fixes
// the first case at compile time).  x of the chunk always has row stride
// PP in shared memory.
#pragma once

#include "common.cuh"

namespace ssd {

constexpr int kThreads = 256;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Real and padded widths of one scan.
struct Dims {
  int P, N;    // head dim, state size
  int PP, NP;  // padded to multiples of 4
};
__host__ __device__ inline Dims dims(int P, int N) { return Dims{P, N, pad4(P), pad4(N)}; }

// Fixed part of the shared memory (floats): the state h (NP x PP), B of the
// chunk transposed (NP x Q+4), the masked scores M (Q x Q+4), and acum, dt,
// exp(acum) and the state weights w (Q each).
__host__ __device__ constexpr int fixed_floats(int Q, int PP, int NP) {
  return NP * PP + NP * (Q + 4) + Q * (Q + 4) + 4 * Q;
}
// One chunk's x (Q x PP) and C (Q x NP+4) in fp32.
__host__ __device__ constexpr int chunk_floats(int Q, int PP, int NP) {
  return Q * PP + Q * (NP + 4);
}

struct Smem {
  float* h;
  float* bt;
  float* m;
  float* acum;
  float* dts;
  float* eq;
  float* w;
};

__device__ __forceinline__ Smem carve(float* base, int Q, const Dims& dm) {
  Smem s;
  s.h = base;
  s.bt = s.h + dm.NP * dm.PP;
  s.m = s.bt + dm.NP * (Q + 4);
  s.acum = s.m + Q * (Q + 4);
  s.dts = s.acum + Q;
  s.eq = s.dts + Q;
  s.w = s.eq + Q;
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_{k < K} a[r[i] * lda + k] * b[k * ldb + c + j]; K % 4 == 0.
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* a, int lda,
                                         const int (&r)[4], const float* b, int ldb,
                                         int c, int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + r[i] * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = ld4(b + (k + kk) * ldb + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(av[i], kk);
        acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
        acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
        acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
        acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Tile t of an R x C output: rows rt, rt + R/4, ... and columns 4ct .. 4ct+3.
__device__ __forceinline__ int tile_rows(int t, int R, int C, int (&r)[4]) {
  const int ct_n = C / 4;
  const int rt = t / ct_n;
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = rt + (R / 4) * i;
  return 4 * (t % ct_n);
}

// Four elements (col .. col+3) of a row of `cols` valid elements as fp32:
// one 4-element load where the row is whole groups of 4 (`vec`), else one
// element at a time with columns at or past `cols` read as 0.
template <typename T>
__device__ __forceinline__ float4 row4(const T* row, int col, int cols, bool vec) {
  if (vec) return load4(row + col);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < cols ? to_f32(row[col + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Q rows of `cols` elements of T (row stride `ld`, rows >= `valid` read as
// 0) into fp32 shared memory `dst` (row stride `lds`, padded columns up to
// pad4(cols) zero-filled).  `vec`: cols % 4 == 0 and rows 4-element aligned.
template <int Q, typename T>
__device__ __forceinline__ void load_rows(float* dst, int lds, const T* src, size_t ld,
                                          int cols, int valid, bool vec) {
  const int groups = pad4(cols) / 4;
  for (int idx = threadIdx.x; idx < Q * groups; idx += kThreads) {
    const int row = idx / groups;
    const int col = (idx % groups) * 4;
    st4(dst + row * lds + col, row < valid ? row4(src + row * ld, col, cols, vec)
                                           : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Q rows of B (N elements of T, row stride `ld`, rows >= `valid` read as 0)
// into bt (NP x Q+4), transposed.  Lanes walk rows, so the transposed
// stores are conflict-free.
template <int Q, typename T>
__device__ __forceinline__ void transpose_b(float* bt, const T* src, size_t ld, int valid,
                                            const Dims& dm, bool vec) {
  for (int idx = threadIdx.x; idx < Q * (dm.NP / 4); idx += kThreads) {
    const int row = idx % Q;
    const int n = (idx / Q) * 4;
    const float4 v = row < valid ? row4(src + row * ld, n, dm.N, vec)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    bt[(n + 0) * (Q + 4) + row] = v.x;
    bt[(n + 1) * (Q + 4) + row] = v.y;
    bt[(n + 2) * (Q + 4) + row] = v.z;
    bt[(n + 3) * (Q + 4) + row] = v.w;
  }
}

// Warp 0: dt of the chunk (0 past `valid`), acum = cumsum(dt * A) by a warp
// scan, eq = exp(acum) and w = exp(acum_last - acum) * dt.  A chunk of 16
// leaves lanes 16..31 on zeros past its end.
template <int Q, typename T>
__device__ __forceinline__ void scan_chunk(const Smem& s, const T* __restrict__ dt,
                                           float A, int valid) {
  static_assert(Q % 32 == 0 || Q == 16, "chunk: a multiple of the warp, or 16");
  constexpr int E = Q >= 32 ? Q / 32 : 1;
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float v[E], d[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane * E + e;
    d[e] = idx < valid && idx < Q ? to_f32(dt[idx]) : 0.f;
    run = __fadd_rn(run, __fmul_rn(d[e], A));
    v[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = __fadd_rn(inc, y);
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  float acum[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acum[e] = __fadd_rn(excl, v[e]);
  const float last = __shfl_sync(0xffffffffu, acum[(Q - 1) % E], (Q - 1) / E);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane * E + e;
    if (idx < Q) {
      s.acum[idx] = acum[e];
      s.dts[idx] = d[e];
      s.eq[idx] = expf(acum[e]);
      s.w[idx] = expf(last - acum[e]) * d[e];
    }
  }
}

// M = [k <= q] (C_q . B_k) exp(acum_q - acum_k) dt_k, from C (Q x NP+4) and bt.
template <int Q>
__device__ __forceinline__ void scores(const Smem& s, const float* c_s, int NP) {
  for (int t = threadIdx.x; t < (Q / 4) * (Q / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, Q, Q, r);
    float acc[4][4];
    zero(acc);
    tile_mma(acc, c_s, NP + 4, r, s.bt, Q + 4, c, NP);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = r[i];
      float out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c + j;
        out[j] = k <= q ? acc[i][j] * expf(s.acum[q] - s.acum[k]) * s.dts[k] : 0.f;
      }
      st4(s.m + q * (Q + 4) + c, make_float4(out[0], out[1], out[2], out[3]));
    }
  }
}

// y = exp(acum_q) (C_q . h) + M x for the chunk's first `valid` rows and
// first P columns, written to `y` (row stride P) in T, 4 at a time where
// `vec` (P % 4 == 0).  `has_state` is false on the first chunk (h = 0).
template <int Q, typename T>
__device__ __forceinline__ void chunk_out(const Smem& s, const float* x_s,
                                          const float* c_s, const Dims& dm,
                                          bool has_state, T* __restrict__ y, int valid,
                                          bool vec) {
  for (int t = threadIdx.x; t < (Q / 4) * (dm.PP / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, Q, dm.PP, r);
    float acc[4][4];
    zero(acc);
    if (has_state) {
      tile_mma(acc, c_s, dm.NP + 4, r, s.h, dm.PP, c, dm.NP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= s.eq[r[i]];
    }
    tile_mma(acc, s.m, Q + 4, r, x_s, dm.PP, c, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r[i] >= valid) continue;
      T* yr = y + static_cast<size_t>(r[i]) * dm.P;
      if (vec) {
        store4(yr + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < dm.P) yr[c + j] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

// x_k <- w_k x_k in place (the state update's weights).
template <int Q>
__device__ __forceinline__ void scale_x(const Smem& s, float* x_s, int PP) {
  for (int idx = threadIdx.x; idx < Q * PP; idx += kThreads) x_s[idx] *= s.w[idx / PP];
}

// h <- exp(acum_last) h + bt x', with x' the weighted x of `scale_x`.
template <int Q>
__device__ __forceinline__ void state_update(const Smem& s, const float* x_s,
                                             const Dims& dm) {
  const float e_last = s.eq[Q - 1];
  for (int t = threadIdx.x; t < (dm.NP / 4) * (dm.PP / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, dm.NP, dm.PP, r);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 hv = ld4(s.h + r[i] * dm.PP + c);
      acc[i][0] = e_last * hv.x;
      acc[i][1] = e_last * hv.y;
      acc[i][2] = e_last * hv.z;
      acc[i][3] = e_last * hv.w;
    }
    tile_mma(acc, s.bt, Q + 4, r, x_s, dm.PP, c, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(s.h + r[i] * dm.PP + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

__device__ __forceinline__ void zero_state(const Smem& s, const Dims& dm) {
  for (int idx = threadIdx.x; idx < dm.NP * dm.PP; idx += kThreads) s.h[idx] = 0.f;
}

// The steps of one chunk after its x (x_s), C (c_s) and bt, acum, dts,
// eq, w are in shared memory and the block has synced: scores, output
// (`vec` as chunk_out's), and (unless it is the last chunk) the state
// update.
template <int Q, typename T>
__device__ __forceinline__ void chunk_step(const Smem& s, float* x_s, const float* c_s,
                                           const Dims& dm, bool first, bool last,
                                           T* __restrict__ y, int valid, bool vec) {
  scores<Q>(s, c_s, dm.NP);
  __syncthreads();
  chunk_out<Q, T>(s, x_s, c_s, dm, !first, y, valid, vec);
  if (!last) {  // the last chunk's state is not needed
    __syncthreads();
    scale_x<Q>(s, x_s, dm.PP);
    __syncthreads();
    state_update<Q>(s, x_s, dm);
  }
}

// Shapes the kernels take (the block's shared memory is checked apart).
__host__ inline bool shape_ok(int BT, int H, int S, int P, int N) {
  return BT > 0 && H > 0 && S > 0 && P > 0 && N > 0 && BT <= 65535;
}

}  // namespace ssd
