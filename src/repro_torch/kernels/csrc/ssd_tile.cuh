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
// All arithmetic is fp32 on the CUDA cores.  Each of the four products is
// a 4 x 4 register tile a thread over shared-memory operands read as
// float4 (`tile_mma`); a tile's rows are interleaved (r, r + R/4, ...) and
// its columns contiguous, so a warp's reads of the column operand are
// consecutive and those of the row operand are broadcasts.
#pragma once

#include "common.cuh"

namespace ssd {

constexpr int kThreads = 256;

// Fixed part of the shared memory (floats): the state h (N x P), B of the
// chunk transposed (N x Q+4), the masked scores M (Q x Q+4), and acum, dt,
// exp(acum) and the state weights w (Q each).
__host__ __device__ constexpr int fixed_floats(int Q, int P, int N) {
  return N * P + N * (Q + 4) + Q * (Q + 4) + 4 * Q;
}
// One chunk's x (Q x P) and C (Q x N+4); K8's ring stage adds B (Q x N+4).
__host__ __device__ constexpr int chunk_floats(int Q, int P, int N) {
  return Q * P + Q * (N + 4);
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

__device__ __forceinline__ Smem carve(float* base, int Q, int P, int N) {
  Smem s;
  s.h = base;
  s.bt = s.h + N * P;
  s.m = s.bt + N * (Q + 4);
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

// Q x N rows of B (row stride `ld`, rows >= `valid` read as 0) into bt (N x Q+4).
// Lanes walk rows, so the transposed stores are conflict-free.
template <int Q>
__device__ __forceinline__ void transpose_b(float* bt, const float* src, int ld,
                                            int valid, int N) {
  for (int idx = threadIdx.x; idx < Q * (N / 4); idx += kThreads) {
    const int row = idx % Q;
    const int n = (idx / Q) * 4;
    const float4 v = row < valid ? ld4(src + row * ld + n) : make_float4(0.f, 0.f, 0.f, 0.f);
    bt[(n + 0) * (Q + 4) + row] = v.x;
    bt[(n + 1) * (Q + 4) + row] = v.y;
    bt[(n + 2) * (Q + 4) + row] = v.z;
    bt[(n + 3) * (Q + 4) + row] = v.w;
  }
}

// Warp 0: dt of the chunk (0 past `valid`), acum = cumsum(dt * A) by a warp
// scan, eq = exp(acum) and w = exp(acum_last - acum) * dt.
template <int Q>
__device__ __forceinline__ void scan_chunk(const Smem& s, const float* __restrict__ dt,
                                           float A, int valid) {
  static_assert(Q % 32 == 0, "chunk must be a multiple of the warp");
  constexpr int E = Q / 32;
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float v[E], d[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane * E + e;
    d[e] = idx < valid ? dt[idx] : 0.f;
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
  const float last = __shfl_sync(0xffffffffu, acum[E - 1], 31);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = lane * E + e;
    s.acum[idx] = acum[e];
    s.dts[idx] = d[e];
    s.eq[idx] = expf(acum[e]);
    s.w[idx] = expf(last - acum[e]) * d[e];
  }
}

// M = [k <= q] (C_q . B_k) exp(acum_q - acum_k) dt_k, from C (Q x N+4) and bt.
template <int Q>
__device__ __forceinline__ void scores(const Smem& s, const float* c_s, int N) {
  for (int t = threadIdx.x; t < (Q / 4) * (Q / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, Q, Q, r);
    float acc[4][4];
    zero(acc);
    tile_mma(acc, c_s, N + 4, r, s.bt, Q + 4, c, N);
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

// y = exp(acum_q) (C_q . h) + M x for the chunk's first `valid` rows, written
// to `y` (row stride P).  `has_state` is false on the first chunk (h = 0).
template <int Q>
__device__ __forceinline__ void chunk_out(const Smem& s, const float* x_s, const float* c_s,
                                          int P, int N, bool has_state,
                                          float* __restrict__ y, int valid) {
  for (int t = threadIdx.x; t < (Q / 4) * (P / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, Q, P, r);
    float acc[4][4];
    zero(acc);
    if (has_state) {
      tile_mma(acc, c_s, N + 4, r, s.h, P, c, N);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= s.eq[r[i]];
    }
    tile_mma(acc, s.m, Q + 4, r, x_s, P, c, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r[i] < valid)
        st4(y + static_cast<size_t>(r[i]) * P + c,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// x_k <- w_k x_k in place (the state update's weights).
template <int Q>
__device__ __forceinline__ void scale_x(const Smem& s, float* x_s, int P) {
  for (int idx = threadIdx.x; idx < Q * P; idx += kThreads) x_s[idx] *= s.w[idx / P];
}

// h <- exp(acum_last) h + bt x', with x' the weighted x of `scale_x`.
template <int Q>
__device__ __forceinline__ void state_update(const Smem& s, const float* x_s, int P, int N) {
  const float e_last = s.eq[Q - 1];
  for (int t = threadIdx.x; t < (N / 4) * (P / 4); t += kThreads) {
    int r[4];
    const int c = tile_rows(t, N, P, r);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 hv = ld4(s.h + r[i] * P + c);
      acc[i][0] = e_last * hv.x;
      acc[i][1] = e_last * hv.y;
      acc[i][2] = e_last * hv.z;
      acc[i][3] = e_last * hv.w;
    }
    tile_mma(acc, s.bt, Q + 4, r, x_s, P, c, Q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      st4(s.h + r[i] * P + c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

__device__ __forceinline__ void zero_state(const Smem& s, int P, int N) {
  for (int idx = threadIdx.x; idx < N * P; idx += kThreads) s.h[idx] = 0.f;
}

// Shapes the kernels take: P and N multiples of 4 (float4 rows).
__host__ inline bool shape_ok(int BT, int H, int S, int P, int N) {
  return BT > 0 && H > 0 && S > 0 && P > 0 && N > 0 && P % 4 == 0 && N % 4 == 0 &&
         BT <= 65535;
}

}  // namespace ssd
