// The chunk step shared by K7 (ssd_scan.cu) and K8 (ssd_scan_pipelined.cu),
// on the tensor cores.  One block walks the chunks of one head of one batch
// row in order.  Per chunk of Q = 16 positions (positions past the sequence
// carry dt = 0: zero input, unit decay, so they add nothing):
//
//   acum  = cumsum(dt * A)
//   M     = [k <= q] (C_q . B_k) exp(acum_q - acum_k) dt_k        (Q x Q)
//   y     = exp(acum_q) (C_q . h) + M x                            (Q x P)
//   h    <- exp(acum_last) h + sum_k exp(acum_last - acum_k) dt_k B_k (x) x_k
//
// The mask is a select: exp(acum_q - acum_k) for k > q has a positive
// exponent and may be inf, so it is never computed (inf * 0 would be NaN).
//
// Arithmetic.  The four products run on mma.sync.m16n8k8 with TF32
// operands and fp32 accumulators, in 3xTF32: each fp32 operand a is split
// as its fragment is loaded into hi = tf32(a) (rounded to nearest) and
// lo = a - hi
// (whose bits past TF32's the tensor core drops), and a.b is taken as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b.  That keeps the scan's fp32 accuracy
// (one TF32 pass is ~1000x worse at the serving shape); operands that are
// raw bf16/fp16 inputs (x, B, C) are exact in TF32 and have no lo term.
// Shared memory holds fp32 only.  Everything else (the scan, exp, the
// mask) is fp32 on the CUDA cores.
//
// Work.  Warp (pb, r) of the block owns the head's head-dim rows
// 16 pb .. 16 pb + 15 and state columns 128 r .. 128 r + 127: it keeps h
// transposed (hT, P x N) for them in the update's accumulator registers
// from chunk to chunk, 16 m16n8 fragments.  Per chunk:
//   1. every warp runs the cumsum itself (warp scan, into its own
//      scratch), so no warp waits on another;
//   2. scores: every warp computes S0 = C B^T on the chunk's two m16n8
//      tiles over its share of the N columns, so the work and the
//      dependency chains are even, into a partial sum of its own;
//   3. after one block barrier, yT = hT C^T (hT's accumulator fragments
//      are the A operand as they stand, with the k order permuted to
//      match), scaled by exp(acum_q), plus xT M^T over live tiles only
//      (key tile <= query tile), M's fragments summed from the partials
//      and masked and scaled as they are loaded; then
//      hT <- exp(acum_last) hT + (w x)T B.
// A state wider than 128 columns is split over warps r (yT's C.h part is
// summed through shared memory); a head dim wider than the block's warps
// cover is split over blocks (grid z), each recomputing the scores.
//
// The chunk is 16: a sweep at the serving shape against chunks of 32 and 64
// and two heads a block (sharing B, C and the scores) found it fastest, as
// it leaves the most blocks an SM (PERF.md).
//
// Shared memory strides are chosen so that every fragment load is free of
// bank conflicts: B and C rows of 128 nr + 8 floats (float2 loads along N,
// and the update's reads down the positions), x rows of 16 pbw + 8 (reads
// down the positions), score rows of Q + 4.  Columns past N or P are zero,
// so a warp's state tiles past N read zeros and stay 0 without a branch;
// rows past the sequence are zero (K7) or finite (K8) and carry dt = 0.
#pragma once

#include "common.cuh"

namespace ssd {

constexpr int Q = 16;         // positions a chunk
constexpr int kMaxWarps = 8;
constexpr int kWarpP = 16;    // head-dim rows of hT a warp holds: one m16 block
constexpr int kWarpNT = 16;   // n8 tiles of state columns a warp holds: 128

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr int cdiv(int n, int m) { return (n + m - 1) / m; }

// How one scan is laid out over warps and blocks, and its shared-memory
// strides (floats).  kernels/ssd_scan.py mirrors it.
struct Geom {
  int P, N;
  int npad;    // N rounded up to whole n8 tiles
  int nr;      // warps across the state columns (128 each)
  int pbw;     // p-blocks (16 head-dim rows) of the head in one block; 0: none fits
  int psplit;  // blocks across the head dim
  int warps;   // pbw * nr
  int xs, bs;  // row strides of x and of B/C
};

__host__ __device__ inline Geom geom(int P, int N) {
  Geom g;
  g.P = P;
  g.N = N;
  g.npad = round_up(N, 8);
  g.nr = cdiv(g.npad, 8 * kWarpNT);
  const int pb = cdiv(P, kWarpP);
  const int cap = kMaxWarps / g.nr;
  g.pbw = cap < pb ? cap : pb;
  g.psplit = g.pbw > 0 ? cdiv(pb, g.pbw) : 0;
  g.warps = g.pbw * g.nr;
  g.xs = kWarpP * g.pbw + 8;
  g.bs = 8 * kWarpNT * g.nr + 8;  // every warp's 128 columns; zero past N
  return g;
}

// One chunk's x, B and C.
__host__ __device__ inline int stage_floats(const Geom& g) { return Q * g.xs + 2 * Q * g.bs; }
// Each warp's partial scores (Q x Q+4), each warp's cumsum scratch (acum
// and dt) and, for a state split over warps, their partial yT.
__host__ __device__ inline int fixed_floats(const Geom& g) {
  return g.warps * Q * (Q + 4) + g.warps * 2 * Q + g.pbw * (g.nr - 1) * kWarpP * Q;
}

struct Stage {
  float* x;  // Q x xs
  float* b;  // Q x bs
  float* c;  // Q x bs
};
__device__ __forceinline__ Stage stage_at(float* base, const Geom& g) {
  Stage s;
  s.x = base;
  s.b = base + Q * g.xs;
  s.c = s.b + Q * g.bs;
  return s;
}

struct Fixed {
  float* part;  // warps x (Q x Q+4): each warp's partial C B^T
  float* scan;  // this warp's: acum (Q), then dt (Q)
  float* red;   // partial yT of the warps with r > 0
};
__device__ __forceinline__ Fixed fixed_at(float* base, const Geom& g) {
  Fixed f;
  f.part = base;
  const int warp = threadIdx.x / 32;
  f.scan = f.part + g.warps * Q * (Q + 4) + warp * 2 * Q;
  f.red = f.part + g.warps * Q * (Q + 4) + g.warps * 2 * Q;
  return f;
}

// --------------------------------------------------------------------------
// TF32 tensor-core helpers
// --------------------------------------------------------------------------

// a as hi = tf32(a), rounded to nearest (ties away from zero, as
// cvt.rna.tf32.f32 rounds, by bit masking: two integer instructions,
// without the finite check the cvt compiles to; inf and nan stay inf and
// nan) and lo = a - hi, exact in fp32; EXACT (a raw bf16/fp16 input,
// exact in TF32): hi = a and no lo.
template <bool EXACT>
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(a);
    lo = 0u;
  } else {
    hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(a - __uint_as_float(hi));
  }
}

// d += a (16x8, row) * b (8x8, col).  Lane (g, t) = (lane / 4, lane % 4)
// holds a at (g, t), (g+8, t), (g, t+4), (g+8, t+4); b at (t, g), (t+4, g);
// d at (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment split for 3xTF32.
template <int K>
struct Frag {
  uint32_t hi[K], lo[K];
};
template <bool EXACT, int K>
__device__ __forceinline__ Frag<K> frag(const float (&v)[K]) {
  Frag<K> f;
#pragma unroll
  for (int i = 0; i < K; ++i) split<EXACT>(v[i], f.hi[i], f.lo[i]);
  return f;
}

// d += a.b in 3xTF32, small terms first; an EXACT operand has no lo term.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  if constexpr (!A_EXACT) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!B_EXACT) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// --------------------------------------------------------------------------
// Loads
// --------------------------------------------------------------------------

// Four elements (col .. col+3) of a row of `cols` valid elements as fp32:
// one 4-element load where `vec` (the row is whole, aligned groups of 4),
// else one element at a time with columns at or past `cols` read as 0.
template <typename T>
__device__ __forceinline__ float4 row4(const T* row, int col, int cols, bool vec) {
  if (vec && col + 4 <= cols) return load4(row + col);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < cols ? to_f32(row[col + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's walk over the (row, group) cells of a rows x per-row grid,
// `step` cells at a time, without a division a cell.
struct Cells {
  int row, col, drow, dcol, per;
  __device__ __forceinline__ Cells(int idx, int step, int per_row)
      : row(idx / per_row), col(idx % per_row), drow(step / per_row), dcol(step % per_row),
        per(per_row) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= per) {
      col -= per;
      ++row;
    }
  }
};

// `rows` rows of T (row stride `ld`, `cols` valid columns, rows >= `valid`
// read as 0) into fp32 shared memory `dst` (row stride `lds`), `width`
// columns (a multiple of 4) zero past `cols`, by all the block's threads,
// with kBatch loads in flight a thread.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int lds, int width, const T* src,
                                          size_t ld, int cols, int rows, int valid,
                                          bool vec) {
  constexpr int kBatch = 4;
  Cells c(threadIdx.x, blockDim.x, width / 4);
  while (c.row < rows) {
    float4 v[kBatch];
    int at[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int col = 4 * c.col;
      at[j] = c.row < rows ? c.row * lds + col : -1;
      v[j] = c.row < valid && col < cols ? row4(src + c.row * ld, col, cols, vec)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      c.next();
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (at[j] >= 0) *reinterpret_cast<float4*>(dst + at[j]) = v[j];
  }
}

// --------------------------------------------------------------------------
// The chunk step
// --------------------------------------------------------------------------

// dt of the chunk for head h of batch row b, one position a lane (0 past
// `valid`, and for lanes 16..31).
template <typename T>
__device__ __forceinline__ float load_dt(const T* __restrict__ dt, int b, int h, int H, int S,
                                         int c0, int valid) {
  const int lane = threadIdx.x % 32;
  return lane < valid ? to_f32(dt[(static_cast<size_t>(b) * H + h) * S + c0 + lane]) : 0.f;
}

// Every warp: acum = cumsum(dt * A) by a warp scan, into its own scratch
// (acum, then dt).
__device__ __forceinline__ void scan_chunk(float* scan, float d, float a) {
  const int lane = threadIdx.x % 32;
  const float v = __fmul_rn(d, a);
  float inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = __fadd_rn(inc, up);
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.f;
  if (lane < Q) {
    scan[lane] = __fadd_rn(excl, v);
    scan[Q + lane] = d;
  }
  __syncwarp();
}

// S0 = C B^T on the chunk's two m16n8 tiles (keys 0..7 and 8..15, both
// live at a chunk of 16): each warp takes both over its share of the N
// columns (k steps), so the work and the dependency chains are even across
// warps, and writes its partial sums to its own Q x Q+4 slice; the output
// step adds the slices, masks and scales them.  Fragments run along N with
// the k order permuted (lane t holds n0 + 2t and n0 + 2t + 1), so each
// operand is one float2 load.
template <bool EXACT>
__device__ __forceinline__ void scores(const Stage& st, const Fixed& fx, const Geom& gm) {
  constexpr int MS = Q + 4;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int ksteps = gm.npad / 8;
  const int lo = warp * ksteps / gm.warps, hi = (warp + 1) * ksteps / gm.warps;
  float d[2][4] = {};
#pragma unroll 2
  for (int ks = lo; ks < hi; ++ks) {
    const float* ca = st.c + g * gm.bs + 8 * ks + 2 * t;
    const float2 a0 = ld2(ca), a1 = ld2(ca + 8 * gm.bs);
    const float av[4] = {a0.x, a1.x, a0.y, a1.y};
    const Frag<4> a = frag<EXACT>(av);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 bv = ld2(st.b + (8 * j + g) * gm.bs + 8 * ks + 2 * t);
      const float bw[2] = {bv.x, bv.y};
      mma3<EXACT, EXACT>(d[j], a, frag<EXACT>(bw));
    }
  }
  float* part = fx.part + warp * Q * MS;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* pr = part + g * MS + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(pr) = make_float2(d[j][0], d[j][1]);
    *reinterpret_cast<float2*>(pr + 8 * MS) = make_float2(d[j][2], d[j][3]);
  }
}

// Per warp: the chunk's output rows for its head-dim rows, and (unless
// `last`) the state update.  `part` holds the warps' partial scores, `y`
// the output at the chunk's first position (row stride P), `p0` the
// block's first head-dim row; the warp owns rows p0 + 16 pb .. and state
// columns 128 r ...  `first`: h = 0 (no C.h term).
template <bool EXACT, typename T>
__device__ __forceinline__ void out_update(float (&h)[kWarpNT][4], const Stage& st,
                                           const float* part, const float* acum,
                                           const float* dts, float* red, const Geom& gm, int pb,
                                           int r, bool first, bool last, T* __restrict__ y,
                                           int valid, int p0) {
  constexpr int QT = Q / 8;
  constexpr int MS = Q + 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // C.h's sum over the state columns is split over KS accumulators (n8
  // tiles nt % KS): eight dependency chains at every chunk
  constexpr int KS = QT >= 8 ? 1 : 8 / QT;
  float yacc[QT][4], ysp[KS > 1 ? KS - 1 : 1][QT][4];
#pragma unroll
  for (int qt = 0; qt < QT; ++qt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      yacc[qt][e] = 0.f;
#pragma unroll
      for (int v = 0; v + 1 < KS; ++v) ysp[v][qt][e] = 0.f;
    }

  // yT = hT C^T: hT's fragment of tile nt is the A operand of k step nt
  // with lane t's k = (2t, 2t+1), which matches C read as float2
  if (!first) {
#pragma unroll
    for (int nt = 0; nt < kWarpNT; ++nt) {
      const float hv[4] = {h[nt][0], h[nt][2], h[nt][1], h[nt][3]};
      const Frag<4> a = frag<false>(hv);
      const float* cr = st.c + g * gm.bs + 8 * (kWarpNT * r + nt) + 2 * t;
#pragma unroll
      for (int qt = 0; qt < QT; ++qt) {
        const float2 cv = ld2(cr + 8 * qt * gm.bs);
        const float bw[2] = {cv.x, cv.y};
        if (nt % KS == 0) {
          mma3<false, EXACT>(yacc[qt], a, frag<EXACT>(bw));
        } else {
          mma3<false, EXACT>(ysp[nt % KS - 1][qt], a, frag<EXACT>(bw));
        }
      }
    }
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int v = 0; v + 1 < KS; ++v) yacc[qt][e] += ysp[v][qt][e];
    if (gm.nr > 1) {  // the warps of one head-dim block sum their columns' parts
      float* mine = red + (pb * (gm.nr - 1) + (r > 0 ? r - 1 : 0)) * (kWarpP * Q);
      if (r > 0) {
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(qt * 4 + e) * 32 + lane] = yacc[qt][e];
      }
      __syncthreads();
      if (r == 0) {
        for (int o = 0; o < gm.nr - 1; ++o) {
#pragma unroll
          for (int qt = 0; qt < QT; ++qt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              yacc[qt][e] += mine[o * (kWarpP * Q) + (qt * 4 + e) * 32 + lane];
        }
      }
    }
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      const float e0 = expf(acum[8 * qt + 2 * t]), e1 = expf(acum[8 * qt + 2 * t + 1]);
      yacc[qt][0] *= e0;
      yacc[qt][1] *= e1;
      yacc[qt][2] *= e0;
      yacc[qt][3] *= e1;
    }
  }
  const float a_last = acum[Q - 1];
  if (!last) {
    const float e_last = expf(a_last);
#pragma unroll
    for (int nt = 0; nt < kWarpNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[nt][e] *= e_last;
  }

  // xT M^T over key tiles kt <= query tile qt, and (unless the last
  // chunk) hT += (w x)T B; both take xT's fragment of k step kt (positions
  // 8kt + t, 8kt + t + 4).  Warps r > 0 compute xT M^T too (no branch) and
  // drop it.
  const float* xc = st.x + kWarpP * pb + g;
  auto xfrag = [&](int k, float (&xv)[4]) {
    xv[0] = xc[k * gm.xs];
    xv[1] = xc[k * gm.xs + 8];
    xv[2] = xc[(k + 4) * gm.xs];
    xv[3] = xc[(k + 4) * gm.xs + 8];
  };
#pragma unroll
  for (int kt = 0; kt < QT; ++kt) {
    float xv[4];
    xfrag(8 * kt + t, xv);
    const Frag<4> a = frag<EXACT>(xv);
#pragma unroll
    for (int qt = kt; qt < QT; ++qt) {
      // M[q][k] = [k <= q] S0[q][k] exp(acum_q - acum_k) dt_k, k = 8kt + t, +4
      const int q = 8 * qt + g, k = 8 * kt + t;
      const float* pr = part + q * MS + k;
      float s0 = 0.f, s1 = 0.f;
      for (int w = 0; w < gm.warps; ++w) {
        s0 += pr[w * Q * MS];
        s1 += pr[w * Q * MS + 4];
      }
      const float bw[2] = {k <= q ? s0 * expf(acum[q] - acum[k]) * dts[k] : 0.f,
                           k + 4 <= q ? s1 * expf(acum[q] - acum[k + 4]) * dts[k + 4] : 0.f};
      mma3<EXACT, false>(yacc[qt], a, frag<false>(bw));
    }
  }
  if (!last) {
#pragma unroll 1
    for (int kt = 0; kt < QT; ++kt) {
      const int k = 8 * kt + t;
      float xv[4];
      xfrag(k, xv);
      const float w0 = expf(a_last - acum[k]) * dts[k];
      const float w1 = expf(a_last - acum[k + 4]) * dts[k + 4];
      const float xw[4] = {xv[0] * w0, xv[1] * w0, xv[2] * w1, xv[3] * w1};
      const Frag<4> aw = frag<false>(xw);
      const float* br = st.b + k * gm.bs + 8 * kWarpNT * r + g;
#pragma unroll
      for (int nt = 0; nt < kWarpNT; ++nt) {
        const float bw[2] = {br[8 * nt], br[8 * nt + 4 * gm.bs]};
        mma3<false, EXACT>(h[nt], aw, frag<EXACT>(bw));
      }
    }
  }

  if (r != 0) return;
#pragma unroll
  for (int qt = 0; qt < QT; ++qt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + kWarpP * pb + g + 8 * (e / 2);
      const int q = 8 * qt + 2 * t + e % 2;
      if (p < gm.P && q < valid) y[static_cast<size_t>(q) * gm.P + p] = from_f32<T>(yacc[qt][e]);
    }
}

// The warp's place in the block: head-dim block pb, column range r.
struct Role {
  int pb, r;
};
__device__ __forceinline__ Role role(const Geom& gm) {
  const int warp = threadIdx.x / 32;
  return Role{warp / gm.nr, warp % gm.nr};
}

// The steps of one chunk after its x, B and C are in shared memory (`st`)
// and the block has synced: the cumsum (from the lane's dt `d`), the
// scores, a block barrier, then output and state update.  The caller
// syncs before the stage or the scores are written again.
template <bool EXACT, typename T>
__device__ __forceinline__ void chunk_step(float (&h)[kWarpNT][4], const Stage& st,
                                           const Fixed& fx, const Geom& gm, const Role& ro,
                                           float d, float a, bool first, bool last,
                                           T* __restrict__ y, int valid, int p0) {
  scan_chunk(fx.scan, d, a);
  scores<EXACT>(st, fx, gm);
  __syncthreads();
  out_update<EXACT, T>(h, st, fx.part, fx.scan, fx.scan + Q, fx.red, gm, ro.pb, ro.r, first,
                       last, y, valid, p0);
}

// Registers: two blocks of up to 8 warps an SM (128 a thread).
constexpr int kMinBlocks = 2;

// Shapes the kernels take (the block's shared memory is checked apart).
__host__ inline bool shape_ok(int BT, int H, int S, int P, int N) {
  return BT > 0 && H > 0 && S > 0 && P > 0 && N > 0 && BT <= 65535;
}

}  // namespace ssd
