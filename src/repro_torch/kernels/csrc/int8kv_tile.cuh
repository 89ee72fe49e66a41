// K6's kernel body (flash_attention_int8kv.cu): GQA flash attention over
// int8 K/V with one fp32 scale a KV head, on the tensor cores, keeping fp32
// accuracy for fp32 q.  The counterpart of _flash_kernel_int8kv in
// src/repro/kernels/flash_attention.py.
//
// What it computes (the reference's rules, not its summation order):
//   s = (q . k8) * k_scale * sm_scale, and -1e30 where the mask is false;
//   the online softmax of flash_tile.cuh (p = 0 where masked);
//   out = (sum p v8) * v_scale / max(l, 1e-30), so a row with no valid key
//   gives 0.  Both scales are folded out of the products: k_scale (with
//   sm_scale and log2 e) is one multiply a score, v_scale one at the end.
//
// One block is one warpgroup (4 warps of 16 query rows) on a 64-row q tile
// of one (batch, head); it walks the K/V tiles of BKT keys (64; 32 at
// head widths above 128) that flash_tile.cuh's scan_window lists live.
//
// 1. Arithmetic.  Tensor cores with fp32 accumulators in every dtype.
//    Every int8 is exact in bf16 and in fp16 (int8_tile.cuh widen4), so K8
//    and V8 are widened exactly, to fp16 for fp16 q and to bf16 otherwise.
//    fp32 q is cut into three bf16 terms hi + mid + lo == q (int8_tile.cuh
//    split3), and so is p: S = Q K8^T and P V8 are then three passes of
//    exact products, and only the fp32 sums round.  bf16 and fp16 q take
//    one pass, with P rounded to q's type (as K2's MmaTile does).
//    Every width runs mma.sync m16n8k16, its operands by ldmatrix from
//    rows padded in shared memory.  wgmma has twice its rate on this tile
//    alone, but in the kernel mma.sync was faster at width 64 and within
//    5 % at width 128 (PERF.md): a block is one warp an SM sub-partition,
//    and mma.sync lets softmax and widening interleave with the products.
// 2. Promotion.  Each tile's P V8 is summed into a fresh accumulator (one
//    pair of 8-column blocks at a time) and added to the fp32 total on the
//    CUDA cores, and at head widths above 64 each 64-deep slice of Q K8^T
//    likewise: without it the fp32 error at S = T = 4096 grows 15-25x
//    (PERF.md).
// 3. Copies.  The int8 K/V tiles, and a partial tile's mask bytes, arrive
//    by 16-byte cp.async into a ring of kDepth = 2 stages and stay int8
//    there.  Each tile is widened once, by the whole block, into one of
//    two 16-bit tiles: at list position i the block waits for tile i+1,
//    syncs once, starts the copy of tile i+2 into tile i's stage,
//    widens tile i+1 into the other 16-bit tile and computes tile i, so
//    one barrier a tile orders all of it.  Rows that are not whole 16-byte
//    vectors are copied element by element.
// 4. Key split.  Where the q tiles leave SMs idle, `split` blocks of a
//    thread-block cluster (grid z) share a q tile: rank r takes the live
//    list's entries r, r + split, ... (the causal load balanced), and the
//    partial (m, l, acc) are combined through distributed shared memory in
//    rank order, each output element by one thread, so every run gives
//    the same bits.  A rank with no live tile holds m = -1e30, l = 0.
//    Each rank adds the tiles it computed to `live`, so their sum is
//    live_tiles(mask, hd).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "flash_tile.cuh"
#include "int8_tile.cuh"

namespace i8kv {

using flash::BQ;
using flash::kLog2e;
using flash::kNegInf;
using flash::kPartial;
using flash::kWindow;
using flash::LiveList;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxSmem = 232448;
constexpr int kDepth = 2;  // stages of the int8 ring

// Shared memory of one block, in bytes and in order: the q tile (three
// bf16 terms for fp32 q, else q's type); two 16-bit tiles of widened K, V
// and mask bytes; kDepth stages of int8 K, int8 V and mask bytes; the live
// list.  After the sweep a split block reuses it from offset 0 for its
// partial acc (fp32), m and l.  Rows are padded by 16 bytes (int8 rows
// too), so rows stay 16-byte aligned and neighbouring rows start in other
// banks.  kernels/pipeline.int8kv_smem_bytes mirrors this.
template <int HD, typename T>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  using W = typename std::conditional<kF16, __half, __nv_bfloat16>::type;
  static constexpr int kTerms = kF32 ? 3 : 1;
  static constexpr int BKT = HD > 128 ? 32 : 64;
  static constexpr int WS = HD + 8;    // 16-bit row, elements
  static constexpr int RS = HD + 16;   // int8 row, bytes
  static constexpr int MS = BKT + 16;  // mask row, bytes
  static constexpr int AS = HD + 4;    // partial acc row, floats
  static constexpr int kQBytes = 2 * kTerms * BQ * WS;
  static constexpr int kWideK = 2 * BKT * WS;
  static constexpr int kWideV = kWideK;
  static constexpr int kMaskBytes = BQ * MS;
  static constexpr int kWideBytes = kWideK + kWideV + kMaskBytes;
  static constexpr int kRawKV = BKT * RS;
  static constexpr int kStageBytes = 2 * kRawKV + kMaskBytes;
  static constexpr int kPartBytes = 4 * BQ * AS + 2 * 4 * BQ;
  static constexpr int kSweepBytes =
      kQBytes + 2 * kWideBytes + kDepth * kStageBytes + static_cast<int>(sizeof(LiveList));
  static constexpr int kBytes = kSweepBytes > kPartBytes ? kSweepBytes : kPartBytes;
  static_assert(4 * BQ * (HD + 4) <= 2 * kWideBytes, "q is staged in the 16-bit tiles");
  static_assert(kBytes <= kMaxSmem, "a block fits the 227 KB a block may have");
};

// q rows q0 .. q0+63 of one head into shared memory by cp.async (element
// copies where rows are not whole 16-byte vectors), rows at or past `rows`
// and columns past hd 0: 16-bit q into its tile, fp32 q into `stage`
// (rows of HD + 4 floats) for split_q.
template <int HD, typename T>
__device__ __forceinline__ void copy_q(typename Layout<HD, T>::W* q_s, unsigned char* stage,
                                       const T* __restrict__ src, size_t ld, int rows, int hd) {
  using L = Layout<HD, T>;
  constexpr int V = Vec16<T>::N;
  if constexpr (L::kF32)
    flash::copy_rows<kThreads, HD, HD + V>(reinterpret_cast<T*>(stage), BQ, src, ld, rows, hd,
                                           hd % V == 0);
  else
    flash::copy_rows<kThreads, HD, L::WS>(q_s, BQ, src, ld, rows, hd, hd % V == 0);
}

// The staged fp32 q into its tile as three bf16 terms, term t's rows after
// t others'.
template <int HD>
__device__ __forceinline__ void split_q(__nv_bfloat16* q_s, const float* stage) {
  constexpr int WS = Layout<HD, float>::WS;
  constexpr int kChunks = HD / 4;
#pragma unroll 4
  for (int j = 0; j < BQ * kChunks / kThreads; ++j) {
    const int c = j * kThreads + threadIdx.x;
    const int r = c / kChunks;
    const int d = (c % kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(stage + r * (HD + 4) + d);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t t[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) i8mm::split3(v[e], t[0][e], t[1][e], t[2][e]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint2*>(q_s + k * BQ * WS + r * WS + d) =
          make_uint2(i8mm::pack_hi16(t[k][0], t[k][1]), i8mm::pack_hi16(t[k][2], t[k][3]));
  }
}

// BKT rows of hd <= HD int8 values (row stride `ld`) into a ring stage (row
// stride RS): 16-byte cp.async chunks where rows are whole vectors (`vec`),
// else element copies; rows at or past `valid` and columns past hd are 0.
template <int HD, int BKT, int RS>
__device__ __forceinline__ void copy_raw(int8_t* dst, const int8_t* __restrict__ src, size_t ld,
                                         int valid, int hd, bool vec) {
  if (vec) {
    constexpr int kChunks = HD / 16;
#pragma unroll
    for (int j = 0; j < (BKT * kChunks + kThreads - 1) / kThreads; ++j) {
      const int c = j * kThreads + threadIdx.x;
      if (BKT * kChunks % kThreads != 0 && c >= BKT * kChunks) break;
      const int r = c / kChunks;
      const int d = (c % kChunks) * 16;
      const bool ok = r < valid && d < hd;
      cp_async16(dst + r * RS + d, ok ? src + r * ld + d : src, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < BKT * HD; c += kThreads) {
      const int r = c / HD;
      const int d = c % HD;
      dst[r * RS + d] = r < valid && d < hd ? src[r * ld + d] : static_cast<int8_t>(0);
    }
  }
}

// A ring stage's int8 tile (BKT x HD, row stride RS bytes) widened exactly
// into a 16-bit tile of rows of WS elements; 8 values a thread step.
template <int HD, typename T>
__device__ __forceinline__ void widen_tile(typename Layout<HD, T>::W* dst, const int8_t* src) {
  using L = Layout<HD, T>;
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int j = 0; j < L::BKT * kChunks / kThreads; ++j) {
    const int c = j * kThreads + threadIdx.x;
    const int r = c / kChunks;
    const int d = (c % kChunks) * 8;
    const uint2 w = *reinterpret_cast<const uint2*>(src + r * L::RS + d);
    uint4 o;
    i8mm::widen4<L::kF16>(w.x, o.x, o.y);
    i8mm::widen4<L::kF16>(w.y, o.z, o.w);
    *reinterpret_cast<uint4*>(dst + r * L::WS + d) = o;
  }
}

// A partial tile's mask bytes (BQ x BKT, row stride MS) from its ring
// stage into the 16-bit tile's mask slot.
template <int BKT, int MS>
__device__ __forceinline__ void copy_mask_bytes(uint8_t* dst, const uint8_t* src) {
  constexpr int CPR = BKT / 16;
#pragma unroll
  for (int j = 0; j < BQ * CPR / kThreads; ++j) {
    const int c = j * kThreads + threadIdx.x;
    const int off = (c / CPR) * MS + (c % CPR) * 16;
    *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(src + off);
  }
}

// Two consecutive output values of type T.
template <typename T>
__device__ __forceinline__ void put2(T* p, float x, float y) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  else
    flash::store2<T>(p, x, y);
}

// The state of one warp: query rows 16w + g and 16w + g + 8 (lane (g, t) =
// (lane / 4, lane % 4)), as in the m16n8k16 fragments; m in log2 units.
template <int HD, typename T>
struct Tile {
  using L = Layout<HD, T>;
  using W = typename L::W;
  static constexpr int BKT = L::BKT;
  static constexpr int NB = BKT / 8;   // 8-key blocks of S
  static constexpr int ND = HD / 8;    // 8-dim blocks of the output
  static constexpr int KD = HD / 16;   // 16-dim steps of q.k
  static constexpr int KK = BKT / 16;  // 16-key steps of p.v
  static constexpr int NT = L::kTerms;
  // 64-deep slices of q.k, each summed apart (promotion)
  static constexpr int kSliceKD = KD > 4 ? 4 : KD;
  // q's fragments stay in registers while they take at most 16 of them
  // (16-bit q up to width 32); wider, they would crowd the accumulators
  static constexpr bool kQRegs = NT * KD <= 4;
  // Widths 128 and 256 also run head dims 80, 96, ...: skip the 16-column
  // steps past hd (a branch each, which splits the products' code).
  static constexpr bool kSkipPast = HD >= 128;
  static_assert(4 * NB <= 32, "one ok bit a score in a 32-bit word");
  float m[2];
  float l[2];  // this lane's share of the row sum; quad-summed at the end
  float o[ND][4];
  uint32_t qf[kQRegs ? KD : 1][NT][4];
  bool q_loaded;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    q_loaded = false;
  }

  // A fragment of q.k step kd, term t: rows 16w + (lane % 16), columns
  // 16kd + 8 (lane / 16).
  __device__ __forceinline__ static void q_frag(uint32_t* a, const W* q_s, int t, int kd) {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    flash::ldsm_x4(a, q_s + t * BQ * L::WS + (16 * w + lane % 16) * L::WS + 16 * kd +
                          8 * (lane / 16));
  }

  // Fold one K/V tile (widened, in shared memory) into the state.  mask_s:
  // the tile's mask bytes, or null for a full tile; c = k_scale * sm_scale
  // * log2 e.  `between()` runs once the products of S are issued, so its
  // work (the next tile's widening) overlaps them.
  template <class Between>
  __device__ __forceinline__ void step(const W* q_s, const W* k_s, const W* v_s,
                                       const uint8_t* mask_s, int hd, float c,
                                       Between&& between) {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    if constexpr (kQRegs) {
      if (!q_loaded) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
#pragma unroll
          for (int tt = 0; tt < NT; ++tt) q_frag(qf[kd][tt], q_s, tt, kd);
        q_loaded = true;
      }
    }

    float s[NB][4];
    // S = Q K^T, each 64-deep slice into a fresh accumulator (promotion):
    // B fragments of 8-key blocks j, j+1 from K rows 8j + 8 (lane / 16) +
    // lane % 8, columns 16kd + 8 ((lane / 8) % 2); the smallest term first.
#pragma unroll
    for (int kd0 = 0; kd0 < KD; kd0 += kSliceKD) {
      float f[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
#pragma unroll
      for (int kd = kd0; kd < kd0 + kSliceKD; ++kd) {
        if (kSkipPast && 16 * kd >= hd) continue;  // columns past hd are 0
        uint32_t a[NT][4];
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[tt][e] = qf[kd][tt][e];
          } else {
            q_frag(a[tt], q_s, tt, kd);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          uint32_t b[4];
          flash::ldsm_x4(b, k_s + (8 * j + 8 * (lane / 16) + lane % 8) * L::WS + 16 * kd +
                                8 * ((lane / 8) % 2));
#pragma unroll
          for (int tt = NT - 1; tt >= 0; --tt) {
            flash::mma16816<W>(f[j], a[tt], b[0], b[1]);
            flash::mma16816<W>(f[j + 1], a[tt], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = kd0 == 0 ? f[j][e] : s[j][e] + f[j][e];
    }
    between();

    // Online softmax on the fragments: element e of block j is row
    // 16w + g + 8 (e / 2), key 8j + 2t + e % 2.
    uint32_t ok = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask_s && mask_s[(16 * w + g + 8 * (e / 2)) * L::MS + 8 * j + 2 * t + e % 2] == 0)
          ok &= ~(1u << (4 * j + e));
        s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * c : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (ok >> (4 * j + e)) & 1u ? exp2f(s[j][e] - m[e / 2]) : 0.f;
        s[j][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P's A fragments of keys 16kk .. 16kk+15: S blocks 2kk and 2kk+1, as
    // three bf16 terms (fp32) or rounded to q's type.
    uint32_t pa[KK][NT][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = s[2 * kk + r / 2][2 * (r % 2)];
        const float y = s[2 * kk + r / 2][2 * (r % 2) + 1];
        if constexpr (NT == 3) {
          uint32_t xt[3], yt[3];
          i8mm::split3(x, xt[0], xt[1], xt[2]);
          i8mm::split3(y, yt[0], yt[1], yt[2]);
#pragma unroll
          for (int tt = 0; tt < 3; ++tt) pa[kk][tt][r] = i8mm::pack_hi16(xt[tt], yt[tt]);
        } else {
          pa[kk][0][r] = flash::pack2<W>(x, y);
        }
      }

    pv(v_s, pa, hd);
  }

  // O += P V, a pair of 8-dim blocks n, n+1 at a time into a fresh
  // accumulator added to o (promotion): V's B fragments come by
  // ldmatrix.trans from V rows 16kk + 8 ((lane / 8) % 2) + lane % 8,
  // columns 8n + 8 (lane / 16).
  __device__ __forceinline__ void pv(const W* v_s, const uint32_t (&pa)[KK][NT][4], int hd) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      if (kSkipPast && 8 * n >= hd) continue;
      float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t b[4];
        flash::ldsm_x4_trans(b, v_s + (16 * kk + 8 * ((lane / 8) % 2) + lane % 8) * L::WS +
                                    8 * n + 8 * (lane / 16));
#pragma unroll
        for (int tt = NT - 1; tt >= 0; --tt) {
          flash::mma16816<W>(f0, pa[kk][tt], b[0], b[1]);
          flash::mma16816<W>(f1, pa[kk][tt], b[2], b[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[n][e] += f0[e];
        o[n + 1][e] += f1[e];
      }
    }
  }

  __device__ __forceinline__ float row_sum(int i) const {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    return li;
  }

  // out[b, r, h, :hd] = acc * v_scale / max(l, 1e-30) for this lane's rows
  // below S.
  __device__ __forceinline__ void finalize(T* __restrict__ out, int b, int h, int q0, int S, int H,
                                           int hd, float vs) const {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float f = vs / fmaxf(row_sum(i), 1e-30f);
      const int r = q0 + 16 * w + g + 8 * i;
      if (r >= S) continue;
      T* orow = out + ((static_cast<size_t>(b) * S + r) * H + h) * hd;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = 8 * n + 2 * t;
        const float x = o[n][2 * i] * f, y = o[n][2 * i + 1] * f;
        if (hd % 2 == 0) {
          if (d < hd) put2<T>(orow + d, x, y);
        } else {
          if (d < hd) orow[d] = from_f32<T>(x);
          if (d + 1 < hd) orow[d + 1] = from_f32<T>(y);
        }
      }
    }
  }

  // A split block's partial state: acc (unnormalised, row stride AS), m
  // and the quad-summed l of each of its 64 rows.
  __device__ __forceinline__ void store_partial(float* acc_s, float* m_s, float* l_s) const {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * w + g + 8 * i;
      const float li = row_sum(i);
      if (t == 0) {
        m_s[r] = m[i];
        l_s[r] = li;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(acc_s + r * L::AS + 8 * n + 2 * t) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
};

// Rank `rank` of a cluster of SPLIT writes rows rank * 64/SPLIT .. of the q
// tile, 2 SPLIT threads a row: with M the largest m of the ranks and w_q =
// 2^(m_q - M), out = (sum_q w_q acc_q) * v_scale / max(sum_q w_q l_q,
// 1e-30), summed in rank order.  Each thread issues all its reads of the
// other ranks' shared memory before it sums.
template <int HD, typename T, int SPLIT>
__device__ __forceinline__ void combine(float* acc_s, float* m_s, float* l_s,
                                        T* __restrict__ out, int b, int h, int q0, int S, int H,
                                        int hd, float vs, int rank) {
  using L = Layout<HD, T>;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  constexpr int kUnits = HD / 4;               // 4 columns a unit
  constexpr int kTpr = 2 * SPLIT;               // threads a row
  constexpr int kPer = (kUnits + kTpr - 1) / kTpr;  // units a thread
  const int r = rank * (BQ / SPLIT) + threadIdx.x / kTpr;
  const int sub = threadIdx.x % kTpr;
  if (q0 + r >= S) return;
  float mq[SPLIT], lq[SPLIT];
#pragma unroll
  for (int q = 0; q < SPLIT; ++q) {
    mq[q] = *cl.map_shared_rank(m_s + r, q);
    lq[q] = *cl.map_shared_rank(l_s + r, q);
  }
  float4 x[kPer][SPLIT];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = 4 * (sub + j * kTpr);
    if (d >= 4 * kUnits) break;
#pragma unroll
    for (int q = 0; q < SPLIT; ++q)
      x[j][q] = *reinterpret_cast<float4*>(cl.map_shared_rank(acc_s + r * L::AS + d, q));
  }
  float M = kNegInf;
#pragma unroll
  for (int q = 0; q < SPLIT; ++q) M = fmaxf(M, mq[q]);
  float wq[SPLIT], lsum = 0.f;
#pragma unroll
  for (int q = 0; q < SPLIT; ++q) {
    wq[q] = exp2f(mq[q] - M);
    lsum += wq[q] * lq[q];
  }
  const float f = vs / fmaxf(lsum, 1e-30f);
  T* orow = out + ((static_cast<size_t>(b) * S + q0 + r) * H + h) * hd;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = 4 * (sub + j * kTpr);
    if (d >= 4 * kUnits || d >= hd) break;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < SPLIT; ++q) {
      a.x += wq[q] * x[j][q].x;
      a.y += wq[q] * x[j][q].y;
      a.z += wq[q] * x[j][q].z;
      a.w += wq[q] * x[j][q].w;
    }
    const float4 o = make_float4(a.x * f, a.y * f, a.z * f, a.w * f);
    if (hd % 4 == 0) {
      store4(orow + d, o);
    } else {
      const float e[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (d + i < hd) orow[d + i] = from_f32<T>(e[i]);
    }
  }
}

// The kernel: grid (B*H, nq, split), the q tile counted from the last
// (heaviest first); a cluster of `split` blocks along z shares a q tile.
// Query head h reads KV head h / (H/K) and its two scales.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
int8kv_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
              const int8_t* __restrict__ v8, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const uint8_t* __restrict__ mask,
              T* __restrict__ out, int S, int T_len, int H, int K, int hd, int mask_b,
              float sm_scale, int* __restrict__ live) {
  using L = Layout<HD, T>;
  using W = typename L::W;
  constexpr int BKT = L::BKT;
  extern __shared__ __align__(16) unsigned char smem[];
  W* q_s = reinterpret_cast<W*>(smem);
  unsigned char* wide = smem + L::kQBytes;
  unsigned char* ring = wide + 2 * L::kWideBytes;
  LiveList& ll = *reinterpret_cast<LiveList*>(ring + kDepth * L::kStageBytes);
  auto k_wide = [&](int i) { return reinterpret_cast<W*>(wide + (i & 1) * L::kWideBytes); };
  auto v_wide = [&](int i) {
    return reinterpret_cast<W*>(wide + (i & 1) * L::kWideBytes + L::kWideK);
  };
  auto m_wide = [&](int i) { return wide + (i & 1) * L::kWideBytes + L::kWideK + L::kWideV; };
  auto k_raw = [&](int i) {
    return reinterpret_cast<int8_t*>(ring + (i % kDepth) * L::kStageBytes);
  };
  auto v_raw = [&](int i) { return k_raw(i) + L::kRawKV; };
  auto m_raw = [&](int i) { return ring + (i % kDepth) * L::kStageBytes + 2 * L::kRawKV; };

  const int split = gridDim.z;
  const int rank = blockIdx.z;  // the cluster spans grid z
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kvh = h / (H / K);
  const float c = __ldg(k_scale + kvh) * sm_scale * kLog2e;
  const float vs = __ldg(v_scale + kvh);
  const uint8_t* mrow = mask + (mask_b > 1 ? static_cast<size_t>(b) * S * T_len : 0) +
                        static_cast<size_t>(q0) * T_len;
  const int rows = S - q0;
  const int nt = (T_len + BKT - 1) / BKT;
  const bool scan = nt > 1;
  const bool mvec = T_len % 16 == 0;
  const bool kvec = hd % 16 == 0;
  const size_t kv_ld = static_cast<size_t>(K) * hd;
  const int8_t* k_b = k8 + (static_cast<size_t>(b) * T_len * K + kvh) * hd;
  const int8_t* v_b = v8 + (static_cast<size_t>(b) * T_len * K + kvh) * hd;

  // q's copies, then the copies of the tile this rank's list most likely
  // starts with (tile `rank`: so for every causal row), both in flight
  // while the block scans its mask rows.
  unsigned char* stage = wide;
  copy_q<HD, T>(q_s, stage, q + ((static_cast<size_t>(b) * S + q0) * H + h) * hd,
                static_cast<size_t>(H) * hd, rows, hd);
  cp_async_commit();
  // Copy tile `t` (window-relative) into stage i % kDepth, with its mask
  // bytes where `partial`.
  auto copy_tile = [&](int i, int w0, int t, bool partial) {
    const int k0 = (w0 + t) * BKT;
    copy_raw<HD, BKT, L::RS>(k_raw(i), k_b + k0 * kv_ld, kv_ld, T_len - k0, hd, kvec);
    copy_raw<HD, BKT, L::RS>(v_raw(i), v_b + k0 * kv_ld, kv_ld, T_len - k0, hd, kvec);
    if (partial)
      flash::copy_mask<kThreads, BKT, L::MS>(m_raw(i), mrow + k0, T_len, rows, T_len - k0, mvec);
  };
  const bool guess = rank < nt;
  if (guess) copy_tile(0, 0, rank, true);
  cp_async_commit();
  Tile<HD, T> tile;
  tile.init();
  int computed = 0;
  bool q_ready = false;
  for (int w0 = 0; w0 < nt; w0 += kWindow) {
    if (scan)
      flash::scan_window<kThreads, BKT>(ll, mrow, rows, T_len, w0, min(kWindow, nt - w0), mvec);
    const int n = scan ? ll.n : 1;
    const int mine = n > rank ? (n - rank + split - 1) / split : 0;
    auto entry = [&](int i) -> int { return scan ? ll.entry[rank + i * split] : kPartial; };
    auto issue = [&](int i) {
      const int e = entry(i);
      copy_tile(i, w0, e & ~kPartial, e & kPartial);
    };
    // Widen stage i % kDepth into 16-bit tile i % 2, mask bytes and all
    // (a full tile's are not read); past this rank's last tile it widens
    // what the stage holds, which nothing reads.
    auto widen = [&](int i) {
      widen_tile<HD, T>(k_wide(i), k_raw(i));
      widen_tile<HD, T>(v_wide(i), v_raw(i));
      copy_mask_bytes<BKT, L::MS>(m_wide(i), m_raw(i));
    };
    bool guessed = false;
    if (w0 == 0) {
      guessed = guess && mine > 0 && (entry(0) & ~kPartial) == rank;
      if (!guessed) {
        cp_async_wait<0>();
        __syncthreads();  // no copy into stage 0 is still in flight
      }
    }
    for (int i = 0; i < kDepth; ++i) {
      if (i < mine && (i > 0 || !guessed)) issue(i);
      cp_async_commit();
    }
    if (mine > 0) {
      cp_async_wait<kDepth - 1>();  // q and tile 0
      __syncthreads();
      if (!q_ready) {
        if constexpr (L::kF32) {
          split_q<HD>(q_s, reinterpret_cast<const float*>(stage));
          __syncthreads();  // the stage is read before tile 0 is widened over it
        }
        q_ready = true;
      }
      widen(0);
    }
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<kDepth - 2>();  // tile i + 1
      __syncthreads();  // ... everyone's; tile i's stage and 16-bit tile i - 1 are free
      if (i + kDepth < mine) issue(i + kDepth);
      cp_async_commit();
      tile.step(q_s, k_wide(i), v_wide(i), (entry(i) & kPartial) ? m_wide(i) : nullptr, hd, c,
                [&] { widen(i + 1); });
    }
    cp_async_wait<0>();
    computed += mine;
  }
  if (live && threadIdx.x == 0) atomicAdd(live, computed);
  if (split == 1) {
    tile.finalize(out, b, h, q0, S, H, hd, vs);
    return;
  }
  float* acc_s = reinterpret_cast<float*>(smem);
  float* m_s = acc_s + BQ * L::AS;
  float* l_s = m_s + BQ;
  __syncthreads();  // no thread still reads the q or 16-bit tiles
  tile.store_partial(acc_s, m_s, l_s);
  cooperative_groups::this_cluster().sync();  // every rank's partial is written
  if (split == 2)
    combine<HD, T, 2>(acc_s, m_s, l_s, out, b, h, q0, S, H, hd, vs, rank);
  else
    combine<HD, T, 4>(acc_s, m_s, l_s, out, b, h, q0, S, H, hd, vs, rank);
  cooperative_groups::this_cluster().sync();  // no rank's partial is still read
}

__host__ inline bool plan_ok(int split) { return split == 1 || split == 2 || split == 4; }

// Launch at the padded width HD; cudaErrorInvalidValue for a split the
// kernel does not take.
template <int HD, typename T>
cudaError_t launch(const void* q, const void* k8, const void* v8, const float* k_scale,
                   const float* v_scale, const void* mask, void* out, int B, int S, int T_len,
                   int H, int K, int hd, int mask_b, float sm_scale, int split, int* live,
                   cudaStream_t stream) {
  if (!plan_ok(split)) return cudaErrorInvalidValue;
  auto kern = int8kv_kernel<HD, T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (S + BQ - 1) / BQ, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<HD, T>::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = split;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), static_cast<const int8_t*>(k8),
                         static_cast<const int8_t*>(v8), k_scale, v_scale,
                         static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K,
                         hd, mask_b, sm_scale, live);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Blocks resident on one SM (the occupancy query), or -error.
template <int HD, typename T>
int occupancy() {
  auto kern = int8kv_kernel<HD, T>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, Layout<HD, T>::kBytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace i8kv
