// The flash-attention kernel shared by K2 (flash_attention.cu, a single
// K/V stage) and K3 (flash_attention_pipelined.cu, a `DEPTH`-stage
// cp.async ring), whose tile skipping (scan_window, LiveList, copy_mask)
// and mma.sync helpers K6 (int8kv_tile.cuh) uses too: the counterpart of
// _online_softmax_update / _init_flash_scratch / _finalize_flash_output in
// src/repro/kernels/flash_attention.py.
//
// What it computes (the reference's rules, not its summation order):
//   s = (q . k) * sm_scale, and -1e30 where the mask is false;
//   m' = max(m, rowmax s); alpha = exp(m - m'); p = mask ? exp(s - m') : 0;
//   l = alpha * l + rowsum p; acc = alpha * acc + p v;
//   out = acc / max(l, 1e-30), so a row with no valid key gives 0.
// Keys past T and queries past S are treated as masked / not written.
//
// One block owns a tile of 64 query rows of one (batch, head) and walks
// the K/V tiles of BKT keys (64; 32 at head widths above 128).
//
// 1. Tile skipping.  On entry the block reads its 64 mask rows once, as
//    16-byte vectors (scan_window), and lists in shared memory the K/V
//    tiles with at least one valid entry, each marked *full* (every entry
//    valid: no per-score test) or *partial*.  Only listed tiles are loaded
//    and computed; a wholly masked tile would leave m, l and acc bit for
//    bit as they were, so skipping it is exact.  A partial tile's mask
//    bytes ride the ring beside its K and V (cp.async where T % 16 == 0),
//    so the tile reads its mask from shared memory.  The list holds
//    kWindow tiles; a longer sweep is walked window by window, the ring
//    drained between windows.  A sweep of one tile is not scanned: that
//    tile is taken as partial.  fp32 rows start tile 0's copies before the
//    scan and keep them where the list begins with tile 0.  Blocks are
//    ordered heaviest query tile first (the last q tile has the most
//    causal keys), so the causal imbalance does not leave a tail wave.
//    Given a counter (`live`), each block adds the K/V tiles it computed,
//    so a caller can check the skipping against the mask.
// 2. fp32 rows (F32Tile): 256 threads,
//    all math fp32 FFMA on the CUDA cores (no TF32: fp32 parity).  q.k
//    takes 4 rows x 4 keys a thread over float4 columns (8 FFMA a load);
//    p.v takes 4 rows x 4 consecutive output dims a thread, P read as
//    float4 over 4 keys and V rows as float4 (8 FFMA a load at hd 64).  A
//    row of P stays within a half-warp, so P needs a warp barrier only.
//    At hd 64 a block holds to 128 registers, so that two share an SM.
// 3. bf16/fp16 rows (MmaTile): 4 warps of 16 query rows each (128
//    threads) on the tensor cores, mma.sync m16n8k16 with fp32
//    accumulators.  Q and K fragments come by ldmatrix, V's by
//    ldmatrix.trans, from K/V kept in shared memory in their own 16-bit
//    type.  S = QK^T stays in registers, the online softmax runs there
//    (quad shuffles), and P is rounded to the input type in registers to
//    become the A fragment of P.V (as SDPA's tensor-core kernels do; l is
//    the sum of the fp32 p).
//
// Head widths: built for HD in {16, 32, 64, 128, 256}; any real head dim
// hd <= HD runs at the least HD >= hd.  Columns at or past hd are zero
// filled, so the padding adds nothing to q.k or p.v, and only columns below
// hd are stored.  Where hd == HD (EXACT) the kernel passes HD itself down
// as hd, so every such test folds away at compile time.  Rows of hd
// elements that are not whole 16-byte vectors are copied element by
// element at the same point of the schedule (only the overlap is lost).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int BQ = 64;
constexpr int kWindow = 128;        // K/V tiles one live list holds
constexpr int kWords = kWindow / 32;
constexpr int kMaxWarps = 8;

constexpr uint16_t kPartial = 0x8000;  // list entry: tile (low bits) | partial
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool uses_mma() {
  return std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;
}

// The live list of one window of K/V tiles (scan_window): 528 bytes.
struct LiveList {
  uint16_t entry[kWindow];           // window-relative tile | kPartial
  uint32_t bits[kMaxWarps][2][kWords];  // per warp: some entry valid / invalid
  int n;
  int computed;                      // live tiles of the windows so far
  int pad[2];
};

// Shared memory of one block, in bytes and in order: the Q tile; the fp32
// tile's P (BQ x BKT fp32); DEPTH stages of (K tile, V tile, mask tile);
// the live list.  Q, K and V are held in their own type T (TS): fp32 on
// the fp32 tile, the 16-bit input type on the tensor cores.  Rows are padded by 16 bytes, so
// they stay 16-byte aligned and neighbouring rows start in other banks.
// kernels/pipeline.ring_smem_bytes mirrors this layout.
template <int HD, typename T, int DEPTH>
struct Layout {
  static constexpr bool kMma = uses_mma<T>();
  using TS = T;
  static constexpr int BKT = HD > 128 ? 32 : 64;
  static constexpr int kThreads = kMma ? 128 : 256;
  static constexpr int KS = HD + 16 / static_cast<int>(sizeof(TS));  // Q, K, V row
  static constexpr int PS = BKT + 4;                 // P row (fp32 tile)
  static constexpr int MS = kMma ? BKT + 16 : BKT;   // mask row (bytes)
  static constexpr size_t kQBytes = sizeof(TS) * BQ * KS;
  static constexpr size_t kPBytes = kMma ? 0 : sizeof(float) * BQ * PS;
  static constexpr size_t kKVBytes = sizeof(TS) * BKT * KS;
  static constexpr size_t kStageBytes = 2 * kKVBytes + BQ * MS;
  static constexpr size_t kListBytes = sizeof(LiveList);
  static constexpr size_t kBytes =
      kQBytes + kPBytes + DEPTH * kStageBytes + kListBytes;
};

__device__ __forceinline__ bool has_zero_byte(unsigned w) {
  return ((w - 0x01010101u) & ~w & 0x80808080u) != 0;
}

// List the live tiles w0 .. w0+ntw-1 of the block's 64 mask rows
// (`mrow`: row q0 of this batch's (S, T) mask; `rows` of them below S).
// For each word of 32 tiles, every thread walks its 16-byte chunks of them
// (16-byte loads where `mvec`, T % 16 == 0, a batch of them issued
// before the first is read, so the scan pays about one L2 latency a
// batch) and keeps a bit a tile for "some entry valid" and
// "some entry invalid"; a
// warp ORs its lanes' bits (__reduce_or_sync) into its own words of shared
// memory, and warp 0 ORs the warps' words and compacts them into the list.
// Two block barriers (three past the first window).
template <int NT, int BKT>
__device__ __forceinline__ void scan_window(LiveList& ll, const uint8_t* __restrict__ mrow,
                                            int rows, int T, int w0, int ntw, bool mvec) {
  constexpr int CPR = BKT / 16;  // chunks a tile row
  constexpr int CPT = BQ * CPR;  // chunks a tile, a multiple of 32
  constexpr int kWarps = NT / 32;
  static_assert(kWarps <= kMaxWarps, "a bit word per warp");
  constexpr int kScanBatch = 8;  // mask loads a thread has in flight
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w0 > 0) __syncthreads();  // the previous window's list is no longer read
  for (int t0 = 0; t0 < ntw; t0 += 32) {
    const int end = min(t0 + 32, ntw) * CPT;  // a multiple of 32: warp-uniform
    unsigned live = 0, part = 0;
    for (int c0 = t0 * CPT; c0 < end; c0 += kScanBatch * NT) {
      uint4 u[kScanBatch];
#pragma unroll
      for (int i = 0; i < kScanBatch; ++i) {
        const int c = c0 + i * NT + threadIdx.x;
        const int r = (c % CPT) / CPR;
        const int col = (w0 + c / CPT) * BKT + (c % CPR) * 16;
        u[i] = make_uint4(0u, 0u, 0u, 0u);
        if (mvec && c < end && r < rows && col < T)
          u[i] = __ldg(reinterpret_cast<const uint4*>(mrow + static_cast<size_t>(r) * T + col));
      }
#pragma unroll
      for (int i = 0; i < kScanBatch; ++i) {
        const int c = c0 + i * NT + threadIdx.x;
        if (c >= end) break;
        const int t = c / CPT;
        const int r = (c % CPT) / CPR;
        const int col = (w0 + t) * BKT + (c % CPR) * 16;
        bool any = false, all = true;
        if (r < rows) {
          if (mvec) {
            any = (u[i].x | u[i].y | u[i].z | u[i].w) != 0;
            all = col < T && !(has_zero_byte(u[i].x) || has_zero_byte(u[i].y) ||
                               has_zero_byte(u[i].z) || has_zero_byte(u[i].w));
          } else {  // rows that are not whole vectors: byte by byte
            const uint8_t* src = mrow + static_cast<size_t>(r) * T + col;
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const bool on = col + e < T && src[e] != 0;
              any |= on;
              all &= on;
            }
          }
        }
        live |= static_cast<unsigned>(any) << (t - t0);
        part |= static_cast<unsigned>(!all) << (t - t0);
      }
    }
    live = __reduce_or_sync(0xffffffffu, live);
    part = __reduce_or_sync(0xffffffffu, part);
    if (lane == 0) {
      ll.bits[warp][0][t0 / 32] = live;
      ll.bits[warp][1][t0 / 32] = part;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int w = 0; w < (ntw + 31) / 32; ++w) {
      unsigned live = 0, part = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        live |= ll.bits[i][0][w];
        part |= ll.bits[i][1][w];
      }
      if ((live >> lane) & 1u)
        ll.entry[n + __popc(live & ((1u << lane) - 1u))] =
            static_cast<uint16_t>(w * 32 + lane) | (((part >> lane) & 1u) ? kPartial : 0);
      n += __popc(live);
    }
    if (lane == 0) {
      ll.n = n;
      ll.computed = (w0 > 0 ? ll.computed : 0) + n;
    }
  }
  __syncthreads();
}

// Copy `rows` (BQ or BKT) rows of hd <= HD elements of T into shared
// memory of the same type (row stride KS, HD columns, those past hd and
// rows at or past `valid` zero-filled): 16-byte cp.async chunks where rows
// are whole vectors (`vec`), else plain element copies.
template <int NT, int HD, int KS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int rows, const T* __restrict__ src,
                                          size_t ld, int valid, int hd, bool vec) {
  constexpr int V = Vec16<T>::N;
  constexpr int kChunks = HD / V;
  for (int c = threadIdx.x; c < rows * kChunks; c += NT) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * V;
    const bool ok = r < valid && d < hd;
    if (vec) {
      cp_async16(dst + r * KS + d, ok ? src + r * ld + d : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        dst[r * KS + d + j] = ok && d + j < hd ? src[r * ld + d + j] : from_f32<T>(0.f);
    }
  }
}

// The mask bytes of one partial tile (BQ rows x BKT keys from `src`, row
// stride T) into shared memory (row stride MS); rows at or past `rows`
// and keys at or past `cols` are 0 (masked).
template <int NT, int BKT, int MS>
__device__ __forceinline__ void copy_mask(uint8_t* dst, const uint8_t* __restrict__ src,
                                          int T, int rows, int cols, bool mvec) {
  constexpr int CPR = BKT / 16;
  for (int c = threadIdx.x; c < BQ * CPR; c += NT) {
    const int r = c / CPR;
    const int d = (c % CPR) * 16;
    const uint8_t* s = src + static_cast<size_t>(r) * T + d;
    if (mvec) {
      const bool ok = r < rows && d < cols;
      cp_async16(dst + r * MS + d, ok ? s : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[r * MS + d + e] = r < rows && d + e < cols ? s[e] : 0;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void fma4(float4& a, float p, float4 v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// ---------------------------------------------------------------------------
// fp32 tile: 256 threads on the CUDA cores.  Thread (ty, tx) = (tid / 16,
// tid % 16) owns query rows ty + 16i (i < 4).  In q.k it owns keys tx + 16j
// (j < BKT/16); the 16 threads of a row are one half-warp, so row max and
// row sum are 4 xor-shuffles.  In p.v it owns 4 consecutive output dims
// 4*dtx + 64*jd (dtx = tx % DT); below hd 64 the DT threads of a row cover
// all dims and the KSPLIT = 16/DT groups of them take every KSPLIT-th
// 4-key step, summed by shuffles at the end.
// ---------------------------------------------------------------------------
template <int HD, class L>
struct F32Tile {
  static constexpr int NJ = L::BKT / 16;
  static constexpr int DT = HD >= 64 ? 16 : HD / 4;
  static constexpr int KSPLIT = 16 / DT;
  static constexpr int DV = HD >= 64 ? HD / 64 : 1;
  float m[4];
  float l[4];
  float4 acc[4][DV];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int jd = 0; jd < DV; ++jd) acc[i][jd] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void load_q(const float*) {}

  // Fold one K/V tile into the state.  mask_s: the tile's mask bytes, or
  // null for a full tile.  A row of P is written and read by the 16
  // threads of one half-warp, so a warp barrier orders P's writes before
  // its reads; the caller syncs the block before P or the tile is
  // overwritten.
  __device__ __forceinline__ void step(const float* q_s, const float* k_s, const float* v_s,
                                       float* p_s, const uint8_t* mask_s, int hd,
                                       float sm_scale) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;

    const int hd4 = (hd + 3) & ~3;  // columns past hd are 0
#pragma unroll 4
    for (int d = 0; d < hd4; d += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = lds4(q_s + (ty + 16 * i) * L::KS + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = lds4(k_s + (tx + 16 * j) * L::KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[NJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ok[j] = !mask_s || mask_s[(ty + 16 * i) * L::MS + tx + 16 * j] != 0;
        s[i][j] = ok[j] ? s[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * L::PS + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DV; ++jd) {
        acc[i][jd].x *= alpha;
        acc[i][jd].y *= alpha;
        acc[i][jd].z *= alpha;
        acc[i][jd].w *= alpha;
      }
    }
    __syncwarp();

    const int dtx = tx % DT;
    const int ks = tx / DT;
#pragma unroll 2
    for (int c = 4 * ks; c < L::BKT; c += 4 * KSPLIT) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = lds4(p_s + (ty + 16 * i) * L::PS + c);
#pragma unroll
      for (int jd = 0; jd < DV; ++jd) {
        if (64 * jd >= hd) continue;
        const float* vc = v_s + c * L::KS + 4 * dtx + 64 * jd;
        const float4 v0 = lds4(vc), v1 = lds4(vc + L::KS), v2 = lds4(vc + 2 * L::KS),
                     v3 = lds4(vc + 3 * L::KS);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fma4(acc[i][jd], p[i].x, v0);
          fma4(acc[i][jd], p[i].y, v1);
          fma4(acc[i][jd], p[i].z, v2);
          fma4(acc[i][jd], p[i].w, v3);
        }
      }
    }
  }

  // out[b, r, h, :hd] = acc / max(l, 1e-30) for this thread's rows below S.
  template <typename T>
  __device__ __forceinline__ void finalize(T* __restrict__ out, int b, int h, int q0, int S,
                                           int H, int hd) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int dtx = tx % DT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = out + ((static_cast<size_t>(b) * S + r) * H + h) * hd;
#pragma unroll
      for (int jd = 0; jd < DV; ++jd) {
        float4 a = acc[i][jd];
#pragma unroll
        for (int off = DT; off < 16; off *= 2) {
          a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
          a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
          a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
          a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
        }
        const int d = 4 * dtx + 64 * jd;
        if (tx >= DT || r >= S || d >= hd) continue;
        const float4 o = make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
        if (hd % 4 == 0) {
          store4(orow + d, o);
        } else {
          const float e[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d + j < hd) orow[d + j] = from_f32<T>(e[j]);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Tensor-core tile: 4 warps, warp w owns query rows 16w .. 16w+15.  In the
// m16n8k16 fragments lane (g, t) = (lane / 4, lane % 4) holds rows g and
// g + 8 and columns 2t, 2t+1 of each 8-column block.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
template <>
__device__ __forceinline__ void store2<__half>(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

template <int HD, class L>
struct MmaTile {
  using T = typename L::TS;
  static constexpr int BKT = L::BKT;
  static constexpr int NB = BKT / 8;  // 8-key blocks of S
  static constexpr int ND = HD / 8;   // 8-dim blocks of the output
  static constexpr int KD = HD / 16;  // 16-dim steps of q.k
  // Q fragments stay in registers up to HD 128; at 256 they would not
  // leave room for the 128 accumulators, and are re-read from shared.
  static constexpr bool kQRegs = HD <= 128;
  static_assert(4 * NB <= 32, "one ok bit a score in a 32-bit word");
  float m[2];  // rows g, g+8, in log2 units (scores times log2 e)
  float l[2];  // this lane's share of the row sum; quad-summed at the end
  float o[ND][4];
  uint32_t qf[kQRegs ? KD : 1][4];

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
  }

  // A fragment of q.k step kd: rows 16w + (lane % 16), columns 16kd +
  // 8 (lane / 16).
  __device__ __forceinline__ void q_frag(uint32_t* a, const T* q_s, int kd) const {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    ldsm_x4(a, q_s + (16 * w + lane % 16) * L::KS + 16 * kd + 8 * (lane / 16));
  }

  __device__ __forceinline__ void load_q(const T* q_s) {
    if constexpr (kQRegs) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) q_frag(qf[kd], q_s, kd);
    }
  }

  __device__ __forceinline__ void step(const T* q_s, const T* k_s, const T* v_s, float*,
                                       const uint8_t* mask_s, int hd, float sm_scale) {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

    // S = Q K^T: B fragments of 8-key blocks j, j+1 from K rows
    // 8j + 8 (lane / 16) + lane % 8, columns 16kd + 8 ((lane / 8) % 2).
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      if (16 * kd >= hd) continue;  // columns past hd are 0
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        q_frag(a, q_s, kd);
      }
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (8 * j + 8 * (lane / 16) + lane % 8) * L::KS + 16 * kd +
                       8 * ((lane / 8) % 2));
        mma16816<T>(s[j], a, b[0], b[1]);
        mma16816<T>(s[j + 1], a, b[2], b[3]);
      }
    }

    // Online softmax on the fragments: element e of block j is row
    // 16w + g + 8 (e / 2), key 8j + 2t + e % 2.
    const float sl = sm_scale * kLog2e;
    uint32_t ok = 0xffffffffu;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (mask_s && mask_s[(16 * w + g + 8 * (e / 2)) * L::MS + 8 * j + 2 * t + e % 2] == 0)
          ok &= ~(1u << (4 * j + e));
        s[j][e] = (ok >> (4 * j + e)) & 1u ? s[j][e] * sl : kNegInf;
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

    // O += P V: P's A fragment of keys 16kk .. 16kk+15 is S blocks 2kk and
    // 2kk+1 rounded to T; V's B fragments of 8-dim blocks n, n+1 come by
    // ldmatrix.trans from V rows 16kk + 8 ((lane / 8) % 2) + lane % 8,
    // columns 8n + 8 (lane / 16).
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        if (8 * n >= hd) continue;
        uint32_t b[4];
        ldsm_x4_trans(b, v_s + (16 * kk + 8 * ((lane / 8) % 2) + lane % 8) * L::KS + 8 * n +
                             8 * (lane / 16));
        mma16816<T>(o[n], a, b[0], b[1]);
        mma16816<T>(o[n + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void finalize(T* __restrict__ out, int b, int h, int q0, int S,
                                           int H, int hd) {
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float denom = fmaxf(li, 1e-30f);
      const int r = q0 + 16 * w + g + 8 * i;
      if (r >= S) continue;
      T* orow = out + ((static_cast<size_t>(b) * S + r) * H + h) * hd;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = 8 * n + 2 * t;
        const float x = o[n][2 * i] / denom, y = o[n][2 * i + 1] / denom;
        if (hd % 2 == 0) {
          if (d < hd) store2<T>(orow + d, x, y);
        } else {
          if (d < hd) orow[d] = from_f32<T>(x);
          if (d + 1 < hd) orow[d + 1] = from_f32<T>(y);
        }
      }
    }
  }
};

template <int HD, class L>
using Tile = typename std::conditional<L::kMma, MmaTile<HD, L>, F32Tile<HD, L>>::type;

// fp32 blocks at the served width 64 with at most two stages are held to
// 128 registers, so that two of them share an SM (a deeper ring leaves
// room for one block only); tensor-core blocks up to width 64 to 170, so
// that three do.
template <int HD, class L, int DEPTH>
__host__ __device__ constexpr int min_blocks() {
  if (L::kMma) return HD <= 64 ? 3 : 1;
  return HD == 64 && DEPTH <= 2 ? 2 : 1;
}

// The kernel: one block per (64-row q tile, head, batch), grid (B*H, nq)
// with the q tile counted from the last.  q, K, V and out of T (float,
// bf16 or fp16).  Query head h reads KV head h / (H/K).  DEPTH == 1 loads
// each live tile and computes it (K2); DEPTH >= 2 streams the live tiles
// through a DEPTH-stage ring (K3): fill DEPTH-1 tiles, then at list position p wait
// for tile p (cp.async.wait_group DEPTH-2), sync the block, start the copy
// of tile p+DEPTH-1 into the slot that position p-1 just finished with, and
// compute tile p while the later copies fly; one commit group per position
// (empty past the end) keeps the wait count uniform.
template <int HD, bool EXACT, typename T, int DEPTH>
__global__ void __launch_bounds__(Layout<HD, T, DEPTH>::kThreads,
                                  (min_blocks<HD, Layout<HD, T, DEPTH>, DEPTH>()))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const uint8_t* __restrict__ mask, T* __restrict__ out, int S, int T_len, int H,
             int K, int hd_arg, int mask_b, float sm_scale, int* __restrict__ live) {
  using L = Layout<HD, T, DEPTH>;
  using TS = typename L::TS;
  constexpr int NT = L::kThreads;
  constexpr int BKT = L::BKT;
  const int hd = EXACT ? HD : hd_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TS* q_s = reinterpret_cast<TS*>(smem_raw);
  float* p_s = reinterpret_cast<float*>(smem_raw + L::kQBytes);
  unsigned char* ring = smem_raw + L::kQBytes + L::kPBytes;
  LiveList& ll = *reinterpret_cast<LiveList*>(ring + DEPTH * L::kStageBytes);
  auto k_slot = [&](int s) { return reinterpret_cast<TS*>(ring + s * L::kStageBytes); };
  auto v_slot = [&](int s) {
    return reinterpret_cast<TS*>(ring + s * L::kStageBytes + L::kKVBytes);
  };
  auto m_slot = [&](int s) { return ring + s * L::kStageBytes + 2 * L::kKVBytes; };

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q tile first
  const int kvh = h / (H / K);
  const uint8_t* mrow =
      mask + (mask_b > 1 ? static_cast<size_t>(b) * S * T_len : 0) + static_cast<size_t>(q0) * T_len;
  const int rows = S - q0;
  const int nt = (T_len + BKT - 1) / BKT;
  const bool scan = nt > 1;
  const bool mvec = T_len % 16 == 0;
  const size_t kv_ld = static_cast<size_t>(K) * hd;

  const T* q_src = q + ((static_cast<size_t>(b) * S + q0) * H + h) * hd;
  copy_rows<NT, HD, L::KS>(q_s, BQ, q_src, static_cast<size_t>(H) * hd, rows, hd,
                           hd % Vec16<T>::N == 0);
  cp_async_commit();

  // fp32 rows start tile 0's copies before the scan, on the guess that the
  // list begins with it (every causal row's does): the scan's mask reads
  // then overlap the copies.  Where the list says otherwise the copies are
  // drained before the fill.  (On the tensor cores the guess measured
  // slower: PERF.md.)
  constexpr bool kGuess = !L::kMma;
  if constexpr (kGuess) {
    const size_t base = (static_cast<size_t>(b) * T_len * K + kvh) * hd;
    const bool vec = hd % Vec16<T>::N == 0;
    copy_rows<NT, HD, L::KS>(k_slot(0), BKT, k + base, kv_ld, T_len, hd, vec);
    copy_rows<NT, HD, L::KS>(v_slot(0), BKT, v + base, kv_ld, T_len, hd, vec);
    copy_mask<NT, BKT, L::MS>(m_slot(0), mrow, T_len, rows, T_len, mvec);
    cp_async_commit();
  }
  Tile<HD, L> tile;
  tile.init();
  bool need_q = true;  // Q lands with the first live tile's copies
  for (int w0 = 0; w0 < nt; w0 += kWindow) {
    if (scan) scan_window<NT, BKT>(ll, mrow, rows, T_len, w0, min(kWindow, nt - w0), mvec);
    const int n = scan ? ll.n : 1;
    auto entry = [&](int p) -> int { return scan ? ll.entry[p] : kPartial; };
    bool guessed = false;  // list position 0's tile is in slot 0 already
    if (kGuess && w0 == 0) {
      guessed = n > 0 && (entry(0) & ~kPartial) == 0;
      if (!guessed) {
        cp_async_wait<0>();
        __syncthreads();  // no copy into a slot is still in flight
      }
    }
    // Copy list position p's K/V tile (and a partial tile's mask bytes)
    // into slot p % DEPTH.
    auto issue = [&](int p) {
      const int e = entry(p);
      const int k0 = (w0 + (e & ~kPartial)) * BKT;
      const int s = p % DEPTH;
      const size_t base = ((static_cast<size_t>(b) * T_len + k0) * K + kvh) * hd;
      const bool vec = hd % Vec16<T>::N == 0;
      copy_rows<NT, HD, L::KS>(k_slot(s), BKT, k + base, kv_ld, T_len - k0, hd, vec);
      copy_rows<NT, HD, L::KS>(v_slot(s), BKT, v + base, kv_ld, T_len - k0, hd, vec);
      if (e & kPartial)
        copy_mask<NT, BKT, L::MS>(m_slot(s), mrow + k0, T_len, rows, T_len - k0, mvec);
    };
    auto compute = [&](int p) {
      const int s = p % DEPTH;
      if (need_q) {
        tile.load_q(q_s);
        need_q = false;
      }
      tile.step(q_s, k_slot(s), v_slot(s), p_s, (entry(p) & kPartial) ? m_slot(s) : nullptr,
                hd, sm_scale);
    };
    if constexpr (DEPTH == 1) {
      for (int p = 0; p < n; ++p) {
        __syncthreads();  // every thread is done with the slot and P
        if (p > 0 || !guessed) issue(p);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        compute(p);
      }
    } else {
#pragma unroll
      for (int p = 0; p < DEPTH - 1; ++p) {
        if (p < n && (p > 0 || !guessed)) issue(p);
        cp_async_commit();
      }
      for (int p = 0; p < n; ++p) {
        cp_async_wait<DEPTH - 2>();  // this thread's copies of tile p have landed
        __syncthreads();             // ... and everyone's; slot (p-1) % DEPTH is free
        if (p + DEPTH - 1 < n) issue(p + DEPTH - 1);
        cp_async_commit();
        compute(p);
      }
    }
    cp_async_wait<0>();
  }
  if (live && threadIdx.x == 0) atomicAdd(live, scan ? ll.computed : 1);
  tile.finalize(out, b, h, q0, S, H, hd);
}

template <int HD, typename T, int DEPTH>
auto kernel_for(int hd) {
  return hd == HD ? flash_kernel<HD, true, T, DEPTH> : flash_kernel<HD, false, T, DEPTH>;
}

// Launch at the padded width HD: cudaErrorInvalidConfiguration where the
// block's shared memory passes the 227 KB a block may have.  Where `live`
// is not null, each block adds to it the K/V tiles it computed.
template <int HD, typename T, int DEPTH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int S, int T_len, int H, int K, int hd, int mask_b, float sm_scale,
                   int* live, cudaStream_t stream) {
  using L = Layout<HD, T, DEPTH>;
  if (L::kBytes > 232448) return cudaErrorInvalidConfiguration;
  auto kern = kernel_for<HD, T, DEPTH>(hd);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K, hd, mask_b,
      sm_scale, live);
  return cudaGetLastError();
}

// Blocks of the width-HD kernel that are resident on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -error.
template <int HD, typename T, int DEPTH>
int occupancy(int hd) {
  using L = Layout<HD, T, DEPTH>;
  if (L::kBytes > 232448) return -static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = kernel_for<HD, T, DEPTH>(hd);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L::kBytes));
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, L::kThreads, L::kBytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The instantiated width for a head dim: the least of 16, 32, 64, 128, 256
// that holds it; 0 above 256 (no kernel).
__host__ inline int padded_head_dim(int hd) {
  for (int w = 16; w <= 256; w *= 2)
    if (hd <= w) return w;
  return 0;
}

// Call F<HD>() for the padded width of a head dim 1 <= hd <= 256, else
// return `bad`.
#define FLASH_DISPATCH_HD(hd, bad, CALL)                                       \
  do {                                                                         \
    switch ((hd) < 1 ? 0 : flash::padded_head_dim(hd)) {                       \
      case 16: { constexpr int W = 16; return CALL; }                          \
      case 32: { constexpr int W = 32; return CALL; }                          \
      case 64: { constexpr int W = 64; return CALL; }                          \
      case 128: { constexpr int W = 128; return CALL; }                        \
      case 256: { constexpr int W = 256; return CALL; }                        \
      default: return bad;                                                     \
    }                                                                          \
  } while (0)

// Launch K2: a single K/V stage.
template <typename T>
cudaError_t dispatch_baseline(int hd, const void* q, const void* k, const void* v,
                              const void* mask, void* out, int B, int S, int T_len, int H, int K,
                              int mask_b, float sm_scale, int* live, cudaStream_t stream) {
  FLASH_DISPATCH_HD(hd, cudaErrorInvalidValue,
                    (launch<W, T, 1>(q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale,
                                     live, stream)));
}

// K3: a `depth`-stage ring (2 <= depth <= 4) at the padded width HD.
template <int HD, typename T>
cudaError_t dispatch_depth(int depth, const void* q, const void* k, const void* v,
                           const void* mask, void* out, int B, int S, int T_len, int H, int K,
                           int hd, int mask_b, float sm_scale, int* live,
                           cudaStream_t stream) {
  switch (depth) {
#define REPRO_DEPTH(D) \
    case D: return launch<HD, T, D>(q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, live, stream);
    REPRO_DEPTH(2) REPRO_DEPTH(3) REPRO_DEPTH(4)
#undef REPRO_DEPTH
    default: return cudaErrorInvalidValue;
  }
}

template <int HD, typename T>
int occupancy_depth(int depth, int hd) {
  switch (depth) {
    case 2: return occupancy<HD, T, 2>(hd);
    case 3: return occupancy<HD, T, 3>(hd);
    case 4: return occupancy<HD, T, 4>(hd);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch K3 with q, K/V and out of T.  Not inline: a source may leave a
// dtype's instantiation to another (FLASH_RING_INSTANCE), so that the
// library's dtypes compile in parallel.
template <typename T>
cudaError_t dispatch_ring(int hd, int depth, const void* q, const void* k, const void* v,
                          const void* mask, void* out, int B, int S, int T_len, int H, int K,
                          int mask_b, float sm_scale, int* live, cudaStream_t stream) {
  FLASH_DISPATCH_HD(hd, cudaErrorInvalidValue,
                    (dispatch_depth<W, T>(depth, q, k, v, mask, out, B, S, T_len, H, K, hd,
                                          mask_b, sm_scale, live, stream)));
}

// Blocks of K3 resident on one SM at head dim hd and ring depth, or -error.
template <typename T>
int occupancy_ring(int hd, int depth) {
  FLASH_DISPATCH_HD(hd, -static_cast<int>(cudaErrorInvalidValue),
                    (occupancy_depth<W, T>(depth, hd)));
}

}  // namespace flash

// K3's instantiations for one dtype: `KW` is `template` in the source that
// compiles them and `extern template` in the one that calls them.
#define FLASH_RING_INSTANCE(KW, T)                                                      \
  KW cudaError_t flash::dispatch_ring<T>(int, int, const void*, const void*, const void*, \
                                         const void*, void*, int, int, int, int, int, int, \
                                         float, int*, cudaStream_t);                     \
  KW int flash::occupancy_ring<T>(int, int)
