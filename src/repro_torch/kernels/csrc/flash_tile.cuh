// The online-softmax tile update shared by K2 (flash_attention.cu), K3
// (flash_attention_pipelined.cu) and K6 (flash_attention_int8kv.cu), so the
// masked-row arithmetic lives in one place -- the counterpart of
// _online_softmax_update / _init_flash_scratch / _finalize_flash_output in
// src/repro/kernels/flash_attention.py -- and the baseline kernel K2 and K6
// share, which differ only in their K/V tile loader (load_kv_tile).
//
// Block shape: 256 threads own a BQ x BKT score tile (BKT = 64 keys, or 32
// where a wide head's ring would not fit).  Thread (ty, tx) = (tid / 16,
// tid % 16) owns query rows ty + 16*i (i < 4), key columns tx + 16*j
// (j < BKT/16) and output dims tx + 16*jd (jd < HD/16).  The 16 threads that
// share a row are one half-warp, so row max and row sum are 4 xor-shuffles.
// All arithmetic is fp32 FFMA on the CUDA cores (no TF32).
//
// Head widths: the kernels are built for HD in {16, 32, 64, 128, 256} and
// take any real head dim hd <= HD at run time (the wrappers pick the least
// HD >= hd): tiles are loaded with columns at or past hd zero-filled, so
// the padding adds nothing to q.k or to p.v, the q.k loop stops at hd
// rounded up to 4, the p.v loop skips the 16-wide column groups wholly past
// hd, and only columns below hd are stored.  Rows of hd elements that are
// whole 16-byte vectors load as vectors; others element by element.  Where
// hd == HD (EXACT) the kernel passes HD itself down as hd, so every one of
// those tests folds away at compile time.
//
// Semantics (bit-for-bit the reference's rules, not its summation order):
//   s = (q . k) * sm_scale, and -1e30 where the mask is false;
//   m' = max(m, rowmax s); alpha = exp(m - m'); p = mask ? exp(s - m') : 0;
//   l = alpha * l + rowsum p; acc = alpha * acc + p v;
//   out = acc / max(l, 1e-30), so a row with no valid key gives 0.
// Keys past T and queries past S are treated as masked / not written.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace flash {

constexpr int BQ = 64;
constexpr int BK = 64;  // keys a tile, except BK_WIDE at HD = 256 in K3
constexpr int BK_WIDE = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kQStride = 4;  // fp32 padding of the Q and P rows

// Row stride (elements) of a K/V tile held as TS in shared memory: padded by
// 16 bytes so rows stay 16-byte aligned and neighbouring rows start in
// different banks.
template <int HD, typename TS, int BKT = BK>
struct KVLayout {
  static constexpr int kStride = HD + 16 / static_cast<int>(sizeof(TS));
  static constexpr int kTileElems = BKT * kStride;
};

template <int HD>
struct QLayout {
  static constexpr int kStride = HD + kQStride;
};
template <int BKT>
struct PLayout {
  static constexpr int kStride = BKT + kQStride;
};

// 4 consecutive elements of a shared-memory row as fp32 (16 B for fp32, 8 B
// for bf16 or fp16; both aligned since d % 4 == 0 and rows are 16-byte
// aligned).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 lds4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
  const float2 a = __half22float2(h[0]);
  const float2 b = __half22float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
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

// Per-thread running state of the online softmax for its 4 query rows.
template <int HD>
struct RowState {
  static constexpr int kDims = HD / 16;
  float m[4];
  float l[4];
  float acc[4][kDims];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int jd = 0; jd < kDims; ++jd) acc[i][jd] = 0.f;
    }
  }
};

// V elements of row `src` from column d as fp32: a 16-byte vector load
// where the row is whole vectors (`vec`, so d + V <= hd whenever d < hd),
// else one element at a time; columns at or past hd are 0.  int8 values
// are multiplied by `scale` (the KV head's) in registers, the same single
// product as the plain version's k8.float() * k_scale.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, int d, int hd,
                                           bool vec, float scale, float* v) {
  constexpr int V = Vec16<T>::N;
  if (vec && d < hd) {
    load16(src + d, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = d + j < hd ? to_f32(src[d + j]) : 0.f;
  }
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] *= scale;
  }
}

// Load `rows` (BQ or BKT) rows of hd <= HD elements of T into fp32 shared
// memory (row stride `dst_stride`, HD columns, those past hd zero-filled).
// Row r of the source starts at src + r * ld; rows at or past `valid` are
// zero-filled (never read from global memory).  `scale` is int8 K/V's.
template <int HD, typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int dst_stride, int rows,
                                              const T* __restrict__ src, size_t ld,
                                              int valid, int hd, float scale = 1.f) {
  constexpr int V = Vec16<T>::N;
  constexpr int kChunks = HD / V;  // 16-byte chunks per row
  const bool vec = hd % V == 0;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * V;
    float v[V];
    if (r < valid) {
      load_chunk(src + r * ld, d, hd, vec, scale, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) store16(dst + r * dst_stride + d + j, v + j);
  }
}

// One K/V tile: update the running state of this thread's rows.
//   q_s: BQ x HD fp32 (stride QLayout::kStride); k_s, v_s: BKT x HD of TS
//   (stride KVLayout::kStride), rows past T and columns past hd zero-filled;
//   p_s: BQ x BKT fp32 scratch.  mask_b points at mask[b or 0], shaped
//   (S, T) uint8.
// Contains one __syncthreads (P written -> P read); the caller must sync
// before p_s or the K/V tile is overwritten.
template <int HD, int BKT, typename TS>
__device__ __forceinline__ void tile_update(
    RowState<HD>& st, const float* q_s, const TS* k_s, const TS* v_s, float* p_s,
    const uint8_t* __restrict__ mask_b, int q0, int k0, int S, int T, int hd,
    float sm_scale) {
  constexpr int QS = QLayout<HD>::kStride;
  constexpr int KS = KVLayout<HD, TS, BKT>::kStride;
  constexpr int PS = PLayout<BKT>::kStride;
  constexpr int NJ = BKT / 16;
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
    for (int i = 0; i < 4; ++i) qv[i] = lds4(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j) kv[j] = lds4(k_s + (tx + 16 * j) * KS + d);
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

  bool ok[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + tx + 16 * j;
      ok[i][j] = r < S && c < T && mask_b[static_cast<size_t>(r) * T + c] != 0;
      s[i][j] = ok[i][j] ? s[i][j] * sm_scale : kNegInf;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = s[i][0];
#pragma unroll
    for (int j = 1; j < NJ; ++j) mx = fmaxf(mx, s[i][j]);
    mx = half_warp_max(mx);
    const float m_new = fmaxf(st.m[i], mx);
    const float alpha = expf(st.m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
      p_s[(ty + 16 * i) * PS + tx + 16 * j] = p;
      rs += p;
    }
    rs = half_warp_sum(rs);
    st.l[i] = alpha * st.l[i] + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int jd = 0; jd < RowState<HD>::kDims; ++jd) st.acc[i][jd] *= alpha;
  }
  __syncthreads();

#pragma unroll 4
  for (int c = 0; c < BKT; ++c) {
    float vv[RowState<HD>::kDims];
#pragma unroll
    for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
      vv[jd] = 16 * jd < hd ? to_f32(v_s[c * KS + tx + 16 * jd]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
        if (16 * jd < hd) st.acc[i][jd] = fmaf(p, vv[jd], st.acc[i][jd]);
    }
  }
}

// out[b, r, h, :hd] = acc / max(l, 1e-30) for this thread's rows below S.
template <int HD, typename T>
__device__ __forceinline__ void finalize(const RowState<HD>& st, T* __restrict__ out,
                                         int b, int h, int q0, int S, int H, int hd) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * S + r) * H + h) * hd;
#pragma unroll
    for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
      if (tx + 16 * jd < hd) orow[tx + 16 * jd] = from_f32<T>(st.acc[i][jd] / denom);
  }
}

// Dynamic shared memory of one block: Q tile + P tile + `kv_tiles` K/V tiles
// of TS (2 per pipeline stage) of BKT keys.
template <int HD, typename TS, int BKT = BK>
constexpr size_t smem_bytes(int kv_tiles) {
  return sizeof(float) * (BQ * QLayout<HD>::kStride + BQ * PLayout<BKT>::kStride) +
         sizeof(TS) * static_cast<size_t>(kv_tiles) * KVLayout<HD, TS, BKT>::kTileElems;
}

// The baseline kernel (K2 with TKV = T, K6 with TKV = int8_t): one block of
// 256 threads per (q tile of 64 rows, head, batch).  Blocks run in no order
// on 132 SMs, so the TPU's sequential K/V grid dimension becomes a loop
// inside the block.  The Q tile is loaded once as fp32; each 64-row K/V
// tile is loaded into fp32 shared memory (int8 K/V converted exactly,
// i8x4_to_f32, and multiplied by the KV head's scale in registers),
// synchronised, and folded into the running state by tile_update.  Query
// head h reads KV head h / (H/K) and, for int8 K/V, that head's two scales
// (k_scale, v_scale; null for float K/V).  Shared memory: Q + P + one K and
// one V tile, 68 KB at HD = 64 and 212 KB at HD = 256, requested as dynamic
// shared memory above the 48 KB static limit.
template <int HD, bool EXACT, typename T, typename TKV>
__global__ void __launch_bounds__(kThreads)
baseline_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
                const TKV* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const uint8_t* __restrict__ mask,
                T* __restrict__ out, int S, int T_len, int H, int K, int hd_arg,
                int mask_b, float sm_scale) {
  const int hd = EXACT ? HD : hd_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KS = KVLayout<HD, float>::kStride;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + BQ * QLayout<HD>::kStride;
  float* k_s = p_s + BQ * PLayout<BK>::kStride;
  float* v_s = k_s + KVLayout<HD, float>::kTileElems;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const float ks = k_scale ? __ldg(k_scale + kvh) : 1.f;
  const float vs = v_scale ? __ldg(v_scale + kvh) : 1.f;
  const uint8_t* mask_b_ptr =
      mask + (mask_b > 1 ? static_cast<size_t>(b) * S * T_len : 0);

  load_tile_f32<HD, T>(q_s, QLayout<HD>::kStride, BQ,
                       q + ((static_cast<size_t>(b) * S + q0) * H + h) * hd,
                       static_cast<size_t>(H) * hd, S - q0, hd);
  RowState<HD> st;
  st.init();

  const size_t kv_ld = static_cast<size_t>(K) * hd;
  const int nk = (T_len + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    const size_t base = ((static_cast<size_t>(b) * T_len + k0) * K + kvh) * hd;
    __syncthreads();  // every thread is done with the previous K/V and P
    load_tile_f32<HD, TKV>(k_s, KS, BK, k + base, kv_ld, T_len - k0, hd, ks);
    load_tile_f32<HD, TKV>(v_s, KS, BK, v + base, kv_ld, T_len - k0, hd, vs);
    __syncthreads();
    tile_update<HD, BK, float>(st, q_s, k_s, v_s, p_s, mask_b_ptr, q0, k0, S, T_len,
                               hd, sm_scale);
  }
  finalize<HD, T>(st, out, b, h, q0, S, H, hd);
}

template <int HD, typename T, typename TKV>
cudaError_t launch_baseline(const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale,
                            const void* mask, void* out, int B, int S, int T_len,
                            int H, int K, int hd, int mask_b, float sm_scale,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, float>(2);
  auto kern = hd == HD ? baseline_kernel<HD, true, T, TKV>
                       : baseline_kernel<HD, false, T, TKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale,
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K, hd,
      mask_b, sm_scale);
  return cudaGetLastError();
}

// The instantiated width for a head dim: the least of 16, 32, 64, 128, 256
// that holds it; 0 above 256 (no kernel).
__host__ inline int padded_head_dim(int hd) {
  for (int w = 16; w <= 256; w *= 2)
    if (hd <= w) return w;
  return 0;
}

// Launch the baseline kernel with q/out of T and K/V of TKV for a head dim
// 1 <= hd <= 256; cudaErrorInvalidValue for another.
template <typename T, typename TKV>
cudaError_t dispatch_baseline(int hd, const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const void* mask, void* out, int B, int S, int T_len,
                              int H, int K, int mask_b, float sm_scale,
                              cudaStream_t stream) {
  if (hd < 1) return cudaErrorInvalidValue;
  switch (padded_head_dim(hd)) {
#define REPRO_HD(W) \
    case W: return launch_baseline<W, T, TKV>(q, k, v, k_scale, v_scale, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, stream);
    REPRO_HD(16) REPRO_HD(32) REPRO_HD(64) REPRO_HD(128) REPRO_HD(256)
#undef REPRO_HD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
