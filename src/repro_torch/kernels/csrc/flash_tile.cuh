// The online-softmax tile update shared by K2 (flash_attention.cu), K3
// (flash_attention_pipelined.cu) and K6 (flash_attention_int8kv.cu), so the
// masked-row arithmetic lives in one place -- the counterpart of
// _online_softmax_update / _init_flash_scratch / _finalize_flash_output in
// src/repro/kernels/flash_attention.py -- and the baseline kernel K2 and K6
// share, which differ only in their K/V tile loader (load_kv_tile).
//
// Block shape: 256 threads own a BQ x BK = 64 x 64 score tile.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16*i and key columns
// tx + 16*j (i, j < 4), and output dims tx + 16*jd (jd < HD/16).  The 16
// threads that share a row are one half-warp, so row max and row sum are 4
// xor-shuffles.  All arithmetic is fp32 FFMA on the CUDA cores (no TF32).
//
// Semantics (bit-for-bit the reference's rules, not its summation order):
//   s = (q . k) * sm_scale, and -1e30 where the mask is false;
//   m' = max(m, rowmax s); alpha = exp(m - m'); p = mask ? exp(s - m') : 0;
//   l = alpha * l + rowsum p; acc = alpha * acc + p v;
//   out = acc / max(l, 1e-30), so a row with no valid key gives 0.
// Keys past T and queries past S are treated as masked / not written.
#pragma once

#include "common.cuh"

namespace flash {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int kQStride = 4;  // fp32 padding of the Q and P rows

// Row stride (elements) of a K/V tile held as TS in shared memory: padded by
// 16 bytes so rows stay 16-byte aligned and neighbouring rows start in
// different banks.
template <int HD, typename TS>
struct KVLayout {
  static constexpr int kStride = HD + 16 / static_cast<int>(sizeof(TS));
  static constexpr int kTileElems = BK * kStride;
};

template <int HD>
struct QLayout {
  static constexpr int kStride = HD + kQStride;
};
constexpr int kPStride = BK + kQStride;

// 4 consecutive elements of a shared-memory row as fp32 (16 B for fp32, 8 B
// for bf16; both aligned since d % 4 == 0 and rows are 16-byte aligned).
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

// Load `rows` (BQ or BK) rows of HD elements of T into fp32 shared memory
// (row stride `dst_stride`).  Row r of the source starts at src + r * ld;
// rows at or past `valid` are zero-filled (never read from global memory).
template <int HD, typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int dst_stride, int rows,
                                              const T* __restrict__ src, size_t ld,
                                              int valid) {
  constexpr int V = Vec16<T>::N;
  constexpr int kChunks = HD / V;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * V;
    float v[V];
    if (r < valid) {
      load16(src + r * ld + d, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; j += 4) store16(dst + r * dst_stride + d + j, v + j);
  }
}

// One K/V tile: update the running state of this thread's rows.
//   q_s: BQ x HD fp32 (stride QLayout::kStride); k_s, v_s: BK x HD of TS
//   (stride KVLayout::kStride), rows past T zero-filled; p_s: BQ x BK fp32
//   scratch.  mask_b points at mask[b or 0], shaped (S, T) uint8.
// Contains one __syncthreads (P written -> P read); the caller must sync
// before p_s or the K/V tile is overwritten.
template <int HD, typename TS>
__device__ __forceinline__ void tile_update(
    RowState<HD>& st, const float* q_s, const TS* k_s, const TS* v_s, float* p_s,
    const uint8_t* __restrict__ mask_b, int q0, int k0, int S, int T,
    float sm_scale) {
  constexpr int QS = QLayout<HD>::kStride;
  constexpr int KS = KVLayout<HD, TS>::kStride;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = lds4(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = lds4(k_s + (tx + 16 * j) * KS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        s[i][j] = a;
      }
  }

  bool ok[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      ok[i][j] = r < S && c < T && mask_b[static_cast<size_t>(r) * T + c] != 0;
      s[i][j] = ok[i][j] ? s[i][j] * sm_scale : kNegInf;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
    mx = half_warp_max(mx);
    const float m_new = fmaxf(st.m[i], mx);
    const float alpha = expf(st.m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = ok[i][j] ? expf(s[i][j] - m_new) : 0.f;
      p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
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
  for (int c = 0; c < BK; ++c) {
    float vv[RowState<HD>::kDims];
#pragma unroll
    for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
      vv[jd] = to_f32(v_s[c * KS + tx + 16 * jd]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = p_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
        st.acc[i][jd] = fmaf(p, vv[jd], st.acc[i][jd]);
    }
  }
}

// out[b, r, h, :] = acc / max(l, 1e-30) for this thread's rows below S.
template <int HD, typename T>
__device__ __forceinline__ void finalize(const RowState<HD>& st, T* __restrict__ out,
                                         int b, int h, int q0, int S, int H) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * S + r) * H + h) * HD;
#pragma unroll
    for (int jd = 0; jd < RowState<HD>::kDims; ++jd)
      orow[tx + 16 * jd] = from_f32<T>(st.acc[i][jd] / denom);
  }
}

// Dynamic shared memory of one block: Q tile + P tile + `kv_tiles` K/V tiles
// of TS (2 per pipeline stage).
template <int HD, typename TS>
constexpr size_t smem_bytes(int kv_tiles) {
  return sizeof(float) * (BQ * QLayout<HD>::kStride + BQ * kPStride) +
         sizeof(TS) * static_cast<size_t>(kv_tiles) * KVLayout<HD, TS>::kTileElems;
}

// K/V tile loaders of the baseline kernel: BK rows of HD elements into fp32
// shared memory (row stride KVLayout<HD, float>::kStride), rows at or past
// `valid` zero-filled.  fp32 or bf16 K/V (K2) are converted and `scale` is
// not used; int8 K/V (K6) arrive in 16-byte loads (16 values), are turned
// into fp32 exactly (i8x4_to_f32) and multiplied by the KV head's scale in
// registers -- the same single product as the plain version's
// k8.float() * k_scale.
template <int HD, typename T>
__device__ __forceinline__ void load_kv_tile(float* dst, const T* __restrict__ src,
                                             size_t ld, int valid, float /*scale*/) {
  load_tile_f32<HD, T>(dst, KVLayout<HD, float>::kStride, BK, src, ld, valid);
}
template <int HD>
__device__ __forceinline__ void load_kv_tile(float* dst,
                                             const int8_t* __restrict__ src,
                                             size_t ld, int valid, float scale) {
  constexpr int kStride = KVLayout<HD, float>::kStride;
  constexpr int kChunks = HD / 16;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c % kChunks) * 16;
    float v[16];
    if (r < valid) {
      load16(src + r * ld + d, v);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4) store16(dst + r * kStride + d + j, v + j);
  }
}

// The baseline kernel (K2 with TKV = T, K6 with TKV = int8_t): one block of
// 256 threads per (q tile of 64 rows, head, batch).  Blocks run in no order
// on 132 SMs, so the TPU's sequential K/V grid dimension becomes a loop
// inside the block.  The Q tile is loaded once as fp32; each 64-row K/V
// tile is loaded into fp32 shared memory by load_kv_tile, synchronised, and
// folded into the running state by tile_update.  Query head h reads KV head
// h / (H/K) and, for int8 K/V, that head's two scales (k_scale, v_scale;
// null for float K/V).  Shared memory: Q + P + one K and one V tile, 68 KB
// at hd = 64, requested as dynamic shared memory above the 48 KB static
// limit.
template <int HD, typename T, typename TKV>
__global__ void __launch_bounds__(kThreads)
baseline_kernel(const T* __restrict__ q, const TKV* __restrict__ k,
                const TKV* __restrict__ v, const float* __restrict__ k_scale,
                const float* __restrict__ v_scale, const uint8_t* __restrict__ mask,
                T* __restrict__ out, int S, int T_len, int H, int K, int mask_b,
                float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + BQ * QLayout<HD>::kStride;
  float* k_s = p_s + BQ * kPStride;
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
                       q + ((static_cast<size_t>(b) * S + q0) * H + h) * HD,
                       static_cast<size_t>(H) * HD, S - q0);
  RowState<HD> st;
  st.init();

  const size_t kv_ld = static_cast<size_t>(K) * HD;
  const int nk = (T_len + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    const size_t base = ((static_cast<size_t>(b) * T_len + k0) * K + kvh) * HD;
    __syncthreads();  // every thread is done with the previous K/V and P
    load_kv_tile<HD>(k_s, k + base, kv_ld, T_len - k0, ks);
    load_kv_tile<HD>(v_s, v + base, kv_ld, T_len - k0, vs);
    __syncthreads();
    tile_update<HD, float>(st, q_s, k_s, v_s, p_s, mask_b_ptr, q0, k0, S, T_len,
                           sm_scale);
  }
  finalize<HD, T>(st, out, b, h, q0, S, H);
}

template <int HD, typename T, typename TKV>
cudaError_t launch_baseline(const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale,
                            const void* mask, void* out, int B, int S, int T_len,
                            int H, int K, int mask_b, float sm_scale,
                            cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, float>(2);
  auto kern = baseline_kernel<HD, T, TKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), k_scale, v_scale,
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K,
      mask_b, sm_scale);
  return cudaGetLastError();
}

// Launch the baseline kernel with q/out of T and K/V of TKV for a head
// width in {16, 32, 64, 128}; cudaErrorInvalidValue for another.
template <typename T, typename TKV>
cudaError_t dispatch_baseline(int hd, const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const void* mask, void* out, int B, int S, int T_len,
                              int H, int K, int mask_b, float sm_scale,
                              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_baseline<16, T, TKV>(q, k, v, k_scale, v_scale, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 32: return launch_baseline<32, T, TKV>(q, k, v, k_scale, v_scale, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 64: return launch_baseline<64, T, TKV>(q, k, v, k_scale, v_scale, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 128: return launch_baseline<128, T, TKV>(q, k, v, k_scale, v_scale, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash
