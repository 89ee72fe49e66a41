// K3: GQA flash attention with K/V tiles streamed through a `depth`-stage
// cp.async ring in shared memory (depth 2-4).
//
// Replaces: src/repro/kernels/pipeline.py::flash_attention_pipelined
// (_flash_pipelined_kernel driven by BurstPipeline.stream_step), the
// Pallas TPU kernel that keeps K/V in HBM and streams them into a rotating
// VMEM buffer with explicit async copies and DMA semaphores.
//
// Bound on an H100: the same work as K2 (flash_attention.cu), so the same
// bound: compute (fp32 CUDA cores, 67 TFLOP/s) at the long prefill buckets
// where this variant runs, memory below S ~ 80.
//
// Design: the math is K2's (flash::tile_update).  What differs is how K/V
// arrive: each thread issues 16-byte cp.async copies (global -> shared,
// bypassing registers and L1) of the raw fp32/bf16/fp16 tile into ring slot
// t % depth, and rows past T are zero-filled by the copy itself.  The
// schedule is BurstPipeline.stream_step's: fill depth-1 tiles, then at step
// t wait for tile t (cp.async.wait_group depth-2), sync the block, start the
// copy of tile t+depth-1 into the slot that step t-1 just finished with,
// and compute on tile t while the later copies fly.  Exactly one commit
// group per tile (empty past the end) keeps the wait count uniform.
// Shared memory at hd = 64, fp32: Q + P = 34 KB plus 34 KB per stage, so
// depth 4 takes 170 KB of the 227 KB a block may have; the wrapper lowers
// the depth where a wider head or the stage count would not fit.  At the
// padded width 256 one 64-key fp32 stage alone is 133 KB, so there the
// tiles are 32 keys (BK_WIDE): Q + P 74 KB plus 65 KB a stage (fp32, depth
// 2) or 33 KB (bf16/fp16, depth 4).
//
// Head dims that are not whole 16-byte vectors (hd * itemsize % 16 != 0)
// cannot take 16-byte cp.async copies; their tiles are copied into the ring
// slot element by element by the same threads at the same point of the
// schedule (the slot is free then), so the ring protocol is unchanged and
// only the overlap is lost.
#include "flash_tile.cuh"

namespace {

using namespace flash;

// Start the copy of one BKT x HD tile (rows past `valid` and columns past
// hd zero-filled): 16-byte cp.async chunks where rows are whole vectors
// (`vec`), else plain element copies.
template <int HD, int BKT, typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* __restrict__ src,
                                           size_t ld, int valid, int hd, bool vec) {
  constexpr int V = Vec16<T>::N;
  constexpr int kChunks = HD / V;
  constexpr int KS = KVLayout<HD, T, BKT>::kStride;
  for (int c = threadIdx.x; c < BKT * kChunks; c += kThreads) {
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

template <int HD, bool EXACT, int BKT, typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
flash_pipelined_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const uint8_t* __restrict__ mask,
                       T* __restrict__ out, int S, int T_len, int H, int K,
                       int hd_arg, int mask_b, float sm_scale) {
  const int hd = EXACT ? HD : hd_arg;  // see flash_tile.cuh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + BQ * QLayout<HD>::kStride;
  T* ring = reinterpret_cast<T*>(p_s + BQ * PLayout<BKT>::kStride);
  constexpr int kTile = KVLayout<HD, T, BKT>::kTileElems;
  // slot s: K tile at ring + (2s) * kTile, V tile at ring + (2s+1) * kTile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const uint8_t* mask_b_ptr =
      mask + (mask_b > 1 ? static_cast<size_t>(b) * S * T_len : 0);
  const size_t kv_ld = static_cast<size_t>(K) * hd;
  const int nk = (T_len + BKT - 1) / BKT;
  const bool vec = hd % Vec16<T>::N == 0;

  auto issue = [&](int t) {
    const int slot = t % DEPTH;
    const int k0 = t * BKT;
    const size_t base = ((static_cast<size_t>(b) * T_len + k0) * K + kvh) * hd;
    issue_tile<HD, BKT, T>(ring + (2 * slot) * kTile, k + base, kv_ld, T_len - k0, hd,
                           vec);
    issue_tile<HD, BKT, T>(ring + (2 * slot + 1) * kTile, v + base, kv_ld, T_len - k0,
                           hd, vec);
  };

  // Fill: tiles 0 .. DEPTH-2, one commit group each.
#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }
  load_tile_f32<HD, T>(q_s, QLayout<HD>::kStride, BQ,
                       q + ((static_cast<size_t>(b) * S + q0) * H + h) * hd,
                       static_cast<size_t>(H) * hd, S - q0, hd);
  RowState<HD> st;
  st.init();

  for (int t = 0; t < nk; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of tile t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nk) issue(t + DEPTH - 1);
    cp_async_commit();
    const int slot = t % DEPTH;
    tile_update<HD, BKT, T>(st, q_s, ring + (2 * slot) * kTile,
                            ring + (2 * slot + 1) * kTile, p_s, mask_b_ptr, q0,
                            t * BKT, S, T_len, hd, sm_scale);
  }
  cp_async_wait<0>();
  finalize<HD, T>(st, out, b, h, q0, S, H, hd);
}

template <int HD, typename T, int DEPTH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int B, int S, int T_len, int H, int K, int hd,
                   int mask_b, float sm_scale, cudaStream_t stream) {
  constexpr int BKT = HD > 128 ? BK_WIDE : BK;
  const size_t smem = smem_bytes<HD, T, BKT>(2 * DEPTH);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  auto kern = hd == HD ? flash_pipelined_kernel<HD, true, BKT, T, DEPTH>
                       : flash_pipelined_kernel<HD, false, BKT, T, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K, hd,
      mask_b, sm_scale);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t dispatch_depth(int depth, const void* q, const void* k, const void* v,
                           const void* mask, void* out, int B, int S, int T_len,
                           int H, int K, int hd, int mask_b, float sm_scale,
                           cudaStream_t stream) {
  switch (depth) {
    case 2: return launch<HD, T, 2>(q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, stream);
    case 3: return launch<HD, T, 3>(q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, stream);
    case 4: return launch<HD, T, 4>(q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int depth, const void* q, const void* k, const void* v,
                        const void* mask, void* out, int B, int S, int T_len, int H,
                        int K, int mask_b, float sm_scale, cudaStream_t stream) {
  if (hd < 1) return cudaErrorInvalidValue;
  switch (padded_head_dim(hd)) {
#define REPRO_HD(W) \
    case W: return dispatch_depth<W, T>(depth, q, k, v, mask, out, B, S, T_len, H, K, hd, mask_b, sm_scale, stream);
    REPRO_HD(16) REPRO_HD(32) REPRO_HD(64) REPRO_HD(128) REPRO_HD(256)
#undef REPRO_HD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As flash_attention_launch (flash_attention.cu), plus `depth` in {2, 3, 4}:
// the number of K/V ring stages.  A depth whose ring does not fit in 227 KB
// of shared memory returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int flash_attention_pipelined_launch(
    const void* q, const void* k, const void* v, const void* mask, void* out, int B,
    int S, int T_len, int H, int K, int hd, int mask_b, float sm_scale, int depth,
    int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch_hd<T>(hd, depth, q, k, v, mask, out, B, S, T_len, H, K,
                                      mask_b, sm_scale, s));
}
