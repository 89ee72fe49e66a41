// K2: GQA flash attention with an explicit boolean mask (baseline).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel with _online_softmax_update, _init_flash_scratch and
// _finalize_flash_output), the Pallas TPU kernel whose sequential last
// grid dimension walks the K/V tiles while the running max, denominator and
// accumulator sit in VMEM scratch.
//
// Bound on an H100: at the prefill buckets of llama110m (S = T <= 512,
// hd = 64, fp32) the work is 4*S*T*hd flops per head against
// (2*S + 2*T)*hd*4 bytes, i.e. ~S/4 flop/byte: compute-bound on the fp32
// CUDA-core rate (67 TFLOP/s) once S passes ~80, memory-bound below.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch).
// Blocks run in no order on 132 SMs, so the TPU's sequential K/V grid
// dimension becomes a loop inside the block.  The Q tile is loaded once as
// fp32; each 64-row K/V tile is loaded (16-byte vector loads, converted to
// fp32) into shared memory, synchronised, and folded into the running
// state by flash::tile_update (fp32 FFMA, no TF32: parity with the fp32
// reference is the point of this first version; tensor cores come later).
// Shared memory: Q + P + one K and one V tile, 68 KB at hd = 64, so it is
// requested as dynamic shared memory above the 48 KB static limit.
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const uint8_t* __restrict__ mask,
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
    load_tile_f32<HD, T>(k_s, KVLayout<HD, float>::kStride, BK, k + base, kv_ld,
                         T_len - k0);
    load_tile_f32<HD, T>(v_s, KVLayout<HD, float>::kStride, BK, v + base, kv_ld,
                         T_len - k0);
    __syncthreads();
    tile_update<HD, float>(st, q_s, k_s, v_s, p_s, mask_b_ptr, q0, k0, S, T_len,
                           sm_scale);
  }
  finalize<HD, T>(st, out, b, h, q0, S, H);
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* out, int B, int S, int T_len, int H, int K, int mask_b,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, float>(2);
  auto kern = flash_kernel<HD, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), S, T_len, H, K,
      mask_b, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* mask, void* out, int B, int S, int T_len, int H,
                        int K, int mask_b, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 32: return launch<32, T>(q, k, v, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 64: return launch<64, T>(q, k, v, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    case 128: return launch<128, T>(q, k, v, mask, out, B, S, T_len, H, K, mask_b, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,S,H,hd), k/v: (B,T,K,hd), out: (B,S,H,hd), all contiguous of
// `dtype`; mask: (mask_b,S,T) contiguous bool with mask_b in {1, B}.
// hd in {16, 32, 64, 128}; H % K == 0.  Returns cudaGetLastError().
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int B, int S,
                                        int T_len, int H, int K, int hd, int mask_b,
                                        float sm_scale, int dtype, int device,
                                        void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_hd<float>(hd, q, k, v, mask, out, B, S, T_len, H, K, mask_b, sm_scale, s);
  if (dtype == kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, mask, out, B, S, T_len, H, K, mask_b,
                                      sm_scale, s);
  return cudaErrorInvalidValue;
}
