// K5: int8-weight GEMM with the x and wq tiles streamed through a
// `depth`-stage cp.async ring in shared memory (depth 2-4).
//
// Replaces: src/repro/kernels/pipeline.py::int8_matmul_pipelined
// (_int8_mm_pipelined_kernel driven by BurstPipeline.stream_step), the
// Pallas TPU kernel that keeps x and wq in HBM and streams their tiles into
// rotating VMEM buffers with explicit async copies and DMA semaphores.
//
// Bound on an H100: in the decode regime the router sends here (M <= 64
// rows; llama110m decodes 8) the work is 2*M*N*K operations against N*K
// weight bytes, ~2*M flop/byte, far below the card's balance point: the
// int8 weight stream at 3.35 TB/s sets the pace (N*K bytes, 7.3 us for the
// 768 x 32000 unembedding).
//
// Design: the math is K4's (i8mm::tile_fma, fp32 FMAs); the tile is shaped
// for few rows and many columns: 8 rows x 32 columns a block (each warp one
// row, each lane one column), so M = 8 wastes no row and the 32 weight rows
// of a stage are read by all 8 warps from shared memory.  What differs from
// K4 is how tiles arrive: each thread issues 16-byte cp.async copies of the
// raw x and int8 tiles into ring slot t % depth, rows past M and N and k
// past K zero-filled by the copy itself; the schedule is K3's
// (flash_attention_pipelined.cu): fill depth-1 tiles, then at step t wait
// for tile t (cp.async.wait_group depth-2), sync the block, start the copy
// of tile t+depth-1 into the slot step t-1 finished with, and compute on
// tile t while the later copies fly; one commit group per tile (empty past
// the end) keeps the wait count uniform.  cp.async needs 16-byte aligned
// rows: K % 16 == 0 and 16-byte aligned bases (the wrapper checks; other
// shapes go to K4).  A stage is 4.7 KB in fp32, so depth 4 takes 19 KB.
#include "int8_tile.cuh"

namespace {

using namespace i8mm;
using S5 = Shape<8, 32, 1, 1>;  // 8 x 32 output tile

// Start the copy of rows [r0, r0 + rows) x k-values [k0, k0 + BK) of a
// row-major (R, K) matrix of E (K * sizeof(E) a multiple of 16).
template <typename E>
__device__ __forceinline__ void issue_rows(E* dst, int stride, int rows,
                                           const E* __restrict__ src, int R, int K,
                                           int r0, int k0) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  constexpr int kChunks = BK / V;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int kk = (c % kChunks) * V;
    const int gr = r0 + r;
    const int gk = k0 + kk;
    const bool ok = gr < R && gk < K;  // a 16-byte chunk is all in or all out
    cp_async16(dst + r * stride + kk,
               ok ? src + static_cast<size_t>(gr) * K + gk : src, ok ? 16 : 0);
  }
}

template <typename T>
constexpr size_t stage_bytes() {
  return sizeof(T) * S5::x_elems<T>() + S5::kWBytes;
}

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
int8_mm_pipelined_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                         const float* __restrict__ scale, T* __restrict__ out,
                         int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kX = S5::x_elems<T>();
  T* x_ring = reinterpret_cast<T*>(smem_raw);
  int8_t* w_ring = reinterpret_cast<int8_t*>(smem_raw + DEPTH * sizeof(T) * kX);
  const int m0 = blockIdx.y * S5::BM;
  const int n0 = blockIdx.x * S5::BN;
  const int nk = (K + BK - 1) / BK;

  auto issue = [&](int t) {
    const int slot = t % DEPTH;
    issue_rows<T>(x_ring + slot * kX, XLayout<T>::kStride, S5::BM, x, M, K, m0,
                  t * BK);
    issue_rows<int8_t>(w_ring + slot * S5::kWBytes, kWStride, S5::BN, wq, N, K, n0,
                       t * BK);
  };

  // Fill: tiles 0 .. DEPTH-2, one commit group each.
#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nk) issue(t);
    cp_async_commit();
  }
  float acc[1][1] = {{0.f}};
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of tile t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nk) issue(t + DEPTH - 1);
    cp_async_commit();
    const int slot = t % DEPTH;
    tile_fma<8, 32, 1, 1, T>(acc, x_ring + slot * kX, w_ring + slot * S5::kWBytes);
  }
  cp_async_wait<0>();
  store_tile<8, 32, 1, 1, T>(acc, scale, out, m0, n0, M, N);
}

template <typename T, int DEPTH>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  const size_t smem = DEPTH * stage_bytes<T>();
  auto kern = int8_mm_pipelined_kernel<T, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((N + S5::BN - 1) / S5::BN, (M + S5::BM - 1) / S5::BM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_depth(int depth, const void* x, const void* wq,
                           const void* scale, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  switch (depth) {
    case 2: return launch<T, 2>(x, wq, scale, out, M, N, K, stream);
    case 3: return launch<T, 3>(x, wq, scale, out, M, N, K, stream);
    case 4: return launch<T, 4>(x, wq, scale, out, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As int8_matmul_launch (int8_matmul.cu), plus `depth` in {2, 3, 4}, the
// number of ring stages; K must be a multiple of 16 and x, wq 16-byte
// aligned (cudaErrorInvalidValue otherwise, without launching).
REPRO_EXPORT int int8_matmul_pipelined_launch(const void* x, const void* wq,
                                              const void* scale, void* out, int M,
                                              int N, int K, int depth, int dtype,
                                              int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      (M + S5::BM - 1) / S5::BM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_depth<float>(depth, x, wq, scale, out, M, N, K, s);
  if (dtype == kBFloat16)
    return dispatch_depth<__nv_bfloat16>(depth, x, wq, scale, out, M, N, K, s);
  if (dtype == kFloat16)
    return dispatch_depth<__half>(depth, x, wq, scale, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
