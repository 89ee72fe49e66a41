// K7: the Mamba2 SSD chunked scan.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel), the
// Pallas TPU kernel whose sequential chunk grid dimension carries the
// (N, P) state in VMEM scratch while x/dt/B/C chunks arrive by BlockSpec.
//
// Bound on an H100: operations.  At the serving shape (BT=4, H=80, S=512,
// P=64, N=128) the four fp32 products of a 64-position chunk come to
// ~9.4 GFLOP against ~86 MB of x, y, dt, B and C: ~140 us on the CUDA
// cores' 67 TFLOP/s against ~26 us of HBM.
//
// Design: one block of 256 threads per (batch, head) walks the chunks in
// order, which takes the place of the TPU's sequential grid dimension; the
// state stays in shared memory from chunk to chunk (ssd_tile.cuh).  The
// chunk is this card's, 64 positions (135 KB of shared memory at N=128,
// P=64), not the TPU schedule's, and any S is taken: positions past S in
// the last chunk are read as dt = 0 and never written.  Each chunk is
// loaded straight from global memory (B transposed on the way in, B and C
// being shared by the heads of a batch row and mostly L2 hits), then the
// block computes the masked scores, the output and the state update.
// fp32 throughout, no TF32.
#include "ssd_tile.cuh"

namespace {

using namespace ssd;

constexpr int kChunk = 64;

// Shared memory of one block (bytes); kernels/ssd_scan.py mirrors it.
long long smem_bytes(int P, int N) {
  return 4LL * (fixed_floats(kChunk, P, N) + chunk_floats(kChunk, P, N));
}

template <int Q>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ C, float* __restrict__ y, int H, int S,
                int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, Q, P, N);
  float* x_s = smem + fixed_floats(Q, P, N);
  float* c_s = x_s + Q * P;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + Q - 1) / Q;
  zero_state(s, P, N);

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * Q;
    const int valid = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with x_s, c_s, bt and h
    const float* xg = x + (bh * S + c0) * P;
    const float* bg = B + (static_cast<size_t>(b) * S + c0) * N;
    const float* cg = C + (static_cast<size_t>(b) * S + c0) * N;
    for (int idx = threadIdx.x; idx < Q * (P / 4); idx += kThreads) {
      const int row = idx / (P / 4);
      const int col = (idx % (P / 4)) * 4;
      st4(x_s + row * P + col,
          row < valid ? ld4(xg + static_cast<size_t>(row) * P + col) : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int idx = threadIdx.x; idx < Q * (N / 4); idx += kThreads) {
      const int row = idx / (N / 4);
      const int col = (idx % (N / 4)) * 4;
      st4(c_s + row * (N + 4) + col,
          row < valid ? ld4(cg + static_cast<size_t>(row) * N + col) : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    transpose_b<Q>(s.bt, bg, N, valid, N);
    scan_chunk<Q>(s, dt + bh * S + c0, a, valid);
    __syncthreads();
    scores<Q>(s, c_s, N);
    __syncthreads();
    chunk_out<Q>(s, x_s, c_s, P, N, ci > 0, y + (bh * S + c0) * P, valid);
    if (ci + 1 < nc) {  // the last chunk's state is not needed
      __syncthreads();
      scale_x<Q>(s, x_s, P);
      __syncthreads();
      state_update<Q>(s, x_s, P, N);
    }
  }
}

}  // namespace

// x, y: (BT, H, S, P); dt: (BT, H, S); A: (H,); B, C: (BT, S, N); all fp32,
// contiguous, 16-byte aligned; P and N multiples of 4.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape it
// does not take, cudaErrorInvalidConfiguration if the block does not fit).
REPRO_EXPORT int ssd_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, void* y, int BT, int H,
                                 int S, int P, int N, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(P, N);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  auto kern = ssd_scan_kernel<kChunk>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), H, S, P, N);
  return cudaGetLastError();
}
