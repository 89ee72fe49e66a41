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
// P=64), not the TPU schedule's, or 32 where a 64-position block does not
// fit (N = 256 at P = 64: 236.5 KB against 227 KB); the wrapper picks it.
// Any S is taken: positions past S in the last chunk are read as dt = 0
// and never written.  Each chunk is loaded straight from global memory and
// widened to fp32 (B transposed on the way in, B and C being shared by the
// heads of a batch row and mostly L2 hits), then the block computes the
// masked scores, the output and the state update.  fp32 arithmetic
// throughout, no TF32; x, dt, B, C and y are fp32, bf16 or fp16, A fp32.
#include "ssd_tile.cuh"

namespace {

using namespace ssd;

// Shared memory of one block (bytes); kernels/ssd_scan.py mirrors it.
long long smem_bytes(int Q, const Dims& dm) {
  return 4LL * (fixed_floats(Q, dm.PP, dm.NP) + chunk_floats(Q, dm.PP, dm.NP));
}

// ALIGNED: P and N are whole 16-byte vectors of T, so every row loads and
// stores 4 at a time (fixed at compile time).
template <typename T, int Q, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ y, int H, int S, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, Q, dm);
  float* x_s = smem + fixed_floats(Q, dm.PP, dm.NP);
  float* c_s = x_s + Q * dm.PP;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + Q - 1) / Q;
  const bool vx = ALIGNED || dm.P % 4 == 0, vbc = ALIGNED || dm.N % 4 == 0;
  zero_state(s, dm);

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * Q;
    const int valid = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with x_s, c_s, bt and h
    const size_t bc = (static_cast<size_t>(b) * S + c0) * dm.N;
    load_rows<Q>(x_s, dm.PP, x + (bh * S + c0) * dm.P, dm.P, dm.P, valid, vx);
    load_rows<Q>(c_s, dm.NP + 4, C + bc, dm.N, dm.N, valid, vbc);
    transpose_b<Q>(s.bt, B + bc, dm.N, valid, dm, vbc);
    scan_chunk<Q>(s, dt + bh * S + c0, a, valid);
    __syncthreads();
    chunk_step<Q>(s, x_s, c_s, dm, ci == 0, ci + 1 == nc, y + (bh * S + c0) * dm.P,
                  valid, vx);
  }
}

template <typename T, int Q>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, int BT, int H, int S, const Dims& dm,
                   cudaStream_t stream) {
  const long long smem = smem_bytes(Q, dm);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  constexpr int V = Vec16<T>::N;
  auto kern = dm.P % V == 0 && dm.N % V == 0 ? ssd_scan_kernel<T, Q, true>
                                             : ssd_scan_kernel<T, Q, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y), H, S, dm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_chunk(int chunk, const void* x, const void* dt, const void* A,
                           const void* B, const void* C, void* y, int BT, int H, int S,
                           const Dims& dm, cudaStream_t s) {
  switch (chunk) {
    case 64: return launch<T, 64>(x, dt, A, B, C, y, BT, H, S, dm, s);
    case 32: return launch<T, 32>(x, dt, A, B, C, y, BT, H, S, dm, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (BT, H, S, P); dt: (BT, H, S); B, C: (BT, S, N), all of `dtype`
// (fp32, bf16, fp16); A: (H,) fp32; all contiguous, 16-byte aligned.
// `chunk` (64 or 32) positions a step.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape it does not take,
// cudaErrorInvalidConfiguration if the block does not fit).
REPRO_EXPORT int ssd_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, void* y, int BT, int H,
                                 int S, int P, int N, int chunk, int dtype, int device,
                                 void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  const Dims dm = dims(P, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch_chunk<T>(chunk, x, dt, A, B, C, y, BT, H, S, dm, st));
}
