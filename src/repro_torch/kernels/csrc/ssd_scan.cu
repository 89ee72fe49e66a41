// K7: the Mamba2 SSD chunked scan.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel), the
// Pallas TPU kernel whose sequential chunk grid dimension carries the
// (N, P) state in VMEM scratch while x/dt/B/C chunks arrive by BlockSpec.
//
// Bound on an H100: operations.  At the serving shape (BT=4, H=80, S=512,
// P=64, N=128) the scan needs 4*BT*H*S*N*P = 5.4 GFLOP (one FMA a state
// element a position for the update and one for the output) against ~87 MB
// of x, y, dt, B and C: ~33 us at the TF32 tensor cores' 495 TFLOP/s taken
// three times (3xTF32, the least that keeps the scan's fp32 accuracy)
// against ~26 us of HBM.
//
// Design: the chunk step of ssd_tile.cuh, on the tensor cores in 3xTF32,
// with the state in registers.  One block of a head of a batch row (4
// warps at P = 64, N = 128) walks the 16-position chunks in order, which
// takes the place of the TPU's sequential grid dimension; the grid is (H,
// BT, head-dim splits).  This baseline loads each chunk straight from
// global memory into fp32 shared memory (B and C are shared by the heads
// of a batch row and mostly L2 hits), then syncs and computes; the next
// chunk's dt is fetched into registers a chunk ahead.  Any S is taken:
// positions past S in the last chunk are read as dt = 0 and never written.
// x, dt, B, C and y are fp32, bf16 or fp16, A fp32.
#include "ssd_tile.cuh"

namespace {

using namespace ssd;

// Shared memory of one block (bytes); kernels/ssd_scan.py mirrors it.
long long smem_bytes(const Geom& gm) { return 4LL * (stage_floats(gm) + fixed_floats(gm)); }

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, T* __restrict__ y, int H, int S, Geom gm) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const Stage st = stage_at(smem, gm);
  const Fixed fx = fixed_at(smem + stage_floats(gm), gm);
  const Role ro = role(gm);
  const int h = blockIdx.x, b = blockIdx.y;
  const int pw = kWarpP * gm.pbw;  // head-dim columns of the block
  const int p0 = blockIdx.z * pw;
  const int pcols = min(pw, gm.P - p0);
  const bool vx = gm.P % 4 == 0, vbc = gm.N % 4 == 0;
  const float a = A[h];
  float hs[kWarpNT][4];
#pragma unroll
  for (int nt = 0; nt < kWarpNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[nt][e] = 0.f;
  const int nc = cdiv(S, Q);
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
  float d = load_dt(dt, b, h, H, S, 0, min(Q, S));

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * Q;
    const int valid = min(Q, S - c0);
    __syncthreads();  // the previous chunk is done with the stage and the scores
    load_rows(st.x, gm.xs, pw, x + (row0 + c0) * gm.P + p0, gm.P, pcols, Q, valid, vx);
    const size_t bc = (static_cast<size_t>(b) * S + c0) * gm.N;
    load_rows(st.b, gm.bs, gm.bs - 8, B + bc, gm.N, gm.N, Q, valid, vbc);
    load_rows(st.c, gm.bs, gm.bs - 8, C + bc, gm.N, gm.N, Q, valid, vbc);
    const float dc = d;
    if (ci + 1 < nc) d = load_dt(dt, b, h, H, S, c0 + Q, min(Q, S - c0 - Q));
    __syncthreads();
    chunk_step<kExact, T>(hs, st, fx, gm, ro, dc, a, ci == 0, ci + 1 == nc,
                          y + (row0 + c0) * gm.P, valid, p0);
  }
}

// The block's shared memory, or 0 if the block has no warp or does not fit.
long long block_smem(const Geom& gm) {
  const long long smem = smem_bytes(gm);
  return gm.pbw >= 1 && smem <= 232448 ? smem : 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, int BT, int H, int S, const Geom& gm,
                   cudaStream_t stream) {
  const long long smem = block_smem(gm);
  if (!smem) return cudaErrorInvalidConfiguration;
  auto kern = ssd_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT, gm.psplit), 32 * gm.warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y), H, S, gm);
  return cudaGetLastError();
}

template <typename T>
int occupancy(const Geom& gm) {
  const long long smem = block_smem(gm);
  if (!smem) return -static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32 * gm.warps,
                                                      static_cast<size_t>(smem));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// x, y: (BT, H, S, P); dt: (BT, H, S); B, C: (BT, S, N), all of `dtype`
// (fp32, bf16, fp16); A: (H,) fp32; all contiguous, 16-byte aligned.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it does not take, cudaErrorInvalidConfiguration if the block does
// not fit).
REPRO_EXPORT int ssd_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* B, const void* C, void* y, int BT, int H,
                                 int S, int P, int N, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  const Geom gm = geom(P, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(x, dt, A, B, C, y, BT, H, S, gm, st));
}

// Blocks of K7 resident on one SM for head dim P, state N and `dtype`
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -error.
REPRO_EXPORT int ssd_scan_occupancy(int P, int N, int dtype, int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (P <= 0 || N <= 0 || dtype < kFloat32 || dtype > kFloat16)
    return -static_cast<int>(cudaErrorInvalidValue);
  const Geom gm = geom(P, N);
  REPRO_DISPATCH_FLOAT(dtype, T, occupancy<T>(gm));
}
