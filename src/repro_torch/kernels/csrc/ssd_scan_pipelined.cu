// K8: the SSD chunked scan with the x, B and C chunks streamed through a
// `depth`-stage cp.async ring in shared memory (depth 2-4).
//
// Replaces: src/repro/kernels/pipeline.py::ssd_scan_pipelined
// (_ssd_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps x/B/C in HBM and streams their chunks into a
// rotating VMEM buffer with explicit async copies and DMA semaphores.
//
// Bound on an H100: operations, as K7 (ssd_scan.cu): the same four fp32
// products, at this kernel's 32-position chunk.
//
// Design: the math is K7's (ssd_tile.cuh); what differs is how a chunk
// arrives.  Each thread issues 16-byte cp.async copies of the raw x
// (32 x P), B and C (32 x N, rows padded to N+4 floats) chunks into ring
// slot t % depth; rows past S are zero-filled by the copy itself (dt = 0
// semantics).  The schedule is BurstPipeline.stream_step's and K3's: fill
// depth-1 chunks, then at chunk t wait for its copies
// (cp.async.wait_group depth-2), sync the block, which also frees the slot
// that chunk t-1 used, start the copy of chunk t+depth-1 into it, and
// compute on chunk t while the later copies fly; one commit group per
// chunk (empty past the end) keeps the wait count uniform.  The chunk is 32
// positions so that a depth-4 ring fits: at N=128, P=64 a stage takes
// 42 KB and the fixed part (state, transposed B, scores) 56 KB, 219 KB in
// all of the 227 KB a block may have.  dt is read directly.
#include "ssd_tile.cuh"

namespace {

using namespace ssd;

constexpr int kChunk = 32;

__host__ __device__ constexpr int stage_floats(int Q, int P, int N) {
  return chunk_floats(Q, P, N) + Q * (N + 4);
}

// Shared memory of one block (bytes); kernels/pipeline.py mirrors it.
long long smem_bytes(int P, int N, int depth) {
  return 4LL * (fixed_floats(kChunk, P, N) + depth * stage_floats(kChunk, P, N));
}

// Start the copy of `rows` rows of `cols` floats (row stride `ld` in global,
// `lds` in shared); rows >= valid are zero-filled.
__device__ __forceinline__ void issue_rows(float* dst, int lds, const float* src, size_t ld,
                                           int rows, int cols, int valid) {
  const int per_row = cols / 4;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int row = idx / per_row;
    const int col = (idx % per_row) * 4;
    const bool ok = row < valid;
    cp_async16(dst + row * lds + col, ok ? src + row * ld + col : src, ok ? 16 : 0);
  }
}

template <int Q, int DEPTH>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_pipelined_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ B,
                          const float* __restrict__ C, float* __restrict__ y, int H,
                          int S, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, Q, P, N);
  float* ring = smem + fixed_floats(Q, P, N);
  const int stage = stage_floats(Q, P, N);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + Q - 1) / Q;

  // slot: x (Q x P), then B and C (Q x N+4 each)
  auto issue = [&](int t) {
    float* slot = ring + (t % DEPTH) * stage;
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    const size_t bc = (static_cast<size_t>(b) * S + c0) * N;
    issue_rows(slot, P, x + (bh * S + c0) * P, P, Q, P, valid);
    issue_rows(slot + Q * P, N + 4, B + bc, N, Q, N, valid);
    issue_rows(slot + Q * P + Q * (N + 4), N + 4, C + bc, N, Q, N, valid);
  };

#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nc) issue(t);
    cp_async_commit();
  }
  zero_state(s, P, N);

  for (int t = 0; t < nc; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of chunk t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nc) issue(t + DEPTH - 1);
    cp_async_commit();
    float* x_s = ring + (t % DEPTH) * stage;
    const float* b_s = x_s + Q * P;
    const float* c_s = b_s + Q * (N + 4);
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    transpose_b<Q>(s.bt, b_s, N + 4, Q, N);  // rows past S are already 0
    scan_chunk<Q>(s, dt + bh * S + c0, a, valid);
    __syncthreads();
    scores<Q>(s, c_s, N);
    __syncthreads();
    chunk_out<Q>(s, x_s, c_s, P, N, t > 0, y + (bh * S + c0) * P, valid);
    if (t + 1 < nc) {  // the last chunk's state is not needed
      __syncthreads();
      scale_x<Q>(s, x_s, P);
      __syncthreads();
      state_update<Q>(s, x_s, P, N);
    }
  }
  cp_async_wait<0>();
}

template <int DEPTH>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, int BT, int H, int S, int P, int N,
                   cudaStream_t stream) {
  const long long smem = smem_bytes(P, N, DEPTH);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  auto kern = ssd_scan_pipelined_kernel<kChunk, DEPTH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), H, S, P, N);
  return cudaGetLastError();
}

}  // namespace

// As ssd_scan_launch (ssd_scan.cu), plus `depth` in {2, 3, 4}: the number of
// ring stages.  A depth whose ring does not fit in 227 KB of shared memory
// returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int ssd_scan_pipelined_launch(const void* x, const void* dt, const void* A,
                                           const void* B, const void* C, void* y, int BT,
                                           int H, int S, int P, int N, int depth,
                                           int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 2: return launch<2>(x, dt, A, B, C, y, BT, H, S, P, N, st);
    case 3: return launch<3>(x, dt, A, B, C, y, BT, H, S, P, N, st);
    case 4: return launch<4>(x, dt, A, B, C, y, BT, H, S, P, N, st);
    default: return cudaErrorInvalidValue;
  }
}
