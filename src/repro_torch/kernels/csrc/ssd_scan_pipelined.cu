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
// all of the 227 KB a block may have.  Where not even a depth-2 ring of
// 32-position chunks fits (fp32 at N = 256, P = 64) the chunk is 16; the
// wrapper picks chunk and depth.  dt is read directly.
//
// The ring holds the raw inputs.  fp32 chunks are computed on in place; a
// bf16 or fp16 chunk is first widened into an fp32 x and C beside the
// fixed part (and B into the transposed bt, as for fp32).  Rows that are
// not whole 16-byte vectors (P or N not a multiple of 16 / itemsize)
// cannot take cp.async copies; they are copied element by element by the
// same threads at the same point of the schedule (the slot is free then),
// so the ring protocol is unchanged and only the overlap is lost.
#include <type_traits>

#include "ssd_tile.cuh"

namespace {

using namespace ssd;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row strides of a ring stage in elements of T: x rows of P, B and C rows
// of N with one 16-byte vector of padding (as K7's C rows of N+4 floats).
template <typename T>
__host__ __device__ int ring_xs(const Dims& dm) {
  return round_up(dm.P, Vec16<T>::N);
}
template <typename T>
__host__ __device__ int ring_bs(const Dims& dm) {
  return round_up(dm.N, Vec16<T>::N) + Vec16<T>::N;
}

// Shared memory of one block (bytes); kernels/pipeline.py mirrors it.
template <typename T>
long long smem_bytes(int Q, const Dims& dm, int depth) {
  const long long work =
      std::is_same<T, float>::value ? 0 : chunk_floats(Q, dm.PP, dm.NP);
  const long long stage = static_cast<long long>(Q) * (ring_xs<T>(dm) + 2 * ring_bs<T>(dm));
  return 4LL * (fixed_floats(Q, dm.PP, dm.NP) + work) + depth * stage * sizeof(T);
}

// Start the copy of `rows` rows of `cols` elements (row stride `ld` in
// global, `lds` in shared); rows >= valid are zero-filled.  `vec`: 16-byte
// cp.async chunks (cols a multiple of the vector); else element copies that
// also zero-fill columns cols .. cols_pad-1.
template <typename T>
__device__ __forceinline__ void issue_rows(T* dst, int lds, const T* src, size_t ld,
                                           int rows, int cols, int cols_pad, int valid,
                                           bool vec) {
  constexpr int V = Vec16<T>::N;
  if (vec) {
    const int per_row = cols / V;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
      const int row = idx / per_row;
      const int col = (idx % per_row) * V;
      const bool ok = row < valid;
      cp_async16(dst + row * lds + col, ok ? src + row * ld + col : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols_pad; idx += kThreads) {
      const int row = idx / cols_pad;
      const int col = idx % cols_pad;
      dst[row * lds + col] =
          row < valid && col < cols ? src[row * ld + col] : from_f32<T>(0.f);
    }
  }
}

// ALIGNED: P and N are whole 16-byte vectors of T, so every row takes
// cp.async copies and 4-wide loads and stores (fixed at compile time).
template <typename T, int Q, int DEPTH, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_pipelined_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C, T* __restrict__ y, int H, int S,
                          Dims dm) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(16) float smem[];
  const Smem s = carve(smem, Q, dm);
  float* work = smem + fixed_floats(Q, dm.PP, dm.NP);  // bf16/fp16: fp32 x and C
  T* ring = reinterpret_cast<T*>(work + (kF32 ? 0 : chunk_floats(Q, dm.PP, dm.NP)));
  const int xs = ring_xs<T>(dm), bs = ring_bs<T>(dm);
  const int stage = Q * (xs + 2 * bs);
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float a = A[h];
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int nc = (S + Q - 1) / Q;
  const bool vx = ALIGNED || dm.P % V == 0, vbc = ALIGNED || dm.N % V == 0;
  const bool v4x = ALIGNED || dm.P % 4 == 0, v4bc = ALIGNED || dm.N % 4 == 0;

  // slot: x (Q x xs), then B and C (Q x bs each)
  auto issue = [&](int t) {
    T* slot = ring + (t % DEPTH) * stage;
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    const size_t bc = (static_cast<size_t>(b) * S + c0) * dm.N;
    issue_rows(slot, xs, x + (bh * S + c0) * dm.P, dm.P, Q, dm.P, xs, valid, vx);
    issue_rows(slot + Q * xs, bs, B + bc, dm.N, Q, dm.N, bs - V, valid, vbc);
    issue_rows(slot + Q * (xs + bs), bs, C + bc, dm.N, Q, dm.N, bs - V, valid, vbc);
  };

#pragma unroll
  for (int t = 0; t < DEPTH - 1; ++t) {
    if (t < nc) issue(t);
    cp_async_commit();
  }
  zero_state(s, dm);

  for (int t = 0; t < nc; ++t) {
    cp_async_wait<DEPTH - 2>();  // this thread's copies of chunk t have landed
    __syncthreads();             // ... and everyone's; slot (t-1) % DEPTH is free
    if (t + DEPTH - 1 < nc) issue(t + DEPTH - 1);
    cp_async_commit();
    T* slot = ring + (t % DEPTH) * stage;
    const T* b_s = slot + Q * xs;
    // x in fp32 with row stride PP (fp32's ring stride xs is PP itself)
    float* x_s;
    const float* c_s;
    if constexpr (kF32) {  // rows past S, and padded columns, are already 0
      x_s = slot;
      c_s = b_s + Q * bs;
    } else {
      x_s = work;
      float* c_w = work + Q * dm.PP;
      load_rows<Q>(x_s, dm.PP, slot, xs, dm.P, Q, v4x);
      load_rows<Q>(c_w, dm.NP + 4, b_s + Q * bs, bs, dm.N, Q, v4bc);
      c_s = c_w;
    }
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    transpose_b<Q>(s.bt, b_s, bs, Q, dm, v4bc);
    scan_chunk<Q>(s, dt + bh * S + c0, a, valid);
    __syncthreads();
    chunk_step<Q>(s, x_s, c_s, dm, t == 0, t + 1 == nc, y + (bh * S + c0) * dm.P, valid,
                  v4x);
  }
  cp_async_wait<0>();
}

template <typename T, int Q, int DEPTH>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, int BT, int H, int S, const Dims& dm,
                   cudaStream_t stream) {
  const long long smem = smem_bytes<T>(Q, dm, DEPTH);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  constexpr int V = Vec16<T>::N;
  auto kern = dm.P % V == 0 && dm.N % V == 0
                  ? ssd_scan_pipelined_kernel<T, Q, DEPTH, true>
                  : ssd_scan_pipelined_kernel<T, Q, DEPTH, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y), H, S, dm);
  return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t dispatch_depth(int depth, const void* x, const void* dt, const void* A,
                           const void* B, const void* C, void* y, int BT, int H, int S,
                           const Dims& dm, cudaStream_t st) {
  switch (depth) {
    case 2: return launch<T, Q, 2>(x, dt, A, B, C, y, BT, H, S, dm, st);
    case 3: return launch<T, Q, 3>(x, dt, A, B, C, y, BT, H, S, dm, st);
    case 4: return launch<T, Q, 4>(x, dt, A, B, C, y, BT, H, S, dm, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_chunk(int chunk, int depth, const void* x, const void* dt,
                           const void* A, const void* B, const void* C, void* y, int BT,
                           int H, int S, const Dims& dm, cudaStream_t st) {
  switch (chunk) {
    case 32: return dispatch_depth<T, 32>(depth, x, dt, A, B, C, y, BT, H, S, dm, st);
    case 16: return dispatch_depth<T, 16>(depth, x, dt, A, B, C, y, BT, H, S, dm, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As ssd_scan_launch (ssd_scan.cu), with `chunk` 32 or 16, plus `depth` in
// {2, 3, 4}: the number of ring stages.  A ring that does not fit in 227 KB
// of shared memory returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int ssd_scan_pipelined_launch(const void* x, const void* dt, const void* A,
                                           const void* B, const void* C, void* y, int BT,
                                           int H, int S, int P, int N, int chunk,
                                           int depth, int dtype, int device,
                                           void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  const Dims dm = dims(P, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch_chunk<T>(chunk, depth, x, dt, A, B, C, y, BT, H, S, dm,
                                         st));
}
