// K8: the SSD chunked scan with the x, B and C chunks streamed through a
// `depth`-stage ring in shared memory (depth 2-4), filled by TMA bulk
// copies.
//
// Replaces: src/repro/kernels/pipeline.py::ssd_scan_pipelined
// (_ssd_pipelined_kernel driven by BurstPipeline.stream_step), the Pallas
// TPU kernel that keeps x/B/C in HBM and streams their chunks into a
// rotating VMEM buffer with explicit async copies and DMA semaphores.
//
// Bound on an H100: operations, as K7 (ssd_scan.cu).
//
// Design: the math and the work split are K7's (ssd_tile.cuh: tensor
// cores in 3xTF32, the state in registers, one head of a batch row a
// block); what differs is how a chunk arrives.  The block starts the copy
// of chunk t into ring slot t % depth as one TMA bulk copy a row, a row a
// thread (cp.async.bulk, global -> shared, completing on the slot's
// mbarrier), laid out with the strides the chunk step reads; thread 0
// tells the mbarrier how many bytes to expect (its one arrival), and every
// thread waits on the slot's phase before it reads.  A row costs one
// instruction, where 16-byte cp.async copies cost a loop of them: in one
// process on the same inputs a cp.async ring ran the serving shape at
// 301.88 us against this ring's 243.27 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).  Only the chunk's rows
// inside the sequence are copied: rows past S keep what an earlier chunk
// left there (zeros from the start, or finite data), which adds nothing,
// since those positions carry dt = 0 (their scores column and their
// weight w are 0, their output rows are never stored).  The padding
// columns, which no copy writes, are zeroed once at the start.  The
// schedule is BurstPipeline.stream_step's: fill depth-1 chunks, then at
// chunk t wait for it, sync the block, which also frees the slot that
// chunk t-1 used, start the copy of chunk t+depth-1 into it (each thread
// after a fence.proxy.async, which orders the block's generic reads of the
// slot before the bulk copies that refill it), and compute
// on chunk t while the later copies fly.  That is two block barriers a
// chunk in fp32, whose ring slots are computed on in place; a bf16 or fp16
// slot is first widened into an fp32 stage beside the ring (one more
// barrier).  dt is read into registers a chunk ahead.  Rows that are not
// whole 16-byte vectors (x where P, B and C where N is not a multiple of
// 16 / itemsize) cannot take bulk copies; the same threads copy them
// element by element at the same point of the schedule (the slot is free
// then): the block barrier after the wait publishes those stores, so the
// ring protocol is unchanged and only their overlap is lost.  The depth is
// the wrapper's choice (kernels/pipeline.py ssd_depth).
#include "ssd_tile.cuh"

namespace {

using namespace ssd;

// Bytes before the ring: one 8-byte mbarrier a stage (depth <= 4), padded
// to keep the ring 16-byte aligned.
constexpr int kBarrierBytes = 64;

// Shared memory of one block (bytes); kernels/pipeline.py mirrors it: the
// mbarriers, `depth` stages of raw inputs, for bf16/fp16 one fp32 stage,
// and the fixed part.
template <typename T>
long long smem_bytes(const Geom& gm, int depth) {
  const long long stage = stage_floats(gm);
  const long long work = std::is_same<T, float>::value ? 0 : 4 * stage;
  return kBarrierBytes + depth * stage * static_cast<long long>(sizeof(T)) + work +
         4LL * fixed_floats(gm);
}

// -- TMA and mbarrier (sm_90) -------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
// Make the mbarrier inits and the block's generic stores to shared memory
// (the zeroed ring) visible to the TMA unit; the caller then syncs.
__device__ __forceinline__ void fence_ring_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Order the block's generic reads of a slot (before the block barrier that
// freed it) before this thread's bulk copies that refill it: a ring
// refilled without it gave wrong tiles where blocks shared an SM
// (tools/int8_ring_race.py).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Arrive on `bar` (its one arrival) and expect `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// -- end TMA and mbarrier -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
ssd_scan_pipelined_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ B,
                          const T* __restrict__ C, T* __restrict__ y, int H, int S,
                          Geom gm, int depth) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int V = Vec16<T>::N;
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int sf = stage_floats(gm);
  T* ring = reinterpret_cast<T*>(smem + kBarrierBytes / 4);
  float* work = smem + kBarrierBytes / 4 + depth * sf * static_cast<int>(sizeof(T)) / 4;
  const Fixed fx = fixed_at(work + (kF32 ? 0 : sf), gm);
  const Role ro = role(gm);
  const int h = blockIdx.x, b = blockIdx.y;
  const int pw = kWarpP * gm.pbw;
  const int p0 = blockIdx.z * pw;
  const int pcols = min(pw, gm.P - p0);
  // bulk copies take rows of whole, aligned 16-byte vectors (the block's
  // first head-dim column, 16 pbw, always is one)
  const bool bulk_x = gm.P % V == 0, bulk_bc = gm.N % V == 0;
  const float a = A[h];
  float hs[kWarpNT][4];
#pragma unroll
  for (int nt = 0; nt < kWarpNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[nt][e] = 0.f;
  const int nc = cdiv(S, Q);
  const size_t row0 = (static_cast<size_t>(b) * H + h) * S;

  // padding columns are never copied: zero the ring once
  const int ring16 = depth * sf * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < ring16; i += blockDim.x)
    reinterpret_cast<float4*>(ring)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0)
    for (int i = 0; i < depth; ++i) mbar_init(bars + i);
  fence_ring_init();
  __syncthreads();

  // slot t % depth gets x (Q x xs), then B and C (Q x bs each): the
  // chunk's rows inside the sequence, one row a thread
  auto issue = [&](int t) {
    T* slot = ring + (t % depth) * sf;
    uint64_t* bar = bars + t % depth;
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    const uint32_t xrow = pcols * static_cast<uint32_t>(sizeof(T));
    const uint32_t nrow = gm.N * static_cast<uint32_t>(sizeof(T));
    if (threadIdx.x == 0)
      mbar_expect(bar, valid * ((bulk_x ? xrow : 0) + (bulk_bc ? 2 * nrow : 0)));
    fence_proxy_async();
    for (int i = threadIdx.x; i < 3 * valid; i += blockDim.x) {
      const int m = i / valid, r = i % valid;  // m: 0 x, 1 B, 2 C
      const T* src = m == 0 ? x + (row0 + c0 + r) * gm.P + p0
                            : (m == 1 ? B : C) + (static_cast<size_t>(b) * S + c0 + r) * gm.N;
      T* dst = m == 0 ? slot + r * gm.xs : slot + Q * gm.xs + ((m - 1) * Q + r) * gm.bs;
      const int cols = m == 0 ? pcols : gm.N;
      if (m == 0 ? bulk_x : bulk_bc) {
        bulk_copy(dst, src, cols * static_cast<uint32_t>(sizeof(T)), bar);
      } else {  // element copies; the barrier after the wait publishes them
        for (int c = 0; c < cols; ++c) dst[c] = src[c];
      }
    }
  };

  for (int t = 0; t < depth - 1 && t < nc; ++t) issue(t);
  float d = load_dt(dt, b, h, H, S, 0, min(Q, S));

  for (int t = 0; t < nc; ++t) {
    mbar_wait(bars + t % depth, (t / depth) & 1);  // chunk t has landed
    __syncthreads();  // everyone is past chunk t-1: its slot is free
    if (t + depth - 1 < nc) issue(t + depth - 1);
    T* slot = ring + (t % depth) * sf;
    Stage st;
    if constexpr (kF32) {
      st = stage_at(slot, gm);
    } else {  // widen the slot into the fp32 stage (same strides)
      for (int i = threadIdx.x; i < sf / 8; i += blockDim.x) {
        float v[8];
        load16(slot + 8 * i, v);
        *reinterpret_cast<float4*>(work + 8 * i) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(work + 8 * i + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
      st = stage_at(work, gm);
    }
    const int c0 = t * Q;
    const int valid = min(Q, S - c0);
    const float dc = d;
    if (t + 1 < nc) d = load_dt(dt, b, h, H, S, c0 + Q, min(Q, S - c0 - Q));
    if constexpr (!kF32) __syncthreads();
    chunk_step<!kF32, T>(hs, st, fx, gm, ro, dc, a, t == 0, t + 1 == nc,
                         y + (row0 + c0) * gm.P, valid, p0);
  }
}

// The block's shared memory at `depth`, or 0 if the block has no warp or
// does not fit.
template <typename T>
long long block_smem(const Geom& gm, int depth) {
  const long long smem = smem_bytes<T>(gm, depth);
  return gm.pbw >= 1 && smem <= 232448 ? smem : 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B,
                   const void* C, void* y, int BT, int H, int S, const Geom& gm, int depth,
                   cudaStream_t stream) {
  if (depth < 2 || depth > 4) return cudaErrorInvalidValue;
  const long long smem = block_smem<T>(gm, depth);
  if (!smem) return cudaErrorInvalidConfiguration;
  auto kern = ssd_scan_pipelined_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(H, BT, gm.psplit), 32 * gm.warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y), H, S, gm,
      depth);
  return cudaGetLastError();
}

template <typename T>
int occupancy(const Geom& gm, int depth) {
  if (depth < 2 || depth > 4) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = block_smem<T>(gm, depth);
  if (!smem) return -static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = ssd_scan_pipelined_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32 * gm.warps,
                                                      static_cast<size_t>(smem));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// As ssd_scan_launch (ssd_scan.cu), plus `depth` in {2, 3, 4}: the number
// of ring stages.  A ring that does not fit in 227 KB of shared memory
// returns cudaErrorInvalidConfiguration without launching.
REPRO_EXPORT int ssd_scan_pipelined_launch(const void* x, const void* dt, const void* A,
                                           const void* B, const void* C, void* y, int BT,
                                           int H, int S, int P, int N, int depth, int dtype,
                                           int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (!shape_ok(BT, H, S, P, N)) return cudaErrorInvalidValue;
  const Geom gm = geom(P, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(x, dt, A, B, C, y, BT, H, S, gm, depth, st));
}

// Blocks of K8 resident on one SM (as ssd_scan_occupancy, at `depth`).
REPRO_EXPORT int ssd_scan_pipelined_occupancy(int P, int N, int depth, int dtype, int device) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (P <= 0 || N <= 0 || dtype < kFloat32 || dtype > kFloat16)
    return -static_cast<int>(cudaErrorInvalidValue);
  const Geom gm = geom(P, N);
  REPRO_DISPATCH_FLOAT(dtype, T, occupancy<T>(gm, depth));
}
