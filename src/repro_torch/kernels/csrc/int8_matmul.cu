// K4: int8-weight GEMM, y[M,N] = (x[M,K] @ f32(wq[N,K])^T) * scale[N], on
// Hopper's tensor cores (wgmma) with a TMA ring.
//
// Replaces: src/repro/kernels/int8_matmul.py::int8_matmul (_int8_mm_kernel),
// the Pallas TPU kernel whose sequential k grid dimension accumulates an fp32
// (bm, bn) tile in VMEM scratch while BlockSpec copies bring the x and int8
// weight tiles in.
//
// Bound on an H100: at the prompt rows the router sends here (M > 64;
// llama110m's prefill gives M = 512) the work is 2*M*N*K operations on
// ~N*K weight bytes, ~2*M flop/byte: bound by operations.  fp32 x runs as
// three bf16 passes (989 / 3 TFLOP/s), bf16 and fp16 x as one (989).
//
// Design: output tiles of tile_m x tile_n (tile_m = 64 * C for C consumer
// warpgroups; tile_n 64, 128 or 256), and one producer warpgroup.  Without
// a K split, one block an SM walks its tiles (persistent), so that the next
// tile's loads and widening overlap this tile's epilogue (one tile a block
// left the SM idle through each epilogue and each new block's first
// loads).  Thread 0 of the producer streams the x tile (x's type, 64 k
// a stage, 128-byte swizzle) and the int8 wq tile into a ring of `depth`
// stages with TMA, one mbarrier a stage, refilling each slot as soon as the
// consumers release it; the producer's other three warps widen each landed
// wq tile into bf16 (fp16 for fp16 x) in wgmma's K-major 128-byte-swizzled
// layout (B) and arrive on a second mbarrier (a first design let thread 0
// widen too and refill only after its share: the stream then waited on
// the widening, and the two added up).  Each
// consumer warpgroup reads its 64 rows of x from shared memory into
// registers (A): fp32 x is cut there into hi, mid and lo bf16 by masking
// bits (i8mm::split3; no rounding), and the three wgmma passes share one B
// descriptor, lo first; bf16 and fp16 x go in one pass.  Every product is
// exact; the tensor core's fp32 sum is not the CUDA cores' round to
// nearest, so in fp32 each stage is summed into a fresh accumulator that
// the CUDA cores then add into the running fp32 sum (promotion, as fp8
// GEMMs do); bf16 and fp16 x accumulate in the wgmma registers.  The
// consumers release a stage on a third mbarrier.  A K split over a
// thread-block cluster (gridDim.z = split) gives each block a range of k
// stages; the blocks write their fp32 partial tiles to shared memory and
// each sums its share of rows over the cluster's blocks in rank order
// (deterministic: no atomics).  The epilogue scales by scale[n] and writes
// x's type.  Where TMA cannot read the operands (K % 16 != 0 or a base not
// 16-byte aligned) the producer copies them element by element into the
// same layouts, zeros past M, N and K, so any M, N and K >= 1 are taken.
// The plan (tile_m, tile_n, split, depth) is kernels/pipeline.py
// int8_plan's.
#include "int8_tile.cuh"
#include "wgmma.cuh"

namespace {

using namespace i8mm;

constexpr int kBK = 64;  // k-values a stage
constexpr int kConverters = 96;  // producer threads that widen wq (warps 1-3)
constexpr int kBarBytes = 128;
constexpr int kAlign = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

template <typename T, int BN, int C>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  static constexpr int BM = 64 * C;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kXBytes = BM * kBK * static_cast<int>(sizeof(T));
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kWBytes = BN * kBK;
  static constexpr int kStage = kXBytes + kBBytes + kWBytes;
  static constexpr int kPartStride = BN + 8;  // floats a row of the split-K partial
  static constexpr int kPartBytes = BM * kPartStride * 4;
  // fp32 sums each stage apart (promotion): a second set of accumulators
  static constexpr bool kPromote = kF32;
  static constexpr int kPasses = kF32 ? 3 : 1;
};

template <typename T, int BN, int C>
constexpr size_t smem_bytes(int depth, int split) {
  using G = Cfg<T, BN, C>;
  const size_t ring = static_cast<size_t>(depth) * G::kStage;
  const size_t part = split > 1 ? static_cast<size_t>(G::kPartBytes) : 0;
  return kAlign + kBarBytes + (ring > part ? ring : part);
}

// x tile of BM rows in 128-byte-swizzled rows: fp32 as two halves of 32
// columns (BM x 128 bytes each), 16-bit types as one of 64.
__device__ __forceinline__ int x_offset(float*, int BM, int r, int c) {
  const int cc = c & 31;
  return (c >> 5) * BM * 128 + r * 128 + ((((cc >> 2) ^ r) & 7) << 4) + ((cc & 3) << 2);
}
template <typename T>
__device__ __forceinline__ int x_offset(T*, int, int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}
// B tile: row n (BN rows), 16-bit value k (0..63), 128-byte swizzle.
__device__ __forceinline__ int b_offset(int n, int k) {
  return n * 128 + ((((k >> 3) ^ n) & 7) << 4) + ((k & 7) << 1);
}

// Split-K epilogue, run by every thread of the block once the consumers'
// fp32 partial tiles (BM x BN, row stride S floats) are in `part`: after a
// cluster barrier, block `rank` sums rows [rank, rank + 1) * BM / split of
// the tile over the cluster's blocks in rank order, scales them and writes
// x's type; a second barrier keeps every block's partial alive until read.
template <typename T, int BM, int BN, int S, int kThreads>
__device__ __forceinline__ void split_reduce(float* part, const float* __restrict__ scale,
                                             T* __restrict__ out, int m0, int n0, int M, int N,
                                             int split, int rank) {
  cooperative_groups::this_cluster().sync();
  const int rows = BM / split;
  for (int e = threadIdx.x; e < rows * BN; e += kThreads) {
    const int r = rank * rows + e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      out[static_cast<size_t>(m) * N + n] =
          from_f32<T>(cluster_sum(part, r * S + c, split) * __ldg(scale + n));
  }
  cooperative_groups::this_cluster().sync();
}

template <typename T, int BN, int C>
__global__ void __launch_bounds__(128 * (C + 1), 1)
int8_mm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const T* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K,
               int depth, int tiles_per_split, int use_tma) {
  using G = Cfg<T, BN, C>;
  constexpr int BM = G::BM;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full_tma = reinterpret_cast<uint64_t*>(smem_raw);  // TMA landed
  uint64_t* full_b = full_tma + 4;                              // B widened
  uint64_t* empty = full_b + 4;                                 // consumers done
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw + kBarBytes) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  const int grp = threadIdx.x / 128;  // warpgroup 0: producer, 1..C: consumers
  // output tiles, N-tile fastest: a block takes tiles tile0, tile0 + step, ...
  // (split 1: one block an SM walks them; split > 1: one tile a cluster)
  const int tiles_n = cdiv(N, BN), ntiles = tiles_n * cdiv(M, BM);
  const int tile0 = blockIdx.y * gridDim.x + blockIdx.x, step = gridDim.x * gridDim.y;
  const int split = gridDim.z, rank = blockIdx.z;
  const int nk = cdiv(K, kBK);
  const int t0 = rank * tiles_per_split;
  const int nt = max(0, min(nk, t0 + tiles_per_split) - t0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      tma::mbar_init(full_tma + s, 1);
      tma::mbar_init(full_b + s, kConverters / 32);
      tma::mbar_init(empty + s, 4 * C);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  auto stage_x = [&](int s) { return ring + s * G::kStage; };
  auto stage_b = [&](int s) { return ring + s * G::kStage + G::kXBytes; };
  auto stage_w = [&](int s) { return ring + s * G::kStage + G::kXBytes + G::kBBytes; };

  if (grp == 0) {
    // ---------------- producer ----------------
    if constexpr (C == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x < 32) {
      // warp 0, thread 0: TMA, each stage as soon as its slot is free
      if (use_tma && threadIdx.x == 0) {
        int q = 0;  // stages issued over this block's tiles
        for (int tile = tile0; tile < ntiles; tile += step)
          for (int i = 0; i < nt; ++i, ++q) {
            const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
            const int s = q % depth, k0 = (t0 + i) * kBK;
            if (q >= depth) tma::mbar_wait(empty + s, ((q / depth) - 1) & 1);
            tma::mbar_expect(full_tma + s, G::kXBytes + G::kWBytes);
            if constexpr (G::kF32) {
              tma::load_2d(stage_x(s), &xmap, k0, m0, full_tma + s);
              tma::load_2d(stage_x(s) + BM * 128, &xmap, k0 + 32, m0, full_tma + s);
            } else {
              tma::load_2d(stage_x(s), &xmap, k0, m0, full_tma + s);
            }
            tma::load_2d(stage_w(s), &wmap, k0, n0, full_tma + s);
          }
      }
      __syncwarp();
    } else {
      // warps 1-3: widen each landed wq tile into B (or, off TMA's grid,
      // copy x and wq element by element)
      const int ct = threadIdx.x - 32;
      int q = 0;
      for (int tile = tile0; tile < ntiles; tile += step)
        for (int i = 0; i < nt; ++i, ++q) {
          const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
          const int s = q % depth;
          const uint32_t ph = (q / depth) & 1;
          uint8_t* bs = stage_b(s);
          if (use_tma) {
            tma::mbar_wait(full_tma + s, ph);
            const uint8_t* ws = stage_w(s);
            // 16 int8 of row n (k 16c .. 16c+15) -> B chunks 2c, 2c+1 of row n
            for (int it = ct; it < BN * 4; it += kConverters) {
              const int n = it >> 2, c = it & 3;
              const uint4 w = *reinterpret_cast<const uint4*>(ws + n * kBK + 16 * c);
              uint4 lo, hi;
              widen4<G::kF16>(w.x, lo.x, lo.y);
              widen4<G::kF16>(w.y, lo.z, lo.w);
              widen4<G::kF16>(w.z, hi.x, hi.y);
              widen4<G::kF16>(w.w, hi.z, hi.w);
              *reinterpret_cast<uint4*>(bs + b_offset(n, 16 * c)) = lo;
              *reinterpret_cast<uint4*>(bs + b_offset(n, 16 * c + 8)) = hi;
            }
          } else {
            if (q >= depth) tma::mbar_wait(empty + s, ((q / depth) - 1) & 1);
            const int k0 = (t0 + i) * kBK;
            // x's bits as they are, zeros past M and K
            using U = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
            const U* xu = reinterpret_cast<const U*>(x);
            T* xs = reinterpret_cast<T*>(stage_x(s));
            for (int e = ct; e < BM * kBK; e += kConverters) {
              const int r = e / kBK, c = e % kBK;
              const int m = m0 + r, k = k0 + c;
              const U v = (m < M && k < K) ? xu[static_cast<size_t>(m) * K + k] : U(0);
              *reinterpret_cast<U*>(stage_x(s) + x_offset(xs, BM, r, c)) = v;
            }
            for (int e = ct; e < BN * kBK; e += kConverters) {
              const int n = e / kBK, c = e % kBK;
              const int nn = n0 + n, k = k0 + c;
              const int8_t v = (nn < N && k < K) ? wq[static_cast<size_t>(nn) * K + k] : 0;
              *reinterpret_cast<uint16_t*>(bs + b_offset(n, c)) = widen1<G::kF16>(v);
            }
            if (ct == 0) tma::mbar_arrive(full_tma + s);
          }
          tma::fence_proxy_async();  // B (and x) stores -> visible to wgmma
          __syncwarp();
          if (threadIdx.x % 32 == 0) tma::mbar_arrive(full_b + s);  // one arrival a warp
        }
    }
    // the accumulators never cross into this branch: after setmaxnreg it
    // has too few registers to hold them
    if (split > 1) {
      __syncthreads();  // the consumers' barrier before their partials
      split_reduce<T, BM, BN, G::kPartStride, G::kThreads>(
          reinterpret_cast<float*>(ring), scale, out, tile0 / tiles_n * BM, tile0 % tiles_n * BN,
          M, N, split, rank);
    }
    return;
  }
  {
    // ---------------- consumers ----------------
    if constexpr (C == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int g = lane / 4, t = lane % 4;
    const int r0 = 64 * (grp - 1) + 16 * warp + g;  // this thread's rows r0, r0 + 8
    // output (r0 + 8h, 8j + 2t + e) of the tile is acc (or sum)[4j + 2h + e],
    // as wgmma lays it out
    int q = 0;
    for (int tile = tile0; tile < ntiles; tile += step) {
      const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
      float acc[BN / 2];
      float sum[G::kPromote ? BN / 2 : 1];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < (G::kPromote ? BN / 2 : 1); ++e) sum[e] = 0.f;
      for (int i = 0; i < nt; ++i, ++q) {
        const int s = q % depth;
        const uint32_t ph = (q / depth) & 1;
        tma::mbar_wait(full_tma + s, ph);
        tma::mbar_wait(full_b + s, ph);
        const uint8_t* xs = stage_x(s);
        // A fragments of the 4 k16 steps: (r0, c), (r0+8, c), (r0, c+8), (r0+8, c+8)
        uint32_t a[G::kPasses][4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 16 * j + 2 * t;
          if constexpr (G::kF32) {
            float* tag = nullptr;
            const float2 v[4] = {
                *reinterpret_cast<const float2*>(xs + x_offset(tag, BM, r0, c)),
                *reinterpret_cast<const float2*>(xs + x_offset(tag, BM, r0 + 8, c)),
                *reinterpret_cast<const float2*>(xs + x_offset(tag, BM, r0, c + 8)),
                *reinterpret_cast<const float2*>(xs + x_offset(tag, BM, r0 + 8, c + 8))};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t h0, m0b, l0, h1, m1b, l1;
              split3(v[q].x, h0, m0b, l0);
              split3(v[q].y, h1, m1b, l1);
              a[0][j][q] = pack_hi16(l0, l1);  // lo pass first
              a[1][j][q] = pack_hi16(m0b, m1b);
              a[2][j][q] = pack_hi16(h0, h1);
            }
          } else {
            T* tag = nullptr;
            a[0][j][0] = *reinterpret_cast<const uint32_t*>(xs + x_offset(tag, BM, r0, c));
            a[0][j][1] = *reinterpret_cast<const uint32_t*>(xs + x_offset(tag, BM, r0 + 8, c));
            a[0][j][2] = *reinterpret_cast<const uint32_t*>(xs + x_offset(tag, BM, r0, c + 8));
            a[0][j][3] =
                *reinterpret_cast<const uint32_t*>(xs + x_offset(tag, BM, r0 + 8, c + 8));
          }
        }
        const uint64_t desc = wg::make_desc_sw128(stage_b(s));
        wg::fence();
#pragma unroll
        for (int p = 0; p < G::kPasses; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wg::Mma<BN, G::kF16>::run(acc, a[p][j], desc + 2 * j,
                                      (G::kPromote && p == 0 && j == 0) ? 0 : 1);
        wg::commit();
        wg::wait<0>();
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(empty + s);  // one arrival a warp
        if constexpr (G::kPromote) {
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) sum[e] += acc[e];
        }
      }

      // ---------------- epilogue ----------------
      const float* v = G::kPromote ? sum : acc;
      if (split == 1) {
        const bool pairs = N % 2 == 0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          if (n >= N) continue;
          const float s0 = __ldg(scale + n);
          const float s1 = n + 1 < N ? __ldg(scale + n + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + r0 + 8 * h;
            if (m >= M) continue;
            T* o = out + static_cast<size_t>(m) * N + n;
            const T y0 = from_f32<T>(v[4 * j + 2 * h] * s0);
            const T y1 = from_f32<T>(v[4 * j + 2 * h + 1] * s1);
            if (pairs) {
              T pr[2] = {y0, y1};
              if constexpr (sizeof(T) == 4)
                *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(pr);
              else
                *reinterpret_cast<uint32_t*>(o) = *reinterpret_cast<const uint32_t*>(pr);
            } else {
              o[0] = y0;
              if (n + 1 < N) o[1] = y1;
            }
          }
        }
        continue;
      }
      // split-K (one tile a cluster): partial tiles to shared memory, summed
      // over the cluster
      __syncthreads();  // every stage is consumed: the ring is free
      float* part = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(part + (r0 + 8 * h) * G::kPartStride + 8 * j + 2 * t) =
              make_float2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      split_reduce<T, BM, BN, G::kPartStride, G::kThreads>(part, scale, out, m0, n0, M, N, split,
                                                           rank);
    }
  }
}

template <typename T, int BN, int C>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out, int M, int N,
                   int K, int split, int depth, int sms, cudaStream_t stream) {
  using G = Cfg<T, BN, C>;
  auto kern = int8_mm_kernel<T, BN, C>;
  static bool attr_set = false;  // once per instantiation, not every launch
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = smem_bytes<T, BN, C>(depth, split);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int nk = cdiv(K, kBK);
  const int tiles_per_split = cdiv(nk, split);
  const int use_tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(wq) % 16 == 0 && K % 16 == 0;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (use_tma) {
    const CUtensorMapDataType xt = G::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : G::kF16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    cudaError_t e = tma::make_map_2d(&xmap, xt, sizeof(T), x, M, K, 128 / sizeof(T), G::BM,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (e != cudaSuccess) return e;
    e = tma::make_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, kBK, BN,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  // split 1: one block an SM walks the tiles (each SM holds one block);
  // split > 1: a cluster of `split` blocks a tile
  const int tiles = cdiv(N, BN) * cdiv(M, G::BM);
  cfg.gridDim = split == 1 ? dim3(tiles < sms ? tiles : sms)
                           : dim3(cdiv(N, BN), cdiv(M, G::BM), split);
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, static_cast<const T*>(x),
                                     static_cast<const int8_t*>(wq),
                                     static_cast<const float*>(scale), static_cast<T*>(out), M,
                                     N, K, depth, tiles_per_split, use_tma);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tile_m, int tile_n, const void* x, const void* wq, const void* scale,
                     void* out, int M, int N, int K, int split, int depth, int sms,
                     cudaStream_t s) {
#define K4_CASE(BN, C)                                                      \
  if (tile_n == BN && tile_m == 64 * C)                                    \
    return launch<T, BN, C>(x, wq, scale, out, M, N, K, split, depth, sms, s);
  K4_CASE(64, 1)
  K4_CASE(128, 1)
  K4_CASE(64, 2)
  K4_CASE(128, 2)
  if constexpr (!std::is_same<T, float>::value) {
    K4_CASE(256, 1)
    K4_CASE(256, 2)
  }
#undef K4_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (M, K) contiguous of `dtype` (fp32, bf16 or fp16); wq: (N, K)
// contiguous int8; scale: (N,) fp32; out: (M, N) of `dtype`.  M, N, K >= 1.
// The plan: tile_m in {64, 128}, tile_n in {64, 128} (and 256 for bf16 and
// fp16), split in {1, 2, 4, 8} (a cluster of blocks along K), depth in
// {2, 3, 4} ring stages whose shared memory fits.  Returns
// cudaGetLastError() (cudaErrorInvalidValue without launching for a plan
// or shape it does not take).
REPRO_EXPORT int int8_matmul_launch(const void* x, const void* wq, const void* scale,
                                    void* out, int M, int N, int K, int tile_m, int tile_n,
                                    int split, int depth, int dtype, int device,
                                    void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0 || K <= 0 || depth < 2 || depth > 4 ||
      (split != 1 && split != 2 && split != 4 && split != 8) || split > cdiv(K, kBK) ||
      cdiv(M, tile_m) > 65535)
    return cudaErrorInvalidValue;
  static int sms = 0;  // the card's SMs, asked once
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, dispatch<T>(tile_m, tile_n, x, wq, scale, out, M, N, K, split,
                                             depth, sms, s));
}

// Blocks of the plan's kernel resident on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the plan's shared
// memory), 0 for a plan that is not built, or -error.
template <typename T, int BN, int C>
int occupancy(int depth, int split) {
  auto kern = int8_mm_kernel<T, BN, C>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSmem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, Cfg<T, BN, C>::kThreads,
                                                      smem_bytes<T, BN, C>(depth, split));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

REPRO_EXPORT int int8_matmul_occupancy(int tile_m, int tile_n, int split, int depth,
                                       int dtype) {
#define K4_OCC(T, BN, C) \
  if (tile_n == BN && tile_m == 64 * C) return occupancy<T, BN, C>(depth, split);
  if (dtype == kFloat32) {
    K4_OCC(float, 64, 1) K4_OCC(float, 128, 1) K4_OCC(float, 64, 2) K4_OCC(float, 128, 2)
  } else if (dtype == kBFloat16) {
    K4_OCC(__nv_bfloat16, 64, 1) K4_OCC(__nv_bfloat16, 128, 1) K4_OCC(__nv_bfloat16, 256, 1)
    K4_OCC(__nv_bfloat16, 64, 2) K4_OCC(__nv_bfloat16, 128, 2) K4_OCC(__nv_bfloat16, 256, 2)
  } else if (dtype == kFloat16) {
    K4_OCC(__half, 64, 1) K4_OCC(__half, 128, 1) K4_OCC(__half, 256, 1)
    K4_OCC(__half, 64, 2) K4_OCC(__half, 128, 2) K4_OCC(__half, 256, 2)
  }
#undef K4_OCC
  return 0;
}

// Dynamic shared memory of one block of the plan (bytes), 0 for a plan
// that is not built; kernels/pipeline.py int8_plan mirrors it.
REPRO_EXPORT int int8_matmul_smem(int tile_m, int tile_n, int split, int depth, int dtype) {
#define K4_SMEM(T, BN, C) \
  if (tile_n == BN && tile_m == 64 * C) return static_cast<int>(smem_bytes<T, BN, C>(depth, split));
  if (dtype == kFloat32) {
    K4_SMEM(float, 64, 1) K4_SMEM(float, 128, 1) K4_SMEM(float, 64, 2) K4_SMEM(float, 128, 2)
  } else {
    K4_SMEM(__half, 64, 1) K4_SMEM(__half, 128, 1) K4_SMEM(__half, 256, 1)
    K4_SMEM(__half, 64, 2) K4_SMEM(__half, 128, 2) K4_SMEM(__half, 256, 2)
  }
#undef K4_SMEM
  return 0;
}
