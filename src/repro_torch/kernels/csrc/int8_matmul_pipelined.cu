// K5: int8-weight GEMM for few rows of x, y[M,N] = (x[M,K] @ f32(wq[N,K])^T)
// * scale[N], with the weight stream in a `depth`-stage TMA ring (depth 2-4).
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
// Design: the roles are swapped, y^T = wq . x^T, so that N fills the
// 16-row side of the tensor cores' mma.sync.m16n8k16 and the few rows of x
// its 8-wide side.  A block owns tile_n = 16 * warps rows of wq and tile_m
// = 8 * MT rows of x (MT = 1, 2 or 4; more rows of x take more blocks),
// and a range of K: K is split over a thread-block cluster (gridDim.z =
// split) where the N / tile_n blocks would leave SMs idle.  x is read once
// a block: its rows are cut into bf16 terms (fp32: hi, mid and lo by
// masking bits, i8mm::split3; bf16 and fp16 as they are) and kept in shared
// memory for the block's whole K range (a panel; a range too long for
// kPanelBudget bytes goes in several; each thread loads a batch of vectors
// before it splits any, so the loads overlap).  Thread 0 streams wq with
// TMA, 64 k of the block's rows a stage, into a ring with one mbarrier a
// stage (the schedule is K8's: fill depth-1 stages; at stage i wait for
// it, sync the block, which frees stage i-1's slot, start stage i+depth-1
// there, compute on stage i), so ~depth * tile_n * 64 bytes a block are in
// flight.  (A design with a producer warp that refilled each slot as soon
// as every consumer warp had arrived on an empty mbarrier gave wrong tiles
// now and then where two or more blocks shared an SM -- K = 2048, M > 8,
// the card's tests -- with the release after the reads or after the
// stage, with a fence after the wait and with a consumers' barrier there;
// the same design with one bulk copy a row was right but 5x slower.  The
// block barrier was right in every run; PERF.md.)  Each
// warp widens its 16 rows x 64 k of int8 in registers (i8mm::widen4) as the
// A operand; a thread's 16 consecutive bytes of a row feed four k16 steps
// with their k permuted, and it reads x's terms under the same permutation,
// so the dot products are unchanged.  Each term has its own accumulators
// (the three column groups of the fp32 product), summed into fp32 registers
// on the CUDA cores after every stage (as K4 promotes) and added lo + mid +
// hi in the epilogue.  A split's blocks then write their fp32 partial
// tiles to shared memory and each sums its share of rows over the cluster
// in rank order (deterministic).  TMA needs 16-byte rows: K % 16 == 0 and
// 16-byte aligned bases (the wrapper checks; other shapes go to K4).
#include "int8_tile.cuh"

namespace {

using namespace i8mm;

constexpr int kBK = 64;                // k-values a stage
constexpr int kBarBytes = 64;          // one mbarrier a stage (depth <= 4), padded
constexpr int kAlign = 128;            // TMA destinations
constexpr int kPanelBudget = 110592;   // bytes of x's terms a panel holds at most
constexpr int kMaxSmem = 232448;

template <typename T, int MT, int W>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  static constexpr int kTerms = kF32 ? 3 : 1;
  static constexpr int TM = 8 * MT;   // rows of x a block
  static constexpr int TN = 16 * W;   // rows of wq a block
  static constexpr int kThreads = 32 * W;
  static constexpr int kStage = TN * kBK;
  static constexpr int kPartStride = TM + 4;  // floats a row (n) of the partial
};

// Stages of the block's K range a panel holds, and its bytes: kTerms * TM
// rows of 16-bit values, each ps * 64 long plus 8 of padding.
__host__ __device__ inline int panel_stages(int terms, int tm, int tiles_per_split) {
  const int ps = (kPanelBudget / (terms * tm) - 16) / (2 * kBK);
  const int fit = ps < tiles_per_split ? ps : tiles_per_split;
  return fit > 1 ? fit : 1;
}
__host__ __device__ inline int panel_bytes(int terms, int tm, int ps) {
  return terms * tm * (ps * kBK + 8) * 2;
}

template <typename T, int MT, int W>
size_t smem_bytes(int depth, int split, int ps) {
  using G = Cfg<T, MT, W>;
  const size_t main = static_cast<size_t>(depth) * G::kStage + panel_bytes(G::kTerms, G::TM, ps);
  const size_t part = split > 1 ? static_cast<size_t>(G::TN) * G::kPartStride * 4 : 0;
  return kAlign + kBarBytes + (main > part ? main : part);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1,
                                         bool f16) {
  if (f16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T, int MT, int W>
__global__ void __launch_bounds__(32 * W)
int8_mm_pipelined_kernel(const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
                         const float* __restrict__ scale, T* __restrict__ out, int M, int N,
                         int K, int depth, int tiles_per_split, int ps) {
  using G = Cfg<T, MT, W>;
  constexpr int TM = G::TM, TN = G::TN, NT = G::kTerms;
  extern __shared__ uint8_t smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw + kBarBytes) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));
  uint16_t* panel = reinterpret_cast<uint16_t*>(ring + depth * G::kStage);
  const int prow = ps * kBK + 8;  // 16-bit values a panel row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int split = gridDim.z, rank = blockIdx.z;
  const int nk = cdiv(K, kBK);
  const int t0 = rank * tiles_per_split;
  const int nt = max(0, min(nk, t0 + tiles_per_split) - t0);

  if (tid == 0) {
    for (int s = 0; s < depth; ++s) tma::mbar_init(full + s, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i) {
    const int s = i % depth;
    tma::mbar_expect(full + s, G::kStage);
    tma::load_2d(ring + s * G::kStage, &wmap, (t0 + i) * kBK, n0, full + s);
  };
  if (tid == 0)
    for (int i = 0; i < min(depth - 1, nt); ++i) issue(i);

  // acc[term][j]: this thread's 2 x 2 outputs of n-tile j (x rows 8j ..)
  // for one stage; sum: their running fp32 totals
  float acc[NT][MT][4], sum[NT][MT][4];
#pragma unroll
  for (int p = 0; p < NT; ++p)
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[p][j][e] = 0.f;

  for (int p0 = 0; p0 < nt; p0 += ps) {
    const int pn = min(ps, nt - p0);
    __syncthreads();  // every warp is done with the previous panel
    // x rows m0 .. m0+TM, k (t0+p0)*64 .. + pn*64 -> terms; zeros past M
    // and K; each thread loads kBatch vectors before it splits any
    {
      constexpr int V = 16 / sizeof(T), kBatch = 8;
      const int kb = (t0 + p0) * kBK, cols = pn * kBK / V, total = TM * cols;
      for (int base = tid; base < total; base += kBatch * G::kThreads) {
        uint4 raw[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * G::kThreads;
          const int r = idx / cols, c = (idx % cols) * V;
          raw[u] = make_uint4(0, 0, 0, 0);
          if (idx < total && m0 + r < M && kb + c < K)
            raw[u] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * K + kb + c);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * G::kThreads;
          if (idx >= total) break;
          const int r = idx / cols, c = (idx % cols) * V;
          if constexpr (G::kF32) {
            const float* f = reinterpret_cast<const float*>(&raw[u]);
            uint32_t h[4], md[4], l[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split3(f[e], h[e], md[e], l[e]);
            *reinterpret_cast<uint2*>(panel + (0 * TM + r) * prow + c) =
                make_uint2(pack_hi16(h[0], h[1]), pack_hi16(h[2], h[3]));
            *reinterpret_cast<uint2*>(panel + (1 * TM + r) * prow + c) =
                make_uint2(pack_hi16(md[0], md[1]), pack_hi16(md[2], md[3]));
            *reinterpret_cast<uint2*>(panel + (2 * TM + r) * prow + c) =
                make_uint2(pack_hi16(l[0], l[1]), pack_hi16(l[2], l[3]));
          } else {
            *reinterpret_cast<uint4*>(panel + r * prow + c) = raw[u];
          }
        }
      }
    }
    __syncthreads();
    for (int i = p0; i < p0 + pn; ++i) {
      const int s = i % depth;
      tma::mbar_wait(full + s, (i / depth) & 1);
      __syncthreads();  // every warp is done with stage i-1: its slot is free
      if (tid == 0 && i + depth - 1 < nt) issue(i + depth - 1);
      // A: rows 16*warp + g and + 8, bytes 16t .. 16t+15 of the stage's 64
      const uint8_t* ws = ring + s * G::kStage + (16 * warp + g) * kBK + 16 * t;
      const uint4 w0 = *reinterpret_cast<const uint4*>(ws);
      const uint4 w1 = *reinterpret_cast<const uint4*>(ws + 8 * kBK);
      const uint32_t wr0[4] = {w0.x, w0.y, w0.z, w0.w}, wr1[4] = {w1.x, w1.y, w1.z, w1.w};
      uint32_t a[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        widen4<G::kF16>(wr0[q], a[q][0], a[q][2]);
        widen4<G::kF16>(wr1[q], a[q][1], a[q][3]);
      }
      const int kofs = (i - p0) * kBK + 16 * t;
#pragma unroll
      for (int p = 0; p < NT; ++p)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
          // B: 16 consecutive k of x row 8j + g, as the A bytes
          const uint16_t* xp = panel + (p * TM + 8 * j + g) * prow + kofs;
          const uint4 b0 = *reinterpret_cast<const uint4*>(xp);
          const uint4 b1 = *reinterpret_cast<const uint4*>(xp + 8);
          const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) mma16816(acc[p][j], a[q], b[2 * q], b[2 * q + 1], G::kF16);
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[p][j][e] += acc[p][j][e];
        }
    }
  }

  // v[j][e]: output (n = 16*warp + g + 8*(e/2), m = 8j + 2t + e%2) of the
  // tile, the terms added lo + mid + hi
  float v[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[j][e] = NT == 3 ? (sum[NT - 1][j][e] + sum[NT > 1 ? 1 : 0][j][e]) + sum[0][j][e]
                        : sum[0][j][e];
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * warp + g + 8 * (e / 2), m = m0 + 8 * j + 2 * t + e % 2;
        if (m < M && n < N)
          out[static_cast<size_t>(m) * N + n] = from_f32<T>(v[j][e] * __ldg(scale + n));
      }
    return;
  }
  __syncthreads();  // every stage and the panel are consumed
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(16 * warp + g + 8 * (e / 2)) * G::kPartStride + 8 * j + 2 * t + e % 2] = v[j][e];
  cooperative_groups::this_cluster().sync();
  const int rows = TN / split;  // rows of wq (outputs' columns) this block sums
  for (int e = tid; e < rows * TM; e += G::kThreads) {
    const int nl = rank * rows + e % rows, ml = e / rows;
    const int n = n0 + nl, m = m0 + ml;
    if (m < M && n < N)
      out[static_cast<size_t>(m) * N + n] =
          from_f32<T>(cluster_sum(part, nl * G::kPartStride + ml, split) * __ldg(scale + n));
  }
  cooperative_groups::this_cluster().sync();  // no block leaves while read
}

template <typename T, int MT, int W>
cudaError_t launch(const void* x, const void* wq, const void* scale, void* out, int M, int N,
                   int K, int split, int depth, cudaStream_t stream) {
  using G = Cfg<T, MT, W>;
  auto kern = int8_mm_pipelined_kernel<T, MT, W>;
  static bool attr_set = false;  // once per instantiation, not every launch
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int tiles_per_split = cdiv(cdiv(K, kBK), split);
  const int ps = panel_stages(G::kTerms, G::TM, tiles_per_split);
  const size_t smem = smem_bytes<T, MT, W>(depth, split, ps);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  cudaError_t e = tma::make_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, N, K, kBK, G::TN,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, G::TN), cdiv(M, G::TM), split);
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
  e = cudaLaunchKernelEx(&cfg, kern, wmap, static_cast<const T*>(x),
                         static_cast<const float*>(scale), static_cast<T*>(out), M, N, K, depth,
                         tiles_per_split, ps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int tile_m, int tile_n, const void* x, const void* wq, const void* scale,
                     void* out, int M, int N, int K, int split, int depth, cudaStream_t s) {
#define K5_CASE(MT, W)                                                     \
  if (tile_m == 8 * MT && tile_n == 16 * W)                               \
    return launch<T, MT, W>(x, wq, scale, out, M, N, K, split, depth, s);
  K5_CASE(1, 4)
  K5_CASE(2, 4)
  K5_CASE(4, 4)
  K5_CASE(1, 8)
  K5_CASE(2, 8)
  K5_CASE(4, 8)
#undef K5_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// As int8_matmul_launch (int8_matmul.cu) for the plan tile_m in {8, 16,
// 32}, tile_n in {64, 128}, split in {1, 2, 4, 8} (at most K's 64-wide
// stages), depth in {2, 3, 4}; K must be a multiple of 16 and x, wq
// 16-byte aligned (cudaErrorInvalidValue otherwise, without launching).
REPRO_EXPORT int int8_matmul_pipelined_launch(const void* x, const void* wq,
                                              const void* scale, void* out, int M, int N,
                                              int K, int tile_m, int tile_n, int split,
                                              int depth, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 ||
      depth < 2 || depth > 4 || (split != 1 && split != 2 && split != 4 && split != 8) ||
      split > cdiv(K, kBK) || cdiv(M, tile_m) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       dispatch<T>(tile_m, tile_n, x, wq, scale, out, M, N, K, split, depth, s));
}

// Dynamic shared memory of one block of the plan at this K (bytes), 0 for
// a plan that is not built; kernels/pipeline.py k5_smem_bytes mirrors it.
REPRO_EXPORT int int8_matmul_pipelined_smem(int tile_m, int tile_n, int split, int depth,
                                            int dtype, int K) {
  const int tiles_per_split = cdiv(cdiv(K, kBK), split);
#define K5_SMEM(T, MT, W)                                                                    \
  if (tile_m == 8 * MT && tile_n == 16 * W)                                                 \
    return static_cast<int>(smem_bytes<T, MT, W>(                                           \
        depth, split, panel_stages(Cfg<T, MT, W>::kTerms, 8 * MT, tiles_per_split)));
  if (dtype == kFloat32) {
    K5_SMEM(float, 1, 4) K5_SMEM(float, 2, 4) K5_SMEM(float, 4, 4)
    K5_SMEM(float, 1, 8) K5_SMEM(float, 2, 8) K5_SMEM(float, 4, 8)
  } else {
    K5_SMEM(__half, 1, 4) K5_SMEM(__half, 2, 4) K5_SMEM(__half, 4, 4)
    K5_SMEM(__half, 1, 8) K5_SMEM(__half, 2, 8) K5_SMEM(__half, 4, 8)
  }
#undef K5_SMEM
  return 0;
}
