// K9: farthest-point sampling, starting at index 0.
//
// Replaces: src/repro/pointcloud/kernels.py::fps (_fps_kernel), the Pallas
// TPU kernel that keeps the whole cloud and its running min-distance in VMEM
// and walks the samples in a fori_loop, one argmax per step.
//
// Bound on an H100: neither bytes nor operations.  The cloud is read once
// (12 bytes a point) and each step does ~10 fp32 operations a point, but
// step s+1 needs the argmax of step s, so the S - 1 steps form one chain of
// cloud-wide reductions.  The roofline bound ignores that chain; the gap to
// it is the chain's length times the latency of one step: the update of
// the block's points (bound by its SM's instruction rate), a warp
// reduction, one barrier, a second warp reduction and one shared-memory
// load.
//
// Design: one cloud per thread-block cluster of C blocks (C = 1, 2, 4, 8 or
// 16, a launch attribute; C = 1 is a plain launch), each block on its own SM
// holding the contiguous span of ceil(N / C) points that starts at rank *
// span.  THREADS threads a block (256, 512 or 1024), PPT points a thread
// (1, 2, 4 or 8) and CLUSTER (C > 1) are template parameters, so the
// one-block kernel carries no cluster code: thread t owns the block's points
// t, t + THREADS, ..., their fp32 coordinates and running min-distances in
// registers, and the block keeps a copy of its points in shared memory
// (16 bytes a point).  PPT = 0 is the scratch path for clouds above the
// register capacity: distances in a global array, coordinates re-read from
// L2.  The plan (C, THREADS, PPT) is chosen in Python
// (kernels/pipeline.py fps_plan).  Each step:
//   1. every thread updates its points' distances to the last sample and
//      takes its best by a tree over them (the lower index wins a tie);
//   2. the argmax runs on one 64-bit key, (hi, lo) = (the distance's fp32
//      bits, 0xFFFFFFFF - index): a distance is >= 0, so its bits order like
//      the float, and the largest key is the farthest point at the lowest
//      index.  A thread with no point gives key 0, which never wins while a
//      real point exists.  A warp's max is two redux.sync: the bits, then
//      the index among the lanes that hold the max bits;
//   3. lane r of every warp writes the warp's key into slot [s & 1][rank *
//      warps + warp] of block r's shared memory (distributed shared memory
//      for C > 1);
//   4. one barrier: __syncthreads for C = 1, barrier.cluster arrive.release
//      / wait.acquire for C > 1.  No warp writes slot s & 1 again before
//      every thread has passed barrier s + 1, so before every warp has read
//      step s's slots: the double buffer makes one barrier a step enough;
//   5. every warp reduces all C * warps slots itself (a lane a slot, then
//      a warp max), so no warp waits on another and nothing is broadcast;
//      the winner's coordinates are then read by its index from the copy
//      of the points of the block that owns it (for C > 1 through
//      distributed shared memory; on the scratch path from L2).
// Only keys cross the reduction: no shuffle, ballot or select carries
// coordinates on the step's chain.  (Measured on the H100 against this:
// five levels of 64-bit shuffles in place of redux.sync, coordinates
// carried with the keys, and one shared-memory atomicMax a warp in place
// of the slots were each slower; PERF.md.)  Indices are global, so the result does
// not depend on the plan.  Only rank 0's thread 0 writes `out`.
// Exactness: d^2 is ((dx*dx + dy*dy) + dz*dz) on p - p[last], each product
// and sum rounded on its own (__fmul_rn/__fadd_rn, no FMA contraction), in
// the order of the reference (pointcloud/ref.py), so the indices match it
// bit for bit.  Distances start at 1e30, as the reference's do.
#include <cooperative_groups.h>
#include <float.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;

// Squared distance in the reference's order, without FMA contraction.
__device__ __forceinline__ float sqdist(float px, float py, float pz, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The SM this thread runs on.
__device__ __forceinline__ int sm_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(r));
  return static_cast<int>(r);
}

// The largest of the warp's keys (hi, lo), in every lane: two redux.sync.
__device__ __forceinline__ uint2 warp_max_key(unsigned hi, unsigned lo) {
  const unsigned mhi = __reduce_max_sync(kFull, hi);
  return make_uint2(mhi, __reduce_max_sync(kFull, hi == mhi ? lo : 0u));
}

// CLUSTER: launched as clusters of C > 1 blocks (else C == 1).
template <typename T, int THREADS, int PPT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const T* __restrict__ xyz, int* __restrict__ out,
           float* __restrict__ dscr, int* __restrict__ smid, int N, int S,
           int C) {
  constexpr int kWarps = THREADS / 32;
  constexpr int P1 = PPT > 0 ? PPT : 1;
  constexpr int kSlots = (CLUSTER ? kMaxCluster : 1) * kWarps;
  // each warp's key, (distance bits, 0xFFFFFFFF - index), double-buffered
  __shared__ uint2 slot[2][kSlots];
  // the block's points (PPT > 0): the winner's coordinates are read here
  extern __shared__ float4 pts[];
  const int rank = CLUSTER ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slots = C * kWarps;
  const int span = (N + C - 1) / C;
  const int lo = rank * span;            // the block's first point
  const int hi = min(N, lo + span);      // one past its last
  const T* p = xyz + static_cast<size_t>(b) * N * 3;
  float* dist = dscr + static_cast<size_t>(b) * N;  // PPT == 0 only
  if (smid != nullptr && tid == 0) smid[blockIdx.x] = sm_id();

  float px[P1], py[P1], pz[P1], pd[P1];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int i = lo + tid + q * THREADS;
      const bool ok = i < hi;
      px[q] = ok ? to_f32(p[3 * i]) : 0.f;
      py[q] = ok ? to_f32(p[3 * i + 1]) : 0.f;
      pz[q] = ok ? to_f32(p[3 * i + 2]) : 0.f;
      pd[q] = ok ? 1e30f : -FLT_MAX;  // a padded slot never wins
      if (ok) pts[i - lo] = make_float4(px[q], py[q], pz[q], 0.f);
    }
  } else {
    for (int i = lo + tid; i < hi; i += THREADS) dist[i] = 1e30f;
  }
  float lx = to_f32(p[0]), ly = to_f32(p[1]), lz = to_f32(p[2]);
  int last = 0;
  // every block of the cluster runs, and `pts` is written, before any
  // slot or point is read
  if (CLUSTER) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int s = 0;; ++s) {
    if (rank == 0 && tid == 0) out[static_cast<size_t>(b) * S + s] = last;
    if (s == S - 1) break;
    // 1. update; the thread's key (0 if it holds no point)
    unsigned khi = 0, klo = 0;
    if constexpr (PPT > 0) {
      float td[PPT];
      int tq[PPT];
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        pd[q] = fminf(pd[q], sqdist(px[q], py[q], pz[q], lx, ly, lz));
        td[q] = pd[q];
        tq[q] = q;
      }
#pragma unroll
      for (int w = 1; w < PPT; w *= 2) {
#pragma unroll
        for (int q = 0; q + w < PPT; q += 2 * w) {
          if (td[q + w] > td[q]) {
            td[q] = td[q + w];
            tq[q] = tq[q + w];
          }
        }
      }
      if (td[0] >= 0.f) {
        khi = __float_as_uint(td[0]);
        klo = 0xffffffffu - static_cast<unsigned>(lo + tid + tq[0] * THREADS);
      }
    } else {
      float bd = -1.f;
      int bi = 0;
      for (int i = lo + tid; i < hi; i += THREADS) {
        const float d = fminf(dist[i], sqdist(to_f32(p[3 * i]),
                                              to_f32(p[3 * i + 1]),
                                              to_f32(p[3 * i + 2]), lx, ly, lz));
        dist[i] = d;
        if (d > bd) {
          bd = d;
          bi = i;
        }
      }
      if (bd >= 0.f) {
        khi = __float_as_uint(bd);
        klo = 0xffffffffu - static_cast<unsigned>(bi);
      }
    }
    // 2.-3. the warp's key; lane r writes it into block r's slot
    const uint2 wk = warp_max_key(khi, klo);
    const int buf = s & 1;
    if (lane < C) {
      uint2* dst = &slot[buf][rank * kWarps + warp];
      if (CLUSTER) dst = cg::this_cluster().map_shared_rank(dst, lane);
      *dst = wk;
    }
    // 4. one barrier
    if (CLUSTER) {
      cluster_barrier();
    } else {
      __syncthreads();
    }
    // 5. every warp reduces every slot, then reads the winner's point
    unsigned ghi = 0, glo = 0;
    if (CLUSTER) {
      for (int j = lane; j < slots; j += 32) {
        const uint2 k = slot[buf][j];
        if (k.x > ghi || (k.x == ghi && k.y > glo)) {
          ghi = k.x;
          glo = k.y;
        }
      }
    } else if (lane < kWarps) {
      const uint2 k = slot[buf][lane];
      ghi = k.x;
      glo = k.y;
    }
    last = static_cast<int>(0xffffffffu - warp_max_key(ghi, glo).y);
    if constexpr (PPT > 0) {
      float4 w;
      if (!CLUSTER) {
        w = pts[last];
      } else {
        const int owner = last / span;
        w = cg::this_cluster().map_shared_rank(pts, owner)[last - owner * span];
      }
      lx = w.x;
      ly = w.y;
      lz = w.z;
    } else {
      lx = to_f32(p[3 * last]);
      ly = to_f32(p[3 * last + 1]);
      lz = to_f32(p[3 * last + 2]);
    }
  }
  // no block leaves while another may still read its points
  if (CLUSTER) cg::this_cluster().sync();
}

// Launch configuration of C blocks a cloud (clusters of C for C > 1).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int blocks, int threads, int C, size_t smem,
                cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of C blocks of `kern` (`smem` bytes of dynamic shared memory
// each) the card can hold at once, or an error.  Sizes above 8 need the
// non-portable attribute, and more than 48 KB the opt-in, first.
template <typename K>
cudaError_t active_clusters(K kern, int threads, int C, int smem, int* n) {
  cudaError_t e = cudaSuccess;
  if (C > 8)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  ClusterLaunch l(C, threads, C, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(n, kern, &l.cfg);
}

template <typename T, int THREADS, int PPT>
cudaError_t launch_plan(const void* xyz, void* out, void* dscr, void* smid,
                        int B, int N, int S, int C, int device,
                        cudaStream_t stream) {
  auto kern = C > 1 ? fps_kernel<T, THREADS, PPT, true>
                    : fps_kernel<T, THREADS, PPT, false>;
  // the most points a block holds, 16 bytes each
  constexpr int kMaxSmem = THREADS * PPT * 16;
  // occupancy of each cluster size at the most shared memory, asked (and
  // the attributes set) once a device
  static int known[16][kMaxCluster + 1];
  int n = device < 16 ? known[device][C] : 0;
  if (n <= 0) {
    cudaError_t e = active_clusters(kern, THREADS, C, kMaxSmem, &n);
    if (e != cudaSuccess) return e;
    if (n <= 0) return cudaErrorLaunchOutOfResources;  // never fits
    if (device < 16) known[device][C] = n;
  }
  const T* x = static_cast<const T*>(xyz);
  int* o = static_cast<int*>(out);
  float* d = static_cast<float*>(dscr);
  int* m = static_cast<int*>(smid);
  const size_t smem = PPT > 0 ? static_cast<size_t>((N + C - 1) / C) * 16 : 0;
  if (C == 1) {
    fps_kernel<T, THREADS, PPT, false><<<B, THREADS, smem, stream>>>(x, o, d, m,
                                                                    N, S, C);
    return cudaGetLastError();
  }
  ClusterLaunch l(B * C, THREADS, C, smem, stream);
  cudaError_t e = cudaLaunchKernelEx(&l.cfg, kern, x, o, d, m, N, S, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xyz, void* out, void* dscr, void* smid, int B,
                   int N, int S, int C, int threads, int ppt, int device,
                   cudaStream_t stream) {
#define REPRO_FPS(TH, P)                                                     \
  if (threads == TH && ppt == P)                                             \
  return launch_plan<T, TH, P>(xyz, out, dscr, smid, B, N, S, C, device,     \
                               stream)
#define REPRO_FPS_T(TH) \
  REPRO_FPS(TH, 0);     \
  REPRO_FPS(TH, 1);     \
  REPRO_FPS(TH, 2);     \
  REPRO_FPS(TH, 4);     \
  REPRO_FPS(TH, 8)
  REPRO_FPS_T(256);
  REPRO_FPS_T(512);
  REPRO_FPS_T(1024);
#undef REPRO_FPS_T
#undef REPRO_FPS
  return cudaErrorInvalidValue;
}

bool legal_plan(int C, int threads, int ppt) {
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) &&
         (threads == 256 || threads == 512 || threads == 1024) &&
         (ppt == 0 || ppt == 1 || ppt == 2 || ppt == 4 || ppt == 8);
}

}  // namespace

// xyz (B, N, 3) fp32, bf16 or fp16, contiguous; out (B, S) int32.  1 <= S <=
// N.  The plan: `cluster` blocks a cloud, `threads` a block, `ppt` points a
// thread in registers (cluster * threads * ppt >= N), or ppt = 0, where
// `dscr` must hold B * N floats of scratch (it is not touched otherwise).
// `smid`, if not null, gets the SM of each of the B * cluster blocks (block
// rank r of cloud b at b * cluster + r).  Launches on `stream` and returns
// the launch's error, or cudaErrorLaunchOutOfResources where no cluster of
// that size fits the card.
REPRO_EXPORT int fps_launch(const void* xyz, void* out, void* dscr, void* smid,
                            int B, int N, int S, int cluster, int threads,
                            int ppt, int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || S <= 0 || S > N || !legal_plan(cluster, threads, ppt))
    return cudaErrorInvalidValue;
  if (ppt > 0 ? static_cast<long long>(cluster) * threads * ppt < N
              : dscr == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(xyz, out, dscr, smid, B, N, S,
                                           cluster, threads, ppt, device, s));
}
