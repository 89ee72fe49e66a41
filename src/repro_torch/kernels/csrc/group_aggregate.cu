// K12: grouped feature aggregation, a direct row gather and a max over the
// k neighbours.
//
// Replaces: src/repro/pointcloud/kernels.py::group_aggregate (_group_kernel),
// the Pallas TPU kernel that streams feature tiles and gathers the
// neighbour rows out of each with a one-hot matmul into a running max.
//
// out[b, m, c] = max_j f[b, idx[b, m, j], c], in the features' dtype.
//
// Bound on an H100: bytes.  The distinct gathered rows, the indices and the
// output are read or written once; the work is one compare per gathered
// element.  This kernel reads every gathered row once per center that names
// it, through L1/L2, so where rows are reused many times (B·M·k much larger
// than the distinct rows) its floor is the gathered bytes at L2's read
// rate; K13 (group_aggregate_pipelined.cu) reads each row once instead.
//
// Design: a warp takes `cpw` centers (1, 2, 4 or 8), 32 / cpw lanes each.
// A center's row is read in 16-byte chunks (one element a lane where a row
// is not whole chunks) by P lanes, P the chunks rounded up to a power of
// two (at most 32; wider rows loop over 32 chunks at a time), so one warp
// load covers R = 32 / (cpw P) rows of each center: 64 fp32 channels are 16
// lanes, two rows a load.  The center's indices arrive in one coalesced
// load, one a lane (clamped as the reference's gather clamps them), and each
// row load takes its index from its lane with __shfl_sync.  kLoads row loads
// a lane (a compile-time count, so the loop unrolls) are all issued before
// the first is folded into the running max (16 bytes in the features' type,
// group::max16), so R kLoads rows of a center are in flight together rather
// than one dependent load at a time: all of them up to k = 16 at two rows a
// load, two rounds at k = 32.  Sixteen loads a lane needed more than the 128
// registers that keep two blocks on an SM, spilled, and ran slower on the
// card at every swept shape (PERF.md).  The R partial maxima of a chunk meet
// by __shfl_xor_sync, and one lane writes it.
#include "group_tile.cuh"

namespace {

using group::kFull;

constexpr int kWarps = 8;
constexpr int kLoads = 8;  // row loads a lane issues before folding them

// A unit of a row as one lane loads it, and its running max: a 16-byte
// chunk held in T (kVec), or one element held in fp32.
template <typename T, bool kVec>
struct Unit;
template <typename T>
struct Unit<T, true> {
  using Raw = uint4;
  using Acc = uint4;
  static constexpr int V = Vec16<T>::N;
  __device__ static Acc init() { return group::neg_inf16<T>(); }
  __device__ static Raw load(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void fold(Acc& acc, const Raw& v) { group::max16<T>(acc, v); }
  __device__ static void fold_lanes(Acc& acc, int off) {
    uint4 o;
    o.x = __shfl_xor_sync(kFull, acc.x, off);
    o.y = __shfl_xor_sync(kFull, acc.y, off);
    o.z = __shfl_xor_sync(kFull, acc.z, off);
    o.w = __shfl_xor_sync(kFull, acc.w, off);
    group::max16<T>(acc, o);
  }
  __device__ static void store(T* p, const Acc& acc) { *reinterpret_cast<uint4*>(p) = acc; }
};
template <typename T>
struct Unit<T, false> {
  using Raw = T;
  using Acc = float;
  static constexpr int V = 1;
  __device__ static Acc init() { return -INFINITY; }
  __device__ static Raw load(const T* p) { return __ldg(p); }
  __device__ static void fold(Acc& acc, const Raw& v) { acc = group::pool_max(acc, to_f32(v)); }
  __device__ static void fold_lanes(Acc& acc, int off) {
    acc = group::pool_max(acc, __shfl_xor_sync(kFull, acc, off));
  }
  __device__ static void store(T* p, const Acc& acc) { *p = from_f32<T>(acc); }
};

template <typename T, bool kVec, int P>
__global__ void __launch_bounds__(kWarps * 32, 2)
group_kernel(const T* __restrict__ f, const int* __restrict__ idx, T* __restrict__ out,
             int BM, int M, int N, int k, int C, int cpw) {
  using U = Unit<T, kVec>;
  constexpr int V = U::V;
  constexpr int NQ = (kLoads + P - 1) / P;  // index registers a lane
  const int lane = threadIdx.x & 31;
  const int W = 32 / cpw;  // lanes a center
  const int R = W / P;     // rows of a center a warp load covers
  const int sub = lane / W, li = lane % W;
  const int rs = li / P, u0 = li % P;
  const long long bm =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * cpw + sub;
  const bool valid = bm < BM;
  const long long b = valid ? bm / M : 0;
  const T* fb = f + b * N * C;
  const int* ib = idx + (valid ? bm : 0) * k;
  const int units = C / V;
  for (int ug = 0; ug < units; ug += P) {  // one pass unless a row is past 32 units
    const int u = ug + u0;
    const bool on = valid && u < units;
    typename U::Acc acc = U::init();
    for (int jb = 0; jb < k; jb += R * kLoads) {
      // entry jb + li + W q of the center's list in register q of lane li
      int ir[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = jb + li + W * q;
        ir[q] = valid && j < k ? group::row_of(__ldg(ib + j), N) : 0;
      }
      // load i of this lane is entry jb + rs + R i: register i / P of lane
      // rs + R (i % P) of the center's lanes
      typename U::Raw raw[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int r = __shfl_sync(kFull, ir[i / P], sub * W + rs + R * (i % P));
        if (on && jb + rs + R * i < k) raw[i] = U::load(fb + static_cast<long long>(r) * C + u * V);
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (on && jb + rs + R * i < k) U::fold(acc, raw[i]);
    }
    // the R partial maxima of each chunk: lanes P, 2P, ... apart
    for (int off = P; off < W; off <<= 1) U::fold_lanes(acc, off);
    if (on && rs == 0) U::store(out + bm * C + u * V, acc);
  }
}

template <typename T, bool kVec, int P>
cudaError_t launch(const void* f, const void* idx, void* out, int B, int N, int M, int k,
                   int C, int cpw, cudaStream_t stream) {
  const long long BM = static_cast<long long>(B) * M;
  const long long blocks = (BM + kWarps * cpw - 1) / (kWarps * cpw);
  if (BM > 0x7fffffff || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  group_kernel<T, kVec, P><<<static_cast<int>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(idx), static_cast<T*>(out),
      static_cast<int>(BM), M, N, k, C, cpw);
  return cudaGetLastError();
}

// Lanes a row of C channels takes (kernels/pipeline.py group_lanes).
inline int lanes_of(int units) {
  int p = 1;
  while (p < units && p < 32) p <<= 1;
  return p;
}

template <typename T, bool kVec>
cudaError_t dispatch_lanes(const void* f, const void* idx, void* out, int B, int N, int M,
                           int k, int C, int cpw, cudaStream_t s) {
  const int P = lanes_of(kVec ? C / Vec16<T>::N : C);
  if (cpw * P > 32) return cudaErrorInvalidValue;
  switch (P) {
    case 1: return launch<T, kVec, 1>(f, idx, out, B, N, M, k, C, cpw, s);
    case 2: return launch<T, kVec, 2>(f, idx, out, B, N, M, k, C, cpw, s);
    case 4: return launch<T, kVec, 4>(f, idx, out, B, N, M, k, C, cpw, s);
    case 8: return launch<T, kVec, 8>(f, idx, out, B, N, M, k, C, cpw, s);
    case 16: return launch<T, kVec, 16>(f, idx, out, B, N, M, k, C, cpw, s);
    default: return launch<T, kVec, 32>(f, idx, out, B, N, M, k, C, cpw, s);
  }
}

template <typename T>
cudaError_t dispatch(const void* f, const void* idx, void* out, int B, int N, int M, int k,
                     int C, int cpw, cudaStream_t s) {
  const bool vec = (C * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? dispatch_lanes<T, true>(f, idx, out, B, N, M, k, C, cpw, s)
             : dispatch_lanes<T, false>(f, idx, out, B, N, M, k, C, cpw, s);
}

}  // namespace

// features (B, N, C) fp32, bf16 or fp16 and idx (B, M, k) int32, contiguous;
// out (B, M, C) in the features' dtype.  k >= 1; `cpw` centers a warp (1, 2,
// 4 or 8, at most 32 / the lanes a row takes: kernels/pipeline.py
// group_plan_legal).  Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int group_aggregate_launch(const void* f, const void* idx, void* out,
                                        int B, int N, int M, int k, int C, int cpw,
                                        int dtype, int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || C <= 0) return cudaErrorInvalidValue;
  if (cpw != 1 && cpw != 2 && cpw != 4 && cpw != 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, dispatch<T>(f, idx, out, B, N, M, k, C, cpw, s));
}
