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
// element.
//
// Design: one thread per output element (b, m, c), grid-stride.  The C
// threads of a center read the same index (a broadcast) and then C
// consecutive elements of the gathered row (one coalesced run), k times;
// the running max stays in an fp32 register.  Rows gathered by several
// centers are served from L2 after their first read.
#include "group_tile.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_kernel(const T* __restrict__ f, const int* __restrict__ idx, T* __restrict__ out,
             int M, int N, int k, int C, size_t total) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += stride) {
    const int c = static_cast<int>(e % C);
    const size_t bm = e / C;  // b * M + m
    const size_t b = bm / M;
    const int* ir = idx + bm * k;
    const T* fb = f + b * N * C + c;
    float acc = -INFINITY;
    for (int j = 0; j < k; ++j)
      acc = group::pool_max(
          acc, to_f32(fb[static_cast<size_t>(group::row_of(ir[j], N)) * C]));
    out[e] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* f, const void* idx, void* out, int B, int N, int M,
                   int k, int C, cudaStream_t stream) {
  const size_t total = static_cast<size_t>(B) * M * C;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  group_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const int*>(idx), static_cast<T*>(out), M,
      N, k, C, total);
  return cudaGetLastError();
}

}  // namespace

// features (B, N, C) fp32, bf16 or fp16 and idx (B, M, k) int32, contiguous;
// out (B, M, C) in the features' dtype.  k >= 1.
// Launches on `stream` and returns cudaGetLastError().
REPRO_EXPORT int group_aggregate_launch(const void* f, const void* idx, void* out,
                                        int B, int N, int M, int k, int C, int dtype,
                                        int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || N <= 0 || M <= 0 || k <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_FLOAT(dtype, T, launch<T>(f, idx, out, B, N, M, k, C, s));
}
