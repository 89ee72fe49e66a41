// K14: one-token (decode) GQA attention read straight from the paged K/V
// pools, through the page table, on the device.
//
// Replaces: no TPU kernel.  The reference has no decode kernel: a one-row
// query falls back to XLA (src/repro/targets/llm.py _attention_schedule,
// golden key 5), and the port's plain path gathers every slot's whole page
// range (`k_pages[page_table]`, all of max_len) and copies it again into the
// einsum's layout (models/layers.py attention_decode_paged, _sdpa_xla).
// This kernel takes that path's place for CUDA pools on backend "cuda".
//
// Bound on an H100: bytes.  A decode step's attention does 4*hd flops a
// (query, key) pair and head against 2*hd*itemsize bytes of K and V a key
// and KV head: 2*G/itemsize flops a byte for G = H/K query heads a KV head
// (4 for granite's bf16 G = 4), far below the ~295 the tensor cores need.  The least time is the live K/V (each slot's min(seq_len + 1,
// P*page) keys) read once at 3.35 TB/s, plus q and out.  So the design reads
// nothing else and keeps loads in flight:
//
//   * one block a (key split, KV head, slot): grid (nsplit, K, B), fixed for
//     fixed pool and table shapes, so a decode step can be captured in a CUDA
//     graph.  An inactive slot's blocks read no page; a split past the
//     slot's live length exits at once.
//   * the block walks its live positions in tiles of TK keys (16 KB of K and
//     V a tile, whatever the dtype and head dim), each position's physical
//     page read from the page table itself, through a 3-stage cp.async ring
//     of 16-byte copies (48 KB of shared memory: up to four blocks an SM,
//     two tiles in flight each).  A tile is read once for all G query rows
//     of its KV head (the GQA group).
//   * compute: LPK lanes (a "sub-worker") hold one key's row in 16-byte
//     vectors; the G dot products reduce over those lanes with shuffles and
//     each sub-worker keeps its own online softmax (running max and sum in
//     fp32, base 2) and fp32 P.V accumulators in registers, rescaled only
//     when its max grows.  At the end the block merges its sub-workers in
//     shared memory, in a fixed order.
//   * where the key range is split (the wrapper's plan: more blocks where
//     B*K alone would leave SMs idle), each split writes its (max, sum) and
//     unnormalised accumulators to fp32 scratch the wrapper allocates, and a
//     second small kernel merges the live splits in order.
// No host sync, no allocation, deterministic: the same inputs give the same
// bits.
#include "common.cuh"

namespace pd {

constexpr int kThreads = 128;
constexpr int kStages = 3;
// 16-byte vectors a ring stage holds: the K tile, then the V tile.
constexpr int kStageVecs = 1024;
constexpr int kHalf = kStageVecs / 2;
constexpr int kMaxSplits = 16;
constexpr int kMergeThreads = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int HD>
struct Shape {
  static constexpr int V = 16 / sizeof(T);          // elements a vector
  static constexpr int VR = HD / V;                 // vectors a row
  static constexpr int LPK = VR < 32 ? VR : 32;     // lanes a key
  static constexpr int VPL = VR / LPK;              // vectors a lane
  static constexpr int E = VPL * V;                 // elements a lane holds
  static constexpr int NSW = kThreads / LPK;        // sub-workers a block
  static constexpr int TK = kHalf / VR;             // keys a tile
  static_assert(HD % V == 0 && VR >= 2, "head dim");
  static_assert(kHalf % kThreads == 0 && TK >= NSW, "tile");
};

// Positions a slot attends: 0 .. min(seq_len, span - 1), the token just
// written at seq_len included, clamped where a length runs past the table.
__device__ __forceinline__ int live_keys(int len, int span) {
  return min(max(len, 0), span - 1) + 1;
}

template <typename T, int HD, int GP>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens,
                    const unsigned char* __restrict__ active, T* __restrict__ out,
                    float* __restrict__ part_ml, float* __restrict__ part_acc, int H,
                    int K, int page, int P, int chunk, int nsplit, float scale_log2) {
  using S = Shape<T, HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  if (!active[b]) {
    if (nsplit == 1) {
      for (int i = tid; i < G * HD; i += kThreads) out[row0 * HD + i] = from_f32<T>(0.f);
    }
    return;
  }
  const int n = live_keys(lens[b], P * page);
  const int t0 = split * chunk;
  if (t0 >= n) return;
  const int t1 = min(t0 + chunk, n);
  const int ntiles = (t1 - t0 + S::TK - 1) / S::TK;
  const int* trow = table + static_cast<size_t>(b) * P;
  uint4* ring = reinterpret_cast<uint4*>(smem);

  // One tile's K and V rows into ring stage `stage`: each thread copies the
  // same vectors of the K and the V tile; positions past t1 are not read.
  auto issue = [&](int tile, int stage) {
    if (tile < ntiles) {
      const int base = t0 + tile * S::TK;
      uint4* dst = ring + stage * kStageVecs;
#pragma unroll
      for (int j = 0; j < kHalf / kThreads; ++j) {
        const int r = tid + j * kThreads;
        const int key = r / S::VR, vec = r % S::VR;
        const int pos = base + key;
        if (pos < t1) {
          const int lp = pos / page;
          const int phys = __ldg(trow + lp);
          const size_t off =
              ((static_cast<size_t>(phys) * page + (pos - lp * page)) * K + kvh) * HD +
              vec * S::V;
          cp_async16(dst + r, kp + off, 16);
          cp_async16(dst + kHalf + r, vp + off, 16);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s, s);

  const int li = tid % S::LPK, sw = tid / S::LPK;
  float qr[GP][S::E], acc[GP][S::E], m[GP], l[GP];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int v = 0; v < S::VPL; ++v) {
      if (g < G) {
        load16(q + (row0 + g) * HD + (li + v * S::LPK) * S::V, &qr[g][v * S::V]);
      } else {
#pragma unroll
        for (int e = 0; e < S::V; ++e) qr[g][v * S::V + e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < S::E; ++e) {
      qr[g][e] *= scale_log2;
      acc[g][e] = 0.f;
    }
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    issue(tile + kStages - 1, (tile + kStages - 1) % kStages);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const uint4* st = ring + (tile % kStages) * kStageVecs;
    const int nvalid = min(S::TK, t1 - (t0 + tile * S::TK));
    // every thread runs the same iterations, so the shuffles see whole warps
    for (int kk0 = 0; kk0 < nvalid; kk0 += S::NSW) {
      const int kk = kk0 + sw;
      const bool valid = kk < nvalid;
      float kf[S::E];
#pragma unroll
      for (int v = 0; v < S::VPL; ++v) {
        if (valid) {
          load16(reinterpret_cast<const T*>(st + kk * S::VR + li + v * S::LPK), &kf[v * S::V]);
        } else {
#pragma unroll
          for (int e = 0; e < S::V; ++e) kf[v * S::V + e] = 0.f;
        }
      }
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < S::E; ++e) a = fmaf(qr[g][e], kf[e], a);
#pragma unroll
        for (int off = S::LPK / 2; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
        s[g] = a;
      }
      if (valid) {
        float vf[S::E];
#pragma unroll
        for (int v = 0; v < S::VPL; ++v)
          load16(reinterpret_cast<const T*>(st + kHalf + kk * S::VR + li + v * S::LPK),
                 &vf[v * S::V]);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          if (g < G) {
            if (s[g] > m[g]) {
              const float f = exp2f(m[g] - s[g]);
              l[g] *= f;
#pragma unroll
              for (int e = 0; e < S::E; ++e) acc[g][e] *= f;
              m[g] = s[g];
            }
            const float p = exp2f(s[g] - m[g]);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < S::E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // Merge the sub-workers: (max, sum) and accumulators into shared memory,
  // then one weight a (sub-worker, row), then the rows in order.
  float* sm_acc = reinterpret_cast<float*>(smem);              // [NSW][GP][HD]
  float* sm_ml = sm_acc + S::NSW * GP * HD;                    // [NSW][GP][2]
  float* sm_w = sm_ml + S::NSW * GP * 2;                       // [NSW][GP]
  float* sm_fin = sm_w + S::NSW * GP;                          // [GP][2]
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      if (li == 0) {
        sm_ml[(sw * GP + g) * 2] = m[g];
        sm_ml[(sw * GP + g) * 2 + 1] = l[g];
      }
#pragma unroll
      for (int v = 0; v < S::VPL; ++v) {
        float* dst = sm_acc + (sw * GP + g) * HD + (li + v * S::LPK) * S::V;
#pragma unroll
        for (int e = 0; e < S::V; e += 4)
          *reinterpret_cast<float4*>(dst + e) =
              make_float4(acc[g][v * S::V + e], acc[g][v * S::V + e + 1],
                          acc[g][v * S::V + e + 2], acc[g][v * S::V + e + 3]);
      }
    }
  }
  __syncthreads();
  if (tid < G) {
    const int g = tid;
    float M = -INFINITY;
    for (int w = 0; w < S::NSW; ++w) M = fmaxf(M, sm_ml[(w * GP + g) * 2]);
    float L = 0.f;
    for (int w = 0; w < S::NSW; ++w) {
      const float f = exp2f(sm_ml[(w * GP + g) * 2] - M);
      sm_w[w * GP + g] = f;
      L = fmaf(sm_ml[(w * GP + g) * 2 + 1], f, L);
    }
    sm_fin[g * 2] = M;
    sm_fin[g * 2 + 1] = L;
    if (nsplit > 1) {
      float* ml = part_ml + ((row0 + g) * nsplit + split) * 2;
      ml[0] = M;
      ml[1] = L;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * S::VR; i += kThreads) {
    const int g = i / S::VR, vec = i % S::VR;
    float o[S::V];
#pragma unroll
    for (int e = 0; e < S::V; ++e) o[e] = 0.f;
    for (int w = 0; w < S::NSW; ++w) {
      const float f = sm_w[w * GP + g];
      const float* src = sm_acc + (w * GP + g) * HD + vec * S::V;
#pragma unroll
      for (int e = 0; e < S::V; ++e) o[e] = fmaf(src[e], f, o[e]);
    }
    if (nsplit == 1) {
      const float inv = 1.f / sm_fin[g * 2 + 1];
#pragma unroll
      for (int e = 0; e < S::V; ++e) o[e] *= inv;
      store16(out + (row0 + g) * HD + vec * S::V, o);
    } else {
      float* dst = part_acc + ((row0 + g) * nsplit + split) * HD + vec * S::V;
#pragma unroll
      for (int e = 0; e < S::V; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
    }
  }
}

// The second pass where the keys were split: one block a (head, slot)
// merges the live splits' (max, sum, accumulators) in split order; an
// inactive slot's rows are zeros.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                   const int* __restrict__ lens, const unsigned char* __restrict__ active,
                   T* __restrict__ out, int H, int hd, int span, int chunk, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * H + h;
  T* o = out + row * hd;
  if (!active[b]) {
    for (int d = threadIdx.x * 4; d < hd; d += kMergeThreads * 4)
      store4(o + d, make_float4(0.f, 0.f, 0.f, 0.f));
    return;
  }
  const int ns = (live_keys(lens[b], span) + chunk - 1) / chunk;
  const float* ml = part_ml + row * nsplit * 2;
  float M = -INFINITY;
  for (int s = 0; s < ns; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.f;
  for (int s = 0; s < ns; ++s) L = fmaf(ml[2 * s + 1], exp2f(ml[2 * s] - M), L);
  const float inv = 1.f / L;
  for (int d = threadIdx.x * 4; d < hd; d += kMergeThreads * 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const float f = exp2f(ml[2 * s] - M);
      const float4 x = *reinterpret_cast<const float4*>(part_acc + (row * nsplit + s) * hd + d);
      a.x = fmaf(x.x, f, a.x);
      a.y = fmaf(x.y, f, a.y);
      a.z = fmaf(x.z, f, a.z);
      a.w = fmaf(x.w, f, a.w);
    }
    store4(o + d, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

template <typename T, int HD, int GP>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lens, const unsigned char* active, void* out, float* part_ml,
                   float* part_acc, int B, int H, int K, int page, int P, int chunk,
                   int nsplit, float scale_log2, cudaStream_t stream) {
  constexpr size_t smem = static_cast<size_t>(kStages) * kStageVecs * 16;
  static_assert(smem <= 48 * 1024, "ring above the default shared memory");
  static_assert((Shape<T, HD>::NSW * GP * (HD + 3) + GP * 2) * 4 <= smem, "merge area");
  paged_decode_kernel<T, HD, GP><<<dim3(nsplit, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lens, active, static_cast<T*>(out), part_ml, part_acc, H, K, page, P, chunk, nsplit,
      scale_log2);
  if (nsplit > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    paged_decode_merge<T><<<dim3(H, B), kMergeThreads, 0, stream>>>(
        part_ml, part_acc, lens, active, static_cast<T*>(out), H, HD, P * page, chunk, nsplit);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(int G, const void* q, const void* kp, const void* vp,
                           const int* table, const int* lens, const unsigned char* active,
                           void* out, float* part_ml, float* part_acc, int B, int H, int K,
                           int page, int P, int chunk, int nsplit, float scale_log2,
                           cudaStream_t stream) {
#define PD_GROUP(GP)                                                                      \
  if (G <= GP)                                                                            \
    return launch<T, HD, GP>(q, kp, vp, table, lens, active, out, part_ml, part_acc, B, H, \
                             K, page, P, chunk, nsplit, scale_log2, stream);
  PD_GROUP(1) PD_GROUP(2) PD_GROUP(4) PD_GROUP(8)
#undef PD_GROUP
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int hd, int G, const void* q, const void* kp, const void* vp,
                     const int* table, const int* lens, const unsigned char* active, void* out,
                     float* part_ml, float* part_acc, int B, int H, int K, int page, int P,
                     int chunk, int nsplit, float scale_log2, cudaStream_t stream) {
  switch (hd) {
#define PD_HD(W)                                                                           \
  case W:                                                                                  \
    return dispatch_group<T, W>(G, q, kp, vp, table, lens, active, out, part_ml, part_acc, B, \
                                H, K, page, P, chunk, nsplit, scale_log2, stream);
    PD_HD(16) PD_HD(32) PD_HD(64) PD_HD(128) PD_HD(256)
#undef PD_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pd

// q: (B,1,H,hd); k_pages/v_pages: (N+1, page, K, hd), all of `dtype` (fp32,
// bf16, fp16), contiguous and 16-byte aligned; page_table: (B,P) int32;
// seq_lens: (B,) int32; active: (B,) bool; out: (B,1,H,hd) of `dtype`.
// hd in {16, 32, 64, 128, 256}; H % K == 0 with H / K <= 8.  The keys of a
// slot are cut into `nsplit` (1..16) ranges of `chunk` positions, chunk *
// nsplit >= P * page; with nsplit > 1, part_ml (B,H,nsplit,2) and part_acc
// (B,H,nsplit,hd) are fp32 scratch, else they may be null.  Returns
// cudaGetLastError() (cudaErrorInvalidValue, launching nothing, for a shape
// the kernel does not take).
REPRO_EXPORT int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* page_table,
    const void* seq_lens, const void* active, void* out, void* part_ml, void* part_acc, int B,
    int H, int K, int hd, int page, int P, int chunk, int nsplit, float sm_scale, int dtype,
    int device, void* stream) {
  cudaError_t e = repro_set_device(device);
  if (e != cudaSuccess) return e;
  if (B <= 0 || B > 65535 || K <= 0 || K > 65535 || H <= 0 || H % K != 0 || H > 65535 ||
      page <= 0 || P <= 0 || chunk <= 0 || nsplit < 1 || nsplit > pd::kMaxSplits ||
      static_cast<long long>(chunk) * nsplit < static_cast<long long>(P) * page ||
      static_cast<long long>(chunk) * (nsplit - 1) >= static_cast<long long>(P) * page ||
      (nsplit > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(seq_lens);
  const unsigned char* act = static_cast<const unsigned char*>(active);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  REPRO_DISPATCH_FLOAT(dtype, T,
                       pd::dispatch<T>(hd, H / K, q, k_pages, v_pages, table, lens, act, out,
                                       ml, acc, B, H, K, page, P, chunk, nsplit,
                                       sm_scale * 1.4426950408889634f, s));
}
