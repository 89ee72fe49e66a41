// TMA, mbarrier and thread-block-cluster helpers of the int8 GEMMs (K4
// int8_matmul.cu, K5 int8_matmul_pipelined.cu), of K11's ring
// (ball_query_pipelined.cu) and of K13's feature tiles
// (group_aggregate_pipelined.cu), and the host code that
// encodes a 2-D tensor map (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so the libraries need no -lcuda).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// any arrival announced with expect_tx).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// After the inits, before the block's barrier: make them visible to the
// TMA unit and to the other blocks of a cluster.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Arrive and announce `bytes` of copies that complete on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
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
// Order this thread's generic accesses to shared memory before later
// accesses of the async proxy: stores before wgmma or TMA reads them, and
// reads of a TMA-filled slot before the TMA write that refills it (a ring
// released to its refill without it gave wrong tiles where blocks shared
// an SM: tools/int8_ring_race.py).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy the box at (c0 = column, c1 = row) of a 2-D tensor map into shared
// memory, completing on `bar`; elements past the matrix arrive as zeros.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// load_2d into the same shared-memory offset of every block of the cluster
// in `mask` (bit r: block rank r), each copy completing on the mbarrier at
// `bar`'s offset in its own block.
__device__ __forceinline__ void load_2d_multicast(void* dst, const CUtensorMap* map, int c0,
                                                  int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// Copy `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, in one 1-D bulk copy completing on `bar`.
__device__ __forceinline__ void load_1d(void* dst, const void* src, uint32_t bytes,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- host --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Map of a row-major (rows, cols) matrix of `elem`-byte values at `base`
// (16-byte aligned, cols * elem a multiple of 16), read in boxes of
// box_rows x box_cols; out-of-range elements read as zeros.
static inline cudaError_t make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                      const void* base, int rows, int cols, int box_cols,
                                      int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tma
