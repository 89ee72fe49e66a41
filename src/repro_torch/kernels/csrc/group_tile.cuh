// The grouped-aggregation pieces shared by K12 (group_aggregate.cu) and K13
// (group_aggregate_pipelined.cu): the index rule and the max-pool step.
//
// The port of _group_update (src/repro/pointcloud/kernels.py:218).  The TPU
// kernel gathers rows as a one-hot matmul per streamed feature tile (the
// MXU's spelling of a gather) into a running max.  On this card the gather
// is a direct indexed load, which is exact, and the max runs in fp32
// registers; a bf16 or fp16 value survives the round trip through fp32
// unchanged.
#pragma once

#include <math.h>

#include "common.cuh"

namespace group {

// The row a neighbour index names, as the reference's JAX gather takes it
// (group_aggregate_ref: f[idx]): a negative index counts from the end, and
// anything still outside [0, N) is clamped to the nearest row.  On the
// point-cloud path every index is in range; this keeps a stray one from
// ever reading outside the array.
__device__ __forceinline__ int row_of(int i, int N) {
  if (i < 0) i += N;
  return min(max(i, 0), N - 1);
}

// max(acc, v) as jnp.max takes it: a NaN wins and stays.  Starting from
// -inf, the result is exactly the largest value seen.
__device__ __forceinline__ float pool_max(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

}  // namespace group
