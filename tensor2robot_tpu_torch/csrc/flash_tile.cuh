// The split-tile layout that the flash attention kernels share:
// flash_attention_fwd.cu (K4), flash_attention_bwd_kv.cu (K5a) and
// flash_attention_bwd_q.cu (K5b) stage their tiles in shared memory as
// float2 {big, small} rows of D columns (tf32_mma.cuh) and read their
// mma.sync fragments through one swizzle, and write their results two
// elements at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace t2r {

// The 4-column group swizzle of row r: distinct over any aligned 4 rows and
// over rows {r, r + 2, r + 4, r + 6} for even or odd r, so that a tile is
// read free of bank conflicts both along D (rows g, columns t and t + 4)
// and along its rows (rows 2t and 2t + 1, column g).
__device__ __forceinline__ int swz(int r) { return ((r ^ (r >> 2)) & 3) << 2; }

// Element (r, c) of a swizzled split tile of D columns.
template <int D>
__device__ __forceinline__ float2 at(const float2* tile, int r, int c) {
  return tile[r * D + (c ^ swz(r))];
}

// Two adjacent float32 results, written in the output's type.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);

template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

}  // namespace t2r
