// What the flash attention kernels share: flash_attention_fwd.cu (K4),
// flash_attention_bwd_kv.cu (K5a), flash_attention_bwd_q.cu (K5b) and
// flash_attention_carry.cu (K6) stage their float32 tiles in shared memory
// as float2 {big, small} rows of D columns (tf32_mma.cuh) and read their
// mma.sync fragments through one swizzle; all their instances write their
// results two elements at a time, and take exponentials and a row's max
// and sum over a quad of lanes alike.

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

// 2^x in one instruction (MUFU.EX2, relative error near 2^-22); 0 for x
// below -126, so 0 for a masked score, which the guards zero as well.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max and the sum over a quad (lanes 4g .. 4g + 3): the lanes that
// hold one row of an mma.sync C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace t2r
