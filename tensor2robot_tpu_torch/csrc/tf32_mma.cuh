// Float32-grade products on Hopper's tensor cores ("3xTF32"), and the
// cp.async copies that stage their tiles. Shared by conv5x5_wgrad.cu (K3),
// flash_attention_fwd.cu (K4), flash_attention_bwd_kv.cu (K5a) and
// flash_attention_bwd_q.cu (K5b).
//
// A TF32 tensor-core product reads 10 explicit mantissa bits of each operand
// and accumulates in float32. Splitting each float32 operand x into
//   big = rna_tf32(x), small = rna_tf32(x - big)
// keeps 21 of its 24 bits, and
//   a * b ~= a_small * b_big + a_big * b_small + a_big * b_big
// (the dropped a_small * b_small is below float32's rounding) gives
// float32-grade products at three tensor-core passes, a multiple of the
// CUDA cores' float32 rate: 495 / 3 = 165 against 67 dense TFLOP/s on an
// H100 SXM. This is what CUTLASS calls OpMultiplyAddFastF32 and what
// PyTorch's float32 memory-efficient attention runs on sm80+. The kernels
// issue the small products before the big one, each pass over a group of
// independent accumulators before the next (a product waits for the one
// before it on its accumulator). A bfloat16 value is exact in TF32
// (small = 0), so bfloat16 inputs take the big pass alone, with exact
// products. The tensor cores' float32 accumulation keeps fewer bits than a
// rounded float32 add, so the kernels keep its chains short and add the
// short sums in float32.
//
// Operands are split once, when a tile is staged in shared memory, and kept
// there as float2 {big, small} pairs, so one 8-byte load gives a fragment
// element both halves.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane = 4 g + t
// (g = lane / 4, t = lane % 4), A 16 x 8, B 8 x 8, C 16 x 8:
//   a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   b0 = B[t][g], b1 = B[t + 4][g]
//   c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
// The fragments leave the layout in shared memory free, which is why these
// kernels use mma.sync: wgmma takes TF32 operands K-major only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace t2r {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// {big, small} of x as TF32 bit patterns held in floats.
__device__ __forceinline__ float2 split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  const uint32_t small = to_tf32(x - __uint_as_float(big));
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}

// d += a b on the tensor cores, one TF32 pass.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One fragment's big and small halves.
template <int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];

  __device__ __forceinline__ void set(int i, float2 v) {
    big[i] = __float_as_uint(v.x);
    small[i] = __float_as_uint(v.y);
  }
  // Splits a float32 value held in registers (an accumulator reused as an
  // operand); one pass needs only its big half.
  template <int kPasses>
  __device__ __forceinline__ void split(int i, float x) {
    if (kPasses == 3) {
      set(i, split_tf32(x));
    } else {
      big[i] = to_tf32(x);
    }
  }
};

__device__ __forceinline__ float4 to_float4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 to_float4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four values split into {big, small} pairs at dst[0..3] (32 bytes, 16-byte
// aligned): two 16-byte stores.
template <int kPasses>
__device__ __forceinline__ void store_split4(float2* dst, float4 v) {
  float2 s0, s1, s2, s3;
  if (kPasses == 3) {
    s0 = split_tf32(v.x);
    s1 = split_tf32(v.y);
    s2 = split_tf32(v.z);
    s3 = split_tf32(v.w);
  } else {  // exact in TF32: the small half is 0
    s0 = make_float2(v.x, 0.0f);
    s1 = make_float2(v.y, 0.0f);
    s2 = make_float2(v.z, 0.0f);
    s3 = make_float2(v.w, 0.0f);
  }
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(s0.x, s0.y, s1.x, s1.y);
  d[1] = make_float4(s2.x, s2.y, s3.x, s3.y);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies four elements (16 bytes of float32, 8 of bfloat16) from global to
// shared memory without the registers; a copy that is not `valid` writes
// zeros and reads nothing (`src` must still be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// One float32 value.
__device__ __forceinline__ void cp_async1(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits for all but the most recently committed group of copies.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace t2r
