// Flash attention backward, dQ: the gradient of exact softmax attention
// with respect to the queries, recomputing the probabilities from the
// forward's per-row log-sum-exp.
//
// Replaces the TPU kernel tensor2robot_tpu/parallel/flash_attention.py
// `_flash_bwd_q_kernel` (launched by `_flash_bwd_pallas`, block recompute
// `_bwd_p_ds`). For each batch-head bh and query row r:
//
//   s[c]  = (q[r] . k[c]) * scale                           (float32)
//   p[c]  = exp(s[c] - lse[r]), and 0 where causal and r < c, or where
//           r >= Lq or c >= Lk (a ragged tail)
//   dp[c] = dO[r] . v[c]
//   ds[c] = p[c] * (dp[c] - delta[r]) * scale
//   dq[r] = sum_c ds[c] k[c]
//
// with delta[r] = dO[r] . o[r] computed before the launch, exactly the
// arithmetic of `_bwd_p_ds`, the causal mask at global positions (q_pos >=
// k_pos, no offset). dq is written in the inputs' type.
//
// This file's tile loop is the float32 instance. The bfloat16 instance is
// a kernel of its own on the bfloat16 tensor cores (flash_bwd_bf16.cuh:
// mma.sync m16n8k16 with ldmatrix, bfloat16 tiles in shared memory), to
// which the C entry below dispatches bfloat16 inputs.
//
// Inputs q, k, v and dO are [B, L, H, D] views given by their strides
// (b, h, l; d is unit stride), so q, k and v are read straight out of the
// head-major [B, L, H, 3, D] qkv projection. lse and delta are contiguous
// float32 [B, H, Lq]. Every row of q, k, v and dO is 16-byte aligned (the
// tiles are copied 4 elements at a time). dq is written by strides too,
// with unit stride along D.
//
// What bounds the float32 instance on an H100: operations. At the training
// shape (B*H = 64, L = 4096, D = 64, causal) it does three products per unmasked (q, k)
// pair (s, dp, ds k), 206 GFLOP, over 0.34 GB of q, k, v, dO and dq: some
// 610 operations a byte. 3.08 ms at the CUDA cores' 67 TFLOP/s float32
// rate; 1.25 ms for the three TF32 passes of float32-grade products at the
// tensor cores' 495 TFLOP/s. The design is the dK/dV kernel's
// (flash_attention_bwd_kv.cu) with the roles of queries and keys exchanged:
//   * all three products on the tensor cores in float32 grade (tf32_mma.cuh):
//     each operand is split once into TF32 big and small halves, and
//     mma.sync m16n8k8 sums small*big + big*small + big*big in float32.
//     Each key tile's dq sums
//     start at zero and are added into float32 registers, as the tensor
//     cores' float32 accumulation keeps fewer bits over long chains;
//   * one block of 4 warps per (bh, tile of 64 query rows), each warp owning
//     16 queries; q and dO are split once, dQ is accumulated in registers
//     and written once, at the end, without atomics, in a fixed order: the
//     same bits run to run. The block loops over 32-row key tiles (the
//     Pallas kernel's sequential grid axis), stopping under the causal mask
//     at the diagonal, and a warp whose 16 queries all precede the tile's
//     keys skips its products; the grid issues the query tiles with the
//     most work (the last, under the causal mask) first;
//   * the next key tile's k and v are in flight (cp.async, zero-filled past
//     Lk) while the tensor cores work on this one; each tile is split once
//     into float2 {big, small} rows whose 4-column groups are XOR-swizzled
//     by the row ((r ^ r >> 2) & 3), so that k is read free of bank
//     conflicts both ways: as the B operand of s (rows g, columns t and
//     t + 4 along D) and as the B operand of dq (rows 2t and 2t + 1 along
//     the keys, column g);
//   * s and dp are computed with the queries as rows, so their accumulator
//     fragments, turned into ds in registers, are the A operands of
//     dq += ds k as they stand: the thread's two key columns (2t, 2t + 1) of
//     a fragment become its two k slots (t, t + 4), and the B fragments read
//     k rows 2t and 2t + 1 to match. ds never touches shared memory;
//   * at D = 64, each warp's q and dO A fragments (the same for every key
//     tile) are read from shared memory once and held in registers, 128 of
//     them in float32. A key tile then costs a warp 128 8-byte B-fragment
//     loads for s and dp (D/8 k steps of 4 n tiles, 2 loads each, from k
//     and from v) and 64 for dq (4 k steps of D/8 n tiles, 2 each, from k):
//     192 loads against 288 tensor-core products, 0.67 a product where the
//     dK/dV kernel makes 0.83. At D = 128 the
//     fragments do not fit and are read from shared memory in every tile:
//     512 loads against 576 products (0.89). dq runs over 8 n tiles at a
//     time, so that two products on one accumulator are eight apart, as in
//     s and dp.
// Tile sizes: 16 queries a warp is the m16 of mma.sync; 64 a block (4
// warps) amortises each key tile's copy and split over 4 warps; 32 keys a
// tile keep the dK/dV kernel's shared-memory budget. Shared memory:
// 8 * D * (2 * 64 + 2 * 32) bytes of split tiles and 2 * 32 * D raw
// elements: 112 KB at D = 64, 224 KB at D = 128. At D = 64 the held fragments take the thread to ptxas's 255 registers with
// a spill of a few dozen bytes (`-Xptxas=-v`, printed by chip_smoke.py), so
// registers and shared memory alike allow two blocks (8 warps) a SM; at
// D = 128, one. The size is set per launch with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_bf16.cuh"
#include "flash_tile.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBlockQ = 64;   // query rows of a block
constexpr int kBlockK = 32;   // key rows of a tile
constexpr int kThreads = 128; // 4 warps of 16 queries

struct Strides {
  int64_t q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l, o_b, o_h, o_l;
  int64_t dq_b, dq_h, dq_l;
};

template <int D>
struct Smem {
  float2 qs[kBlockQ * D];   // split tiles, swizzled
  float2 os[kBlockQ * D];
  float2 ks[kBlockK * D];
  float2 vs[kBlockK * D];
  float k_raw[kBlockK * D]; // raw copies of the next key tile
  float v_raw[kBlockK * D];
};

// Starts the copy of key tile k0: k and v rows.
template <int D>
__device__ __forceinline__ void stage_kv(Smem<D>& sm, const float* kb,
                                         const float* vb, int64_t k_l,
                                         int64_t v_l, int k0, int Lk) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kBlockK * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const bool in = k0 + r < Lk;
    t2r::cp_async4(&sm.k_raw[r * D + c], in ? kb + (k0 + r) * k_l + c : kb,
                   in);
    t2r::cp_async4(&sm.v_raw[r * D + c], in ? vb + (k0 + r) * v_l + c : vb,
                   in);
  }
  t2r::cp_async_commit();
}

// The A fragment of rows r0 .. r0 + 15 and columns c0 .. c0 + 7 of a split
// tile (t = lane % 4, g = lane / 4 as in tf32_mma.cuh).
template <int D>
__device__ __forceinline__ void load_a(t2r::Frag<4>& a, const float2* tile,
                                       int row, int c0) {
  a.set(0, t2r::at<D>(tile, row, c0));
  a.set(1, t2r::at<D>(tile, row + 8, c0));
  a.set(2, t2r::at<D>(tile, row, c0 + 4));
  a.set(3, t2r::at<D>(tile, row + 8, c0 + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ d_out,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int H, int Lq, int Lk, Strides st, float scale,
                   int causal) {
  constexpr int kPasses = 3;
  constexpr int kChunks = D / 4;
  constexpr int kSteps = D / 8;   // k steps of s and dp, n tiles of dq
  constexpr bool kResident = D == 64;
  constexpr int kHeld = kResident ? kSteps : 1;
  constexpr int kGroup = 8;      // n tiles of dq a pass runs over
  static_assert(kSteps % kGroup == 0, "D is a multiple of 64");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int n_q = (Lq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_q - 1 - blockIdx.y) * kBlockQ;  // longest causal first
  const int b = bh / H;
  const int h = bh % H;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const float* ob = d_out + b * st.o_b + h * st.o_h;

  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Key tiles whose first key lies past the block's last query are all
    // masked (tiles are aligned from position 0).
    n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);
  }
  stage_kv(sm, kb, vb, st.k_l, st.v_l, 0, Lk);
  for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const bool in = q0 + r < Lq;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 qv = in ? t2r::to_float4(qb + (q0 + r) * st.q_l + c) : zero;
    const float4 ov = in ? t2r::to_float4(ob + (q0 + r) * st.o_l + c) : zero;
    t2r::store_split4<kPasses>(&sm.qs[r * D + (c ^ t2r::swz(r))], qv);
    t2r::store_split4<kPasses>(&sm.os[r * D + (c ^ t2r::swz(r))], ov);
  }

  const int qr = warp * 16 + g;   // this lane's query rows qr and qr + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q_pos = q0 + qr + 8 * half;
    const int64_t row = static_cast<int64_t>(bh) * Lq + q_pos;
    lse_r[half] = q_pos < Lq ? lse[row] : 0.0f;
    delta_r[half] = q_pos < Lq ? delta[row] : 0.0f;
  }

  float dq_acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dq_acc[n][i] = 0.0f;
  }
  // The warp's q and dO A fragments, held across key tiles at D = 64.
  t2r::Frag<4> aq_held[kHeld], ao_held[kHeld];
  if (kResident) {
    __syncthreads();  // the split q and dO tiles are ready
#pragma unroll
    for (int kk = 0; kk < kHeld; ++kk) {
      load_a<D>(aq_held[kk], sm.qs, qr, kk * 8 + t);
      load_a<D>(ao_held[kk], sm.os, qr, kk * 8 + t);
    }
  }
  // Under the causal mask a tile whose first key lies past the warp's last
  // query is all masked for it.
  const int warp_last_q = q0 + warp * 16 + 15;

  for (int tile = 0; tile < n_k; ++tile) {
    const int k0 = tile * kBlockK;
    t2r::cp_async_wait_all();
    __syncthreads();  // the copy has landed; the last tile's products ended
    for (int e = tid; e < kBlockK * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e % kChunks) * 4;
      t2r::store_split4<kPasses>(&sm.ks[r * D + (c ^ t2r::swz(r))],
                                 t2r::to_float4(&sm.k_raw[r * D + c]));
      t2r::store_split4<kPasses>(&sm.vs[r * D + (c ^ t2r::swz(r))],
                                 t2r::to_float4(&sm.v_raw[r * D + c]));
    }
    __syncthreads();  // split tiles ready; the raw buffers are free
    if (tile + 1 < n_k) {
      stage_kv(sm, kb, vb, st.k_l, st.v_l, k0 + kBlockK, Lk);
    }
    if (causal && warp_last_q < k0) continue;

    // s = q k^T and dp = dO v^T: this warp's 16 queries x 32 keys, four n
    // tiles of 8 keys each. Each pass runs over all eight products before
    // the next, so that two products on one accumulator are eight apart.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = 0.0f;
        dp[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int c0 = kk * 8 + t;
      t2r::Frag<4> aq_tile, ao_tile;
      if (!kResident) {
        load_a<D>(aq_tile, sm.qs, qr, c0);
        load_a<D>(ao_tile, sm.os, qr, c0);
      }
      const t2r::Frag<4>& aq = kResident ? aq_held[kk % kHeld] : aq_tile;
      const t2r::Frag<4>& ao = kResident ? ao_held[kk % kHeld] : ao_tile;
      t2r::Frag<2> bk[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = 8 * j + g;
        bk[j].set(0, t2r::at<D>(sm.ks, kr, c0));
        bk[j].set(1, t2r::at<D>(sm.ks, kr, c0 + 4));
        bv[j].set(0, t2r::at<D>(sm.vs, kr, c0));
        bv[j].set(1, t2r::at<D>(sm.vs, kr, c0 + 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], aq.small, bk[j].big);
        t2r::mma_tf32(dp[j], ao.small, bv[j].big);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], aq.big, bk[j].small);
        t2r::mma_tf32(dp[j], ao.big, bv[j].small);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], aq.big, bk[j].big);
        t2r::mma_tf32(dp[j], ao.big, bv[j].big);
      }
    }

    // ds in place of dp: element i of n tile j is query qr + 8 (i >> 1),
    // key 8 j + 2 t + (i & 1) of the tile.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q_pos = q0 + qr + 8 * (i >> 1);
        const int k_pos = k0 + 8 * j + 2 * t + (i & 1);
        const bool keep =
            q_pos < Lq && k_pos < Lk && !(causal && q_pos < k_pos);
        const float p =
            keep ? expf(s[j][i] * scale - lse_r[i >> 1]) : 0.0f;
        dp[j][i] = p * (dp[j][i] - delta_r[i >> 1]) * scale;
      }
    }

    // dq += ds k over the tile's 32 keys, 8 a k step: the accumulator
    // fragment of n tile j is the A fragment of k step j, its key 2t in
    // slot t and 2t + 1 in slot t + 4. Eight n tiles of dq at a time (all of
    // them at D = 64), pass by pass; the tile's sums start from zero and
    // join the block's at its end.
#pragma unroll
    for (int n0 = 0; n0 < kSteps; n0 += kGroup) {
      float part[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::Frag<4> ads;
        ads.split<kPasses>(0, dp[j][0]);
        ads.split<kPasses>(1, dp[j][2]);
        ads.split<kPasses>(2, dp[j][1]);
        ads.split<kPasses>(3, dp[j][3]);
        const int r0 = 8 * j + 2 * t;
        t2r::Frag<2> bk[kGroup];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          const int c = 8 * (n0 + n) + g;
          bk[n].set(0, t2r::at<D>(sm.ks, r0, c));
          bk[n].set(1, t2r::at<D>(sm.ks, r0 + 1, c));
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          t2r::mma_tf32(part[n], ads.small, bk[n].big);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          t2r::mma_tf32(part[n], ads.big, bk[n].small);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          t2r::mma_tf32(part[n], ads.big, bk[n].big);
        }
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[n0 + n][i] += part[n][i];
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q_pos = q0 + qr + 8 * half;
    if (q_pos >= Lq) continue;
    float* dq_row = dq + b * st.dq_b + h * st.dq_h + q_pos * st.dq_l;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      t2r::store2<float>(dq_row + 8 * n + 2 * t, dq_acc[n][2 * half],
                     dq_acc[n][2 * half + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* d_out,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Lq, int Lk, const Strides& st, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_bwd_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lq + kBlockQ - 1) / kBlockQ);
  flash_bwd_q_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), H, Lq, Lk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, d_out: [B, Lq, H, D]; k, v: [B, Lk, H, D]; all float32 or all
// bfloat16, given by element strides (batch, head, row) with unit stride
// along D and 16-byte aligned rows. lse, delta: contiguous float32
// [B, H, Lq]. dq: [B, Lq, H, D] of the inputs' type, written by strides
// (batch, head, row), unit stride along D. D is 64 or 128. Returns
// cudaGetLastError() after the launch (0 on success), or 1
// (cudaErrorInvalidValue) for a D the kernel was not built for.
int t2r_flash_attention_bwd_q(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, void* dq, int B, int H, int Lq,
    int Lk, int D, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh,
    long long o_sl, long long dq_sb, long long dq_sh, long long dq_sl,
    float scale, int causal, int bf16, void* stream) {
  const Strides st = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
                      o_sb, o_sh, o_sl, dq_sb, dq_sh, dq_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? t2r::bwd_bf16::launch_q<64>(q, k, v, d_out, lse, delta, dq,
                                               B, H, Lq, Lk, st, scale,
                                               causal, s)
                : launch<64>(q, k, v, d_out, lse, delta, dq, B, H, Lq, Lk,
                             st, scale, causal, s);
  }
  if (D == 128) {
    return bf16 ? t2r::bwd_bf16::launch_q<128>(q, k, v, d_out, lse, delta,
                                                dq, B, H, Lq, Lk, st, scale,
                                                causal, s)
                : launch<128>(q, k, v, d_out, lse, delta, dq, B, H, Lq, Lk,
                              st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
