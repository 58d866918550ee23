// The bfloat16 instances of the flash attention backward: K5a (dK, dV,
// flash_attention_bwd_kv.cu) and K5b (dQ, flash_attention_bwd_q.cu), on
// Hopper's bfloat16 tensor cores. The arithmetic is that of the float32
// instances (see the two .cu files) and of the JAX package's `_bwd_p_ds`:
//
//   s  = (q . k) * scale,  p = exp(s - lse), 0 where masked,
//   dp = dO . v,           ds = p * (dp - delta) * scale,
//   dv = sum p dO,  dk = sum ds q,  dq = sum ds k,
//
// with float32 lse and delta, every product of bfloat16 inputs exact and
// summed in float32, and dk, dv, dq rounded to bfloat16 once, as they are
// written.
//
// What bounds them on an H100: operations. At the training shape (B*H = 64,
// L = 4096, D = 64, causal) K5a does four products per unmasked (q, k) pair
// (275 GFLOP) over 0.2 GB of bfloat16 q, k, v, dO, dk, dv and float32 lse
// and delta; K5b three (206 GFLOP) over 0.17 GB: some 1,300 operations a
// byte, 0.278 and 0.209 ms at the dense bfloat16 peak of 989 TFLOP/s, 0.06
// and 0.05 ms at 3.35 TB/s.
//
// The design (bf16_mma.cuh):
//   * every product is mma.sync m16n8k16 with bfloat16 operands and float32
//     accumulators (1024 multiply-adds an instruction at the full bfloat16
//     rate, where the float32 instances' TF32 m16n8k8 has half of both);
//   * tiles are kept as bfloat16 in shared memory, copied by 16-byte
//     cp.async straight into XOR-swizzled rows (chunk ^ row & 7), and read
//     by ldmatrix, free of bank conflicts: non-transposed along D for the
//     products along D (K5a's s^T = k q^T and dp^T = v dO^T, K5b's
//     s = q k^T and dp = dO v^T), transposed for the products along the
//     rows (K5a's dv += p^T dO and dk += ds^T q, K5b's dq += ds k). There
//     is no widening pass, and one barrier a tile: the tile that streams
//     (q, dO, lse and delta in K5a; k and v in K5b) sits in a two-stage
//     ring, the next one in flight while the tensor cores work on this one;
//   * p and ds stay in registers: the accumulator fragments of two adjacent
//     n8 tiles, rounded to bfloat16, are the A fragment of one k16 step
//     (`a_from_c`);
//   * the mask and the ragged-tail test run only on tiles that cross the
//     diagonal or a ragged end (a warp-uniform branch); full tiles skip
//     them, and tiles a warp sees nothing of are skipped, as before;
//   * exp(s * scale - lse) is taken as exp2(s * scale * log2(e) - lse *
//     log2(e)), one FMA and one MUFU.EX2;
//   * the products along D load a fragment of the streaming tile (q and dO
//     in K5a, k and v in K5b) once for all of a warp's rows, so each warp
//     owns two m16 tiles (32 rows) at D = 64: half the ldmatrix traffic a
//     product of one m16 tile a warp. A block is 4 warps, 128 rows (K5a's
//     keys, K5b's queries); the tile that streams is 32 queries in K5a and
//     64 keys in K5b, the most that the registers hold beside the
//     accumulators. At D = 128 the accumulators take twice the registers:
//     one m16 tile a warp, 8 warps, 32-row tiles. The other tilings tried
//     on the card (one m16 tile a warp with 64-row tiles, 8 or 2 warps a
//     block) were slower;
//   * dk and dv (or dq) are summed in the tensor cores' float32
//     accumulators across the whole loop and written once, at the end,
//     without atomics, in a fixed order: the same bits run to run.
// Occupancy (-Xptxas=-v, printed by chip_smoke.py): at D = 64, K5a 255
// registers and no spill, K5b 255 and an 8-byte spill, 128 threads: two
// blocks (8 warps) a SM, 48.5 and 64 KB of shared memory each; at
// D = 128, K5a 243 registers, K5b 169, 256 threads: one block (8 warps) a
// SM. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, at
// the training shape: K5a 0.9446 ms, K5b 0.6928 ms, some 30% of their
// bounds. What holds them there: each warp loads its own fragments of the
// streaming tile and waits on its exponentials between the two pairs of
// products, with 8 warps a SM to hide it. A wgmma version of K5a (the
// streaming tile read once a warpgroup) was barely faster on the card,
// its products still waiting on the softmax; FlashAttention-3's answer is
// warpgroups that take turns, fed by a producer warp (PERF.md).
//
// Rounding of p and ds: each is rounded to bfloat16 for the second pair of
// products (dv += p^T dO, dk += ds^T q, dq += ds k), as FlashAttention-2
// and PyTorch's bfloat16 attention backward do: the tensor cores take
// bfloat16 operands, and a relative error of 2^-9 on each term of a sum
// over hundreds to thousands of rows stays well under the 2^-8 of the one
// rounding of dk, dv and dq to bfloat16 (tests/test_torch_flash_bf16_
// rounding.py holds this rounding against the JAX package's float32
// backward on the CPU, at 2e-2 of max as chip_smoke.py holds the card).
// A split of p and ds into two bfloat16 halves (two passes) would keep 16
// bits, but is not needed for the bounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "flash_tile.cuh"

namespace t2r {
namespace bwd_bf16 {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// The tilings at head dim D (KvCfg for K5a, QCfg for K5b): each warp owns
// kM m16 tiles of rows (16 kM keys in K5a, queries in K5b), kWarps warps a
// block, so a block owns kRows = 128 rows; the other side streams through
// in tiles of kStream rows.
template <int kM_, int kWarps_, int kStream_>
struct Tiling {
  static constexpr int kM = kM_, kWarps = kWarps_, kStream = kStream_;
  static constexpr int kThreads = 32 * kWarps, kRows = 16 * kM * kWarps;
};

template <int D>
struct KvCfg;
template <>
struct KvCfg<64> : Tiling<2, 4, 32> {};
template <>
struct KvCfg<128> : Tiling<1, 8, 32> {};

template <int D>
struct QCfg;
template <>
struct QCfg<64> : Tiling<2, 4, 64> {};
template <>
struct QCfg<128> : Tiling<1, 8, 32> {};

// p and ds / scale of one accumulator element: p = exp(s * scale - lse)
// as 2^(s * scale_log2 - lse2) with lse2 = lse * log2(e), 0 where `keep`
// is false; dp becomes p * (dp - delta). The scale of ds is applied to the
// sums it feeds, once, at the end.
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2,
                                     float delta, float scale_log2,
                                     bool keep) {
  const float p = keep ? exp2_approx(fmaf(s, scale_log2, -lse2)) : 0.0f;
  s = p;
  dp = p * (dp - delta);
}

// K5a's p^T and ds^T / scale in place of s^T and dp^T: element i of n tile
// j of m tile m is key kw + 16 m + g + 8 (i >> 1), query q0 + 8 j + 2 t +
// (i & 1). kMask: the tile crosses the diagonal or a ragged end.
template <int kM, int kQN, bool kMask>
__device__ __forceinline__ void kv_p_ds(float (&s)[kM][kQN][4],
                                        float (&dp)[kM][kQN][4],
                                        const float* lse, const float* delta,
                                        float scale_log2, int q0, int kw,
                                        int g, int t, int Lq, int Lk,
                                        int causal) {
#pragma unroll
  for (int j = 0; j < kQN; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(&lse[8 * j + 2 * t]);
    const float2 d2 =
        *reinterpret_cast<const float2*>(&delta[8 * j + 2 * t]);
    const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
    const float dl[2] = {d2.x, d2.y};
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool keep = true;
        if (kMask) {
          const int q_pos = q0 + 8 * j + 2 * t + (i & 1);
          const int k_pos = kw + 16 * m + g + 8 * (i >> 1);
          keep = q_pos < Lq && k_pos < Lk && !(causal && q_pos < k_pos);
        }
        p_ds(s[m][j][i], dp[m][j][i], lse2[i & 1], dl[i & 1], scale_log2,
             keep);
      }
    }
  }
}

// K5b's ds / scale in place of dp: element i of n tile j of m tile m is
// query qw + 16 m + g + 8 (i >> 1), key k0 + 8 j + 2 t + (i & 1). kMask:
// the tile crosses the diagonal or a ragged end.
template <int kM, int kKN, bool kMask>
__device__ __forceinline__ void q_ds(float (&s)[kM][kKN][4],
                                     float (&dp)[kM][kKN][4],
                                     const float (&lse2)[kM][2],
                                     const float (&dl)[kM][2],
                                     float scale_log2, int k0, int qw, int g,
                                     int t, int Lq, int Lk, int causal) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool keep = true;
        if (kMask) {
          const int q_pos = qw + 16 * m + g + 8 * (i >> 1);
          const int k_pos = k0 + 8 * j + 2 * t + (i & 1);
          keep = q_pos < Lq && k_pos < Lk && !(causal && q_pos < k_pos);
        }
        p_ds(s[m][j][i], dp[m][j][i], lse2[m][i >> 1], dl[m][i >> 1],
             scale_log2, keep);
      }
    }
  }
}

// --- K5a: dk and dv -------------------------------------------------------

template <int D>
struct KvSmem {
  static constexpr int kQ = KvCfg<D>::kStream;
  bf16 k[KvCfg<D>::kRows * D];  // the block's keys, swizzled
  bf16 v[KvCfg<D>::kRows * D];
  bf16 q[2][kQ * D];          // a two-stage ring of query tiles
  bf16 o[2][kQ * D];          // and of dO
  float lse[2][kQ];
  float delta[2][kQ];
};

template <int D, typename Strides>
__global__ void __launch_bounds__(KvCfg<D>::kThreads)
flash_bwd_kv_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ d_out,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Lq, int Lk, Strides st, float scale,
                         int causal) {
  using Smem = KvSmem<D>;
  constexpr int kM = KvCfg<D>::kM;
  constexpr int kThreads = KvCfg<D>::kThreads;
  constexpr int kRows = KvCfg<D>::kRows;
  constexpr int kQ = Smem::kQ;
  constexpr int kWarpRows = 16 * kM;
  constexpr int kSteps = D / 16;     // k16 steps of s^T and dp^T along D
  constexpr int kQN = kQ / 8;        // n tiles of s^T: the tile's queries
  constexpr int kN = D / 8;          // n tiles of dk and dv
  extern __shared__ __align__(128) unsigned char bf16_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(bf16_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;   // the first tiles have the most work
  const int b = bh / H;
  const int h = bh % H;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* ob = d_out + b * st.o_b + h * st.o_h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * Lq;
  const float* delta_b = delta + static_cast<int64_t>(bh) * Lq;
  const uint32_t k_tile = smem_u32(sm.k);
  const uint32_t v_tile = smem_u32(sm.v);

  const int n_q = (Lq + kQ - 1) / kQ;
  // Under the causal mask, query tiles that end before the block's first
  // key see none of its keys (tiles are aligned from position 0).
  const int q_start = causal ? k0 / kQ : 0;

  auto stage_q = [&](int tile, int buf) {
    const int q0 = tile * kQ;
    stage_rows<D, kQ, kThreads>(smem_u32(sm.q[buf]), qb, st.q_l, q0, Lq);
    stage_rows<D, kQ, kThreads>(smem_u32(sm.o[buf]), ob, st.o_l, q0, Lq);
    const int r = tid % kQ;
    const bool in = q0 + r < Lq;
    if (tid < kQ) {
      cp_async1(&sm.lse[buf][r], in ? lse_b + q0 + r : lse_b, in);
    } else if (tid < 2 * kQ) {
      cp_async1(&sm.delta[buf][r], in ? delta_b + q0 + r : delta_b, in);
    }
  };
  stage_rows<D, kRows, kThreads>(k_tile, k + b * st.k_b + h * st.k_h, st.k_l,
                                 k0, Lk);
  stage_rows<D, kRows, kThreads>(v_tile, v + b * st.v_b + h * st.v_h, st.v_l,
                                 k0, Lk);
  if (q_start < n_q) stage_q(q_start, 0);
  cp_async_commit();

  float dk_acc[kM][kN][4], dv_acc[kM][kN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dk_acc[m][n][i] = 0.0f;
        dv_acc[m][n][i] = 0.0f;
      }
    }
  }
  const LdsmLane<D, true> rows_first(lane);
  const LdsmLane<D, false> chunks_first(lane);
  const int w0 = warp * kWarpRows;   // the warp's first row of the block
  const int kw = k0 + w0;            // and its first key
  const float scale_log2 = scale * kLog2e;

  for (int tile = q_start; tile < n_q; ++tile) {
    const int buf = (tile - q_start) & 1;
    const int q0 = tile * kQ;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the last tile's reads ended
    if (tile + 1 < n_q) {
      stage_q(tile + 1, buf ^ 1);
      cp_async_commit();
    }
    // Keys past Lk, and under the causal mask queries that all precede
    // the warp's keys, leave the warp nothing to do in this tile.
    if (kw >= Lk || (causal && q0 + kQ - 1 < kw)) continue;
    const uint32_t q_tile = smem_u32(sm.q[buf]);
    const uint32_t o_tile = smem_u32(sm.o[buf]);

    // s^T = k q^T and dp^T = v dO^T: the warp's keys x the tile's queries,
    // kM m tiles of 16 keys by kQN n tiles of 8 queries; each q and dO
    // fragment serves the warp's kM m tiles.
    float s[kM][kQN][4], dp[kM][kQN][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < kQN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[m][j][i] = 0.0f;
          dp[m][j][i] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ak[kM][4], av[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        ldsm_x4(ak[m], rows_first.at(k_tile, w0 + 16 * m, 2 * kk));
        ldsm_x4(av[m], rows_first.at(v_tile, w0 + 16 * m, 2 * kk));
      }
#pragma unroll
      for (int jj = 0; jj < kQN / 2; ++jj) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, chunks_first.at(q_tile, 16 * jj, 2 * kk));
        ldsm_x4(bo, chunks_first.at(o_tile, 16 * jj, 2 * kk));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(s[m][2 * jj], ak[m], bq[0], bq[1]);
          mma_bf16(s[m][2 * jj + 1], ak[m], bq[2], bq[3]);
          mma_bf16(dp[m][2 * jj], av[m], bo[0], bo[1]);
          mma_bf16(dp[m][2 * jj + 1], av[m], bo[2], bo[3]);
        }
      }
    }

    const bool mask = (causal && q0 < kw + kWarpRows - 1) || q0 + kQ > Lq ||
                      kw + kWarpRows > Lk;
    if (mask) {
      kv_p_ds<kM, kQN, true>(s, dp, sm.lse[buf], sm.delta[buf], scale_log2,
                             q0, kw, g, t, Lq, Lk, causal);
    } else {
      kv_p_ds<kM, kQN, false>(s, dp, sm.lse[buf], sm.delta[buf], scale_log2,
                              q0, kw, g, t, Lq, Lk, causal);
    }

    // dv += p^T dO and dk += ds^T q over the tile's queries, 16 a k step:
    // the p^T (ds^T) fragments of n tiles 2 kq and 2 kq + 1 are the A
    // fragment of k step kq; dO and q are read transposed (rows = queries
    // = k), two n tiles of D a load, each serving the kM m tiles.
#pragma unroll
    for (int kq = 0; kq < kQN / 2; ++kq) {
      uint32_t ap[kM][4], ads[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        a_from_c(ap[m], s[m][2 * kq], s[m][2 * kq + 1]);
        a_from_c(ads[m], dp[m][2 * kq], dp[m][2 * kq + 1]);
      }
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, rows_first.at(o_tile, 16 * kq, 2 * np));
        ldsm_x4_trans(bq, rows_first.at(q_tile, 16 * kq, 2 * np));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(dv_acc[m][2 * np], ap[m], bo[0], bo[1]);
          mma_bf16(dv_acc[m][2 * np + 1], ap[m], bo[2], bo[3]);
          mma_bf16(dk_acc[m][2 * np], ads[m], bq[0], bq[1]);
          mma_bf16(dk_acc[m][2 * np + 1], ads[m], bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block (none ran the loop)

#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k_pos = kw + 16 * m + g + 8 * half;
      if (k_pos >= Lk) continue;
      bf16* dk_row = dk + b * st.dk_b + h * st.dk_h + k_pos * st.dk_l;
      bf16* dv_row = dv + b * st.dv_b + h * st.dv_h + k_pos * st.dv_l;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int c = 8 * n + 2 * t;
        store2<bf16>(dk_row + c, dk_acc[m][n][2 * half] * scale,
                     dk_acc[m][n][2 * half + 1] * scale);
        store2<bf16>(dv_row + c, dv_acc[m][n][2 * half],
                     dv_acc[m][n][2 * half + 1]);
      }
    }
  }
}

template <int D, typename Strides>
int launch_kv(const void* q, const void* k, const void* v, const void* d_out,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Lq, int Lk, const Strides& st, float scale,
              int causal, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(KvSmem<D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_bwd_kv_bf16_kernel<D, Strides>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lk + KvCfg<D>::kRows - 1) / KvCfg<D>::kRows);
  flash_bwd_kv_bf16_kernel<D, Strides>
      <<<grid, KvCfg<D>::kThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk, st,
          scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// --- K5b: dq --------------------------------------------------------------

template <int D>
struct QSmem {
  static constexpr int kK = QCfg<D>::kStream;
  bf16 q[QCfg<D>::kRows * D];  // the block's queries, swizzled
  bf16 o[QCfg<D>::kRows * D];  // and their dO rows
  bf16 k[2][kK * D];          // a two-stage ring of key tiles
  bf16 v[2][kK * D];
};

template <int D, typename Strides>
__global__ void __launch_bounds__(QCfg<D>::kThreads)
flash_bwd_q_bf16_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ d_out,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int Lq, int Lk,
                        Strides st, float scale, int causal) {
  using Smem = QSmem<D>;
  constexpr int kM = QCfg<D>::kM;
  constexpr int kThreads = QCfg<D>::kThreads;
  constexpr int kRows = QCfg<D>::kRows;
  constexpr int kK = Smem::kK;
  constexpr int kWarpRows = 16 * kM;
  constexpr int kSteps = D / 16;     // k16 steps of s and dp along D
  constexpr int kKN = kK / 8;        // n tiles of s: the tile's keys
  constexpr int kN = D / 8;          // n tiles of dq
  extern __shared__ __align__(128) unsigned char bf16_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(bf16_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int n_q = (Lq + kRows - 1) / kRows;
  const int q0 = (n_q - 1 - blockIdx.y) * kRows;   // longest causal first
  const int b = bh / H;
  const int h = bh % H;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const uint32_t q_tile = smem_u32(sm.q);
  const uint32_t o_tile = smem_u32(sm.o);

  int n_k = (Lk + kK - 1) / kK;
  if (causal) {
    // Key tiles whose first key lies past the block's last query are all
    // masked (tiles are aligned from position 0).
    n_k = min(n_k, (q0 + kRows - 1) / kK + 1);
  }
  stage_rows<D, kRows, kThreads>(q_tile, q + b * st.q_b + h * st.q_h, st.q_l,
                                 q0, Lq);
  stage_rows<D, kRows, kThreads>(o_tile, d_out + b * st.o_b + h * st.o_h,
                                 st.o_l, q0, Lq);
  stage_rows<D, kK, kThreads>(smem_u32(sm.k[0]), kb, st.k_l, 0, Lk);
  stage_rows<D, kK, kThreads>(smem_u32(sm.v[0]), vb, st.v_l, 0, Lk);
  cp_async_commit();

  const int w0 = warp * kWarpRows;   // the warp's first row of the block
  const int qw = q0 + w0;            // and its first query
  // This lane's queries: qw + 16 m + g + 8 half.
  float lse2[kM][2], dl[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q_pos = qw + 16 * m + g + 8 * half;
      const int64_t row = static_cast<int64_t>(bh) * Lq + q_pos;
      lse2[m][half] = q_pos < Lq ? lse[row] * kLog2e : 0.0f;
      dl[m][half] = q_pos < Lq ? delta[row] : 0.0f;
    }
  }
  float dq_acc[kM][kN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dq_acc[m][n][i] = 0.0f;
    }
  }
  const LdsmLane<D, true> rows_first(lane);
  const LdsmLane<D, false> chunks_first(lane);
  const float scale_log2 = scale * kLog2e;

  for (int tile = 0; tile < n_k; ++tile) {
    const int buf = tile & 1;
    const int k0 = tile * kK;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the last tile's reads ended
    if (tile + 1 < n_k) {
      stage_rows<D, kK, kThreads>(smem_u32(sm.k[buf ^ 1]), kb, st.k_l,
                                  k0 + kK, Lk);
      stage_rows<D, kK, kThreads>(smem_u32(sm.v[buf ^ 1]), vb, st.v_l,
                                  k0 + kK, Lk);
      cp_async_commit();
    }
    // Queries past Lq, and under the causal mask keys that all follow the
    // warp's queries, leave the warp nothing to do in this tile.
    if (qw >= Lq || (causal && qw + kWarpRows - 1 < k0)) continue;
    const uint32_t k_tile = smem_u32(sm.k[buf]);
    const uint32_t v_tile = smem_u32(sm.v[buf]);

    // s = q k^T and dp = dO v^T: the warp's queries x the tile's keys, kM
    // m tiles of 16 queries by kKN n tiles of 8 keys; each k and v fragment
    // serves the warp's kM m tiles.
    float s[kM][kKN][4], dp[kM][kKN][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[m][j][i] = 0.0f;
          dp[m][j][i] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t aq[kM][4], ao[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        ldsm_x4(aq[m], rows_first.at(q_tile, w0 + 16 * m, 2 * kk));
        ldsm_x4(ao[m], rows_first.at(o_tile, w0 + 16 * m, 2 * kk));
      }
#pragma unroll
      for (int jj = 0; jj < kKN / 2; ++jj) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, chunks_first.at(k_tile, 16 * jj, 2 * kk));
        ldsm_x4(bv, chunks_first.at(v_tile, 16 * jj, 2 * kk));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(s[m][2 * jj], aq[m], bk[0], bk[1]);
          mma_bf16(s[m][2 * jj + 1], aq[m], bk[2], bk[3]);
          mma_bf16(dp[m][2 * jj], ao[m], bv[0], bv[1]);
          mma_bf16(dp[m][2 * jj + 1], ao[m], bv[2], bv[3]);
        }
      }
    }

    const bool mask = (causal && k0 + kK - 1 > qw) || k0 + kK > Lk ||
                      qw + kWarpRows > Lq;
    if (mask) {
      q_ds<kM, kKN, true>(s, dp, lse2, dl, scale_log2, k0, qw, g, t, Lq, Lk,
                          causal);
    } else {
      q_ds<kM, kKN, false>(s, dp, lse2, dl, scale_log2, k0, qw, g, t, Lq, Lk,
                           causal);
    }

    // dq += ds k over the tile's keys, 16 a k step: the ds fragments of n
    // tiles 2 kq and 2 kq + 1 are the A fragment of k step kq; k is read
    // transposed (rows = keys = k), two n tiles of D a load, each serving
    // the kM m tiles.
#pragma unroll
    for (int kq = 0; kq < kKN / 2; ++kq) {
      uint32_t ads[kM][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        a_from_c(ads[m], dp[m][2 * kq], dp[m][2 * kq + 1]);
      }
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, rows_first.at(k_tile, 16 * kq, 2 * np));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(dq_acc[m][2 * np], ads[m], bk[0], bk[1]);
          mma_bf16(dq_acc[m][2 * np + 1], ads[m], bk[2], bk[3]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q_pos = qw + 16 * m + g + 8 * half;
      if (q_pos >= Lq) continue;
      bf16* dq_row = dq + b * st.dq_b + h * st.dq_h + q_pos * st.dq_l;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        store2<bf16>(dq_row + 8 * n + 2 * t, dq_acc[m][n][2 * half] * scale,
                     dq_acc[m][n][2 * half + 1] * scale);
      }
    }
  }
}

template <int D, typename Strides>
int launch_q(const void* q, const void* k, const void* v, const void* d_out,
             const void* lse, const void* delta, void* dq, int B, int H,
             int Lq, int Lk, const Strides& st, float scale, int causal,
             cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(QSmem<D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_bwd_q_bf16_kernel<D, Strides>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lq + QCfg<D>::kRows - 1) / QCfg<D>::kRows);
  flash_bwd_q_bf16_kernel<D, Strides>
      <<<grid, QCfg<D>::kThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(d_out),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dq), H, Lq, Lk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd_bf16
}  // namespace t2r
