// The bfloat16 instances of the flash attention forward: K4 (O and LSE from
// scratch, flash_attention_fwd.cu) and K6 (one update of a carried,
// unnormalized float32 (o, m, l) at global offsets, flash_attention_carry.cu)
// on Hopper's bfloat16 tensor cores. The arithmetic is that of the float32
// instances (flash_fwd.cuh, described in the two .cu files) and of the JAX
// package's `_block_update`:
//
//   s    = (q . k) * scale, NEG_INF where masked,
//   m'   = max(m, max_c s);  safe = m' <= NEG_INF/2 ? 0 : m'
//   p    = s <= NEG_INF/2 ? 0 : exp(s - safe)
//   corr = m <= NEG_INF/2 ? 0 : exp(m - safe)
//   l    = l * corr + sum p;   o = o * corr + p v
//
// folded over key tiles, with every product of bfloat16 inputs exact and
// summed in float32, the guards in the same places, and the exponentials
// taken base 2 (scores scaled by scale * log2(e)). K4 writes O = o / max(l,
// 1e-20), rounded to bfloat16 once, and LSE = m + log(max(l, 1e-20)) in
// float32; K6 writes o, m and l back in float32.
//
// How p meets v (`kSplitP`). The tensor cores take p as bfloat16, where
// `_block_update` keeps it in float32. In both instances l and the
// correction come from the float32 p, o is summed in float32, and the LSE,
// m and l never see a rounded p.
//   * K4 (kSplitP false) rounds p to bfloat16 for p v: one product, the
//     arithmetic of FlashAttention-2 and of PyTorch's bfloat16 attention. A
//     relative error of 2^-9 on each term of a sum weighted by p stays under
//     the 2^-8 of O's own rounding to bfloat16 (chip_smoke.py holds O to
//     2e-2 and the LSE to 1e-5 of the plain version).
//   * K6 (kSplitP true) splits p into a bfloat16 high half and the bfloat16
//     rounding of the rest: two products against v, some 16 bits of p
//     (relative error below 2^-17). K6 is held to 1e-5 of max of the plain
//     version after a carried hop (chip_smoke.py's CARRY_RTOL), which one
//     rounding of p would miss. Each key tile's p v starts from zero in
//     registers of its own and is added to o after its correction, o = o *
//     corr + tile sum, as the float32 instances do: the tensor cores'
//     float32 accumulation keeps fewer bits than a rounded add over long
//     chains. K4 scales o by corr and accumulates into it directly.
//
// What bounds them on an H100: operations. At the training shape (B*H = 64,
// L = 4096, D = 64, causal) K4 does two products per unmasked (q, k) pair,
// 137 GFLOP, over 134 MB of bfloat16 q, k, v and O and float32 LSE: 0.139
// ms at the dense bfloat16 peak of 989 TFLOP/s, 0.040 ms at 3.35 TB/s. K6's
// split p adds half again of the products (the bound counts the
// function's two), and its float32 o, m and l, read and written, add 138 MB
// at that shape.
//
// The design (bf16_mma.cuh), the bfloat16 backward's (flash_bwd_bf16.cuh)
// turned to the forward:
//   * both products are mma.sync m16n8k16 with bfloat16 operands and
//     float32 accumulators, at the full bfloat16 rate, where the float32
//     instances' TF32 m16n8k8 has half of it;
//   * q, k and v are copied as bfloat16 by 16-byte cp.async straight into
//     XOR-swizzled shared memory (chunk ^ row & 7): no widening or split
//     pass. Key tiles sit in a two-stage ring, the next one in flight while
//     the tensor cores work on this one, with one barrier a tile. Shared
//     memory is 48 KB at D = 64 (the float32 instances' 192 KB), so several
//     blocks share a SM where the registers allow;
//   * fragments load by ldmatrix, free of bank conflicts: each warp's q
//     fragments once a block, held in registers across the key tiles; k
//     non-transposed as the B operand of s = q k^T, v transposed as the B
//     operand of p v;
//   * s is computed with the queries as rows, so the online softmax runs on
//     its accumulator fragments (a row's scores lie in a quad: two shuffles
//     a max or a sum), and p stays in registers: the fragments of two
//     adjacent n8 tiles, rounded (or split) to bfloat16, are the A fragment
//     of one k16 step of p v (`a_from_c`);
//   * the tiling (`Cfg`): at D = 64 K4's warps own two m16 tiles (32
//     queries), so each k and v fragment serves two products: 4 warps a
//     block of 128 queries, 64-key tiles, 243 registers (`-Xptxas=-v`), two
//     blocks a SM. K6's extra registers (the tile sums, p's second half)
//     leave it one m16 tile a warp: 4 warps a block of 64 queries, capped
//     at 168 registers so that three blocks share a SM. At D = 128 the
//     accumulators take twice the registers: one m16 tile a warp, 8 warps,
//     and 32-key tiles for K6. The other tilings tried on the card (one
//     m16 tile a warp for K4, 8 warps a block, 32- to 128-key tiles, q
//     reloaded from shared memory every tile) were no faster, or spilled;
//   * the mask runs only on tiles that cross the diagonal or the ragged end
//     of the keys (a warp-uniform branch), a warp whose queries all precede
//     a tile's keys skips it, the tile loop ends at the block's diagonal,
//     and the grid issues the query tiles with the most work first;
//   * O and the LSE, or the state, stay in registers and are written once,
//     at the end, in a fixed order: the same bits run to run.
// K6 also keeps the float32 instance's rules (flash_attention_carry.cu):
// the state loaded into the fragments before the first key tile, m
// converted to base 2 at load and back at store (the NEG_INF sentinel kept
// as it is), the causal mask at the clamped delta = q_offset - k_offset, a
// block whose queries all precede its first key returning before it reads
// anything, and rows whose queries precede every key left as they were (so
// a warp whose queries all do writes nothing).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "flash_tile.cuh"

namespace t2r {
namespace fwd_bf16 {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Each warp owns kM m16 tiles of queries, kWarps warps a block, so a block
// owns kRows queries; keys stream through in tiles of kBlockK. kMinBlocks:
// the blocks a SM must hold (__launch_bounds__), which caps the registers.
template <int kM_, int kWarps_, int kBlockK_, int kMinBlocks_ = 1>
struct Tiling {
  static constexpr int kM = kM_, kWarps = kWarps_, kBlockK = kBlockK_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kThreads = 32 * kWarps, kRows = 16 * kM * kWarps;
};

// The tiling at head dim D, for one rounding of p (K4) or a split p (K6).
template <int D, bool kSplitP>
struct Cfg;
template <>
struct Cfg<64, false> : Tiling<2, 4, 64> {};
template <>
struct Cfg<128, false> : Tiling<1, 8, 64> {};
template <>
struct Cfg<64, true> : Tiling<1, 4, 64, 3> {};
template <>
struct Cfg<128, true> : Tiling<1, 8, 32> {};

template <int D, bool kSplitP>
struct Smem {
  using C = Cfg<D, kSplitP>;
  bf16 q[C::kRows * D];            // the block's queries, swizzled
  bf16 k[2][C::kBlockK * D];       // a two-stage ring of key tiles
  bf16 v[2][C::kBlockK * D];
};

// K4 writes O in bfloat16; K6 carries a float32 o.
template <bool kCarry>
using OutType = std::conditional_t<kCarry, float, bf16>;

// The online softmax of one m16 tile of queries over one key tile, on the
// fragments of s (q . k, not yet scaled) in place: element i of n tile j
// is query q_first + g + 8 (i >> 1) (as a key position), key k0 + 8 j + 2 t
// + (i & 1). s becomes p, corr each row's correction of o, and the rows' m
// (base-2 units) and l are updated. kMask: the tile crosses the diagonal or
// the end of the keys, and its hidden scores become NEG_INF, with
// `_block_update`'s guards; the kernel also takes this path for every tile
// when the scale is not positive. A tile without hidden scores holds no
// NEG_INF, so its p is 2^(s scale log2(e) - m) in one FMA and one MUFU.EX2:
// the guard of p would never fire, and with a positive scale the max of
// the scaled scores is the scaled max of the scores.
template <int kKN, bool kMask>
__device__ __forceinline__ void online_softmax(
    float (&s)[kKN][4], float (&m_row)[2], float (&l_row)[2],
    float (&corr)[2], float to_log2, int q_first, int k0, int g, int t,
    int Lk, int causal) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q_pos = q_first + g + 8 * (i >> 1);
        const int k_pos = k0 + 8 * j + 2 * t + (i & 1);
        s[j][i] = k_pos >= Lk || (causal && q_pos < k_pos)
                      ? kNegInf
                      : s[j][i] * to_log2;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float row_max = kMask ? kNegInf : s[0][2 * half];
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
      row_max = fmaxf(row_max, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
    }
    row_max = quad_max(row_max);
    const float m_new =
        fmaxf(m_row[half], kMask ? row_max : row_max * to_log2);
    const float safe_m = m_new <= kNegInf / 2 ? 0.0f : m_new;
    float row_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKN; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[j][2 * half + e];
        const float p =
            kMask ? (x <= kNegInf / 2 ? 0.0f : exp2_approx(x - safe_m))
                  : exp2_approx(fmaf(x, to_log2, -safe_m));
        s[j][2 * half + e] = p;
        row_sum += p;
      }
    }
    corr[half] = m_row[half] <= kNegInf / 2
                     ? 0.0f
                     : exp2_approx(m_row[half] - safe_m);
    l_row[half] = l_row[half] * corr[half] + quad_sum(row_sum);
    m_row[half] = m_new;
  }
}

// K4: o is O, stat the LSE; l_state and delta_in are unused. K6: o, stat
// (m) and l_state are the carried state, read and written in place;
// delta_in = q_offset - k_offset, clamped to [-Lq, Lk] by the caller.
template <int D, bool kCarry, bool kSplitP, typename Strides>
__global__ void __launch_bounds__(Cfg<D, kSplitP>::kThreads,
                                  Cfg<D, kSplitP>::kMinBlocks)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      OutType<kCarry>* __restrict__ o,
                      float* __restrict__ stat, float* __restrict__ l_state,
                      int H, int Lq, int Lk, Strides st, float scale,
                      int causal, int delta_in) {
  using C = Cfg<D, kSplitP>;
  using Sm = Smem<D, kSplitP>;
  constexpr int kM = C::kM;
  constexpr int kThreads = C::kThreads;
  constexpr int kRows = C::kRows;
  constexpr int kBlockK = C::kBlockK;
  constexpr int kWarpRows = 16 * kM;
  constexpr int kSteps = D / 16;     // k16 steps of s along D
  constexpr int kKN = kBlockK / 8;   // n tiles of s: the tile's keys
  constexpr int kN = D / 8;          // n tiles of o
  extern __shared__ __align__(128) unsigned char fwd_bf16_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(fwd_bf16_smem);
  // Key c is hidden from query r when causal and r + delta < c.
  const int delta = kCarry ? delta_in : 0;

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

  if constexpr (kCarry) {
    // Every query of the block precedes the block's first key: the carried
    // state is already the answer, and nothing is read or written.
    if (causal && min(q0 + kRows, Lq) - 1 + delta < 0) return;
  }
  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Key tiles whose first key lies past the block's last query are all
    // masked (tiles are aligned from key 0).
    n_k = min(n_k, (q0 + delta + kRows - 1) / kBlockK + 1);
  }
  const uint32_t q_tile = smem_u32(sm.q);
  stage_rows<D, kRows, kThreads>(q_tile, q + b * st.q_b + h * st.q_h, st.q_l,
                                 q0, Lq);
  stage_rows<D, kBlockK, kThreads>(smem_u32(sm.k[0]), kb, st.k_l, 0, Lk);
  stage_rows<D, kBlockK, kThreads>(smem_u32(sm.v[0]), vb, st.v_l, 0, Lk);
  cp_async_commit();

  const int w0 = warp * kWarpRows;   // the warp's first row of the block
  const int qw = q0 + w0;            // and its first query
  // This lane's queries: qw + 16 m + g + 8 half.
  float acc[kM][kN][4];
  float m_row[kM][2], l_row[kM][2];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      m_row[m][half] = kNegInf;
      l_row[m][half] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;
    }
  }
  if constexpr (kCarry) {
    // The carried state of this lane's rows, m in base-2 units (the
    // NEG_INF sentinel kept as it is); rows past Lq are not read.
    const int64_t row0 = static_cast<int64_t>(bh) * Lq;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q_pos = qw + 16 * m + g + 8 * half;
        if (q_pos >= Lq) continue;
        const float* src = o + (row0 + q_pos) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(src + 8 * n);
          acc[m][n][2 * half] = x.x;
          acc[m][n][2 * half + 1] = x.y;
        }
        const float mv = stat[row0 + q_pos];
        m_row[m][half] = mv <= kNegInf / 2 ? kNegInf : mv * kLog2e;
        l_row[m][half] = l_state[row0 + q_pos];
      }
    }
  }

  const LdsmLane<D, true> rows_first(lane);
  const LdsmLane<D, false> chunks_first(lane);
  cp_async_wait_all();
  __syncthreads();  // q and key tile 0 have landed
  // The warp's q A fragments, the same for every key tile.
  uint32_t aq[kM][kSteps][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      ldsm_x4(aq[m][kk], rows_first.at(q_tile, w0 + 16 * m, 2 * kk));
    }
  }
  const int warp_first_q = qw + delta;   // as key positions
  const int warp_last_q = warp_first_q + kWarpRows - 1;
  const float to_log2 = scale * kLog2e;   // scores in base-2 units
  const bool scale_positive = to_log2 > 0.0f;

  for (int tile = 0; tile < n_k; ++tile) {
    const int buf = tile & 1;
    const int k0 = tile * kBlockK;
    if (tile > 0) {
      cp_async_wait_all();
      __syncthreads();  // this tile has landed; the last tile's reads ended
    }
    if (tile + 1 < n_k) {
      stage_rows<D, kBlockK, kThreads>(smem_u32(sm.k[buf ^ 1]), kb, st.k_l,
                                       k0 + kBlockK, Lk);
      stage_rows<D, kBlockK, kThreads>(smem_u32(sm.v[buf ^ 1]), vb, st.v_l,
                                       k0 + kBlockK, Lk);
      cp_async_commit();
    }
    // Under the causal mask, keys that all follow the warp's queries leave
    // it nothing to do in this tile.
    if (causal && warp_last_q < k0) continue;
    const uint32_t k_tile = smem_u32(sm.k[buf]);
    const uint32_t v_tile = smem_u32(sm.v[buf]);

    // s = q k^T: the warp's queries x the tile's keys, kM m tiles of 16
    // queries by kKN n tiles of 8 keys; each k fragment serves the warp's
    // kM m tiles.
    float s[kM][kKN][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[m][j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kKN / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, chunks_first.at(k_tile, 16 * jj, 2 * kk));
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          mma_bf16(s[m][2 * jj], aq[m][kk], bk[0], bk[1]);
          mma_bf16(s[m][2 * jj + 1], aq[m][kk], bk[2], bk[3]);
        }
      }
    }

    // Only a tile that crosses the diagonal or the end of the keys is
    // masked.
    float corr[kM][2];
    if (k0 + kBlockK > Lk || (causal && k0 + kBlockK - 1 > warp_first_q) ||
        !scale_positive) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        online_softmax<kKN, true>(s[m], m_row[m], l_row[m], corr[m], to_log2,
                                  warp_first_q + 16 * m, k0, g, t, Lk,
                                  causal);
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        online_softmax<kKN, false>(s[m], m_row[m], l_row[m], corr[m],
                                   to_log2, warp_first_q + 16 * m, k0, g, t,
                                   Lk, causal);
      }
    }

    // o = o * corr + p v over the tile's keys, 16 a k step: the p
    // fragments of n tiles 2 kq and 2 kq + 1 are the A fragment of k step
    // kq; v is read transposed (rows = keys = k), two n tiles of D a load,
    // each serving the kM m tiles.
    if constexpr (kSplitP) {
      float part[kM][kN][4];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) part[m][n][i] = 0.0f;
        }
      }
#pragma unroll
      for (int kq = 0; kq < kKN / 2; ++kq) {
        uint32_t hi[kM][4], lo[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          a_from_c_split(hi[m], lo[m], s[m][2 * kq], s[m][2 * kq + 1]);
        }
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, rows_first.at(v_tile, 16 * kq, 2 * np));
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_bf16(part[m][2 * np], lo[m], bv[0], bv[1]);
            mma_bf16(part[m][2 * np + 1], lo[m], bv[2], bv[3]);
          }
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_bf16(part[m][2 * np], hi[m], bv[0], bv[1]);
            mma_bf16(part[m][2 * np + 1], hi[m], bv[2], bv[3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[m][n][i] = acc[m][n][i] * corr[m][i >> 1] + part[m][n][i];
          }
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] *= corr[m][i >> 1];
        }
      }
#pragma unroll
      for (int kq = 0; kq < kKN / 2; ++kq) {
        uint32_t ap[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          a_from_c(ap[m], s[m][2 * kq], s[m][2 * kq + 1]);
        }
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, rows_first.at(v_tile, 16 * kq, 2 * np));
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_bf16(acc[m][2 * np], ap[m], bv[0], bv[1]);
            mma_bf16(acc[m][2 * np + 1], ap[m], bv[2], bv[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block

  if constexpr (kCarry) {
    // Rows whose queries precede every key took none and stay as they
    // were; the others write o unnormalized, m back in natural-log units,
    // and l.
    const int64_t row0 = static_cast<int64_t>(bh) * Lq;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q_pos = qw + 16 * m + g + 8 * half;
        if (q_pos >= Lq || (causal && q_pos + delta < 0)) continue;
        float* dst = o + (row0 + q_pos) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          store2<float>(dst + 8 * n, acc[m][n][2 * half],
                        acc[m][n][2 * half + 1]);
        }
        if (t == 0) {
          const float mv = m_row[m][half];
          stat[row0 + q_pos] = mv <= kNegInf / 2 ? kNegInf : mv * kLn2;
          l_state[row0 + q_pos] = l_row[m][half];
        }
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q_pos = qw + 16 * m + g + 8 * half;
        if (q_pos >= Lq) continue;
        const float l_final = fmaxf(l_row[m][half], 1e-20f);
        bf16* dst = o + ((static_cast<int64_t>(b) * Lq + q_pos) * H + h) * D;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          store2<bf16>(dst + 8 * n + 2 * t, acc[m][n][2 * half] / l_final,
                       acc[m][n][2 * half + 1] / l_final);
        }
        if (t == 0) {
          stat[static_cast<int64_t>(bh) * Lq + q_pos] =
              m_row[m][half] * kLn2 + logf(l_final);
        }
      }
    }
  }
}

// Sets the kernel's shared memory and launches it on a (B H, query tiles)
// grid; returns cudaGetLastError().
template <int D, bool kCarry, bool kSplitP, typename Strides>
int launch(const void* q, const void* k, const void* v, void* o, void* stat,
           void* l_state, int B, int H, int Lq, int Lk, const Strides& st,
           float scale, int causal, int delta, cudaStream_t stream) {
  using C = Cfg<D, kSplitP>;
  const int bytes = static_cast<int>(sizeof(Smem<D, kSplitP>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kCarry, kSplitP, Strides>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lq + C::kRows - 1) / C::kRows);
  flash_fwd_bf16_kernel<D, kCarry, kSplitP, Strides>
      <<<grid, C::kThreads, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<OutType<kCarry>*>(o),
          static_cast<float*>(stat), static_cast<float*>(l_state), H, Lq, Lk,
          st, scale, causal, delta);
  return static_cast<int>(cudaGetLastError());
}

// Launches the instance of head dim D (64 or 128); 1
// (cudaErrorInvalidValue) for another D.
template <bool kCarry, bool kSplitP, typename Strides>
int launch_any(const void* q, const void* k, const void* v, void* o,
               void* stat, void* l_state, int B, int H, int Lq, int Lk, int D,
               const Strides& st, float scale, int causal, int delta,
               cudaStream_t s) {
  if (D == 64) {
    return launch<64, kCarry, kSplitP>(q, k, v, o, stat, l_state, B, H, Lq,
                                       Lk, st, scale, causal, delta, s);
  }
  if (D == 128) {
    return launch<128, kCarry, kSplitP>(q, k, v, o, stat, l_state, B, H, Lq,
                                        Lk, st, scale, causal, delta, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fwd_bf16
}  // namespace t2r
