// Flash attention forward: exact softmax attention with an online softmax,
// returning O and the per-row log-sum-exp.
//
// Replaces the TPU kernel tensor2robot_tpu/parallel/flash_attention.py
// `_flash_bhld` (kernel body `_flash_kernel`, block update `_block_update`,
// finalize under `i_k == n_k - 1`). For each batch-head bh and query row r:
//
//   s[c]   = (q[r] . k[c]) * scale                    (float32)
//   s[c]   = NEG_INF where causal and r < c, or c >= Lk
//   m, l   = running max and sum of exp(s - m), folded tile by tile:
//            m' = max(m, max_c s);  safe = m' <= NEG_INF/2 ? 0 : m'
//            p  = s <= NEG_INF/2 ? 0 : exp(s - safe)
//            corr = m <= NEG_INF/2 ? 0 : exp(m - safe)
//            l  = l * corr + sum p;   acc = acc * corr + p @ v
//   o[r]   = acc / max(l, 1e-20)   in the input's type
//   lse[r] = m + log(max(l, 1e-20))                    (float32)
//
// the arithmetic of `_block_update` and `_finalize`, with the causal mask at
// global positions (q_pos >= k_pos, no offset), and with the exponentials
// taken base 2: the scores are scaled by scale * log2(e), so m is in base-2
// units, exp(s - m) is 2^(s' - m'), and lse = m' ln 2 + log(l). The guards
// are the same and in the same places.
//
// Inputs are [B, L, H, D] views given by their strides (b, h, l; d is unit
// stride), so the kernel reads q, k and v straight out of the head-major
// [B, L, H, 3, D] qkv projection without copies. Every row of q, k and v is
// 16-byte aligned (the tiles are copied 4 elements at a time). O is written
// contiguous [B, Lq, H, D]; LSE contiguous [B, H, Lq].
//
// What bounds it on an H100: operations. At the served shape (B*H = 8,
// L = 4096, D = 64, causal) it does two products per unmasked (q, k) pair
// (s and p v), 17.2 GFLOP, over 34 MB of q, k, v and o: some 500 operations
// a byte. 0.26 ms at the CUDA cores' 67 TFLOP/s float32 rate; 0.10 ms for
// the three TF32 passes of float32-grade products at the tensor cores'
// 495 TFLOP/s. The design is the dQ kernel's (flash_attention_bwd_q.cu)
// with dp and ds taken away and the output accumulator added:
//   * both products on the tensor cores in float32 grade (tf32_mma.cuh):
//     each operand is split once into TF32 big and small halves, and
//     mma.sync m16n8k8 sums small*big + big*small + big*big in float32.
//     bfloat16 q, k and v are exact in TF32, so s takes the big pass alone;
//     p is float32 (as `_block_update` computes it), so p v takes p's small
//     and big halves against v's exact big one. Each key tile's p v sums
//     start at zero in their own fragments and are added into the float32
//     output accumulator after its correction, o = o * corr + tile sum, as
//     the tensor cores' float32 accumulation keeps fewer bits over long
//     chains;
//   * one block of 8 warps per (bh, tile of 128 query rows), each warp
//     owning 16 queries; the output, its row max and its row sum stay in
//     registers and are written once, at the end, in a fixed order: the same
//     bits run to run. The block loops over key tiles (the Pallas kernel's
//     sequential grid axis), stopping under the causal mask at the
//     diagonal; only a tile that crosses the diagonal or the ragged end of
//     the keys is masked, in a pass of its own before the softmax, and a
//     warp whose 16 queries all precede a tile's keys skips it. The grid
//     issues the query tiles with the most work (the last, under the causal
//     mask) first;
//   * k and v tiles are copied with cp.async into two raw buffers, two
//     tiles ahead, and split into two buffers of float2 {big, small} rows
//     whose 4-column groups are XOR-swizzled by the row (flash_tile.cuh), so
//     that k is read free of bank conflicts as the B operand of s (rows g,
//     columns t and t + 4 along D) and v as the B operand of p v (rows 2t
//     and 2t + 1 along the keys, column g). A tile costs one barrier: after
//     it, each warp splits its share of the next tile, starts the copy of
//     the one after, and multiplies this one;
//   * s is computed with the queries as rows, so the online softmax runs on
//     its accumulator fragments: a row's scores lie in the 4 threads of a
//     quad, and its max and sum take two shuffles each; 2^x is one
//     ex2.approx instruction. The fragments, turned into p in registers,
//     are the A operands of p v as they stand: the thread's two key columns
//     (2t, 2t + 1) of a fragment become its two k slots (t, t + 4), and the
//     B fragments read v rows 2t and 2t + 1 to match. p never touches shared
//     memory, and no barrier separates the two products;
//   * at D = 64, each warp's q A fragments (the same for every key tile) are
//     read from shared memory once and held in registers, 64 of them in
//     float32, and key tiles are 64 rows: q's split tile is staged where
//     the split k tiles go, before the first key tile lands. A tile then
//     costs a warp 128 8-byte B-fragment loads for s (D/8 k steps of 8 n
//     tiles, 2 loads each) and 128 for p v (8 k steps of D/8 n tiles)
//     against 384 tensor-core products (128 + 256 in bfloat16). At D = 128
//     the fragments do not fit: q's split tile stays in shared memory beside
//     16-row key tiles and is read in every tile, and p v runs over 8 n
//     tiles at a time, so that two products on one accumulator are eight
//     apart;
//   * every fragment load is one LDS at a constant offset from one of 16
//     per-lane byte offsets (FragOffsets): the swizzle of a row depends only
//     on its low 3 bits and the parity of its 8-row group. Computing each
//     swizzled address in the loop took more instructions than the products
//     and loads together (cuobjdump's SASS); the copy and split passes run
//     fixed trip counts for the same reason.
// 128 queries a block share each key tile's copy, split and barrier among 8
// warps; at some 245 registers a thread (`-Xptxas=-v`) one block, 8 warps,
// fills a SM either way. Shared memory: 2 * 8 * D * 2 * kBlockK bytes of
// split tiles and 2 * 2 * kBlockK * D raw elements, plus at D = 128 q's
// 8 * 128 * D split tile: 192 KB at D = 64 in float32, 224 KB at D = 128.
// The size is set per launch with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 8;               // of 16 queries each
constexpr int kBlockQ = 16 * kWarps;    // query rows of a block
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// At D = 64 q's fragments are held in registers and key tiles are 64 rows;
// at D = 128 q's split tile stays in shared memory beside 16-row key tiles.
template <int D>
struct Tiles {
  static constexpr bool kResident = D == 64;
  static constexpr int kBlockK = kResident ? 64 : 16;
};

struct Strides {
  int64_t q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l;
};

template <typename T, int D>
struct Smem {
  static constexpr int kBlockK = Tiles<D>::kBlockK;
  float2 ks[2][kBlockK * D];   // split tiles, swizzled, double-buffered
  float2 vs[2][kBlockK * D];
  T k_raw[2][kBlockK * D];     // raw copies of the next key tiles
  T v_raw[2][kBlockK * D];
  // q's split tile at D = 128; at D = 64 it is staged in ks, both buffers.
  float2 qs[Tiles<D>::kResident ? 1 : kBlockQ * D];
};

// Starts the copy of key tile k0, its k and v rows, into raw buffer buf.
template <typename T, int D>
__device__ __forceinline__ void stage_kv(Smem<T, D>& sm, int buf,
                                         const T* kb, const T* vb,
                                         int64_t k_l, int64_t v_l, int k0,
                                         int Lk) {
  constexpr int kBlockK = Tiles<D>::kBlockK;
  constexpr int kChunks = D / 4;          // 4-element chunks a row
  constexpr int kRows = kThreads / kChunks;   // rows a pass copies
  static_assert(kBlockK % kRows == 0, "whole passes");
  const int r0 = threadIdx.x / kChunks;
  const int c = (threadIdx.x % kChunks) * 4;
  const T* k_row = kb + (k0 + r0) * k_l + c;
  const T* v_row = vb + (k0 + r0) * v_l + c;
#pragma unroll
  for (int i = 0; i < kBlockK / kRows; ++i) {
    const int r = r0 + i * kRows;
    const bool in = k0 + r < Lk;
    t2r::cp_async4(&sm.k_raw[buf][r * D + c], in ? k_row : kb, in);
    t2r::cp_async4(&sm.v_raw[buf][r * D + c], in ? v_row : vb, in);
    k_row += kRows * k_l;
    v_row += kRows * v_l;
  }
  t2r::cp_async_commit();
}

// Splits raw key tile buf into the split tiles of buffer buf.
template <typename T, int D, int kPasses>
__device__ __forceinline__ void split_kv(Smem<T, D>& sm, int buf) {
  constexpr int kBlockK = Tiles<D>::kBlockK;
  constexpr int kChunks = D / 4;
  constexpr int kRows = kThreads / kChunks;
  const int r0 = threadIdx.x / kChunks;
  const int c = (threadIdx.x % kChunks) * 4;
#pragma unroll
  for (int i = 0; i < kBlockK / kRows; ++i) {
    const int r = r0 + i * kRows;
    // The swizzle reads a row's low 4 bits: one value a lane at kRows = 16.
    const int split = r * D + (c ^ t2r::swz(r0 + i * kRows % 16));
    t2r::store_split4<kPasses>(&sm.ks[buf][split],
                               t2r::to_float4(&sm.k_raw[buf][r * D + c]));
    t2r::store_split4<kPasses>(&sm.vs[buf][split],
                               t2r::to_float4(&sm.v_raw[buf][r * D + c]));
  }
}

// One {big, small} element of a split tile at a shared-memory address.
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// Where this lane's fragment elements lie in a swizzled split tile of D
// columns (flash_tile.cuh), as byte offsets. The swizzle of row r depends on
// r's low 3 bits and the parity of r / 8 alone, and it moves 4-column groups
// within 16 columns, so an element's offset is one of 8 per-lane values plus
// a constant of the unrolled loops:
//   rows 8j + g, columns 8kk + t + 4e (A of q, B of s from k):
//     8 (8 j D + 16 (kk / 2)) + rows[j % 2][kk % 2][e]
//   rows 8j + 2t + u, columns 8n + g (B of p v from v):
//     8 (8 j D + 16 (n / 2)) + cols[j % 2][n % 2][u]
template <int D>
struct FragOffsets {
  uint32_t rows[2][2][2];
  uint32_t cols[2][2][2];

  __device__ __forceinline__ FragOffsets(int g, int t) {
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * jp + g;
          rows[jp][kp][e] =
              8 * (g * D + t + ((8 * kp + 4 * e) ^ t2r::swz(r)));
          const int r2 = 8 * jp + 2 * t + e;
          cols[jp][kp][e] =
              8 * ((2 * t + e) * D + ((8 * kp + g) ^ t2r::swz(r2)));
        }
      }
    }
  }
  // Row 8j + g, column 8kk + t + 4e (j, kk and e constants of unrolled
  // loops).
  __device__ __forceinline__ float2 by_row(uint32_t tile, int j, int kk,
                                           int e) const {
    return lds2(tile + rows[j % 2][kk % 2][e] +
                8 * (8 * j * D + 16 * (kk / 2)));
  }
  // Row 8j + 2t + u, column 8n + g.
  __device__ __forceinline__ float2 by_key(uint32_t tile, int j, int n,
                                           int u) const {
    return lds2(tile + cols[j % 2][n % 2][u] +
                8 * (8 * j * D + 16 * (n / 2)));
  }
};

// The A fragment of rows g and g + 8, columns 8kk + t and 8kk + t + 4, of
// a split tile (t = lane % 4, g = lane / 4 as in tf32_mma.cuh).
template <int D>
__device__ __forceinline__ void load_a(t2r::Frag<4>& a,
                                       const FragOffsets<D>& frag,
                                       uint32_t tile, int kk) {
  a.set(0, frag.by_row(tile, 0, kk, 0));
  a.set(1, frag.by_row(tile, 1, kk, 0));
  a.set(2, frag.by_row(tile, 0, kk, 1));
  a.set(3, frag.by_row(tile, 1, kk, 1));
}

// 2^x in one instruction (relative error near 2^-22); 0 for x below -126,
// so 0 for a masked score, which the guards zero as well.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D, int kPasses>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk, Strides st,
                 float scale, int causal) {
  constexpr int kBlockK = Tiles<D>::kBlockK;
  constexpr bool kResident = Tiles<D>::kResident;
  constexpr int kChunks = D / 4;
  constexpr int kSteps = D / 8;          // k steps of s, n tiles of o
  constexpr int kKeySteps = kBlockK / 8; // n tiles of s, k steps of p v
  constexpr int kHeld = kResident ? kSteps : 1;
  constexpr int kGroup = 8;              // n tiles of o a pass runs over
  static_assert(kSteps % kGroup == 0, "D is a multiple of 64");
  static_assert(!kResident || 2 * kBlockK >= kBlockQ,
                "q's split tile is staged in ks and vs");
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_bytes);
  float2* qs = kResident ? sm.ks[0] : sm.qs;

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
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;

  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Key tiles whose first key lies past the block's last query are all
    // masked (tiles are aligned from position 0).
    n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);
  }
  // Key tiles 0 and 1 in flight (tile 1 past Lk or past the causal end
  // is zero-filled or unused).
  stage_kv(sm, 0, kb, vb, st.k_l, st.v_l, 0, Lk);
  stage_kv(sm, 1, kb, vb, st.k_l, st.v_l, kBlockK, Lk);
  for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const float4 qv = q0 + r < Lq
                          ? t2r::to_float4(qb + (q0 + r) * st.q_l + c)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    t2r::store_split4<kPasses>(&qs[r * D + (c ^ t2r::swz(r))], qv);
  }

  const int qr = warp * 16 + g;   // this lane's query rows qr and qr + 8
  const FragOffsets<D> frag(g, t);
  // The warp's 16 rows of q's split tile.
  const uint32_t q_tile = t2r::smem_u32(qs + warp * 16 * D);
  // The warp's q A fragments, held across key tiles at D = 64. The barrier
  // before key tile 0's split keeps ks until every warp has read them.
  t2r::Frag<4> aq_held[kHeld];
  if (kResident) {
    __syncthreads();  // q's split tile is ready
#pragma unroll
    for (int kk = 0; kk < kHeld; ++kk) {
      load_a<D>(aq_held[kk], frag, q_tile, kk);
    }
  }

  t2r::cp_async_wait_one();   // key tile 0
  __syncthreads();  // tile 0 has landed; q's fragments are read
  split_kv<T, D, kPasses>(sm, 0);

  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.0f, 0.0f};
  const int warp_first_q = q0 + warp * 16;
  const int warp_last_q = warp_first_q + 15;

  for (int tile = 0; tile < n_k; ++tile) {
    const int k0 = tile * kBlockK;
    t2r::cp_async_wait_all();   // key tile + 1
    // Split tile `tile` is ready, key tile + 1 has landed, and every warp
    // has ended the last tile's products and splits.
    __syncthreads();
    if (tile + 1 < n_k) split_kv<T, D, kPasses>(sm, (tile + 1) & 1);
    if (tile + 2 < n_k) {
      stage_kv(sm, tile & 1, kb, vb, st.k_l, st.v_l, k0 + 2 * kBlockK, Lk);
    }
    const uint32_t k_tile = t2r::smem_u32(sm.ks[tile & 1]);
    const uint32_t v_tile = t2r::smem_u32(sm.vs[tile & 1]);
    if (causal && warp_last_q < k0) continue;

    // s = q k^T: this warp's 16 queries x kBlockK keys, n tiles of 8 keys.
    // Each pass runs over all the n tiles before the next, so that two
    // products on one accumulator are kKeySteps apart.
    float s[kKeySteps][4];
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      t2r::Frag<4> aq_tile;
      if (!kResident) load_a<D>(aq_tile, frag, q_tile, kk);
      const t2r::Frag<4>& aq = kResident ? aq_held[kk % kHeld] : aq_tile;
      t2r::Frag<2> bk[kKeySteps];
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        bk[j].set(0, frag.by_row(k_tile, j, kk, 0));
        bk[j].set(1, frag.by_row(k_tile, j, kk, 1));
      }
      if (kPasses == 3) {
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
          t2r::mma_tf32(s[j], aq.small, bk[j].big);
        }
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
          t2r::mma_tf32(s[j], aq.big, bk[j].small);
        }
      }
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        t2r::mma_tf32(s[j], aq.big, bk[j].big);
      }
    }

    // The online softmax on the fragments: element i of n tile j is query
    // qr + 8 (i >> 1), key k0 + 8 j + 2 t + (i & 1). Only a tile that
    // crosses the diagonal or the end of the keys is masked.
    const bool masked = k0 + kBlockK > Lk ||
                        (causal && k0 + kBlockK - 1 > warp_first_q);
    const float to_log2 = scale * kLog2e;   // scores in base-2 units
    if (masked) {
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q_pos = q0 + qr + 8 * (i >> 1);
          const int k_pos = k0 + 8 * j + 2 * t + (i & 1);
          s[j][i] = k_pos >= Lk || (causal && q_pos < k_pos)
                        ? kNegInf
                        : s[j][i] * to_log2;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= to_log2;
      }
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        row_max = fmaxf(row_max, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      }
      const float m_new = fmaxf(m_row[half], quad_max(row_max));
      const float safe_m = m_new <= kNegInf / 2 ? 0.0f : m_new;
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * half + e];
          const float p = x <= kNegInf / 2 ? 0.0f : exp2_approx(x - safe_m);
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

    // acc = acc * corr + p v over the tile's keys, 8 a k step: the
    // accumulator fragment of n tile j is the A fragment of k step j, its
    // key 2t in slot t and 2t + 1 in slot t + 4. kGroup n tiles of o at a
    // time (all of them at D = 64), pass by pass; the tile's sums start
    // from zero.
#pragma unroll
    for (int n0 = 0; n0 < kSteps; n0 += kGroup) {
      float part[kGroup][4];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[n][i] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        t2r::Frag<4> ap;   // p is float32: both halves in every type
        ap.split<3>(0, s[j][0]);
        ap.split<3>(1, s[j][2]);
        ap.split<3>(2, s[j][1]);
        ap.split<3>(3, s[j][3]);
        t2r::Frag<2> bv[kGroup];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          bv[n].set(0, frag.by_key(v_tile, j, n0 + n, 0));
          bv[n].set(1, frag.by_key(v_tile, j, n0 + n, 1));
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          t2r::mma_tf32(part[n], ap.small, bv[n].big);
        }
        if (kPasses == 3) {
#pragma unroll
          for (int n = 0; n < kGroup; ++n) {
            t2r::mma_tf32(part[n], ap.big, bv[n].small);
          }
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          t2r::mma_tf32(part[n], ap.big, bv[n].big);
        }
      }
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[n0 + n][i] = acc[n0 + n][i] * corr[i >> 1] + part[n][i];
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q_pos = q0 + qr + 8 * half;
    if (q_pos >= Lq) continue;
    const float l_final = fmaxf(l_row[half], 1e-20f);
    T* dst = o + ((static_cast<int64_t>(b) * Lq + q_pos) * H + h) * D;
#pragma unroll
    for (int n = 0; n < kSteps; ++n) {
      t2r::store2<T>(dst + 8 * n + 2 * t, acc[n][2 * half] / l_final,
                     acc[n][2 * half + 1] / l_final);
    }
    if (t == 0) {
      lse[static_cast<int64_t>(bh) * Lq + q_pos] =
          m_row[half] * kLn2 + logf(l_final);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Lq, int Lk, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int kPasses = sizeof(T) == 4 ? 3 : 1;
  const int bytes = static_cast<int>(sizeof(Smem<T, D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kPasses>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D, kPasses><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Lq, Lk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, Lq, H, D], k and v: [B, Lk, H, D], all float32 or all bfloat16,
// given by element strides (batch, head, row) with unit stride along D and
// 16-byte aligned rows; o: contiguous [B, Lq, H, D] of the inputs' type;
// lse: contiguous float32 [B, H, Lq]. D is 64 or 128. Returns
// cudaGetLastError() after the launch (0 on success), or 1
// (cudaErrorInvalidValue) for a D the kernel was not built for.
int t2r_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Lq, int Lk,
                            int D, long long q_sb, long long q_sh,
                            long long q_sl, long long k_sb, long long k_sh,
                            long long k_sl, long long v_sb, long long v_sh,
                            long long v_sl, float scale, int causal,
                            int bf16, void* stream) {
  const Strides st = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Lq, Lk,
                                            st, scale, causal, s)
                : launch<float, 64>(q, k, v, o, lse, B, H, Lq, Lk, st, scale,
                                    causal, s);
  }
  if (D == 128) {
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Lq, Lk,
                                             st, scale, causal, s)
                : launch<float, 128>(q, k, v, o, lse, B, H, Lq, Lk, st,
                                     scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
