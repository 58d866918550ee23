// The flash attention forward's float32 tile loop, shared by
// flash_attention_fwd.cu (K4: O and LSE from scratch) and
// flash_attention_carry.cu (K6: one update of a carried, unnormalized
// (o, m, l) at global offsets). The design is described in
// flash_attention_fwd.cu's header; K6's additions in
// flash_attention_carry.cu's. The bfloat16 instances of both are a kernel
// of their own (flash_fwd_bf16.cuh).
//
// One kernel template, two instances: kCarry false is K4, kCarry true is K6.
// K6's differences are its state in and out (`if constexpr (kCarry)`) and
// its causal mask at an offset: key c of the block is hidden from query r
// when r + delta < c, delta = q_offset - k_offset. K4's instance takes
// delta = 0 as a constant, so its code is what it was before K6 shared it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tile.cuh"
#include "tf32_mma.cuh"

namespace t2r {
namespace fwd {
// Internal linkage, as each kernel library is one translation unit: the
// compiler then builds K4 as it did before K6 shared its loop.
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

template <int D>
struct Smem {
  static constexpr int kBlockK = Tiles<D>::kBlockK;
  float2 ks[2][kBlockK * D];   // split tiles, swizzled, double-buffered
  float2 vs[2][kBlockK * D];
  float k_raw[2][kBlockK * D];   // raw copies of the next key tiles
  float v_raw[2][kBlockK * D];
  // q's split tile at D = 128; at D = 64 it is staged in ks, both buffers.
  float2 qs[Tiles<D>::kResident ? 1 : kBlockQ * D];
};

// Starts the copy of key tile k0, its k and v rows, into raw buffer buf.
template <int D>
__device__ __forceinline__ void stage_kv(Smem<D>& sm, int buf,
                                         const float* kb, const float* vb,
                                         int64_t k_l, int64_t v_l, int k0,
                                         int Lk) {
  constexpr int kBlockK = Tiles<D>::kBlockK;
  constexpr int kChunks = D / 4;          // 4-element chunks a row
  constexpr int kRows = kThreads / kChunks;   // rows a pass copies
  static_assert(kBlockK % kRows == 0, "whole passes");
  const int r0 = threadIdx.x / kChunks;
  const int c = (threadIdx.x % kChunks) * 4;
  const float* k_row = kb + (k0 + r0) * k_l + c;
  const float* v_row = vb + (k0 + r0) * v_l + c;
#pragma unroll
  for (int i = 0; i < kBlockK / kRows; ++i) {
    const int r = r0 + i * kRows;
    const bool in = k0 + r < Lk;
    cp_async4(&sm.k_raw[buf][r * D + c], in ? k_row : kb, in);
    cp_async4(&sm.v_raw[buf][r * D + c], in ? v_row : vb, in);
    k_row += kRows * k_l;
    v_row += kRows * v_l;
  }
  cp_async_commit();
}

// Splits raw key tile buf into the split tiles of buffer buf.
template <int D>
__device__ __forceinline__ void split_kv(Smem<D>& sm, int buf) {
  constexpr int kBlockK = Tiles<D>::kBlockK;
  constexpr int kChunks = D / 4;
  constexpr int kRows = kThreads / kChunks;
  const int r0 = threadIdx.x / kChunks;
  const int c = (threadIdx.x % kChunks) * 4;
#pragma unroll
  for (int i = 0; i < kBlockK / kRows; ++i) {
    const int r = r0 + i * kRows;
    // The swizzle reads a row's low 4 bits: one value a lane at kRows = 16.
    const int split = r * D + (c ^ swz(r0 + i * kRows % 16));
    store_split4<3>(&sm.ks[buf][split],
                    to_float4(&sm.k_raw[buf][r * D + c]));
    store_split4<3>(&sm.vs[buf][split],
                    to_float4(&sm.v_raw[buf][r * D + c]));
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
          rows[jp][kp][e] = 8 * (g * D + t + ((8 * kp + 4 * e) ^ swz(r)));
          const int r2 = 8 * jp + 2 * t + e;
          cols[jp][kp][e] =
              8 * ((2 * t + e) * D + ((8 * kp + g) ^ swz(r2)));
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
__device__ __forceinline__ void load_a(Frag<4>& a, const FragOffsets<D>& frag,
                                       uint32_t tile, int kk) {
  a.set(0, frag.by_row(tile, 0, kk, 0));
  a.set(1, frag.by_row(tile, 1, kk, 0));
  a.set(2, frag.by_row(tile, 0, kk, 1));
  a.set(3, frag.by_row(tile, 1, kk, 1));
}

// K4: o is O, stat the LSE; l_state and delta_in are unused (K6's, last,
// so that K4's parameters lie where they did before K6 shared the loop).
// K6: o, stat (m) and l_state are the carried state, read and written in
// place; delta_in = q_offset - k_offset, clamped to [-Lq, Lk] by the caller.
template <int D, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ stat, int H, int Lq, int Lk, Strides st,
                 float scale, int causal, float* __restrict__ l_state,
                 int delta_in) {
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
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_bytes);
  float2* qs = kResident ? sm.ks[0] : sm.qs;
  // Key c is hidden from query r when causal and r + delta < c.
  const int delta = kCarry ? delta_in : 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int n_q = (Lq + kBlockQ - 1) / kBlockQ;
  const int q0 = (n_q - 1 - blockIdx.y) * kBlockQ;  // longest causal first
  // The block's first query as a key position, which the causal mask
  // compares with keys. Added here, outside the loop: an add of K4's 0 in
  // the loop's conditions made the compiler lay them out with branches.
  const int q0k = q0 + delta;
  const int b = bh / H;
  const int h = bh % H;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;

  if constexpr (kCarry) {
    // Every query of the block precedes the block's first key: the carried
    // state is already the answer, and nothing is read or written.
    if (causal && min(q0 + kBlockQ, Lq) - 1 + delta < 0) return;
  }
  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Key tiles whose first key lies past the block's last query are all
    // masked (tiles are aligned from key 0).
    n_k = min(n_k, (q0k + kBlockQ - 1) / kBlockK + 1);
  }
  // Key tiles 0 and 1 in flight (tile 1 past Lk or past the causal end
  // is zero-filled or unused).
  stage_kv(sm, 0, kb, vb, st.k_l, st.v_l, 0, Lk);
  stage_kv(sm, 1, kb, vb, st.k_l, st.v_l, kBlockK, Lk);
  for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const float4 qv = q0 + r < Lq
                          ? to_float4(qb + (q0 + r) * st.q_l + c)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    store_split4<3>(&qs[r * D + (c ^ swz(r))], qv);
  }

  const int qr = warp * 16 + g;   // this lane's query rows qr and qr + 8
  const FragOffsets<D> frag(g, t);
  // The warp's 16 rows of q's split tile.
  const uint32_t q_tile = smem_u32(qs + warp * 16 * D);
  // The warp's q A fragments, held across key tiles at D = 64. The barrier
  // before key tile 0's split keeps ks until every warp has read them.
  Frag<4> aq_held[kHeld];
  if (kResident) {
    __syncthreads();  // q's split tile is ready
#pragma unroll
    for (int kk = 0; kk < kHeld; ++kk) {
      load_a<D>(aq_held[kk], frag, q_tile, kk);
    }
  }

  cp_async_wait_one();   // key tile 0
  __syncthreads();  // tile 0 has landed; q's fragments are read
  split_kv<D>(sm, 0);

  float acc[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.0f, 0.0f};
  if constexpr (kCarry) {
    // The carried state of rows qr and qr + 8, m in base-2 units (the
    // NEG_INF sentinel kept as it is); rows past Lq are not read.
    const int64_t row0 = static_cast<int64_t>(bh) * Lq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q_pos = q0 + qr + 8 * half;
      if (q_pos >= Lq) continue;
      const float* src = o + (row0 + q_pos) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(src + 8 * n);
        acc[n][2 * half] = x.x;
        acc[n][2 * half + 1] = x.y;
      }
      const float m = stat[row0 + q_pos];
      m_row[half] = m <= kNegInf / 2 ? kNegInf : m * kLog2e;
      l_row[half] = l_state[row0 + q_pos];
    }
  }
  const int warp_first_q = q0k + warp * 16;   // as key positions
  const int warp_last_q = warp_first_q + 15;

  for (int tile = 0; tile < n_k; ++tile) {
    const int k0 = tile * kBlockK;
    cp_async_wait_all();   // key tile + 1
    // Split tile `tile` is ready, key tile + 1 has landed, and every warp
    // has ended the last tile's products and splits.
    __syncthreads();
    if (tile + 1 < n_k) split_kv<D>(sm, (tile + 1) & 1);
    if (tile + 2 < n_k) {
      stage_kv(sm, tile & 1, kb, vb, st.k_l, st.v_l, k0 + 2 * kBlockK, Lk);
    }
    const uint32_t k_tile = smem_u32(sm.ks[tile & 1]);
    const uint32_t v_tile = smem_u32(sm.vs[tile & 1]);
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
      Frag<4> aq_tile;
      if (!kResident) load_a<D>(aq_tile, frag, q_tile, kk);
      const Frag<4>& aq = kResident ? aq_held[kk % kHeld] : aq_tile;
      Frag<2> bk[kKeySteps];
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        bk[j].set(0, frag.by_row(k_tile, j, kk, 0));
        bk[j].set(1, frag.by_row(k_tile, j, kk, 1));
      }
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        mma_tf32(s[j], aq.small, bk[j].big);
      }
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        mma_tf32(s[j], aq.big, bk[j].small);
      }
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) {
        mma_tf32(s[j], aq.big, bk[j].big);
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
          const int q_pos = q0k + qr + 8 * (i >> 1);
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
        Frag<4> ap;   // p is float32: both halves
        ap.split<3>(0, s[j][0]);
        ap.split<3>(1, s[j][2]);
        ap.split<3>(2, s[j][1]);
        ap.split<3>(3, s[j][3]);
        Frag<2> bv[kGroup];
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          bv[n].set(0, frag.by_key(v_tile, j, n0 + n, 0));
          bv[n].set(1, frag.by_key(v_tile, j, n0 + n, 1));
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          mma_tf32(part[n], ap.small, bv[n].big);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          mma_tf32(part[n], ap.big, bv[n].small);
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          mma_tf32(part[n], ap.big, bv[n].big);
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

  if constexpr (kCarry) {
    // A warp that took no key tile leaves its rows as they were; the others
    // write o unnormalized, m back in natural-log units, and l.
    if (causal && warp_last_q < 0) return;
    const int64_t row0 = static_cast<int64_t>(bh) * Lq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q_pos = q0 + qr + 8 * half;
      if (q_pos >= Lq) continue;
      float* dst = o + (row0 + q_pos) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        store2<float>(dst + 8 * n, acc[n][2 * half], acc[n][2 * half + 1]);
      }
      if (t == 0) {
        const float m = m_row[half];
        stat[row0 + q_pos] = m <= kNegInf / 2 ? kNegInf : m * kLn2;
        l_state[row0 + q_pos] = l_row[half];
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q_pos = q0 + qr + 8 * half;
      if (q_pos >= Lq) continue;
      const float l_final = fmaxf(l_row[half], 1e-20f);
      float* dst = o + ((static_cast<int64_t>(b) * Lq + q_pos) * H + h) * D;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        store2<float>(dst + 8 * n + 2 * t, acc[n][2 * half] / l_final,
                      acc[n][2 * half + 1] / l_final);
      }
      if (t == 0) {
        stat[static_cast<int64_t>(bh) * Lq + q_pos] =
            m_row[half] * kLn2 + logf(l_final);
      }
    }
  }
}

// Sets the kernel's shared memory and launches it on a (B H, query tiles)
// grid; returns cudaGetLastError().
template <int D, bool kCarry>
int launch(const void* q, const void* k, const void* v, void* o, void* stat,
           void* l_state, int B, int H, int Lq, int Lk, const Strides& st,
           float scale, int causal, int delta, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kCarry>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<D, kCarry><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(stat), H, Lq, Lk, st, scale, causal,
      static_cast<float*>(l_state), delta);
  return static_cast<int>(cudaGetLastError());
}

// Launches the float32 instance of head dim D (64 or 128); 1
// (cudaErrorInvalidValue) for another D.
template <bool kCarry>
int launch_any(const void* q, const void* k, const void* v, void* o,
               void* stat, void* l_state, int B, int H, int Lq, int Lk, int D,
               const Strides& st, float scale, int causal, int delta,
               cudaStream_t s) {
  if (D == 64) {
    return launch<64, kCarry>(q, k, v, o, stat, l_state, B, H, Lq, Lk, st,
                              scale, causal, delta, s);
  }
  if (D == 128) {
    return launch<128, kCarry>(q, k, v, o, stat, l_state, B, H, Lq, Lk, st,
                               scale, causal, delta, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace fwd
}  // namespace t2r
