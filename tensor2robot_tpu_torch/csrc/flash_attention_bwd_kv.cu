// Flash attention backward, dK and dV: the gradient of exact softmax
// attention with respect to the keys and values, recomputing the
// probabilities from the forward's per-row log-sum-exp.
//
// Replaces the TPU kernel tensor2robot_tpu/parallel/flash_attention.py
// `_flash_bwd_kv_kernel` (launched by `_flash_bwd_pallas`, block recompute
// `_bwd_p_ds`). For each batch-head bh, key row c and query row r:
//
//   s[r][c]  = (q[r] . k[c]) * scale                       (float32)
//   p[r][c]  = exp(s[r][c] - lse[r]), and 0 where causal and r < c, or
//              where r >= Lq or c >= Lk (a ragged tail)
//   dp[r][c] = dO[r] . v[c]
//   ds[r][c] = p[r][c] * (dp[r][c] - delta[r]) * scale
//   dv[c]    = sum_r p[r][c] dO[r]
//   dk[c]    = sum_r ds[r][c] q[r]
//
// with delta[r] = dO[r] . o[r] computed before the launch (the JAX package
// computes it outside its kernels too), exactly the arithmetic of
// `_bwd_p_ds`, the causal mask at global positions (q_pos >= k_pos, no
// offset). dk and dv are written in the inputs' type.
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
// tiles are copied 4 elements at a time). dk and dv are written by strides
// too, with unit stride along D.
//
// What bounds the float32 instance on an H100: operations. At the training
// shape (B*H = 64, L = 4096, D = 64, causal) it does four products per unmasked (q, k) pair
// (s, dp, p^T dO, ds^T q), 275 GFLOP, over 0.4 GB of q, k, v, dO, dk and
// dv: some 700 operations a byte. 4.10 ms at the CUDA cores' 67 TFLOP/s
// float32 rate; 1.67 ms for the three TF32 passes of float32-grade products
// at the tensor cores' 495 TFLOP/s. The design:
//   * all four products on the tensor cores in float32 grade (tf32_mma.cuh):
//     each operand is split once into TF32 big and small halves, and
//     mma.sync m16n8k8 sums small*big + big*small + big*big in float32;
//   * one block of 4 warps per (bh, tile of 64 key rows), each warp owning
//     16 keys. k and v are split once into shared memory and stay there; dK
//     and dV are accumulated in registers and written once, at the end,
//     without atomics, in a fixed order: the same bits run to run. The block
//     loops over 32-row query tiles (the Pallas kernel's sequential grid
//     axis), starting under the causal mask at the first tile that reaches
//     the diagonal; the grid issues the key tiles with the most work (the
//     first, under the causal mask) first;
//   * the next query tile's q, dO, lse and delta are in flight (cp.async,
//     zero-filled past Lq) while the tensor cores work on this one; each
//     tile is split once into float2 {big, small} rows whose 4-column
//     groups are XOR-swizzled by the row ((r ^ r >> 2) & 3), so that the
//     fragment loads below are free of bank conflicts;
//   * s^T = k q^T and dp^T = v dO^T are computed transposed (keys as the
//     rows), so their accumulator fragments, turned into p^T and ds^T in
//     registers, are the A operands of dv += p^T dO and dk += ds^T q as they
//     stand: the thread's two query columns (2t, 2t + 1) of a fragment become
//     its two k slots (t, t + 4), and the B fragments read dO and q rows
//     2t and 2t + 1 to match. p and ds never touch shared memory.
// Shared memory: 8 * D * (2 * 64 + 2 * 32) bytes of split tiles, 2 * 32 * D
// raw elements and 256 bytes of lse and delta: 112.5 KB at D = 64 (two
// blocks a SM), 224.5 KB at D = 128 (one), set per launch with
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_bf16.cuh"
#include "flash_tile.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBlockK = 64;   // key rows of a block
constexpr int kBlockQ = 32;   // query rows of a tile
constexpr int kThreads = 128; // 4 warps of 16 keys

struct Strides {
  int64_t q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l, o_b, o_h, o_l;
  int64_t dk_b, dk_h, dk_l, dv_b, dv_h, dv_l;
};

template <int D>
struct Smem {
  float2 ks[kBlockK * D];   // split tiles, swizzled
  float2 vs[kBlockK * D];
  float2 qs[kBlockQ * D];
  float2 os[kBlockQ * D];
  float q_raw[kBlockQ * D]; // raw copies of the next query tile
  float o_raw[kBlockQ * D];
  float lse_raw[kBlockQ];
  float delta_raw[kBlockQ];
  float lse[kBlockQ];       // this tile's
  float delta[kBlockQ];
};

// Starts the copy of query tile q0: q and dO rows, lse and delta.
template <int D>
__device__ __forceinline__ void stage_q(Smem<D>& sm, const float* qb,
                                        const float* ob, const float* lse_b,
                                        const float* delta_b, int64_t q_l,
                                        int64_t o_l, int q0, int Lq) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kBlockQ * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const bool in = q0 + r < Lq;
    t2r::cp_async4(&sm.q_raw[r * D + c], in ? qb + (q0 + r) * q_l + c : qb,
                   in);
    t2r::cp_async4(&sm.o_raw[r * D + c], in ? ob + (q0 + r) * o_l + c : ob,
                   in);
  }
  const int r = threadIdx.x % kBlockQ;
  const bool in = q0 + r < Lq;
  if (threadIdx.x < kBlockQ) {
    t2r::cp_async1(&sm.lse_raw[r], in ? lse_b + q0 + r : lse_b, in);
  } else if (threadIdx.x < 2 * kBlockQ) {
    t2r::cp_async1(&sm.delta_raw[r], in ? delta_b + q0 + r : delta_b, in);
  }
  t2r::cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Lq, int Lk, Strides st,
                    float scale, int causal) {
  constexpr int kPasses = 3;
  constexpr int kChunks = D / 4;
  constexpr int kN = D / 8;   // n tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_bytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k_tile = blockIdx.y;   // the first tiles have the most work
  const int k0 = k_tile * kBlockK;
  const int b = bh / H;
  const int h = bh % H;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const float* ob = d_out + b * st.o_b + h * st.o_h;
  const float* lse_b = lse + static_cast<int64_t>(bh) * Lq;
  const float* delta_b = delta + static_cast<int64_t>(bh) * Lq;

  const int n_q = (Lq + kBlockQ - 1) / kBlockQ;
  // Under the causal mask, query tiles that end before this tile's first
  // key see none of its keys: the first that reaches the diagonal starts at
  // k0 (tiles are aligned from position 0).
  const int q_start = causal ? k0 / kBlockQ : 0;
  if (q_start < n_q) {
    stage_q(sm, qb, ob, lse_b, delta_b, st.q_l, st.o_l, q_start * kBlockQ,
            Lq);
  }
  for (int e = tid; e < kBlockK * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    const bool in = k0 + r < Lk;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 kv = in ? t2r::to_float4(kb + (k0 + r) * st.k_l + c) : zero;
    const float4 vv = in ? t2r::to_float4(vb + (k0 + r) * st.v_l + c) : zero;
    t2r::store_split4<kPasses>(&sm.ks[r * D + (c ^ t2r::swz(r))], kv);
    t2r::store_split4<kPasses>(&sm.vs[r * D + (c ^ t2r::swz(r))], vv);
  }

  float dk_acc[kN][4], dv_acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dk_acc[n][i] = 0.0f;
      dv_acc[n][i] = 0.0f;
    }
  }
  const int kr = warp * 16 + g;   // this lane's key rows kr and kr + 8

  for (int tile = q_start; tile < n_q; ++tile) {
    const int q0 = tile * kBlockQ;
    t2r::cp_async_wait_all();
    __syncthreads();  // the copy has landed; the last tile's products ended
    for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e % kChunks) * 4;
      t2r::store_split4<kPasses>(&sm.qs[r * D + (c ^ t2r::swz(r))],
                                 t2r::to_float4(&sm.q_raw[r * D + c]));
      t2r::store_split4<kPasses>(&sm.os[r * D + (c ^ t2r::swz(r))],
                                 t2r::to_float4(&sm.o_raw[r * D + c]));
    }
    if (tid < kBlockQ) {
      sm.lse[tid] = sm.lse_raw[tid];
      sm.delta[tid] = sm.delta_raw[tid];
    }
    __syncthreads();  // split tiles ready; the raw buffers are free
    if (tile + 1 < n_q) {
      stage_q(sm, qb, ob, lse_b, delta_b, st.q_l, st.o_l, q0 + kBlockQ, Lq);
    }

    // s^T = k q^T and dp^T = v dO^T: this warp's 16 keys x 32 queries, four
    // n tiles of 8 queries each. Each pass runs over all eight products
    // before the next, so that two products on one accumulator are eight
    // apart.
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
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c0 = kk * 8 + t;
      t2r::Frag<4> ak, av;
      ak.set(0, t2r::at<D>(sm.ks, kr, c0));
      ak.set(1, t2r::at<D>(sm.ks, kr + 8, c0));
      ak.set(2, t2r::at<D>(sm.ks, kr, c0 + 4));
      ak.set(3, t2r::at<D>(sm.ks, kr + 8, c0 + 4));
      av.set(0, t2r::at<D>(sm.vs, kr, c0));
      av.set(1, t2r::at<D>(sm.vs, kr + 8, c0));
      av.set(2, t2r::at<D>(sm.vs, kr, c0 + 4));
      av.set(3, t2r::at<D>(sm.vs, kr + 8, c0 + 4));
      t2r::Frag<2> bq[4], bo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = 8 * j + g;
        bq[j].set(0, t2r::at<D>(sm.qs, qr, c0));
        bq[j].set(1, t2r::at<D>(sm.qs, qr, c0 + 4));
        bo[j].set(0, t2r::at<D>(sm.os, qr, c0));
        bo[j].set(1, t2r::at<D>(sm.os, qr, c0 + 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], ak.small, bq[j].big);
        t2r::mma_tf32(dp[j], av.small, bo[j].big);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], ak.big, bq[j].small);
        t2r::mma_tf32(dp[j], av.big, bo[j].small);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::mma_tf32(s[j], ak.big, bq[j].big);
        t2r::mma_tf32(dp[j], av.big, bo[j].big);
      }
    }

    // p^T and ds^T in place: element i of n tile j is key kr + 8 (i >> 1),
    // query 8 j + 2 t + (i & 1) of the tile.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = 8 * j + 2 * t + (i & 1);
        const int q_pos = q0 + qi;
        const int k_pos = k0 + kr + 8 * (i >> 1);
        const bool keep =
            q_pos < Lq && k_pos < Lk && !(causal && q_pos < k_pos);
        const float p = keep ? expf(s[j][i] * scale - sm.lse[qi]) : 0.0f;
        s[j][i] = p;
        dp[j][i] = p * (dp[j][i] - sm.delta[qi]) * scale;
      }
    }

    // dv += p^T dO and dk += ds^T q over the tile's 32 queries, 8 a k step:
    // the accumulator fragment of n tile j is the A fragment of k step j,
    // its query 2t in slot t and 2t + 1 in slot t + 4. Four n tiles of dv
    // and dk at a time, pass by pass; the tile's sums start from zero and
    // join the block's at its end, as the tensor cores' float32
    // accumulation keeps fewer bits than a rounded float32 add.
#pragma unroll
    for (int n0 = 0; n0 < kN; n0 += 4) {
      float pv[4][4], pk[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[n][i] = 0.0f;
          pk[n][i] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t2r::Frag<4> ap, ads;
        ap.split<kPasses>(0, s[j][0]);
        ap.split<kPasses>(1, s[j][2]);
        ap.split<kPasses>(2, s[j][1]);
        ap.split<kPasses>(3, s[j][3]);
        ads.split<kPasses>(0, dp[j][0]);
        ads.split<kPasses>(1, dp[j][2]);
        ads.split<kPasses>(2, dp[j][1]);
        ads.split<kPasses>(3, dp[j][3]);
        const int r0 = 8 * j + 2 * t;
        t2r::Frag<2> bo[4], bq[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * (n0 + n) + g;
          bo[n].set(0, t2r::at<D>(sm.os, r0, c));
          bo[n].set(1, t2r::at<D>(sm.os, r0 + 1, c));
          bq[n].set(0, t2r::at<D>(sm.qs, r0, c));
          bq[n].set(1, t2r::at<D>(sm.qs, r0 + 1, c));
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          t2r::mma_tf32(pv[n], ap.small, bo[n].big);
          t2r::mma_tf32(pk[n], ads.small, bq[n].big);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          t2r::mma_tf32(pv[n], ap.big, bo[n].small);
          t2r::mma_tf32(pk[n], ads.big, bq[n].small);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          t2r::mma_tf32(pv[n], ap.big, bo[n].big);
          t2r::mma_tf32(pk[n], ads.big, bq[n].big);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[n0 + n][i] += pv[n][i];
          dk_acc[n0 + n][i] += pk[n][i];
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k_pos = k0 + kr + 8 * half;
    if (k_pos >= Lk) continue;
    float* dk_row = dk + b * st.dk_b + h * st.dk_h + k_pos * st.dk_l;
    float* dv_row = dv + b * st.dv_b + h * st.dv_h + k_pos * st.dv_l;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int c = 8 * n + 2 * t;
      t2r::store2<float>(dk_row + c, dk_acc[n][2 * half],
                         dk_acc[n][2 * half + 1]);
      t2r::store2<float>(dv_row + c, dv_acc[n][2 * half],
                         dv_acc[n][2 * half + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* d_out,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Lq, int Lk, const Strides& st, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<D>));
  cudaError_t status = cudaFuncSetAttribute(
      flash_bwd_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(B * H, (Lk + kBlockK - 1) / kBlockK);
  flash_bwd_kv_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, st, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, d_out: [B, Lq, H, D]; k, v: [B, Lk, H, D]; all float32 or all
// bfloat16, given by element strides (batch, head, row) with unit stride
// along D. lse, delta: contiguous float32 [B, H, Lq]. dk, dv: [B, Lk, H, D]
// of the inputs' type, written by strides (batch, head, row), unit stride
// along D. D is 64 or 128. Returns cudaGetLastError() after the launch (0
// on success), or 1 (cudaErrorInvalidValue) for a D the kernel was not
// built for.
int t2r_flash_attention_bwd_kv(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Lq, int Lk, int D, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, long long o_sb, long long o_sh,
    long long o_sl, long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl, float scale,
    int causal, int bf16, void* stream) {
  const Strides st = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
                      o_sb, o_sh, o_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh,
                      dv_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? t2r::bwd_bf16::launch_kv<64>(q, k, v, d_out, lse, delta,
                                                dk, dv, B, H, Lq, Lk, st,
                                                scale, causal, s)
                : launch<64>(q, k, v, d_out, lse, delta, dk, dv, B, H, Lq,
                             Lk, st, scale, causal, s);
  }
  if (D == 128) {
    return bf16 ? t2r::bwd_bf16::launch_kv<128>(q, k, v, d_out, lse, delta,
                                                 dk, dv, B, H, Lq, Lk, st,
                                                 scale, causal, s)
                : launch<128>(q, k, v, d_out, lse, delta, dk, dv, B, H, Lq,
                              Lk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
