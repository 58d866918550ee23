// Flash attention carry: one unnormalized online-softmax update of a carried
// (o, m, l) with a new k/v block, at global positions. The inner step of
// ring attention: each hop folds the k/v block that has just arrived into
// the running state, and the ring normalizes once after the last hop.
//
// Replaces the TPU kernel tensor2robot_tpu/parallel/flash_attention.py
// `flash_attention_carry` (kernel body `_flash_carry_kernel`, block update
// `_block_update`). For each batch-head bh and query row r:
//
//   s[c]  = (q[r] . k[c]) * scale                      (float32)
//   s[c]  = NEG_INF where causal and q_offset + r < k_offset + c
//   m'    = max(m, max_c s);  safe = m' <= NEG_INF/2 ? 0 : m'
//   p     = s <= NEG_INF/2 ? 0 : exp(s - safe)
//   corr  = m <= NEG_INF/2 ? 0 : exp(m - safe)
//   l     = l * corr + sum p;   o = o * corr + p @ v;   m = m'
//
// folded over k/v tiles of 64 rows, exactly the arithmetic of
// `_block_update`. The state is read and written IN PLACE: o float32
// [B, H, Lq, D], m and l float32 [B, H, Lq], all contiguous. Each block owns
// its query rows, so no two blocks touch one row.
//
// q, k and v are [B, L, H, D] views given by their strides (b, h, l; d is
// unit stride), as K4 reads them.
//
// What bounds it on an H100: operations. A full hop of ring attention at
// 4 ranks ([32, 1024, 8, 64] a shard) does 68.7 GFLOP of float32 products
// over 134 MB of k and v, some 500 operations a byte. Like K4, from which it
// is derived, this first version runs them as float32 FMAs on the CUDA cores;
// wgmma and TMA are later work. Its design is K4's:
//   * one block of 256 threads per (bh, tile of 64 query rows); k and v
//     tiles of 64 rows stream through shared memory; each thread owns a 4x4
//     block of the score tile and a 4 x D/16 block of the accumulator, which
//     it loads from o at the start and stores back at the end;
//   * under the causal mask a tile stops at the last k tile that holds a
//     position at or before its last query's, and a tile whose queries all
//     precede the block's first key (every tile of a hop above the diagonal)
//     returns before it reads anything: its state is already the answer.
// Shared memory as K4's: (2 D + 64) * 68 + 64 D floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPad = 4;  // keeps transposed rows 16-byte aligned
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int smem_floats(int d) {
  return d * (kBlockQ + kPad) + d * (kBlockK + kPad) + kBlockK * d +
         kBlockK * (kBlockQ + kPad);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int offset = 8; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_carry_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ m_state, float* __restrict__ l_state,
                   int H, int Lq, int Lk, int64_t q_sb, int64_t q_sh,
                   int64_t q_sl, int64_t k_sb, int64_t k_sh, int64_t k_sl,
                   int64_t v_sb, int64_t v_sh, int64_t v_sl, float scale,
                   int causal, int64_t q_offset, int64_t k_offset) {
  constexpr int kGroups = D / 64;  // float4 column groups of o per thread
  constexpr int kQRow = kBlockQ + kPad;
  constexpr int kKRow = kBlockK + kPad;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // key columns tx*4 .. tx*4+3
  const int n_q = (Lq + kBlockQ - 1) / kBlockQ;
  const int q_tile = n_q - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = q_tile * kBlockQ;
  const int bh = blockIdx.y;

  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Keys past the tile's last query position are all masked: the tile
    // needs the k tiles up to the one holding that position.
    const int64_t last = q_offset + min(q0 + kBlockQ, Lq) - 1 - k_offset;
    if (last < 0) return;  // the whole tile is masked: the state stands
    n_k = static_cast<int>(
        min(static_cast<int64_t>(n_k), last / kBlockK + 1));
  }

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                    // [D][kQRow]
  float* kt = qt + D * kQRow;          // [D][kKRow]
  float* vs = kt + D * kKRow;          // [kBlockK][D]
  float* pt = vs + kBlockK * D;        // [kBlockK][kQRow]

  const int b = bh / H;
  const int h = bh % H;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  float* ob = o + static_cast<int64_t>(bh) * Lq * D;
  float* mb = m_state + static_cast<int64_t>(bh) * Lq;
  float* lb = l_state + static_cast<int64_t>(bh) * Lq;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qt[d * kQRow + r] =
        q0 + r < Lq ? to_float(qb[(q0 + r) * q_sl + d]) : 0.0f;
  }

  // The carried state of this thread's rows; rows past Lq start empty and
  // are never written back.
  float m[4], l[4], acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < Lq;
    m[i] = in ? mb[row] : kNegInf;
    l[i] = in ? lb[row] : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 a =
          in ? *reinterpret_cast<const float4*>(
                   ob + static_cast<int64_t>(row) * D + g * 64 + tx * 4)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[i][g * 4] = a.x;
      acc[i][g * 4 + 1] = a.y;
      acc[i][g * 4 + 2] = a.z;
      acc[i][g * 4 + 3] = a.w;
    }
  }

  for (int kt_i = 0; kt_i < n_k; ++kt_i) {
    const int k0 = kt_i * kBlockK;
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Lk;
      kt[d * kKRow + r] = in ? to_float(kb[(k0 + r) * k_sl + d]) : 0.0f;
      vs[r * D + d] = in ? to_float(vb[(k0 + r) * v_sl + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kQRow +
                                                        ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kKRow +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q_offset + q0 + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (c >= Lk || (causal && q_pos < k_offset + c)) x = kNegInf;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      row_max = half_warp_max(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float safe_m = m_new <= kNegInf / 2 ? 0.0f : m_new;
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= kNegInf / 2 ? 0.0f : expf(s[i][j] - safe_m);
        s[i][j] = p;
        row_sum += p;
      }
      row_sum = half_warp_sum(row_sum);
      const float corr = m[i] <= kNegInf / 2 ? 0.0f : expf(m[i] - safe_m);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * kGroups; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kQRow + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pt + c * kQRow +
                                                        ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(vs + c * D +
                                                          g * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][g * 4 + j] = fmaf(av[i], wv[j], acc[i][g * 4 + j]);
          }
        }
      }
    }
    __syncthreads();  // k, v and p are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      *reinterpret_cast<float4*>(ob + static_cast<int64_t>(row) * D +
                                 g * 64 + tx * 4) =
          make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                      acc[i][g * 4 + 3]);
    }
    if (tx == 0) {
      mb[row] = m[i];
      lb[row] = l[i];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, int B, int H, int Lq, int Lk, const int64_t* strides,
           float scale, int causal, int64_t q_offset, int64_t k_offset,
           cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t status = cudaFuncSetAttribute(
      flash_carry_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  flash_carry_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), H, Lq, Lk, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5], strides[6],
      strides[7], strides[8], scale, causal, q_offset, k_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, Lq, H, D], k and v: [B, Lk, H, D], all float32 or all bfloat16,
// given by element strides (batch, head, row) with unit stride along D;
// o: contiguous float32 [B, H, Lq, D]; m, l: contiguous float32 [B, H, Lq],
// all three updated in place. q_offset and k_offset are the global positions
// of q's and k's first rows. D is 64 or 128. Returns cudaGetLastError()
// after the launch (0 on success), or 1 (cudaErrorInvalidValue) for a D the
// kernel was not built for.
int t2r_flash_attention_carry(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int B, int H, int Lq,
                              int Lk, int D, long long q_sb, long long q_sh,
                              long long q_sl, long long k_sb, long long k_sh,
                              long long k_sl, long long v_sb, long long v_sh,
                              long long v_sl, float scale, int causal,
                              long long q_offset, long long k_offset,
                              int bf16, void* stream) {
  const int64_t strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh,
                              k_sl, v_sb, v_sh, v_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, m, l, B, H, Lq, Lk,
                                            strides, scale, causal, q_offset,
                                            k_offset, s)
                : launch<float, 64>(q, k, v, o, m, l, B, H, Lq, Lk, strides,
                                    scale, causal, q_offset, k_offset, s);
  }
  if (D == 128) {
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, m, l, B, H, Lq, Lk,
                                             strides, scale, causal,
                                             q_offset, k_offset, s)
                : launch<float, 128>(q, k, v, o, m, l, B, H, Lq, Lk, strides,
                                     scale, causal, q_offset, k_offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
