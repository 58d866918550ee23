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
// exactly the arithmetic of `_block_update` and `_finalize`, with the causal
// mask at global positions (q_pos >= k_pos, no offset).
//
// Inputs are [B, L, H, D] views given by their strides (b, h, l; d is unit
// stride), so the kernel reads q, k and v straight out of the head-major
// [B, L, H, 3, D] qkv projection without copies. O is written contiguous
// [B, Lq, H, D]; LSE contiguous [B, H, Lq].
//
// What bounds it on an H100: operations. At the served shape (B*H = 8,
// L = 4096, D = 64, causal) it does some 17 GFLOP of float32 products over
// 34 MB of q, k, v and o, some 500 operations a byte. This first version runs
// them as float32 FMAs on the CUDA cores (67 TFLOP/s at the card's peak), not
// on the tensor cores; wgmma, TMA and warp specialisation are later work. Its
// design:
//   * one block of 256 threads per (bh, tile of 64 query rows); k and v tiles
//     of 64 rows stream through shared memory, so no score ever reaches device
//     memory and each k/v tile is read once per query tile;
//   * each thread owns a 4x4 block of the 64x64 score tile and a 4 x D/16
//     block of the output accumulator, in registers; q and k are staged
//     transposed ([d][row]) and v row-major, so the inner loops read 16-byte
//     vectors from shared memory without bank conflicts: 16 FMAs per two
//     vector loads in the score product and per 1 + D/64 in p @ v;
//   * the 16 threads that share a query row sit in one half-warp and reduce
//     its max and sum with shuffles;
//   * under the causal mask a query tile stops at the diagonal: the k tiles
//     wholly above it are skipped, and query tiles are issued last first, so
//     the longest blocks start first.
// Shared memory: (2 D + 64) * 68 + 64 D floats (68.6 KB at D = 64, 119.8 KB
// at D = 128), above the 48 KB default, set per launch with
// cudaFuncSetAttribute.

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

template <typename T>
struct Out4;

template <>
struct Out4<float> {
  __device__ static void store(float* dst, float a, float b, float c,
                               float d) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  }
};

template <>
struct Out4<__nv_bfloat16> {
  __device__ static void store(__nv_bfloat16* dst, float a, float b, float c,
                               float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
};

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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Lq, int Lk,
                 int64_t q_sb, int64_t q_sh, int64_t q_sl, int64_t k_sb,
                 int64_t k_sh, int64_t k_sl, int64_t v_sb, int64_t v_sh,
                 int64_t v_sl, float scale, int causal) {
  constexpr int kGroups = D / 64;  // float4 column groups of o per thread
  constexpr int kQRow = kBlockQ + kPad;
  constexpr int kKRow = kBlockK + kPad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                    // [D][kQRow]
  float* kt = qt + D * kQRow;          // [D][kKRow]
  float* vs = kt + D * kKRow;          // [kBlockK][D]
  float* pt = vs + kBlockK * D;        // [kBlockK][kQRow]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // key columns tx*4 .. tx*4+3
  const int n_q = (Lq + kBlockQ - 1) / kBlockQ;
  const int q_tile = n_q - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = q_tile * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qt[d * kQRow + r] =
        q0 + r < Lq ? to_float(qb[(q0 + r) * q_sl + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) acc[i][j] = 0.0f;
  }

  int n_k = (Lk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Tiles whose first key lies past the tile's last query are all masked.
    n_k = min(n_k, (q0 + kBlockQ - 1) / kBlockK + 1);
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
      const int q_pos = q0 + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (k_pos >= Lk || (causal && q_pos < k_pos)) x = kNegInf;
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
    const int q_pos = q0 + ty * 4 + i;
    if (q_pos >= Lq) continue;
    const float l_final = fmaxf(l[i], 1e-20f);
    T* dst = o + ((static_cast<int64_t>(b) * Lq + q_pos) * H + h) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      Out4<T>::store(dst + g * 64 + tx * 4, acc[i][g * 4] / l_final,
                     acc[i][g * 4 + 1] / l_final, acc[i][g * 4 + 2] / l_final,
                     acc[i][g * 4 + 3] / l_final);
    }
    if (tx == 0) {
      lse[static_cast<int64_t>(bh) * Lq + q_pos] = m[i] + logf(l_final);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Lq, int Lk, const int64_t* strides, float scale,
           int causal, cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t status = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Lq, Lk, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], strides[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: [B, Lq, H, D], k and v: [B, Lk, H, D], all float32 or all bfloat16,
// given by element strides (batch, head, row) with unit stride along D;
// o: contiguous [B, Lq, H, D] of the inputs' type;
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
  const int64_t strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh,
                              k_sl, v_sb, v_sh, v_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Lq, Lk,
                                            strides, scale, causal, s)
                : launch<float, 64>(q, k, v, o, lse, B, H, Lq, Lk, strides,
                                    scale, causal, s);
  }
  if (D == 128) {
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Lq, Lk,
                                             strides, scale, causal, s)
                : launch<float, 128>(q, k, v, o, lse, B, H, Lq, Lk, strides,
                                     scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
