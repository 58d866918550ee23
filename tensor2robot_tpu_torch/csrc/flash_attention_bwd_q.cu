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
//           c >= Lk (a ragged tail)
//   dp[c] = dO[r] . v[c]
//   ds[c] = p[c] * (dp[c] - delta[r]) * scale
//   dq[r] = sum_c ds[c] k[c]
//
// with delta[r] = dO[r] . o[r] computed before the launch, exactly the
// arithmetic of `_bwd_p_ds`, the causal mask at global positions (q_pos >=
// k_pos, no offset). dq is written in the inputs' type.
//
// Inputs q, k, v and dO are [B, L, H, D] views given by their strides
// (b, h, l; d is unit stride), so q, k and v are read straight out of the
// head-major [B, L, H, 3, D] qkv projection. lse and delta are contiguous
// float32 [B, H, Lq]. dq is written by strides too, with unit stride along
// D and rows 16-byte aligned.
//
// What bounds it on an H100: operations. At the training shape (B*H = 64,
// L = 4096, D = 64, causal) it does three products per unmasked (q, k)
// pair (s, dp, ds k), 206 GFLOP, over 0.34 GB of q, k, v, dO and dq: some
// 610 operations a byte. This first version runs them as float32 FMAs on
// the CUDA cores (67 TFLOP/s at the card's peak: 3.08 ms), not on the
// tensor cores; wgmma and TMA are later work. Its design:
//   * one block of 256 threads per (bh, tile of 64 query rows), with q, dO,
//     lse and delta resident in shared memory and its dQ accumulator in
//     registers; it loops over 64-row k/v tiles (the Pallas kernel's
//     sequential grid axis), stopping under the causal mask at the
//     diagonal, so dQ is written once, at the end, without atomics, in a
//     fixed order: the same bits run to run;
//   * s and dp as in the dK/dV kernel: row-major tiles padded to D + 4
//     floats, a thread owning query rows ty*4..ty*4+3 (a broadcast within
//     a quarter warp) and key rows tx, tx+16, tx+32, tx+48 (8 distinct
//     bank groups), 8 FMAs per conflict-free 16-byte load;
//   * ds goes through shared memory transposed ([key][query], one 16-byte
//     store per key a thread) for the product ds k, where a thread owns
//     query rows ty*4..+3 and columns tx*4..+3 of each 64-wide group of D:
//     16 FMAs per 1 + D/64 loads;
//   * query tiles with the most work (the last, under the causal mask) are
//     issued first.
// Shared memory: 4 * 64 * (D + 4) + 64 * 68 + 128 floats (85.5 KB at
// D = 64, 149.5 KB at D = 128), above the 48 KB default, set per launch
// with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // rows of every q and k/v tile
constexpr int kPad = 4;       // keeps rows 16-byte aligned, spreads banks
constexpr int kPRow = kBlock + kPad;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Out4;

template <>
struct Out4<float> {
  __device__ static void store(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Out4<__nv_bfloat16> {
  __device__ static void store(__nv_bfloat16* dst, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
};

constexpr int smem_floats(int d) {
  return 4 * kBlock * (d + kPad) + kBlock * kPRow + 2 * kBlock;
}

// Rows row0 .. row0 + 63 of one [L, D] view into a row-major float tile;
// rows at or past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows) {
  constexpr int kRow = D + kPad;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    tile[r * kRow + d] =
        row0 + r < rows ? to_float(src[(row0 + r) * row_stride + d]) : 0.0f;
  }
}

struct Strides {
  int64_t q_b, q_h, q_l, k_b, k_h, k_l, v_b, v_h, v_l, o_b, o_h, o_l;
  int64_t dq_b, dq_h, dq_l;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ d_out,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int H, int Lq, int Lk, Strides st, float scale,
                   int causal) {
  constexpr int kGroups = D / 64;  // float4 column groups per thread
  constexpr int kRow = D + kPad;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                    // [64 queries][kRow]
  float* dos = qs + kBlock * kRow;     // [64 queries][kRow]
  float* ks = dos + kBlock * kRow;     // [64 keys][kRow]
  float* vs = ks + kBlock * kRow;      // [64 keys][kRow]
  float* dst = vs + kBlock * kRow;     // ds transposed: [64 keys][kPRow]
  float* lse_s = dst + kBlock * kPRow; // [64]
  float* delta_s = lse_s + kBlock;     // [64]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int n_q = (Lq + kBlock - 1) / kBlock;
  const int q_tile = n_q - 1 - blockIdx.x;  // longest causal tiles first
  const int q0 = q_tile * kBlock;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + h * st.k_h;
  const T* vb = v + b * st.v_b + h * st.v_h;
  const T* ob = d_out + b * st.o_b + h * st.o_h;

  load_tile<T, D>(qs, qb, st.q_l, q0, Lq);
  load_tile<T, D>(dos, ob, st.o_l, q0, Lq);
  if (tid < kBlock) {
    const bool in = q0 + tid < Lq;
    const int64_t row = static_cast<int64_t>(bh) * Lq + q0 + tid;
    lse_s[tid] = in ? lse[row] : 0.0f;
    delta_s[tid] = in ? delta[row] : 0.0f;
  }

  float acc[4][4 * kGroups];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4 * kGroups; ++j) acc[i][j] = 0.0f;
  }

  int n_k = (Lk + kBlock - 1) / kBlock;
  if (causal) {
    // Tiles whose first key lies past the tile's last query are all masked.
    n_k = min(n_k, (q0 + kBlock - 1) / kBlock + 1);
  }
  for (int k_tile = 0; k_tile < n_k; ++k_tile) {
    const int k0 = k_tile * kBlock;
    load_tile<T, D>(ks, kb, st.k_l, k0, Lk);
    load_tile<T, D>(vs, vb, st.v_l, k0, Lk);
    __syncthreads();

    // s and dp for query rows ty*4 + i and key rows tx + 16 j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.0f;
        dp[i][j] = 0.0f;
      }
    }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kRow + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kRow + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          s[i][j] = fmaf(a[i].w, c[j].w, x);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(dos + (ty * 4 + i) * kRow + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * kRow + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = dp[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          dp[i][j] = fmaf(a[i].w, c[j].w, x);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int k_pos = k0 + c;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int q_pos = q0 + r;
        const bool keep = k_pos < Lk && !(causal && q_pos < k_pos);
        const float p = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.0f;
        ds[i] = p * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(dst + c * kPRow + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dq += ds k for query rows ty*4 + i.
#pragma unroll 2
    for (int c = 0; c < kBlock; ++c) {
      const float4 ds4 = *reinterpret_cast<const float4*>(dst + c * kPRow +
                                                          ty * 4);
      const float dsv[4] = {ds4.x, ds4.y, ds4.z, ds4.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            ks + c * kRow + g * 64 + tx * 4);
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][g * 4 + j] = fmaf(dsv[i], kv[j], acc[i][g * 4 + j]);
          }
        }
      }
    }
    __syncthreads();  // k, v and ds are overwritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty * 4 + i;
    if (q_pos >= Lq) continue;
    T* dq_row = dq + b * st.dq_b + h * st.dq_h + q_pos * st.dq_l;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      Out4<T>::store(dq_row + g * 64 + tx * 4, &acc[i][g * 4]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* d_out,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Lq, int Lk, const Strides& st, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = smem_floats(D) * static_cast<int>(sizeof(float));
  cudaError_t status = cudaFuncSetAttribute(
      flash_bwd_q_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((Lq + kBlock - 1) / kBlock, B * H);
  flash_bwd_q_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), H, Lq, Lk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, d_out: [B, Lq, H, D]; k, v: [B, Lk, H, D]; all float32 or all
// bfloat16, given by element strides (batch, head, row) with unit stride
// along D. lse, delta: contiguous float32 [B, H, Lq]. dq: [B, Lq, H, D] of
// the inputs' type, written by strides (batch, head, row), unit stride
// along D. D is 64 or 128. Returns cudaGetLastError() after the launch (0
// on success), or 1 (cudaErrorInvalidValue) for a D the kernel was not
// built for.
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
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, d_out, lse, delta, dq,
                                            B, H, Lq, Lk, st, scale, causal,
                                            s)
                : launch<float, 64>(q, k, v, d_out, lse, delta, dq, B, H, Lq,
                                    Lk, st, scale, causal, s);
  }
  if (D == 128) {
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, d_out, lse, delta, dq,
                                             B, H, Lq, Lk, st, scale, causal,
                                             s)
                : launch<float, 128>(q, k, v, d_out, lse, delta, dq, B, H,
                                     Lq, Lk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
