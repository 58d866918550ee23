// Non-overlapping max pool forward on NHWC, with an optional window index.
//
// Replaces the forward TPU kernel of tensor2robot_tpu/layers/pallas_pooling.py
// (`max_pool_pallas` -> `_pallas_call_fwd`, kernel body `_fwd_kernel`), and
// computes what tensor2robot_tpu/layers/pooling.py `max_pool` computes for a
// window equal to its stride, in the wider geometry of pooling.py: SAME with
// low padding (79 -> 27 pads one row and column on each side) as well as high
// padding, padded cells reading as -inf; VALID drops the tail that fits no
// whole window.
//
//   out[b, ho, wo, c] = max over the window at (ho * wh - pad_top,
//                                                wo * ww - pad_left)
//   idx[b, ho, wo, c] = i1 * ww + j  (int8), chosen stage-wise as
//                       pallas_pooling.py and pooling.py choose it: within
//                       each window column j the first maximal row i1, then
//                       the first maximal column. NaN counts as maximal, as
//                       jnp.argmax and torch.argmax count it.
//
// The max is compared in float32 and the chosen input is stored as it was
// read, so the output is exact in bf16 as well.
//
// What bounds it on an H100: bytes. The windows do not overlap, so each
// input byte is read once and each output byte written once; the compares
// are a few per byte. A served batch of the critic reads some 0.6 GB
// through six pools, two of them larger than the 50 MB L2. The design moves
// those bytes with few instructions and many of them in flight:
//   * one block row per output row (b, ho), from blockIdx in 32-bit
//     arithmetic; its threads run over (wo, channel vector), channels
//     innermost, so a warp's loads of one window cell are contiguous and
//     every sector it fetches is used whole;
//   * a thread loads a vector of V channels at once, 16 bytes (4 float32 or
//     8 bf16) where C and the input's address allow it, else one element
//     (the wrapper chooses V);
//   * for the 2x2 and 3x3 windows of the critic it issues all of its
//     window's loads, as streaming loads that do not linger in the caches,
//     before the first compare, then reduces them in the stage-wise order;
//     other windows loop over their cells;
//   * the V maxima go out as one store, the V int8 indices as one packed 4-
//     or 8-byte store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// V consecutive channels at p (aligned to the vector), as floats: float32
// as it is, bf16 (its bits) widened exactly.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
      v[0] = a.x;
      v[1] = a.y;
      v[2] = a.z;
      v[3] = a.w;
    } else {
      v[0] = __ldcs(reinterpret_cast<const float*>(p));
    }
  } else {
    if constexpr (V == 8) {
      const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
      const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(words[i] << 16);
        v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    } else {
      const unsigned short bits =
          __ldcs(reinterpret_cast<const unsigned short*>(p));
      v[0] = __uint_as_float(static_cast<uint32_t>(bits) << 16);
    }
  }
}

// The V chosen values back in the input's type: a widened bf16 value keeps
// its bits in the upper half, so dropping the lower half gives it back.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<float*>(p) = v[0];
    }
  } else {
    uint32_t bits[V];
#pragma unroll
    for (int i = 0; i < V; ++i) bits[i] = __float_as_uint(v[i]) >> 16;
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(bits[0] | bits[1] << 16, bits[2] | bits[3] << 16,
                     bits[4] | bits[5] << 16, bits[6] | bits[7] << 16);
    } else {
      *reinterpret_cast<unsigned short*>(p) =
          static_cast<unsigned short>(bits[0]);
    }
  }
}

// V int8 window indices as one store of V bytes.
template <int V>
__device__ __forceinline__ void store_index(int8_t* p, const int (&k)[V]) {
  if constexpr (V == 1) {
    *p = static_cast<int8_t>(k[0]);
  } else {
    uint32_t words[V / 4];
#pragma unroll
    for (int w = 0; w < V / 4; ++w) {
      words[w] = static_cast<uint32_t>(k[4 * w]) |
                 static_cast<uint32_t>(k[4 * w + 1]) << 8 |
                 static_cast<uint32_t>(k[4 * w + 2]) << 16 |
                 static_cast<uint32_t>(k[4 * w + 3]) << 24;
    }
    if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) = words[0];
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
    }
  }
}

// Whether `v` replaces the running maximum `m`: strictly greater, or the
// first NaN.
__device__ __forceinline__ bool takes(float v, float m) {
  return v > m || (isnan(v) && !isnan(m));
}

// The stage-wise first maximum of a window, V channels at a time: cells
// are offered column by column (j), each column row by row (i).
template <int V>
struct Window {
  float best[V];
  int best_k[V];
  float col[V];
  int col_i[V];

  __device__ __forceinline__ void cell(int i, const float (&v)[V]) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if (i == 0 || takes(v[c], col[c])) {
        col[c] = v[c];
        col_i[c] = i;
      }
    }
  }
  __device__ __forceinline__ void end_column(int j, int ww) {
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if (j == 0 || takes(col[c], best[c])) {
        best[c] = col[c];
        best_k[c] = col_i[c] * ww + j;
      }
    }
  }
};

// KH, KW: the window when it is known at compile time (all loads issued
// before the compares), 0 when it is the runtime wh, ww.
template <typename T, int V, int KH, int KW>
__global__ void __launch_bounds__(kMaxThreads)
max_pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                int8_t* __restrict__ idx, int H, int W, int C, int wh_arg,
                int ww_arg, int Ho, int Wo, int pad_top, int pad_left) {
  const int wh = KH > 0 ? KH : wh_arg;
  const int ww = KW > 0 ? KW : ww_arg;
  const int vectors = C / V;
  const int pos = blockIdx.y * blockDim.x + threadIdx.x;  // in the row
  if (pos >= Wo * vectors) return;
  const int row = blockIdx.x;   // b * Ho + ho
  const int b = row / Ho;
  const int ho = row - b * Ho;
  const int wo = pos / vectors;
  const int c = (pos - wo * vectors) * V;
  const int h0 = ho * wh - pad_top;
  const int w0 = wo * ww - pad_left;
  const T* frame = x + static_cast<int64_t>(b) * H * W * C + c;
  auto read = [&](int i, int j, float (&v)[V]) {
    const int h = h0 + i;
    const int w = w0 + j;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      load_vec<T, V>(frame + (static_cast<int64_t>(h) * W + w) * C, v);
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l) v[l] = -INFINITY;
    }
  };

  Window<V> win;
  if constexpr (KH > 0 && KW > 0) {
    float cells[KW][KH][V];
#pragma unroll
    for (int j = 0; j < KW; ++j) {
#pragma unroll
      for (int i = 0; i < KH; ++i) read(i, j, cells[j][i]);
    }
#pragma unroll
    for (int j = 0; j < KW; ++j) {
#pragma unroll
      for (int i = 0; i < KH; ++i) win.cell(i, cells[j][i]);
      win.end_column(j, KW);
    }
  } else {
    for (int j = 0; j < ww; ++j) {
      for (int i = 0; i < wh; ++i) {
        float v[V];
        read(i, j, v);
        win.cell(i, v);
      }
      win.end_column(j, ww);
    }
  }
  const int64_t o = (static_cast<int64_t>(row) * Wo + wo) * C + c;
  store_vec<T, V>(out + o, win.best);
  if (idx != nullptr) store_index<V>(idx + o, win.best_k);
}

template <typename T, int V, int KH, int KW>
void launch(const void* x, void* out, void* idx, int B, int H, int W, int C,
            int wh, int ww, int Ho, int Wo, int pad_top, int pad_left,
            cudaStream_t stream) {
  // One block row per output row; its threads cover the row's
  // Wo * C / V vectors in as few warps as the blocks of at most 256 allow.
  const int per_row = Wo * (C / V);
  if (B * Ho == 0 || per_row == 0) return;   // nothing to pool
  const int blocks = (per_row + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_row + blocks - 1) / blocks + 31) / 32 * 32;
  const dim3 grid(B * Ho, blocks);
  max_pool_kernel<T, V, KH, KW><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<int8_t*>(idx), H, W, C, wh, ww, Ho, Wo, pad_top,
      pad_left);
}

template <typename T, int V>
void launch_window(const void* x, void* out, void* idx, int B, int H, int W,
                   int C, int wh, int ww, int Ho, int Wo, int pad_top,
                   int pad_left, cudaStream_t stream) {
  if (wh == 2 && ww == 2) {
    launch<T, V, 2, 2>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                       pad_left, stream);
  } else if (wh == 3 && ww == 3) {
    launch<T, V, 3, 3>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                       pad_left, stream);
  } else {
    launch<T, V, 0, 0>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                       pad_left, stream);
  }
}

}  // namespace

extern "C" {

// x: float32 or bfloat16 [B, H, W, C]; out: same type [B, Ho, Wo, C]; idx:
// int8 [B, Ho, Wo, C] or null. All contiguous and on the current device.
// vec: the channels a thread loads at once, 16 bytes' worth (4 float32, 8
// bf16; C a multiple of it, x 16-byte aligned) or 1. Returns
// cudaGetLastError() after the launch (0 on success), or 1
// (cudaErrorInvalidValue) for another vec.
int t2r_max_pool(const void* x, void* out, void* idx, int B, int H, int W,
                 int C, int wh, int ww, int Ho, int Wo, int pad_top,
                 int pad_left, int is_bf16, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec == 8) {
    launch_window<uint16_t, 8>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo,
                               pad_top, pad_left, s);
  } else if (is_bf16 && vec == 1) {
    launch_window<uint16_t, 1>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo,
                               pad_top, pad_left, s);
  } else if (!is_bf16 && vec == 4) {
    launch_window<float, 4>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo,
                            pad_top, pad_left, s);
  } else if (!is_bf16 && vec == 1) {
    launch_window<float, 1>(x, out, idx, B, H, W, C, wh, ww, Ho, Wo,
                            pad_top, pad_left, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
