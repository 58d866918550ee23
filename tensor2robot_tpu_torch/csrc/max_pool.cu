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
// The max is taken in float32 and stored in the input's type; the stored
// value is one of the inputs, so it is exact in bf16 as well.
//
// What bounds it on an H100: bytes. Each input element is read once and
// compared once, each output written once; the compares are a few per byte.
// One thread computes one output element with the channel innermost, so the
// 32 threads of a warp read 32 neighbouring channels of the same pixel: every
// load of the wh * ww window is one coalesced 128-byte (f32) access, and the
// window's rows are reused from L1/L2 by the neighbouring output columns of
// the same block. A grid-stride loop keeps the grid at a few waves of the
// card whatever the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Whether `v` replaces the running maximum `m`: strictly greater, or the
// first NaN.
__device__ __forceinline__ bool takes(float v, float m) {
  return v > m || (isnan(v) && !isnan(m));
}

template <typename T>
__global__ void max_pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int8_t* __restrict__ idx, int B, int H, int W,
                                int C, int wh, int ww, int Ho, int Wo,
                                int pad_top, int pad_left) {
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * C;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(t % C);
    int64_t r = t / C;
    const int wo = static_cast<int>(r % Wo);
    r /= Wo;
    const int ho = static_cast<int>(r % Ho);
    const int b = static_cast<int>(r / Ho);
    const int h0 = ho * wh - pad_top;
    const int w0 = wo * ww - pad_left;
    const T* frame = x + static_cast<int64_t>(b) * H * W * C + c;
    float best = -INFINITY;
    int best_k = 0;
    for (int j = 0; j < ww; ++j) {
      const int w = w0 + j;
      const bool w_in = w >= 0 && w < W;
      float m = -INFINITY;
      int mi = 0;
      for (int i = 0; i < wh; ++i) {
        const int h = h0 + i;
        const float v = (w_in && h >= 0 && h < H)
                            ? to_float(frame[(static_cast<int64_t>(h) * W + w) * C])
                            : -INFINITY;
        if (i == 0 || takes(v, m)) {
          m = v;
          mi = i;
        }
      }
      if (j == 0 || takes(m, best)) {
        best = m;
        best_k = mi * ww + j;
      }
    }
    out[t] = from_float<T>(best);
    if (idx != nullptr) idx[t] = static_cast<int8_t>(best_k);
  }
}

}  // namespace

extern "C" {

// x: float32 or bfloat16 [B, H, W, C]; out: same type [B, Ho, Wo, C]; idx:
// int8 [B, Ho, Wo, C] or null. All contiguous and on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
int t2r_max_pool(const void* x, void* out, void* idx, int B, int H, int W,
                 int C, int wh, int ww, int Ho, int Wo, int pad_top,
                 int pad_left, int is_bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * Ho * Wo * C;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* index = static_cast<int8_t*>(idx);
  if (is_bf16) {
    max_pool_kernel<__nv_bfloat16><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        index, B, H, W, C, wh, ww, Ho, Wo, pad_top, pad_left);
  } else {
    max_pool_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), index, B, H, W,
        C, wh, ww, Ho, Wo, pad_top, pad_left);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
