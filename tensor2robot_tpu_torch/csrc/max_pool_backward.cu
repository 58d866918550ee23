// Non-overlapping max pool backward on NHWC: routes dy to the window cell
// that the forward's int8 index names, and writes 0 everywhere else.
//
// Replaces the backward TPU kernel of tensor2robot_tpu/layers/pallas_pooling.py
// (`_pallas_call_bwd`, kernel body `_bwd_kernel`), and computes what
// tensor2robot_tpu/layers/pooling.py `_max_pool_bwd` computes with its two
// one-hot compares, in the wider geometry of pooling.py that the Pallas kernel
// does not take: SAME with low padding (79 -> 27 pads one row and column on
// each side) as well as high padding, and VALID, whose dropped tail gets 0.
//
//   dx[b, h, w, c] = dy[b, oh, ow, c]  if idx[b, oh, ow, c] == i * ww + j
//                    0                 otherwise, and in a VALID tail
//   with oh = (h + pad_top) / wh,  i = (h + pad_top) - oh * wh,
//        ow = (w + pad_left) / ww, j = (w + pad_left) - ow * ww.
//
// The index is K2f's (csrc/max_pool.cu): the stage-wise first maximum,
// relative to the padded window. A gradient routed to a padded cell is
// dropped, as pooling.py's crop of the padded dx drops it.
//
// The kernel only copies bits: dx is either dy's value or +0, so it works on
// the raw 32-bit (float32) or 16-bit (bfloat16) patterns and is bit-exact
// with the plain version in both types.
//
// What bounds it on an H100: bytes. Every dx element is written once and dy
// and the index are read once: a critic step's three pools write 513 MB of
// dx and read 74 MB. The design is the mirror of the forward's (K2f):
//   * one block row per output row (b, oh), placed from blockIdx in 32-bit
//     arithmetic; its threads run over (ow, channel vector), channels
//     innermost, so that a warp's stores to one window cell are contiguous;
//   * a thread loads its V channels of dy (16 bytes: 4 float32 or 8 bf16)
//     and their V int8 indices (one 4- or 8-byte load) once, then writes its
//     whole window of dx, wh x ww cells, each as one 16-byte streaming store
//     (the dy bits where the index names the cell, +0 elsewhere); cells in
//     the low or high padding are skipped. The wrapper chooses V from C and
//     the addresses of dy and the index; other shapes take the one-element
//     instance of the same kernel;
//   * dx rows and columns that no window covers (a VALID tail) are
//     zero-filled by the last output row's and the last output column's
//     threads, so every dx element is written exactly once, without
//     atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// V consecutive elements as raw bits: Bits is uint32_t (float32) or
// uint16_t (bf16), V * sizeof(Bits) is 16 bytes or one element.
template <typename Bits, int V>
__device__ __forceinline__ void load_bits(const Bits* p, uint32_t (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = __ldcs(p);
  } else {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t words[4] = {a.x, a.y, a.z, a.w};
    if constexpr (sizeof(Bits) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = words[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[2 * i] = words[i] & 0xffffu;
        x[2 * i + 1] = words[i] >> 16;
      }
    }
  }
}

// V int8 window indices, from one load of V bytes.
template <int V>
__device__ __forceinline__ void load_index(const int8_t* p, int (&k)[V]) {
  if constexpr (V == 1) {
    k[0] = __ldcs(p);
  } else {
    uint32_t words[V / 4];
    if constexpr (V == 4) {
      words[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint2 a = __ldcs(reinterpret_cast<const uint2*>(p));
      words[0] = a.x;
      words[1] = a.y;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      k[i] = static_cast<int8_t>(words[i / 4] >> (8 * (i % 4)));
    }
  }
}

// Writes V elements: x[i] where k[i] == cell, +0 elsewhere, as one
// streaming store.
template <typename Bits, int V>
__device__ __forceinline__ void store_cell(Bits* p, const uint32_t (&x)[V],
                                           const int (&k)[V], int cell) {
  uint32_t y[V];
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = k[i] == cell ? x[i] : 0u;
  if constexpr (V == 1) {
    __stcs(p, static_cast<Bits>(y[0]));
  } else if constexpr (sizeof(Bits) == 4) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(y[0], y[1], y[2], y[3]));
  } else {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(y[0] | y[1] << 16, y[2] | y[3] << 16,
                      y[4] | y[5] << 16, y[6] | y[7] << 16));
  }
}

// KH, KW: the window when it is known at compile time, 0 when it is the
// runtime wh, ww.
template <typename Bits, int V, int KH, int KW>
__global__ void __launch_bounds__(kMaxThreads)
max_pool_backward_kernel(const Bits* __restrict__ dy,
                         const int8_t* __restrict__ idx,
                         Bits* __restrict__ dx, int H, int W, int C,
                         int wh_arg, int ww_arg, int Ho, int Wo, int pad_top,
                         int pad_left) {
  const int wh = KH > 0 ? KH : wh_arg;
  const int ww = KW > 0 ? KW : ww_arg;
  const int vectors = C / V;
  const int pos = blockIdx.y * blockDim.x + threadIdx.x;  // in the row
  if (pos >= Wo * vectors) return;
  const int row = blockIdx.x;   // b * Ho + oh
  const int b = row / Ho;
  const int oh = row - b * Ho;
  const int ow = pos / vectors;
  const int c = (pos - ow * vectors) * V;
  const int64_t o = (static_cast<int64_t>(row) * Wo + ow) * C + c;
  uint32_t x[V];
  int k[V];
  load_bits<Bits, V>(dy + o, x);
  load_index<V>(idx + o, k);

  const int h0 = oh * wh - pad_top;
  const int w0 = ow * ww - pad_left;
  Bits* frame = dx + static_cast<int64_t>(b) * H * W * C + c;
  auto cell_ptr = [&](int h, int w) {
    return frame + (static_cast<int64_t>(h) * W + w) * C;
  };
#pragma unroll
  for (int i = 0; i < wh; ++i) {
    const int h = h0 + i;
    if (h < 0 || h >= H) continue;
#pragma unroll
    for (int j = 0; j < ww; ++j) {
      const int w = w0 + j;
      if (w < 0 || w >= W) continue;
      store_cell<Bits, V>(cell_ptr(h, w), x, k, i * ww + j);
    }
  }

  // A VALID tail: the rows below the last window and the columns right of
  // it. The last output row's threads zero the rows (all their columns
  // from w0), the last output column's the columns of their window rows.
  const int h_end = Ho * wh - pad_top;   // first row no window covers
  const int w_end = Wo * ww - pad_left;
  if (h_end >= H && w_end >= W) return;
  const uint32_t zeros[V] = {};
  const int h_last = oh == Ho - 1 ? H : min(h0 + wh, H);
  const int w_last = ow == Wo - 1 ? W : min(w0 + ww, W);
  for (int h = max(h0, 0); h < h_last; ++h) {
    for (int w = max(w0, 0); w < w_last; ++w) {
      if (h < h_end && w < w_end) continue;   // inside a window: written
      store_cell<Bits, V>(cell_ptr(h, w), zeros, k, 0);
    }
  }
}

template <typename Bits, int V, int KH, int KW>
void launch(const void* dy, const void* idx, void* dx, int B, int H, int W,
            int C, int wh, int ww, int Ho, int Wo, int pad_top, int pad_left,
            cudaStream_t stream) {
  // One block row per output row; its threads cover the row's
  // Wo * C / V vectors in as few warps as the blocks of at most 256 allow.
  const int per_row = Wo * (C / V);
  if (B * Ho == 0 || per_row == 0) return;   // nothing to route
  const int blocks = (per_row + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_row + blocks - 1) / blocks + 31) / 32 * 32;
  const dim3 grid(B * Ho, blocks);
  max_pool_backward_kernel<Bits, V, KH, KW><<<grid, threads, 0, stream>>>(
      static_cast<const Bits*>(dy), static_cast<const int8_t*>(idx),
      static_cast<Bits*>(dx), H, W, C, wh, ww, Ho, Wo, pad_top, pad_left);
}

template <typename Bits, int V>
void launch_window(const void* dy, const void* idx, void* dx, int B, int H,
                   int W, int C, int wh, int ww, int Ho, int Wo, int pad_top,
                   int pad_left, cudaStream_t stream) {
  if (wh == 2 && ww == 2) {
    launch<Bits, V, 2, 2>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                          pad_left, stream);
  } else if (wh == 3 && ww == 3) {
    launch<Bits, V, 3, 3>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                          pad_left, stream);
  } else {
    launch<Bits, V, 0, 0>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo, pad_top,
                          pad_left, stream);
  }
}

}  // namespace

extern "C" {

// dy: float32 or bfloat16 [B, Ho, Wo, C]; idx: int8 [B, Ho, Wo, C]; dx: the
// type of dy, [B, H, W, C]. elem_bytes is 4 (float32) or 2 (bfloat16). All
// contiguous and on the current device. vec: the channels a thread moves at
// once, 16 bytes' worth (4 float32, 8 bf16; C a multiple of it, dy and dx
// 16-byte aligned, idx aligned to vec bytes) or 1. Returns
// cudaGetLastError() after the launch (0 on success), or 1
// (cudaErrorInvalidValue) for another elem_bytes or vec.
int t2r_max_pool_backward(const void* dy, const void* idx, void* dx, int B,
                          int H, int W, int C, int wh, int ww, int Ho, int Wo,
                          int pad_top, int pad_left, int elem_bytes, int vec,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2 && vec == 8) {
    launch_window<uint16_t, 8>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo,
                               pad_top, pad_left, s);
  } else if (elem_bytes == 2 && vec == 1) {
    launch_window<uint16_t, 1>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo,
                               pad_top, pad_left, s);
  } else if (elem_bytes == 4 && vec == 4) {
    launch_window<uint32_t, 4>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo,
                               pad_top, pad_left, s);
  } else if (elem_bytes == 4 && vec == 1) {
    launch_window<uint32_t, 1>(dy, idx, dx, B, H, W, C, wh, ww, Ho, Wo,
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
