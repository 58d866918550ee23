// Per-frame crop + uint8-to-float convert, one pass over device memory.
//
// Replaces the TPU kernel tensor2robot_tpu/preprocessors/pallas_crop.py
// `fused_crop_convert` (kernel body `_crop_kernel`). It computes
//
//   out[b, y, x, c] = float(images[b, oy + y, ox + x, c]) * (1 / denom)
//
// with (oy, ox) read from offsets[b] in device memory and clamped to
// [0, H - th] x [0, W - tw], as the Pallas wrapper clamps them. The JAX source
// divides (`image / 255.0`), but XLA compiles a divide by a constant into a
// multiply by the constant's float32 reciprocal, in the jitted serving path
// and in the Pallas kernel alike. The kernel computes what they compute:
// the reciprocal rounded once to float32, then one IEEE multiply, which
// matches both bit for bit (a true divide differs from them by one ulp in
// about half the values). A bf16 output is the float32 product rounded to
// nearest even.
//
// What bounds it on an H100: bytes. Each output element costs one byte read
// and four (or two) bytes written, and one multiply; those are far below
// the card's arithmetic rate. The design therefore only has to keep the
// memory system busy with wide, coalesced accesses:
//   * a row of the crop is tw*C contiguous elements in the input and in the
//     output, so one block row (blockIdx.y) copies one output row, and one
//     thread converts a run of kRun consecutive elements of it;
//   * neighbouring threads read neighbouring bytes and write neighbouring
//     runs, and a run is stored as one 16-byte (f32) or 8-byte (bf16) vector
//     when the row length allows it;
//   * the crop offsets are two integers a frame, read from device memory by
//     every thread (they stay in L1), so the host never waits on them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 4;
constexpr int kThreads = 128;

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

template <typename T>
struct alignas(sizeof(T) * kRun) Pack {
  T v[kRun];
};

template <typename T>
__global__ void crop_convert_kernel(const uint8_t* __restrict__ images,
                                    const int32_t* __restrict__ offsets,
                                    T* __restrict__ out, int H, int W, int C,
                                    int th, int tw, float scale) {
  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int row_len = tw * C;
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kRun;
  if (i0 >= row_len) return;
  const int oy = min(max(offsets[2 * b], 0), H - th);
  const int ox = min(max(offsets[2 * b + 1], 0), W - tw);
  const uint8_t* src =
      images + ((static_cast<int64_t>(b) * H + oy + y) * W + ox) * C;
  T* dst = out + (static_cast<int64_t>(b) * th + y) * row_len;
  if (row_len % kRun == 0) {
    // Every run is whole and starts on a kRun-element boundary of a row
    // that itself starts on one, so the vector store is aligned.
    Pack<T> pack;
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      pack.v[k] = from_float<T>(static_cast<float>(src[i0 + k]) * scale);
    }
    *reinterpret_cast<Pack<T>*>(dst + i0) = pack;
  } else {
    for (int k = 0; k < kRun && i0 + k < row_len; ++k) {
      dst[i0 + k] = from_float<T>(static_cast<float>(src[i0 + k]) * scale);
    }
  }
}

}  // namespace

extern "C" {

// images: uint8 [B, H, W, C]; offsets: int32 [B, 2] (y, x); out: float32 or
// bfloat16 [B, th, tw, C]; all contiguous and on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
int t2r_crop_convert(const void* images, const void* offsets, void* out,
                     int B, int H, int W, int C, int th, int tw, float denom,
                     int out_bf16, void* stream) {
  const int row_len = tw * C;
  const int runs = (row_len + kRun - 1) / kRun;
  const dim3 grid((runs + kThreads - 1) / kThreads, th, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / denom;  // rounded once, as XLA folds it
  const uint8_t* in = static_cast<const uint8_t*>(images);
  const int32_t* offs = static_cast<const int32_t*>(offsets);
  if (out_bf16) {
    crop_convert_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        in, offs, static_cast<__nv_bfloat16*>(out), H, W, C, th, tw, scale);
  } else {
    crop_convert_kernel<float><<<grid, kThreads, 0, s>>>(
        in, offs, static_cast<float*>(out), H, W, C, th, tw, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
