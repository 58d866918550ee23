// Weight gradient of a 5x5, stride 1, SAME convolution on NHWC, accumulated
// in float32, on Hopper's tensor cores.
//
// Replaces the TPU kernel tensor2robot_tpu/layers/pallas_wgrad.py
// `conv5x5_wgrad` (kernel body `_wgrad_kernel`). For x and dy of shape
// [B, H, W, C] it computes the HWIO [5, 5, C, C] float32 gradient
//
//   dW[a, b, ci, co] = sum over (n, h, w) of
//                      xpad[n, h + a, w + b, ci] * dy[n, h, w, co]
//
// where xpad is x with 2 zero rows and columns on every side (the SAME pad of
// a 5x5 stride-1 conv): 25 shifted products of [positions, C]^T [positions, C].
// Inputs are float32 or bfloat16; sums are float32, as the Pallas kernel's
// `preferred_element_type=jnp.float32` makes them.
//
// What bounds it on an H100: operations. At the body convs' [32, 79, 79, 64]
// the products with real data are 64 * 64 * 32 * 389 * 389 multiply-adds
// (offset a covers 79 - |a - 2| rows, so 389 rows and 389 columns summed over
// the offsets), 39.7 GFLOP, against 102 MB of inputs: 0.59 ms at the CUDA
// cores' 67 TFLOP/s float32 rate, and 0.24 ms for the three TF32 passes of
// float32-grade products at the tensor cores' 495 TFLOP/s; 0.03 ms at
// 3.35 TB/s. The design:
//   * float32-grade products on the tensor cores (tf32_mma.cuh): each float32
//     operand is split once, as it is staged, into TF32 big and small halves,
//     and mma.sync m16n8k8 sums small*big + big*small + big*big in float32.
//     bfloat16 inputs are exact in TF32 and take the big pass alone;
//   * a block owns one row offset a, all five column offsets b and a 64 x 64
//     (ci, co) tile of the output: 5 x 64 x 64 float32 accumulators over 8
//     warps, 80 registers a thread. Its stage is a segment of one image row:
//     80 dy positions and the 84 x positions of the shifted row (a 2-column
//     halo each side, zeros outside the image). The five b offsets read the
//     same staged x strip shifted by b rows, so every x and dy element is
//     copied and split once a stage and used by five products;
//   * only rows whose shifted x row lies in the image are staged (the SAME
//     pad's zero rows are skipped); positions are decoded once a segment;
//   * the next segment's raw copy is in flight (cp.async, zero-filled outside
//     the image and the channels) while the tensor cores work on this one;
//   * the split tiles are float2 {big, small} rows of 64 channels whose
//     4-channel groups are XOR-swizzled by the row (r & 3): an A fragment's
//     four rows r..r+3 (any r: the b shift) and a B fragment's rows fall in
//     distinct banks, so fragment loads are free of conflicts;
//   * segments are split over blocks (the grid's x) so that the grid fills
//     the SMs (one block of 126 KB of shared memory a SM); each block writes
//     its own partial tile and a second pass sums the partials in a fixed
//     order. No atomics: the result is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kSide = 5;       // kernel side
constexpr int kPad = 2;        // SAME pad of a 5x5 stride-1 conv
constexpr int kTile = 64;      // (ci, co) tile of one block
constexpr int kSeg = 80;       // dy positions of one image row per stage
constexpr int kXRows = kSeg + kSide - 1;   // x positions of a stage
constexpr int kThreads = 256;  // 8 warps: 4 (ci) x 2 (co) of 16 x 32
constexpr int kChunks = kTile / 4;         // 4-channel copies a row
constexpr int kReduceThreads = 256;

template <typename T>
struct Smem {
  float2 xs[kXRows * kTile];   // split x strip, swizzled
  float2 ds[kSeg * kTile];     // split dy strip, swizzled
  T xr[kXRows * kTile];        // raw copy of the next stage
  T dr[kSeg * kTile];
};

// The 4-channel group swizzle of row r.
__device__ __forceinline__ int swz(int r) { return (r & 3) << 2; }

template <typename T>
struct Geometry {
  const T* x;
  const T* dy;
  int H, W, C, a, ci0, co0, h_lo, rows, per_row;
};

// Starts the raw copy of segment s: dy positions w0 .. w0 + 79 of image row
// (n, h) and x positions w0 - 2 .. w0 + 81 of row h + a - 2.
template <typename T>
__device__ __forceinline__ void stage(Smem<T>& sm, const Geometry<T>& geo,
                                      int64_t s) {
  const int w0 = static_cast<int>(s % geo.per_row) * kSeg;
  const int64_t r = s / geo.per_row;
  const int h = geo.h_lo + static_cast<int>(r % geo.rows);
  const int64_t n = r / geo.rows;
  const int64_t row_elems = static_cast<int64_t>(geo.W) * geo.C;
  const T* dy_row = geo.dy + (n * geo.H + h) * row_elems + geo.co0;
  const T* x_row = geo.x + (n * geo.H + h + geo.a - kPad) * row_elems + geo.ci0;
  for (int e = threadIdx.x; e < (kSeg + kXRows) * kChunks; e += kThreads) {
    int row = e / kChunks;
    const int c = (e % kChunks) * 4;
    if (row < kSeg) {
      const int w = w0 + row;
      const bool in = w < geo.W && geo.co0 + c < geo.C;
      t2r::cp_async4(&sm.dr[row * kTile + c],
                     in ? dy_row + static_cast<int64_t>(w) * geo.C + c : geo.dy,
                     in);
    } else {
      row -= kSeg;
      const int w = w0 + row - kPad;
      const bool in = w >= 0 && w < geo.W && geo.ci0 + c < geo.C;
      t2r::cp_async4(&sm.xr[row * kTile + c],
                     in ? x_row + static_cast<int64_t>(w) * geo.C + c : geo.x,
                     in);
    }
  }
  t2r::cp_async_commit();
}

template <typename T, int kPasses>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_tc_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    float* __restrict__ partials, int H, int W, int C,
                    int batch) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_bytes);

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int tiles = (C + kTile - 1) / kTile;
  Geometry<T> geo;
  geo.x = x;
  geo.dy = dy;
  geo.H = H;
  geo.W = W;
  geo.C = C;
  geo.a = blockIdx.z;
  geo.ci0 = (blockIdx.y / tiles) * kTile;
  geo.co0 = (blockIdx.y % tiles) * kTile;
  // dy rows h whose shifted x row h + a - 2 lies in the image.
  geo.h_lo = max(0, kPad - geo.a);
  geo.rows = min(H, H + kPad - geo.a) - geo.h_lo;
  geo.per_row = (W + kSeg - 1) / kSeg;
  const int64_t segs =
      geo.rows > 0 ? static_cast<int64_t>(batch) * geo.rows * geo.per_row : 0;
  const int64_t s_begin = segs * split / splits;
  const int64_t s_end = segs * (split + 1) / splits;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 3) * 16;   // this warp's ci rows in the tile
  const int wn = (warp >> 2) * 32;  // and co columns

  float acc[kSide][4][4];
#pragma unroll
  for (int b = 0; b < kSide; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[b][j][i] = 0.0f;
    }
  }

  if (s_begin < s_end) stage(sm, geo, s_begin);
  for (int64_t s = s_begin; s < s_end; ++s) {
    t2r::cp_async_wait_all();
    __syncthreads();  // the copy has landed; the last stage's products ended
    for (int e = tid; e < (kSeg + kXRows) * kChunks; e += kThreads) {
      int row = e / kChunks;
      const int c = (e % kChunks) * 4;
      if (row < kSeg) {
        t2r::store_split4<kPasses>(&sm.ds[row * kTile + (c ^ swz(row))],
                                   t2r::to_float4(&sm.dr[row * kTile + c]));
      } else {
        row -= kSeg;
        t2r::store_split4<kPasses>(&sm.xs[row * kTile + (c ^ swz(row))],
                                   t2r::to_float4(&sm.xr[row * kTile + c]));
      }
    }
    __syncthreads();  // split tiles ready; the raw buffer is free
    if (s + 1 < s_end) stage(sm, geo, s + 1);

    // This segment's sums start from zero and join the block's at its end:
    // the tensor cores' float32 accumulation keeps fewer bits than a
    // rounded float32 add, so its chains stay short (30 products deep).
    float part[kSide][4][4];
#pragma unroll
    for (int b = 0; b < kSide; ++b) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[b][j][i] = 0.0f;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < kSeg / 8; ++kk) {
      const int k0 = kk * 8;
      t2r::Frag<2> bf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 8 * j + g;
        const int r0 = k0 + t, r1 = k0 + t + 4;
        bf[j].set(0, sm.ds[r0 * kTile + (n ^ swz(r0))]);
        bf[j].set(1, sm.ds[r1 * kTile + (n ^ swz(r1))]);
      }
      // Two offsets at a time, pass by pass: eight independent products in
      // a row between two that share an accumulator.
#pragma unroll
      for (int b0 = 0; b0 < kSide; b0 += 2) {
        t2r::Frag<4> af[2];
#pragma unroll
        for (int bi = 0; bi < 2; ++bi) {
          if (b0 + bi < kSide) {
            // x position of dy position k0 + t at offset b: staged row
            // k0 + t + b.
            const int r0 = k0 + b0 + bi + t, r1 = r0 + 4;
            const int m = wm + g;
            af[bi].set(0, sm.xs[r0 * kTile + (m ^ swz(r0))]);
            af[bi].set(1, sm.xs[r0 * kTile + ((m + 8) ^ swz(r0))]);
            af[bi].set(2, sm.xs[r1 * kTile + (m ^ swz(r1))]);
            af[bi].set(3, sm.xs[r1 * kTile + ((m + 8) ^ swz(r1))]);
          }
        }
        if (kPasses == 3) {
#pragma unroll
          for (int bi = 0; bi < 2; ++bi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (b0 + bi < kSide) {
                t2r::mma_tf32(part[b0 + bi][j], af[bi].small, bf[j].big);
              }
            }
          }
#pragma unroll
          for (int bi = 0; bi < 2; ++bi) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (b0 + bi < kSide) {
                t2r::mma_tf32(part[b0 + bi][j], af[bi].big, bf[j].small);
              }
            }
          }
        }
#pragma unroll
        for (int bi = 0; bi < 2; ++bi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (b0 + bi < kSide) {
              t2r::mma_tf32(part[b0 + bi][j], af[bi].big, bf[j].big);
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kSide; ++b) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[b][j][i] += part[b][j][i];
      }
    }
  }

  // partials: [splits, 25, C, C]; this block's tiles of its split, row a.
  const int64_t cc = static_cast<int64_t>(C) * C;
  float* out = partials +
               (static_cast<int64_t>(split) * kSide * kSide + geo.a * kSide) * cc;
#pragma unroll
  for (int b = 0; b < kSide; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = geo.co0 + wn + 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = geo.ci0 + wm + g + 8 * half;
        if (ci < C && co < C) {  // C % 4 == 0: co + 1 < C too
          *reinterpret_cast<float2*>(out + b * cc +
                                     static_cast<int64_t>(ci) * C + co) =
              make_float2(acc[b][j][2 * half], acc[b][j][2 * half + 1]);
        }
      }
    }
  }
}

// out[t] = partials[0][t] + partials[1][t] + ... in that order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int splits,
                                    int64_t size) {
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < size; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) sum += partials[s * size + t];
    out[t] = sum;
  }
}

template <typename T, int kPasses>
cudaError_t launch_partials(const void* x, const void* dy, float* partials,
                            int B, int H, int W, int C, int splits,
                            cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<T>));
  const cudaError_t status = cudaFuncSetAttribute(
      wgrad_tc_kernel<T, kPasses>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return status;
  const int tiles = (C + kTile - 1) / kTile;
  const dim3 grid(splits, tiles * tiles, kSide);
  wgrad_tc_kernel<T, kPasses><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, H, W, C,
      B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy: float32 or bfloat16 [B, H, W, C], contiguous, C % 4 == 0, 16-byte
// aligned; partials: float32 [splits, 5, 5, C, C] scratch; out: float32
// [5, 5, C, C]. The staged row segments of each row offset are divided
// evenly over the `splits` blocks of each (offset, channel tile). Launches
// the partial pass and the fixed-order reduction on `stream`. Returns
// cudaGetLastError() after the launches (0 on success).
int t2r_conv5x5_wgrad(const void* x, const void* dy, void* partials,
                      void* out, int B, int H, int W, int C, int splits,
                      int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const cudaError_t status =
      is_bf16 ? launch_partials<__nv_bfloat16, 1>(x, dy, part, B, H, W, C,
                                                  splits, s)
              : launch_partials<float, 3>(x, dy, part, B, H, W, C, splits, s);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int64_t size = static_cast<int64_t>(kSide) * kSide * C * C;
  int64_t blocks = (size + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  wgrad_reduce_kernel<<<static_cast<int>(blocks), kReduceThreads, 0, s>>>(
      part, static_cast<float*>(out), splits, size);
  return static_cast<int>(cudaGetLastError());
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
