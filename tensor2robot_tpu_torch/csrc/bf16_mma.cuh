// bfloat16 products on Hopper's tensor cores through mma.sync, and the
// 16-byte cp.async copies and ldmatrix fragment loads that feed them.
// Used by flash_bwd_bf16.cuh (the bfloat16 instances of K5a and K5b) and
// flash_fwd_bf16.cuh (those of K4 and K6).
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, lane = 4 g + t
// (g = lane / 4, t = lane % 4), A 16 x 16, B 16 x 8, C 16 x 8 float32; each
// A and B register holds two bfloat16 values, the lower k index in the
// lower half:
//   a0 = A[g][2t, 2t+1],     a1 = A[g + 8][2t, 2t+1],
//   a2 = A[g][2t+8, 2t+9],   a3 = A[g + 8][2t+8, 2t+9]
//   b0 = B[2t, 2t+1][g],     b1 = B[2t+8, 2t+9][g]
//   c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]
// So the C fragments of two adjacent n8 tiles (columns 16j .. 16j + 15) are
// the A fragment of one k16 step, rounded to bfloat16 and packed in pairs:
// a0 = (c0, c1) and a1 = (c2, c3) of tile 2j, a2 and a3 the same of tile
// 2j + 1 (`a_from_c`).
//
// Tiles live in shared memory as bfloat16 rows of D elements, D / 8 chunks
// of 16 bytes, with chunk c of row r stored at chunk c ^ (r & 7). ldmatrix
// reads eight 16-byte rows a matrix; the eight rows r0 .. r0 + 7 (r0 a
// multiple of 8) of one logical chunk sit at eight distinct chunks, which
// cover the 32 banks once: every fragment load is free of bank conflicts,
// along D and, transposed, along the rows alike. A lane addresses one row of
// one 8 x 8 matrix of an x4 load:
//   `kRowsFirst` (A operands, and B operands loaded transposed): lanes 0-7
//     rows 0-7 of chunk c, lanes 8-15 rows 8-15 of chunk c, lanes 16-23
//     rows 0-7 of chunk c + 1, lanes 24-31 rows 8-15 of chunk c + 1;
//     ldmatrix gives a0 .. a3 of a 16-row, 16-column A fragment, or, with
//     .trans on a tile whose rows are the k index, b0, b1 of n tile c / 2
//     and b0, b1 of n tile c / 2 + 1 (the columns 8c .. 8c + 15);
//   `kChunksFirst` (B operands whose rows are the n index): lanes 0-7 rows
//     0-7 of chunk c, lanes 8-15 rows 0-7 of chunk c + 1, lanes 16-23 rows
//     8-15 of chunk c, lanes 24-31 rows 8-15 of chunk c + 1; ldmatrix gives
//     b0, b1 of n tile (rows 0-7) and b0, b1 of n tile (rows 8-15) for the
//     k16 step of chunks c, c + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace t2r {

// d += a b on the tensor cores: bfloat16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two float32 values rounded to bfloat16 (to nearest even), lo in the lower
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k16 step j from the C fragments of n tiles 2j, 2j + 1.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Two float32 values as two bfloat16 halves: hi rounded to nearest even,
// lo the rounding of the rest (x - hi is exact in float32). hi + lo keeps
// some 16 bits of each value: a relative error below 2^-17.
__device__ __forceinline__ void pack_bf16_split(uint32_t& hi, uint32_t& lo,
                                                float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// `a_from_c` with each value split into its two halves.
__device__ __forceinline__ void a_from_c_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c0)[4],
                                               const float (&c1)[4]) {
  pack_bf16_split(hi[0], lo[0], c0[0], c0[1]);
  pack_bf16_split(hi[1], lo[1], c0[2], c0[3]);
  pack_bf16_split(hi[2], lo[2], c1[0], c1[1]);
  pack_bf16_split(hi[3], lo[3], c1[2], c1[3]);
}

// 16 bytes from global to shared memory without the registers; a copy that
// is not `valid` writes zeros and reads nothing (`src` must still be a
// mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Byte offset of chunk c of row r in a swizzled tile of D bfloat16 columns.
template <int D>
__device__ __forceinline__ uint32_t swz_offset(int r, int c) {
  return static_cast<uint32_t>(r * (2 * D) + ((c ^ (r & 7)) << 4));
}

// Starts the copy of kTileRows rows of D bfloat16 from `src` (row stride
// `ld` elements) from row r0 on into the swizzled tile at shared address
// `dst`, by kThreads threads; rows from `limit` on are zero-filled.
template <int D, int kTileRows, int kThreads>
__device__ __forceinline__ void stage_rows(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           int64_t ld, int r0, int limit) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kTileRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool in = r0 + r < limit;
    cp_async16(dst + swz_offset<D>(r, c),
               in ? src + (r0 + r) * ld + c * 8 : src, in);
  }
}

// Where a lane points an x4 ldmatrix of a swizzled tile: `at(r0, c0)` is the
// shared address of the lane's row of the four 8 x 8 matrices at rows
// r0 .. r0 + 15 (r0 a multiple of 8) and chunks c0, c0 + 1 (c0 even). The
// lane's row and chunk offsets and its swizzle are fixed once, so a load
// costs an xor and an add.
template <int D, bool kRowsFirst>
struct LdsmLane {
  uint32_t row_bytes;   // the lane's row offset times the row's bytes
  int key;              // the lane's chunk offset ^ its row's swizzle

  __device__ __forceinline__ explicit LdsmLane(int lane) {
    const int row = kRowsFirst ? (lane & 7) + ((lane >> 3) & 1) * 8
                               : (lane & 7) + (lane >> 4) * 8;
    const int chunk = kRowsFirst ? lane >> 4 : (lane >> 3) & 1;
    row_bytes = static_cast<uint32_t>(row * (2 * D));
    key = chunk ^ (lane & 7);   // (c0 + chunk) ^ (row & 7) for even c0
  }
  __device__ __forceinline__ uint32_t at(uint32_t tile, int r0,
                                         int c0) const {
    return tile + static_cast<uint32_t>(r0 * (2 * D)) + row_bytes +
           (static_cast<uint32_t>(c0 ^ key) << 4);
  }
};

}  // namespace t2r
