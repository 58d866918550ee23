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
// the arithmetic of `_block_update` and `_finalize`, with the causal mask at
// global positions (q_pos >= k_pos, no offset), and with the exponentials
// taken base 2: the scores are scaled by scale * log2(e), so m is in base-2
// units, exp(s - m) is 2^(s' - m'), and lse = m' ln 2 + log(l). The guards
// are the same and in the same places.
//
// Inputs are [B, L, H, D] views given by their strides (b, h, l; d is unit
// stride), so the kernel reads q, k and v straight out of the head-major
// [B, L, H, 3, D] qkv projection without copies. Every row of q, k and v is
// 16-byte aligned (the tiles are copied 4 elements at a time). O is written
// contiguous [B, Lq, H, D]; LSE contiguous [B, H, Lq].
//
// What bounds it on an H100: operations. At the served shape (B*H = 8,
// L = 4096, D = 64, causal) it does two products per unmasked (q, k) pair
// (s and p v), 17.2 GFLOP, over 34 MB of q, k, v and o: some 500 operations
// a byte. 0.26 ms at the CUDA cores' 67 TFLOP/s float32 rate; 0.10 ms for
// the three TF32 passes of float32-grade products at the tensor cores'
// 495 TFLOP/s. The design is the dQ kernel's (flash_attention_bwd_q.cu)
// with dp and ds taken away and the output accumulator added:
//   * both products on the tensor cores in float32 grade (tf32_mma.cuh):
//     each operand is split once into TF32 big and small halves, and
//     mma.sync m16n8k8 sums small*big + big*small + big*big in float32.
//     bfloat16 q, k and v are exact in TF32, so s takes the big pass alone;
//     p is float32 (as `_block_update` computes it), so p v takes p's small
//     and big halves against v's exact big one. Each key tile's p v sums
//     start at zero in their own fragments and are added into the float32
//     output accumulator after its correction, o = o * corr + tile sum, as
//     the tensor cores' float32 accumulation keeps fewer bits over long
//     chains;
//   * one block of 8 warps per (bh, tile of 128 query rows), each warp
//     owning 16 queries; the output, its row max and its row sum stay in
//     registers and are written once, at the end, in a fixed order: the same
//     bits run to run. The block loops over key tiles (the Pallas kernel's
//     sequential grid axis), stopping under the causal mask at the
//     diagonal; only a tile that crosses the diagonal or the ragged end of
//     the keys is masked, in a pass of its own before the softmax, and a
//     warp whose 16 queries all precede a tile's keys skips it. The grid
//     issues the query tiles with the most work (the last, under the causal
//     mask) first;
//   * k and v tiles are copied with cp.async into two raw buffers, two
//     tiles ahead, and split into two buffers of float2 {big, small} rows
//     whose 4-column groups are XOR-swizzled by the row (flash_tile.cuh), so
//     that k is read free of bank conflicts as the B operand of s (rows g,
//     columns t and t + 4 along D) and v as the B operand of p v (rows 2t
//     and 2t + 1 along the keys, column g). A tile costs one barrier: after
//     it, each warp splits its share of the next tile, starts the copy of
//     the one after, and multiplies this one;
//   * s is computed with the queries as rows, so the online softmax runs on
//     its accumulator fragments: a row's scores lie in the 4 threads of a
//     quad, and its max and sum take two shuffles each; 2^x is one
//     ex2.approx instruction. The fragments, turned into p in registers,
//     are the A operands of p v as they stand: the thread's two key columns
//     (2t, 2t + 1) of a fragment become its two k slots (t, t + 4), and the
//     B fragments read v rows 2t and 2t + 1 to match. p never touches shared
//     memory, and no barrier separates the two products;
//   * at D = 64, each warp's q A fragments (the same for every key tile) are
//     read from shared memory once and held in registers, 64 of them in
//     float32, and key tiles are 64 rows: q's split tile is staged where
//     the split k tiles go, before the first key tile lands. A tile then
//     costs a warp 128 8-byte B-fragment loads for s (D/8 k steps of 8 n
//     tiles, 2 loads each) and 128 for p v (8 k steps of D/8 n tiles)
//     against 384 tensor-core products (128 + 256 in bfloat16). At D = 128
//     the fragments do not fit: q's split tile stays in shared memory beside
//     16-row key tiles and is read in every tile, and p v runs over 8 n
//     tiles at a time, so that two products on one accumulator are eight
//     apart;
//   * every fragment load is one LDS at a constant offset from one of 16
//     per-lane byte offsets (FragOffsets): the swizzle of a row depends only
//     on its low 3 bits and the parity of its 8-row group. Computing each
//     swizzled address in the loop took more instructions than the products
//     and loads together (cuobjdump's SASS); the copy and split passes run
//     fixed trip counts for the same reason.
// 128 queries a block share each key tile's copy, split and barrier among 8
// warps; at some 245 registers a thread (`-Xptxas=-v`) one block, 8 warps,
// fills a SM either way. Shared memory: 2 * 8 * D * 2 * kBlockK bytes of
// split tiles and 2 * 2 * kBlockK * D raw elements, plus at D = 128 q's
// 8 * 128 * D split tile: 192 KB at D = 64 in float32, 224 KB at D = 128.
// The size is set per launch with cudaFuncSetAttribute.
//
// The kernel is flash_fwd.cuh's tile loop, which K6 (the ring hop's carried
// update, flash_attention_carry.cu) shares; this file is its entry point.

#include <cuda_runtime.h>

#include "flash_fwd.cuh"

extern "C" {

// q: [B, Lq, H, D], k and v: [B, Lk, H, D], all float32 or all bfloat16,
// given by element strides (batch, head, row) with unit stride along D and
// 16-byte aligned rows; o: contiguous [B, Lq, H, D] of the inputs' type;
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
  const t2r::fwd::Strides st = {q_sb, q_sh, q_sl, k_sb, k_sh,
                                k_sl, v_sb, v_sh, v_sl};
  return t2r::fwd::launch_any<false>(q, k, v, o, lse, nullptr, B, H, Lq, Lk,
                                     D, st, scale, causal, 0, bf16,
                                     static_cast<cudaStream_t>(stream));
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
