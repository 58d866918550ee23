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
// folded over k/v tiles, the arithmetic of `_block_update`. The state is
// read and written IN PLACE: o float32 [B, H, Lq, D], m and l float32
// [B, H, Lq], all contiguous. Each block owns its query rows, so no two
// blocks touch one row. q, k and v are [B, L, H, D] views given by their
// strides (b, h, l; d is unit stride) with 16-byte aligned rows, as K4
// reads them.
//
// What bounds it on an H100: operations. The one-rank ring's hop ([8, 4096,
// 8, 64], causal, offsets 0) does 137 GFLOP of products over 340 MB of q,
// k, v and the state read and written: 2.05 ms at the CUDA cores' float32
// rate, 0.83 ms for three TF32 passes at the tensor cores' 495 TFLOP/s.
// The kernel is K4's (flash_attention_fwd.cu, whose header describes the
// design: 3xTF32 mma.sync, blocks of 8 warps of 16 queries, double-buffered
// swizzled split tiles by cp.async, the online softmax on the fragments, p
// made in registers, q's fragments held at D = 64, per-lane fragment offset
// tables, the mask in a pass of its own, the longest query tiles first):
// both run flash_fwd.cuh's tile loop, this one as its kCarry instance.
// What the carry adds:
//   * the state in and out: a warp loads its rows' o into its output
//     accumulator fragments, and m and l into each quad's rows, before the
//     first key tile, so the first tile's correction takes the carried m;
//     at the end it stores o unnormalized, m and l. Rows past Lq are neither
//     read nor written;
//   * base-2 exponentials with a natural-log m in memory: the scores are
//     scaled by scale * log2(e), as in K4, so m is converted as it is
//     loaded (m log2 e) and stored (m ln 2), and the NEG_INF sentinel is
//     kept as it is both ways (NEG_INF log2 e would still pass the
//     NEG_INF/2 guard, but would come back as another number). The other
//     choice, natural units throughout, costs a multiply an element in the
//     loop; the conversion costs two a row a hop, and its rounding (some
//     1e-7 of m) is far inside the tolerance;
//   * the causal mask at global offsets: with delta = q_offset - k_offset
//     (clamped to [-Lq, Lk], which changes no mask), key c is hidden from
//     query r when r + delta < c. The tile loop's end, the choice of tiles
//     that take the mask pass and the warp skip all read delta; it need not
//     be a multiple of a tile and may be negative (Lq > Lk);
//   * a block whose queries all precede its first key (every block of a hop
//     that the mask hides) returns before it reads anything, and a warp
//     whose queries do returns without writing: the state they own stays
//     bit for bit as it was.
// Shared memory and registers are K4's: 192 KB at D = 64 in float32, 224 KB
// at D = 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "flash_fwd.cuh"

extern "C" {

// q: [B, Lq, H, D], k and v: [B, Lk, H, D], all float32 or all bfloat16,
// given by element strides (batch, head, row) with unit stride along D and
// 16-byte aligned rows; o: contiguous float32 [B, H, Lq, D]; m, l:
// contiguous float32 [B, H, Lq], all three updated in place. q_offset and
// k_offset are the global positions of q's and k's first rows. D is 64 or
// 128. Returns cudaGetLastError() after the launch (0 on success), or 1
// (cudaErrorInvalidValue) for a D the kernel was not built for.
int t2r_flash_attention_carry(const void* q, const void* k, const void* v,
                              void* o, void* m, void* l, int B, int H, int Lq,
                              int Lk, int D, long long q_sb, long long q_sh,
                              long long q_sl, long long k_sb, long long k_sh,
                              long long k_sl, long long v_sb, long long v_sh,
                              long long v_sl, float scale, int causal,
                              long long q_offset, long long k_offset,
                              int bf16, void* stream) {
  const t2r::fwd::Strides st = {q_sb, q_sh, q_sl, k_sb, k_sh,
                                k_sl, v_sb, v_sh, v_sl};
  // Below -Lq every query precedes every key; above Lk every key precedes
  // every query.
  const long long delta = std::min<long long>(
      std::max<long long>(q_offset - k_offset, -Lq), Lk);
  return t2r::fwd::launch_any<true>(q, k, v, o, m, l, B, H, Lq, Lk, D, st,
                                    scale, causal, static_cast<int>(delta),
                                    bf16, static_cast<cudaStream_t>(stream));
}

const char* t2r_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
