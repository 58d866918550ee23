"""The rounding of the bf16 flash forward kernels, K4 and K6, held to the JAX
package on the CPU.

The bf16 instances of K4 and K6 (``csrc/flash_fwd_bf16.cuh``) run on the
card only. Their arithmetic departs from the float32 plain versions in one
place, how p meets v: the tensor cores take p as bf16, where JAX's
``_block_update`` keeps it in float32. K4 rounds p to bf16 (relative to the
running max) for p v; K6 splits it into a bf16 high half and the bf16
rounding of the rest, two products against v. In both, every product of
bf16 inputs is exact and summed in float32, the online softmax folds key
tiles of the kernel's width with the running max (base-2 exponentials, the
``NEG_INF`` guards), and l and the correction come from the float32 p, so
the LSE, m and l never see a rounded p. K4 rounds O to bf16 once, as
o / l. ``_fold`` repeats that arithmetic here (its float32 sums in another
order than the card's), so whether the rounding fits the card's bounds
shows before the card runs.

Inputs are bf16 values drawn by numpy from a seed. JAX's ``_flash_bhld``
and ``flash_attention_carry`` run in interpret mode on the same values as
float32. Tolerances are those ``chip_smoke.py`` holds the card's bf16
kernels to: K4's O within 2e-2 (``FLASH_ATOL``: O's own bf16 rounding,
2^-8 relative on values of order 1, plus p's, 2^-9 on each term of a sum
weighted by p) and its LSE within 1e-5 (``LSE_ATOL``); K6's o, m and l,
after a carried hop, within 1e-5 of each one's max (``CARRY_RTOL``). One
rounding of p in K6 would miss that bound, which is why K6 splits p: the
last test shows it.
"""

import importlib

import numpy as np
import pytest
import torch

jax_flash = importlib.import_module('tensor2robot_tpu.parallel.flash_attention')

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
FLASH_ATOL = 2e-2   # chip_smoke.FLASH_ATOL[torch.bfloat16]
LSE_ATOL = 1e-5     # chip_smoke.LSE_ATOL
CARRY_RTOL = 1e-5   # chip_smoke.CARRY_RTOL
# The key tiles of the bf16 kernels (flash_fwd_bf16.cuh's Cfg): K4's 64
# keys at D = 64 and 128; K6's 64 at D = 64 and 32 at D = 128.
K4_BLOCK_K = {64: 64, 128: 64}
K6_BLOCK_K = {64: 64, 128: 32}


def _bf16(x):
  """float32 values rounded to bf16 (to nearest even), kept as float32."""
  return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).float()


def _draw(rng, *shape):
  return _bf16(rng.randn(*shape).astype(np.float32))


def _fold(q, k, v, o, m2, l, q_pos, k_pos, causal, scale, block_k, p_v):
  """The bf16 kernels' tile loop: folds [BH, Lk, D] keys at positions
  ``k_pos`` into the [BH, Lq] state (o, m in base-2 units, l) of queries
  at positions ``q_pos``, ``block_k`` keys a tile; ``p_v(p, v)`` is the
  tile's p v from the float32 p."""
  to_log2 = scale * LOG2E
  zero = torch.zeros(())
  for k0 in range(0, k.shape[1], block_k):
    s = (q @ k[:, k0:k0 + block_k].transpose(1, 2)) * to_log2
    if causal:
      keep = q_pos[:, None] >= k_pos[None, k0:k0 + block_k]
      s = torch.where(keep, s, torch.full((), NEG_INF))
    m_new = torch.maximum(m2, s.amax(-1))
    safe = torch.where(m_new <= NEG_INF / 2, zero, m_new)
    p = torch.where(s <= NEG_INF / 2, zero, torch.exp2(s - safe[..., None]))
    corr = torch.where(m2 <= NEG_INF / 2, zero, torch.exp2(m2 - safe))
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + p_v(p, v[:, k0:k0 + block_k])
    m2 = m_new
  return o, m2, l


def _rounded(p, v):
  """K4: p rounded to bf16 for p v."""
  return _bf16(p) @ v


def _split(p, v):
  """K6: p as two bf16 halves, hi + lo, two products against v."""
  hi = _bf16(p)
  lo = _bf16(p - hi)
  return lo @ v + hi @ v


def _k4(q, k, v, causal, scale):
  """(O rounded to bf16, LSE) of [BH, L, D] tensors holding bf16 values by
  K4's bf16 arithmetic."""
  bh, l_q, d = q.shape
  o, m2, l = _fold(q, k, v, torch.zeros((bh, l_q, d)),
                   torch.full((bh, l_q), NEG_INF), torch.zeros((bh, l_q)),
                   torch.arange(l_q), torch.arange(k.shape[1]), causal,
                   scale, K4_BLOCK_K[d], _rounded)
  l_final = l.clamp_min(1e-20)
  return _bf16(o / l_final[..., None]), m2 * LN2 + torch.log(l_final)


def _k6(q, k, v, state, q_offset, k_offset, causal, scale, p_v=_split):
  """The carried (o, m, l) after K6's bf16 update: m converted to base 2
  and back, the NEG_INF sentinel kept; rows whose query precedes every key
  keep their state."""
  o, m, l = (torch.from_numpy(np.array(x, np.float32)) for x in state)
  bh, l_q, d = q.shape
  q_pos = q_offset + torch.arange(l_q)
  m2 = torch.where(m <= NEG_INF / 2, torch.full((), NEG_INF), m * LOG2E)
  o2, m2, l2 = _fold(q, k, v, o, m2, l, q_pos,
                     k_offset + torch.arange(k.shape[1]), causal, scale,
                     K6_BLOCK_K[d], p_v)
  m_out = torch.where(m2 <= NEG_INF / 2, torch.full((), NEG_INF), m2 * LN2)
  seen = (q_pos >= k_offset) if causal else torch.ones(l_q, dtype=torch.bool)
  return (torch.where(seen[:, None], o2, o), torch.where(seen, m_out, m),
          torch.where(seen, l2, l))


@pytest.mark.parametrize('b,l,h,d,causal,block', [
    (2, 256, 2, 64, True, 64),
    (2, 200, 3, 128, False, 40),   # 64-key tiles: the last one ragged
])
def test_k4_bf16_rounding_matches_jax_forward(b, l, h, d, causal, block):
  rng = np.random.RandomState(l * 10 + d)
  q, k, v = (_draw(rng, b * h, l, d) for _ in range(3))
  scale = 1.0 / float(np.sqrt(d))
  want_o, want_lse = jax_flash._flash_bhld(
      q.numpy(), k.numpy(), v.numpy(), scale=scale, causal=causal,
      block_q=block, block_k=block, interpret=True)
  got_o, got_lse = _k4(q, k, v, causal, scale)
  o_err = float(np.abs(got_o.numpy() - np.asarray(want_o)).max())
  lse_err = float(np.abs(got_lse.numpy() - np.asarray(want_lse)).max())
  assert o_err <= FLASH_ATOL, o_err
  assert lse_err <= LSE_ATOL, lse_err


def _carry_case(d, l_q, l_k, q_offset, k_offset, seed):
  """q, k, v of a hop and the JAX state after an earlier full hop of the
  same queries, all bf16 values; JAX's updated state."""
  rng = np.random.RandomState(seed)
  bh = 4
  q, k0, v0 = (_draw(rng, bh, l_q, d) for _ in range(3))
  k, v = (_draw(rng, bh, l_k, d) for _ in range(2))
  scale = 1.0 / float(np.sqrt(d))
  state = (np.zeros((bh, l_q, d), np.float32),
           np.full((bh, l_q), NEG_INF, np.float32),
           np.zeros((bh, l_q), np.float32))
  state = jax_flash.flash_attention_carry(
      q.numpy(), k0.numpy(), v0.numpy(), *state, q_offset, q_offset - l_q,
      True, scale, interpret=True)
  want = jax_flash.flash_attention_carry(
      q.numpy(), k.numpy(), v.numpy(), *state, q_offset, k_offset, True,
      scale, interpret=True)
  return q, k, v, state, scale, [np.asarray(w, np.float32) for w in want]


def _rel_err(got, want):
  return max(float(np.abs(g.numpy() - w).max()) /
             max(float(np.abs(w).max()), 1e-30) for g, w in zip(got, want))


# Rank 1's queries of a two-rank ring (offset 128) after rank 0's block.
CARRY_CASES = [
    (64, 128, 128, 128, 128),   # the diagonal hop
    (64, 128, 128, 128, 0),     # a full hop
    (64, 128, 128, 128, 256),   # a hop the mask hides
    (64, 128, 128, 128, 148),   # hidden from the first 20 queries
    (128, 100, 72, 40, 30),     # ragged 32-key tiles, across the diagonal
]


@pytest.mark.parametrize('d,l_q,l_k,q_offset,k_offset', CARRY_CASES)
def test_k6_bf16_split_matches_jax_carry(d, l_q, l_k, q_offset, k_offset):
  q, k, v, state, scale, want = _carry_case(d, l_q, l_k, q_offset, k_offset,
                                            seed=q_offset + k_offset + d)
  got = _k6(q, k, v, state, q_offset, k_offset, True, scale)
  err = _rel_err(got, want)
  assert err <= CARRY_RTOL, err
  hidden = min(max(k_offset - q_offset, 0), l_q)
  for g, s in zip(got, state):   # rows that see no key keep their bits
    np.testing.assert_array_equal(g[:, :hidden].numpy(),
                                  np.asarray(s)[:, :hidden])


def test_k6_bf16_one_rounding_of_p_would_miss_the_bound():
  """Why K6 splits p: at the diagonal hop, p rounded once to bf16 moves o
  by more than CARRY_RTOL of its max; the split keeps it within."""
  q, k, v, state, scale, want = _carry_case(*CARRY_CASES[0], seed=7)
  split = _rel_err(_k6(q, k, v, state, 128, 128, True, scale), want)
  rounded = _rel_err(_k6(q, k, v, state, 128, 128, True, scale,
                         p_v=_rounded), want)
  assert split <= CARRY_RTOL < rounded, (split, rounded)
