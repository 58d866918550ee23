"""The rounding of the bf16 flash backward kernels, held to the JAX package
on the CPU.

The bf16 instances of K5a and K5b (``csrc/flash_bwd_bf16.cuh``) run on the
card only. Their arithmetic departs from the float32 plain version in one
place: p and ds / scale are rounded to bf16 before the second pair of
products (dv += p^T dO, dk += ds^T q, dq += ds k), as the bf16 tensor cores
take them, with every product exact and summed in float32, exp(s * scale -
lse) taken base 2, the scale applied to the dk and dq sums at the end, and
dq, dk, dv rounded to bf16 once. ``_emulate`` repeats that arithmetic here
(its float32 sums in another order than the card's), so whether the
rounding fits the card's bound shows before the card runs.

Inputs are bf16 values drawn by numpy from a seed. The JAX package's
``_flash_bwd_pallas`` runs in interpret mode on the same values as float32
(its forward's O and LSE too), as ``test_torch_seq2act_training.py``'s K5
test runs it; the emulation takes that LSE and O rounded to bf16, as the
card's bf16 forward writes it. Tolerance: 2e-2 of each gradient's max, the
bound ``chip_smoke.py`` holds the card's bf16 backward to (``BWD_RTOL``):
one bf16 rounding of the result (2^-8 relative) plus the rounding of p, ds
and O (2^-9 relative on each term of sums over hundreds of rows, which
average out far below that).
"""

import importlib

import numpy as np
import pytest
import torch

jax_flash = importlib.import_module('tensor2robot_tpu.parallel.flash_attention')

LOG2E = 1.4426950408889634
RTOL = 2e-2   # of max|JAX|, as chip_smoke.BWD_RTOL[torch.bfloat16]


def _bf16(x):
  """float32 values rounded to bf16 (to nearest even), kept as float32."""
  return torch.as_tensor(np.array(x, np.float32)).to(torch.bfloat16).float()


def _emulate(q, k, v, out, lse, d_out, causal, scale):
  """dq, dk, dv of [BH, L, D] float32 tensors holding bf16 values (lse
  [BH, Lq] float32) by the bf16 kernels' arithmetic."""
  l_q, l_k = q.shape[1], k.shape[1]
  delta = (d_out * out).sum(-1, keepdim=True)      # flash_attention_delta
  s = q @ k.transpose(1, 2)                         # exact products, f32 sums
  p = torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E)
  if causal:
    q_pos = torch.arange(l_q)[:, None]
    k_pos = torch.arange(l_k)[None, :]
    p = torch.where(q_pos >= k_pos, p, torch.zeros(()))
  dp = d_out @ v.transpose(1, 2)
  ds = p * (dp - delta)                             # ds / scale
  p16, ds16 = _bf16(p), _bf16(ds)
  dv = p16.transpose(1, 2) @ d_out
  dk = (ds16.transpose(1, 2) @ q) * scale
  dq = (ds16 @ k) * scale
  return tuple(_bf16(g) for g in (dq, dk, dv))


@pytest.mark.parametrize('b,l_q,l_k,h,d,causal,block_q,block_k', [
    (2, 256, 256, 2, 64, True, 64, 64),
    (2, 200, 136, 3, 128, False, 40, 68),
])
def test_bf16_rounding_matches_jax_backward(b, l_q, l_k, h, d, causal,
                                            block_q, block_k):
  rng = np.random.RandomState(l_q * 1000 + l_k + d)
  bh = b * h
  q, d_out = (_bf16(rng.randn(bh, l_q, d).astype(np.float32))
              for _ in range(2))
  k, v = (_bf16(rng.randn(bh, l_k, d).astype(np.float32)) for _ in range(2))
  scale = 1.0 / float(np.sqrt(d))
  jq, jk, jv, jdo = (x.numpy() for x in (q, k, v, d_out))
  out, lse = jax_flash._flash_bhld(jq, jk, jv, scale=scale, causal=causal,
                                   block_q=block_q, block_k=block_k,
                                   interpret=True)
  want = jax_flash._flash_bwd_pallas(jq, jk, jv, out, lse, jdo, scale=scale,
                                     causal=causal, block_q=block_q,
                                     block_k=block_k, interpret=True)
  got = _emulate(q, k, v, _bf16(np.asarray(out)),
                 torch.from_numpy(np.array(lse, np.float32)), d_out, causal,
                 scale)
  for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
    w = np.asarray(w, np.float32)
    assert g.shape == w.shape, name
    err = float(np.abs(g.numpy() - w).max())
    assert err <= RTOL * float(np.abs(w).max()), (name, err,
                                                  float(np.abs(w).max()))
