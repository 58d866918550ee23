"""Ring attention: exact attention over sequences sharded across ranks.

The counterpart of the JAX package's ``parallel/ring_attention.py``. Each
rank of a ``torch.distributed`` group holds a [B, L/N, H, D] shard of q, k
and v (the per-shard body of JAX's ``shard_map``); the k/v blocks travel
round the ring, rank to rank + 1, while an online softmax folds each into
the rank's running (o, m, l). N hops later every query has seen every key,
exactly.

Forward (``_ring_forward``): hop i holds the block of rank ``src = (rank -
i) mod N``, at global offsets ``q_offset = rank * L/N`` and ``k_offset =
src * L/N``, and folds it in through ``flash_attention_carry`` (kernel K6
on a CUDA tensor, its plain version on a CPU tensor). k and v ride in one
packed buffer, and the next hop's exchange is posted before the hop's
kernel, so that the copy can overlap it; the last hop posts none (JAX's
loop rotates once more, back to where the blocks started). After the last
hop: ``lse = m + log(max(l, 1e-30))``, ``out = o / max(l, 1e-20)``.

The JAX model never reaches the Pallas kernel in ``'ring'`` mode (its
``run_attention`` calls ``ring_self_attention`` without ``use_pallas``,
which defaults to False), and computes the same update in jnp
(``_block_attention``). The two share their arithmetic, so the port routes
every hop through K6.

Backward (``_ring_backward``): JAX's blockwise recompute in plain PyTorch,
as the JAX package writes it in jnp whatever ``use_pallas`` says. Each hop
recomputes ``p = exp(s - lse)`` for the block it holds, with ``delta =
rowsum(dO * O)``; dq accumulates at home, and the dk/dv accumulators ride
the ring with their k/v blocks, arriving home after N hops. A hop that the
causal mask hides entirely adds nothing and is skipped. Each hop holds one
[B, H, L/N, L/N] float32 score block and its derivatives (float64 for
float64 inputs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import flash_attention as flash_lib
from tensor2robot_tpu_torch.parallel.flash_attention import NEG_INF

__all__ = ['ring_self_attention']


def _masked_hop(rank: int, src: int, l_q: int, l_k: int,
                causal: bool) -> bool:
  """Whether the causal mask hides the whole block of ``src`` from the
  queries of ``rank``: its first key follows their last query."""
  return causal and src * l_k > rank * l_q + l_q - 1


def _ring_forward(q, k, v, group, causal: bool, scale: float):
  """(out [B, Lq, H, D] in q's dtype, lse float32 [B, H, Lq]) of this
  rank's shard."""
  rank, n = collectives.rank(group), collectives.world_size(group)
  b, l_q, h, d = q.shape
  l_k = k.shape[1]
  o = torch.zeros((b, h, l_q, d), dtype=torch.float32, device=q.device)
  m = torch.full((b, h, l_q), NEG_INF, dtype=torch.float32, device=q.device)
  l = torch.zeros((b, h, l_q), dtype=torch.float32, device=q.device)
  if q.dtype == torch.float64:
    o, m, l = o.double(), m.double(), l.double()
  kv = torch.stack([k, v])
  for i in range(n):
    src = (rank - i) % n
    exchange = (collectives.ring_permute_async([kv], group) if i < n - 1
                else None)
    flash_lib.flash_attention_carry(q, kv[0], kv[1], o, m, l, rank * l_q,
                                    src * l_k, causal, scale)
    if exchange is not None:
      kv, = exchange.wait()
  lse = m + torch.log(l.clamp_min(1e-30))
  out = o / l.clamp_min(1e-20)[..., None]
  return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, d_out, group, causal: bool,
                   scale: float):
  """(dq, dk, dv) of this rank's shard, each in its input's dtype."""
  rank, n = collectives.rank(group), collectives.world_size(group)
  l_q, l_k = q.shape[1], k.shape[1]
  acc = torch.float64 if q.dtype == torch.float64 else torch.float32
  neg_inf = torch.full((), NEG_INF, dtype=acc, device=q.device)
  zero = torch.zeros((), dtype=acc, device=q.device)
  qf, do = q.to(acc), d_out.to(acc)
  # delta[b, h, q] = sum_d dO * O, the softmax Jacobian's diagonal term.
  delta = (do * out.to(acc)).sum(-1).transpose(1, 2)[..., None]
  lse = torch.where(lse <= NEG_INF / 2, zero, lse.to(acc))[..., None]
  q_pos = rank * l_q + torch.arange(l_q, device=q.device)
  dq = torch.zeros(q.shape, dtype=acc, device=q.device)
  dkv = torch.zeros((2,) + tuple(k.shape), dtype=acc, device=q.device)
  kv = torch.stack([k, v])
  for i in range(n):
    src = (rank - i) % n
    exchange = (collectives.ring_permute_async([kv], group) if i < n - 1
                else None)
    if not _masked_hop(rank, src, l_q, l_k, causal):
      kf, vf = kv[0].to(acc), kv[1].to(acc)
      s = torch.einsum('bqhd,bkhd->bhqk', qf, kf) * scale
      if causal:
        k_pos = src * l_k + torch.arange(l_k, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, neg_inf)
      p = torch.where(s <= NEG_INF / 2, zero, torch.exp(s - lse))
      del s
      dkv[1] += torch.einsum('bhqk,bqhd->bkhd', p, do)
      ds = torch.einsum('bqhd,bkhd->bhqk', do, vf).sub_(delta).mul_(p)
      del p
      dq += torch.einsum('bhqk,bkhd->bqhd', ds, kf) * scale
      dkv[0] += torch.einsum('bhqk,bqhd->bkhd', ds, qf) * scale
      del ds, kf, vf
    if exchange is not None:
      kv, = exchange.wait()
    # The accumulators go on with their block; after N hops each is home.
    dkv, = collectives.ring_permute([dkv], group)
  return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
  """This rank's shard of ring attention, differentiable in q, k and v."""

  @staticmethod
  def forward(ctx, q, k, v, group, causal, scale):
    out, lse = _ring_forward(q, k, v, group, causal, scale)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.group, ctx.causal, ctx.scale = group, causal, scale
    return out

  @staticmethod
  def backward(ctx, d_out):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _ring_backward(q, k, v, out, lse, d_out, ctx.group,
                                ctx.causal, ctx.scale)
    return dq, dk, dv, None, None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        group, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
  """Exact attention of the sequence that ``group``'s ranks hold in shards.

  q, k, v: this rank's [B, L/N, H, D] shard (rank r holds positions
  ``[r L/N, (r + 1) L/N)``; strided views with unit stride along D will
  do). ``causal`` masks over global positions. ``scale`` defaults to ``1 /
  sqrt(D)``. Every rank of the group must call it together. Shard lengths
  above 128 must be multiples of 128 (the carry kernel's block rule, as in
  JAX): otherwise it raises ValueError before any rank posts an exchange,
  since a rank that raised with a send in flight would leave its peers
  waiting. Returns this rank's [B, L/N, H, D] shard of the output in q's
  dtype.
  """
  if group is None:
    raise ValueError('ring_self_attention needs a process group.')
  if q.dim() != 4 or k.shape != v.shape or k.shape != q.shape:
    raise ValueError('ring_self_attention takes q, k, v shards of one shape '
                     '[B, L/N, H, D]; got {}, {}, {}.'.format(
                         tuple(q.shape), tuple(k.shape), tuple(v.shape)))
  flash_lib.check_carry_lengths(q.shape[1], k.shape[1])
  if scale is None:
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
  return _RingAttention.apply(q, k, v, group, causal, scale)

