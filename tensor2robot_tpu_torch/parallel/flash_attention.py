"""Flash attention, forward and backward, and the ring hop: kernels K4,
K5a, K5b and K6 of the port.

The JAX package's ``parallel/flash_attention.py`` runs exact attention as a
Pallas TPU kernel (``_flash_bhld``): an online softmax over k/v blocks that
never writes the [L, L] scores to memory, returning O and the per-row
log-sum-exp (LSE). Its ``custom_vjp`` backward (``_flash_bwd_pallas``) is
two more Pallas kernels that recompute the probabilities from the LSE: one
for dK and dV (``_flash_bwd_kv_kernel``), one for dQ
(``_flash_bwd_q_kernel``). Their Hopper counterparts are the CUDA kernels
in ``csrc/flash_attention_fwd.cu`` (K4), ``csrc/flash_attention_bwd_kv.cu``
(K5a) and ``csrc/flash_attention_bwd_q.cu`` (K5b).

A CUDA tensor goes through those kernels or raises; a CPU tensor goes
through the plain versions: ``flash_attention_plain``, a dense softmax over
[BH, L, L] with the same arithmetic (``NEG_INF`` masking, ``p`` zeroed
below ``NEG_INF / 2``, ``O = acc / max(l, 1e-20)``, ``LSE = m +
log(max(l, 1e-20))``), and ``flash_attention_bwd_plain``, ``_bwd_p_ds``
written out densely. ``delta = rowsum(dO * O)`` is plain PyTorch before
K5a and K5b, as the JAX package computes it outside its kernels. The plain
versions compute in float32 (float64 for float64 inputs, which only they
take). ``flash_attention_forward`` and ``flash_attention_backward`` are
the dispatchers the ``autograd.Function`` calls.

``block_q`` and ``block_k`` (and the backward's ``block_q_bwd`` and
``block_k_bwd``, defaulting by length as ``_bwd_default_blocks`` does) keep
the JAX contract: a length that no block of the ladder (a multiple of 8)
divides raises ``ValueError``. They do not tile the CUDA kernels, which run
their own tiles and mask a ragged tail; the plain versions are dense. The
JAX wrapper's zero padding of the head dim to 128 is a Mosaic lane rule and
is not carried over: the kernels take D = 64 or 128 as it is.

``flash_attention_carry`` is the inner step of ring attention
(``parallel/ring_attention.py``), the JAX package's ``flash_attention_carry``
(``_flash_carry_kernel``): one unnormalized online-softmax update of a
carried (o, m, l) with a k/v block at global positions, in place. A CUDA
tensor goes through kernel K6 (``csrc/flash_attention_carry.cu``), a CPU
tensor through ``flash_attention_carry_plain``, ``_block_update`` over the
whole block at once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import kernels

__all__ = ['NEG_INF', 'flash_attention', 'flash_attention_backward',
           'flash_attention_bwd_kv', 'flash_attention_bwd_plain',
           'flash_attention_bwd_plain_blhd', 'flash_attention_bwd_q',
           'flash_attention_carry', 'flash_attention_carry_plain',
           'flash_attention_delta', 'flash_attention_forward',
           'flash_attention_plain', 'flash_attention_plain_blhd',
           'flash_attention_with_lse']

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (64, 128)


def _dividing_block_or_raise(requested: int, length: int) -> int:
  """The largest block <= ``requested`` on the power-of-two ladder that
  divides ``length``; raises for lengths nothing on it divides (L % 8)."""
  for candidate in (requested, 512, 256, 128, 64, 32, 16, 8):
    if (candidate % 8 == 0 and candidate <= length and
        length % candidate == 0 and candidate <= requested):
      return candidate
  raise ValueError(
      'No flash-attention block size <= {} divides sequence length {}; '
      'pad the sequence to a multiple of 8.'.format(requested, length))


def _bwd_default_blocks(l_q: int, l_k: int) -> Tuple[int, int]:
  """The JAX backward's default blocks, keyed on the longer side."""
  return (256, 256) if max(l_q, l_k) <= 4096 else (512, 1024)


def _check_blocks(q: torch.Tensor, l_q: int, l_k: int, block_q: int,
                  block_k: int, block_q_bwd: Optional[int],
                  block_k_bwd: Optional[int]) -> None:
  if q.element_size() >= 4:
    # The JAX wrapper caps float32 blocks (a VMEM limit); kept so that the
    # same lengths raise.
    block_q, block_k = min(block_q, 256), min(block_k, 512)
  _dividing_block_or_raise(min(block_q, l_q), l_q)
  _dividing_block_or_raise(min(block_k, l_k), l_k)
  default_q, default_k = _bwd_default_blocks(l_q, l_k)
  _dividing_block_or_raise(min(block_q_bwd or default_q, l_q), l_q)
  _dividing_block_or_raise(min(block_k_bwd or default_k, l_k), l_k)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
  return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_keep(l_q: int, l_k: int, device) -> torch.Tensor:
  """[Lq, Lk] bool: q_pos >= k_pos at global positions (no offset)."""
  return (torch.arange(l_q, device=device)[:, None] >=
          torch.arange(l_k, device=device)[None, :])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(O, LSE) of [BH, L, D] inputs by a dense softmax over [BH, Lq, Lk].

  The arithmetic of the Pallas kernel's ``_block_update`` and finalize in
  one block: float32 scores ``q k^T * scale``, the causal mask at global
  positions (``q_pos >= k_pos``) as ``NEG_INF``. O is in q's dtype, LSE
  float32 [BH, Lq].
  """
  acc = _acc_dtype(q)
  s = torch.einsum('bqd,bkd->bqk', q.to(acc), k.to(acc)) * scale
  if causal:
    keep = _causal_keep(q.shape[1], k.shape[1], q.device)
    s = torch.where(keep, s, torch.full((), NEG_INF, dtype=acc,
                                        device=q.device))
  m = s.amax(-1, keepdim=True)
  safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
  p = torch.exp(s - safe_m)
  p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
  l_final = p.sum(-1, keepdim=True).clamp_min(1e-20)
  out = torch.einsum('bqk,bkd->bqd', p, v.to(acc)) / l_final
  return out.to(q.dtype), (m + torch.log(l_final))[..., 0]


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, d_out: torch.Tensor,
                              causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, ...]:
  """(dq, dk, dv) of [BH, L, D] operands, dense: ``_bwd_p_ds`` written out.

  ``s = q k^T * scale`` in float32 with ``NEG_INF`` where ``q_pos <
  k_pos``; ``p = exp(s - lse)``, zeroed where causal and ``s <= NEG_INF /
  2``; ``dp = dO v^T``; ``ds = p (dp - delta) scale`` with ``delta =
  rowsum(dO * O)``; ``dv = p^T dO``, ``dk = ds^T q``, ``dq = ds k``, each in
  its input's dtype.
  """
  acc = _acc_dtype(q)
  qf, kf, vf, do = (x.to(acc) for x in (q, k, v, d_out))
  delta = (do * out.to(acc)).sum(-1, keepdim=True)
  s = torch.einsum('bqd,bkd->bqk', qf, kf) * scale
  if causal:
    keep = _causal_keep(q.shape[1], k.shape[1], q.device)
    s = torch.where(keep, s, torch.full((), NEG_INF, dtype=acc,
                                        device=q.device))
  p = torch.exp(s - lse.to(acc)[..., None])
  if causal:
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
  dp = torch.einsum('bqd,bkd->bqk', do, vf)
  ds = p * (dp - delta) * scale
  dv = torch.einsum('bqk,bqd->bkd', p, do)
  dk = torch.einsum('bqk,bqd->bkd', ds, qf)
  dq = torch.einsum('bqk,bkd->bqd', ds, kf)
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _to_bhld(x: torch.Tensor) -> torch.Tensor:
  b, l, h, d = x.shape
  return x.permute(0, 2, 1, 3).reshape(b * h, l, d)


def _from_bhld(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
  return x.reshape(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


def flash_attention_plain_blhd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``flash_attention_plain`` on [B, L, H, D]: (O [B, Lq, H, D], LSE
  [B, H, Lq]), the layout of the CUDA kernel's inputs and outputs."""
  b, l_q, h, _ = q.shape
  out, lse = flash_attention_plain(_to_bhld(q), _to_bhld(k), _to_bhld(v),
                                   causal, scale)
  return _from_bhld(out, b, h), lse.reshape(b, h, l_q)


def flash_attention_bwd_plain_blhd(q, k, v, out, lse, d_out, causal: bool,
                                   scale: float) -> Tuple[torch.Tensor, ...]:
  """``flash_attention_bwd_plain`` on [B, L, H, D] operands and LSE
  [B, H, Lq]: (dq, dk, dv) [B, L, H, D]."""
  b, l_q, h, _ = q.shape
  grads = flash_attention_bwd_plain(
      _to_bhld(q), _to_bhld(k), _to_bhld(v), _to_bhld(out),
      lse.reshape(b * h, l_q), _to_bhld(d_out), causal, scale)
  return tuple(_from_bhld(g, b, h) for g in grads)


def _check_cuda(name: str, q, *others) -> None:
  if q.device.type != 'cuda':
    raise ValueError('{} launches a CUDA kernel; q is on {}.'.format(
        name, q.device))
  for i, t in enumerate((q,) + others):
    if t.device != q.device:
      raise ValueError('{}: operand {} is on {}, q on {}.'.format(
          name, i, t.device, q.device))
    if t.dtype != q.dtype:
      raise ValueError('{}: operands must share a dtype; operand {} is {}, '
                       'q {}.'.format(name, i, t.dtype, q.dtype))
    if t.stride(-1) != 1:
      raise ValueError('{} reads operand {} with unit stride along D; got '
                       'strides {}.'.format(name, i, t.stride()))
  if q.dtype not in _DTYPES:
    raise ValueError('{} takes float32 or bfloat16, not {}.'.format(
        name, q.dtype))
  if q.shape[-1] not in _HEAD_DIMS:
    raise ValueError('{} is built for head dims {}, not {}.'.format(
        name, _HEAD_DIMS, q.shape[-1]))
  if q.shape[0] * q.shape[2] > 65535:
    raise ValueError('{} launches one block row per (batch, head): at most '
                     '65535.'.format(name))
  if min(q.shape[1], others[0].shape[1] if others else 1) == 0:
    raise ValueError('{} needs at least one query and one key.'.format(name))


def _strides(*tensors):
  """(batch, head, row) element strides of [B, L, H, D] tensors."""
  out = []
  for t in tensors:
    out += [t.stride(0), t.stride(2), t.stride(1)]
  return out


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
  """K4 on [B, L, H, D] strided views: (O [B, Lq, H, D], LSE [B, H, Lq])."""
  _check_cuda('flash_attention_fwd', q, k, v)
  _check_rows_aligned('flash_attention_fwd', q, k, v)
  b, l_q, h, d = q.shape
  l_k = k.shape[1]
  out = torch.empty((b, l_q, h, d), dtype=q.dtype, device=q.device)
  lse = torch.empty((b, h, l_q), dtype=torch.float32, device=q.device)
  kernels.launch('flash_attention_fwd', q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, h, l_q, l_k, d, *_strides(q, k, v), float(scale),
                 int(causal), int(q.dtype == torch.bfloat16))
  return out, lse


def _rows_aligned(t: torch.Tensor) -> bool:
  """Whether every (batch, head, row) start of a [B, L, H, D] view is
  16-byte aligned."""
  return t.data_ptr() % 16 == 0 and all(
      t.stride(i) * t.element_size() % 16 == 0 for i in range(3))


def _check_rows_aligned(name: str, *tensors) -> None:
  """K4, K5a, K5b and K6 copy rows 4 elements at a time: every row of
  their [B, L, H, D] operands must start on 16 bytes."""
  for i, t in enumerate(tensors):
    if not _rows_aligned(t):
      raise ValueError('{} copies rows 4 elements at a time: operand {} '
                       'needs 16-byte aligned rows; got strides {} at '
                       'address {}.'.format(name, i, t.stride(),
                                            t.data_ptr()))


def _check_bwd_cuda(name: str, q, k, v, d_out, lse, delta) -> None:
  """The checks of K5a and K5b, which also need every row of q, k, v and
  dO 16-byte aligned."""
  _check_cuda('flash_attention_bwd', q, k, v, d_out)
  _check_rows_aligned(name, q, k, v, d_out)
  b, l_q, h, _ = q.shape
  for label, t in (('lse', lse), ('delta', delta)):
    if (tuple(t.shape) != (b, h, l_q) or t.dtype != torch.float32 or
        not t.is_contiguous() or t.device != q.device):
      raise ValueError('{} takes a contiguous float32 {} [B, H, Lq] = {} '
                       'on {}; got {} {} on {}.'.format(
                           name, label, (b, h, l_q), q.device, t.dtype,
                           tuple(t.shape), t.device))


def flash_attention_delta(out: torch.Tensor,
                          d_out: torch.Tensor) -> torch.Tensor:
  """``delta = rowsum(dO * O)`` of [B, Lq, H, D] tensors in float32, as
  contiguous [B, H, Lq]: the input of K5a and K5b that the JAX package
  also computes outside its kernels."""
  return (d_out.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_kv(q, k, v, d_out, lse, delta, causal: bool,
                           scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
  """K5a on [B, L, H, D] strided views of CUDA tensors: (dk, dv),
  contiguous [B, Lk, H, D] in q's dtype."""
  _check_bwd_cuda('flash_attention_bwd_kv', q, k, v, d_out, lse, delta)
  b, l_q, h, d = q.shape
  l_k = k.shape[1]
  dk = torch.empty((b, l_k, h, d), dtype=q.dtype, device=q.device)
  dv = torch.empty((b, l_k, h, d), dtype=q.dtype, device=q.device)
  kernels.launch('flash_attention_bwd_kv', q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, l_q, l_k, d,
                 *_strides(q, k, v, d_out, dk, dv), float(scale),
                 int(causal), int(q.dtype == torch.bfloat16))
  return dk, dv


def flash_attention_bwd_q(q, k, v, d_out, lse, delta, causal: bool,
                          scale: float) -> torch.Tensor:
  """K5b on [B, L, H, D] strided views of CUDA tensors: dq, contiguous
  [B, Lq, H, D] in q's dtype."""
  _check_bwd_cuda('flash_attention_bwd_q', q, k, v, d_out, lse, delta)
  b, l_q, h, d = q.shape
  l_k = k.shape[1]
  dq = torch.empty((b, l_q, h, d), dtype=q.dtype, device=q.device)
  kernels.launch('flash_attention_bwd_q', q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, l_q,
                 l_k, d, *_strides(q, k, v, d_out, dq), float(scale),
                 int(causal), int(q.dtype == torch.bfloat16))
  return dq


def _flash_bwd_cuda(q, k, v, out, lse, d_out, causal: bool, scale: float):
  """The delta pass, K5a (dk, dv), then K5b (dq)."""
  if d_out.stride(-1) != 1 or not _rows_aligned(d_out):
    d_out = d_out.contiguous()
  delta = flash_attention_delta(out, d_out)
  dk, dv = flash_attention_bwd_kv(q, k, v, d_out, lse, delta, causal, scale)
  dq = flash_attention_bwd_q(q, k, v, d_out, lse, delta, causal, scale)
  return dq, dk, dv


def _device_type(q: torch.Tensor) -> str:
  if q.device.type not in ('cpu', 'cuda'):
    raise ValueError('flash_attention runs on CUDA or CPU tensors, not '
                     '{}.'.format(q.device))
  return q.device.type


def flash_attention_forward(q, k, v, causal: bool, scale: float):
  """(O [B, Lq, H, D], LSE float32 [B, H, Lq]) of [B, L, H, D] inputs: K4
  for a CUDA tensor, the plain version for a CPU tensor."""
  if _device_type(q) == 'cpu':
    return flash_attention_plain_blhd(q, k, v, causal, scale)
  return _flash_fwd_cuda(q, k, v, causal, scale)


def flash_attention_backward(q, k, v, out, lse, d_out, causal: bool,
                             scale: float):
  """(dq, dk, dv) [B, L, H, D] from the forward's inputs, O and LSE and the
  gradient of O: K5a and K5b for a CUDA tensor, the plain version for a CPU
  tensor."""
  if _device_type(q) == 'cpu':
    return flash_attention_bwd_plain_blhd(q, k, v, out, lse, d_out, causal,
                                          scale)
  return _flash_bwd_cuda(q, k, v, out, lse, d_out, causal, scale)


class _FlashAttention(torch.autograd.Function):
  """Attention on [B, L, H, D]: (O, LSE) forward, O differentiable. As the
  JAX ``custom_vjp`` differentiates O only, LSE carries no gradient."""

  @staticmethod
  def forward(ctx, q, k, v, causal, scale):
    out, lse = flash_attention_forward(q, k, v, causal, scale)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)
    return out, lse

  @staticmethod
  def backward(ctx, d_out, d_lse):
    del d_lse  # LSE is not differentiable
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, d_out,
                                          ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


def _resolve(q, k, v, scale, block_q, block_k, block_q_bwd, block_k_bwd):
  if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
      q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                              k.shape[3]):
    raise ValueError('flash_attention takes q [B, Lq, H, D] and k, v '
                     '[B, Lk, H, D]; got {}, {}, {}.'.format(
                         tuple(q.shape), tuple(k.shape), tuple(v.shape)))
  _check_blocks(q, q.shape[1], k.shape[1], block_q, block_k, block_q_bwd,
                block_k_bwd)
  if scale is None:
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
  return scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None) -> torch.Tensor:
  """Exact attention over [B, L, H, D] inputs, O(L) memory, differentiable:
  O [B, Lq, H, D] in q's dtype.

  ``scale`` defaults to ``1 / sqrt(D)``. q, k and v may be strided views
  (of one qkv projection, say) as long as D has unit stride and, on the
  card, every row starts on 16 bytes: the CUDA kernels read them where
  they lie, and K5a and K5b write their gradients contiguous
  [B, L, H, D].
  """
  scale = _resolve(q, k, v, scale, block_q, block_k, block_q_bwd,
                   block_k_bwd)
  return _FlashAttention.apply(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: int = 1024, block_k: int = 1024
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(O [BH, Lq, D], LSE float32 [BH, Lq]) of [BH, L, D] inputs: the
  contract of the JAX package's ``_flash_bhld``. O differentiates through
  K5a and K5b; LSE carries no gradient."""
  if q.dim() != 3:
    raise ValueError('flash_attention_with_lse takes [BH, L, D] inputs; got '
                     '{}.'.format(tuple(q.shape)))
  q4, k4, v4 = (x[:, :, None, :] for x in (q, k, v))
  scale = _resolve(q4, k4, v4, scale, block_q, block_k, None, None)
  out, lse = _FlashAttention.apply(q4, k4, v4, causal, scale)
  return out[:, :, 0, :], lse[:, 0, :]


# -- K6: the ring hop ----------------------------------------------------------


def check_carry_lengths(l_q: int, l_k: int, block_q: int = 128,
                        block_k: int = 128) -> None:
  """The JAX wrapper's rule: a shard length above the block (128) must be a
  multiple of it. K6 itself masks a ragged tile; the rule is kept so that
  the same lengths raise."""
  block_q, block_k = min(block_q, l_q), min(block_k, l_k)
  if l_q % block_q or l_k % block_k:
    raise ValueError(
        'Shard lengths ({}, {}) must be multiples of the block sizes '
        '({}, {}).'.format(l_q, l_k, block_q, block_k))


def _check_carry(q, k, v, o, m, l) -> None:
  if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
      q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                              k.shape[3]):
    raise ValueError('flash_attention_carry takes q [B, Lq, H, D] and k, v '
                     '[B, Lk, H, D]; got {}, {}, {}.'.format(
                         tuple(q.shape), tuple(k.shape), tuple(v.shape)))
  b, l_q, h, d = q.shape
  if (tuple(o.shape) != (b, h, l_q, d) or tuple(m.shape) != (b, h, l_q) or
      tuple(l.shape) != (b, h, l_q)):
    raise ValueError('flash_attention_carry carries o [B, H, Lq, D] = {} and '
                     'm, l [B, H, Lq]; got {}, {}, {}.'.format(
                         (b, h, l_q, d), tuple(o.shape), tuple(m.shape),
                         tuple(l.shape)))
  check_carry_lengths(l_q, k.shape[1])


def flash_attention_carry_plain(q, k, v, o, m, l, q_offset: int,
                                k_offset: int, causal: bool, scale: float):
  """``_block_update`` over the whole k/v block at once, in place.

  Float32 scores (float64 for float64 inputs) ``q k^T * scale``, ``NEG_INF``
  where causal and ``q_offset + i < k_offset + j``; ``m' = max(m, rowmax)``,
  ``p = exp(s - m')`` zeroed where ``s <= NEG_INF / 2`` (and ``m'`` taken
  as 0 there), the correction ``exp(m - m')`` zeroed where ``m <= NEG_INF /
  2``; ``l = l * corr + rowsum(p)``, ``o = o * corr + p v``. Returns the
  updated (o, m, l), the tensors it was given.
  """
  acc = _acc_dtype(q)
  neg_inf = torch.full((), NEG_INF, dtype=acc, device=q.device)
  zero = torch.zeros((), dtype=acc, device=q.device)
  s = torch.einsum('bqhd,bkhd->bhqk', q.to(acc), k.to(acc)) * scale
  if causal:
    keep = (q_offset + torch.arange(q.shape[1], device=q.device))[:, None] >= (
        k_offset + torch.arange(k.shape[1], device=q.device))[None, :]
    s = torch.where(keep, s, neg_inf)
  m_prev = m.to(acc)
  m_new = torch.maximum(m_prev, s.amax(-1))
  safe_m = torch.where(m_new <= NEG_INF / 2, zero, m_new)
  p = torch.exp(s - safe_m[..., None])
  p = torch.where(s <= NEG_INF / 2, zero, p)
  del s
  corr = torch.where(m_prev <= NEG_INF / 2, zero, torch.exp(m_prev - safe_m))
  l_new = l.to(acc) * corr + p.sum(-1)
  o_new = o.to(acc) * corr[..., None] + torch.einsum('bhqk,bkhd->bhqd', p,
                                                     v.to(acc))
  o.copy_(o_new)
  m.copy_(m_new)
  l.copy_(l_new)
  return o, m, l


def _flash_carry_cuda(q, k, v, o, m, l, q_offset: int, k_offset: int,
                      causal: bool, scale: float):
  """K6 on [B, L, H, D] strided views of CUDA tensors; (o, m, l) in place."""
  _check_cuda('flash_attention_carry', q, k, v)
  _check_rows_aligned('flash_attention_carry', q, k, v)
  for name, t in (('o', o), ('m', m), ('l', l)):
    if (t.dtype != torch.float32 or not t.is_contiguous() or
        t.device != q.device or t.data_ptr() % 16):
      raise ValueError('flash_attention_carry carries a contiguous, 16-byte '
                       'aligned float32 {} on {}; got {} on {}.'.format(
                           name, q.device, t.dtype, t.device))
  b, l_q, h, d = q.shape
  kernels.launch('flash_attention_carry', q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
                 l.data_ptr(), b, h, l_q, k.shape[1], d, *_strides(q, k, v),
                 float(scale), int(causal), int(q_offset), int(k_offset),
                 int(q.dtype == torch.bfloat16))
  return o, m, l


def flash_attention_carry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                          q_offset: int, k_offset: int, causal: bool,
                          scale: float):
  """One unnormalized flash update of the carried (o, m, l) with a new k/v
  block: K6 for a CUDA tensor, the plain version for a CPU tensor.

  q [B, Lq, H, D] and k, v [B, Lk, H, D] may be strided views with unit
  stride along D and, on the card, 16-byte aligned rows. The state is float32: o [B, H, Lq, D] and m, l [B, H,
  Lq], starting from 0, ``NEG_INF`` and 0. It is updated IN PLACE (each
  block of the kernel owns its query rows) and returned. ``q_offset`` and
  ``k_offset`` are the global positions of q's and k's first rows, for the
  causal mask. Shard lengths above 128 must be multiples of 128, as in the
  JAX wrapper. Forward only: ring attention's backward recomputes
  blockwise from the LSE.
  """
  _check_carry(q, k, v, o, m, l)
  if _device_type(q) == 'cpu':
    return flash_attention_carry_plain(q, k, v, o, m, l, q_offset, k_offset,
                                       causal, scale)
  return _flash_carry_cuda(q, k, v, o, m, l, q_offset, k_offset, causal,
                           scale)
