"""Flash attention forward: kernel K4 of the port.

The JAX package's ``parallel/flash_attention.py`` runs exact attention as a
Pallas TPU kernel (``_flash_bhld``): an online softmax over k/v blocks that
never writes the [L, L] scores to memory, returning O and the per-row
log-sum-exp (LSE) that the backward needs. Its Hopper counterpart is the
CUDA kernel in ``csrc/flash_attention_fwd.cu``. A CUDA tensor goes through
that kernel or raises; a CPU tensor goes through
``flash_attention_plain``, a dense softmax over [BH, L, L] with the same
arithmetic (``NEG_INF`` masking, ``p`` zeroed below ``NEG_INF / 2``,
``O = acc / max(l, 1e-20)``, ``LSE = m + log(max(l, 1e-20))``).

``block_q`` and ``block_k`` keep the JAX contract: a length that no block
of the ladder (a multiple of 8) divides raises ``ValueError``. They do not
tile the CUDA kernel, which runs its own 64 x 64 tiles and masks a ragged
tail; the plain version is dense. The JAX wrapper's zero padding of the
head dim to 128 is a Mosaic lane rule and is not carried over: the kernel
takes D = 64 or 128 as it is.

The backward (the Pallas kernels ``_flash_bwd_pallas``) is not ported yet:
differentiating through ``flash_attention`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import kernels

__all__ = ['NEG_INF', 'flash_attention', 'flash_attention_plain',
           'flash_attention_plain_blhd', 'flash_attention_with_lse']

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


def _check_blocks(q: torch.Tensor, l_q: int, l_k: int, block_q: int,
                  block_k: int) -> None:
  if q.element_size() >= 4:
    # The JAX wrapper caps float32 blocks (a VMEM limit); kept so that the
    # same lengths raise.
    block_q, block_k = min(block_q, 256), min(block_k, 512)
  _dividing_block_or_raise(min(block_q, l_q), l_q)
  _dividing_block_or_raise(min(block_k, l_k), l_k)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(O, LSE) of [BH, L, D] inputs by a dense softmax over [BH, Lq, Lk].

  The arithmetic of the Pallas kernel's ``_block_update`` and finalize in
  one block: float32 scores ``q k^T * scale``, the causal mask at global
  positions (``q_pos >= k_pos``) as ``NEG_INF``. O is in q's dtype, LSE
  float32 [BH, Lq].
  """
  s = torch.einsum('bqd,bkd->bqk', q.float(), k.float()) * scale
  if causal:
    l_q, l_k = q.shape[1], k.shape[1]
    keep = (torch.arange(l_q, device=q.device)[:, None] >=
            torch.arange(l_k, device=q.device)[None, :])
    s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
  m = s.amax(-1, keepdim=True)
  safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
  p = torch.exp(s - safe_m)
  p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
  l_final = p.sum(-1, keepdim=True).clamp_min(1e-20)
  out = torch.einsum('bqk,bkd->bqd', p, v.float()) / l_final
  return out.to(q.dtype), (m + torch.log(l_final))[..., 0]


def flash_attention_plain_blhd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``flash_attention_plain`` on [B, L, H, D]: (O [B, Lq, H, D], LSE
  [B, H, Lq]), the layout of the CUDA kernel's inputs and outputs."""
  b, l_q, h, d = q.shape

  def to_bhld(x):
    return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

  out, lse = flash_attention_plain(to_bhld(q), to_bhld(k), to_bhld(v),
                                   causal, scale)
  return (out.reshape(b, h, l_q, d).permute(0, 2, 1, 3),
          lse.reshape(b, h, l_q))


def _check_cuda(q, k, v) -> None:
  for name, t in (('q', q), ('k', k), ('v', v)):
    if t.device != q.device:
      raise ValueError('{} is on {}, q on {}.'.format(name, t.device,
                                                      q.device))
    if t.dtype != q.dtype:
      raise ValueError('q, k and v must share a dtype; {} is {}, q {}.'
                       .format(name, t.dtype, q.dtype))
    if t.stride(-1) != 1:
      raise ValueError('flash_attention_fwd reads {} with unit stride '
                       'along D; got strides {}.'.format(name, t.stride()))
  if q.dtype not in _DTYPES:
    raise ValueError('flash_attention_fwd takes float32 or bfloat16, not '
                     '{}.'.format(q.dtype))
  if q.shape[-1] not in _HEAD_DIMS:
    raise ValueError('flash_attention_fwd is built for head dims {}, not '
                     '{}.'.format(_HEAD_DIMS, q.shape[-1]))
  if q.shape[0] * q.shape[2] > 65535:
    raise ValueError('flash_attention_fwd launches one block row per '
                     '(batch, head): at most 65535.')


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
  """K4 on [B, L, H, D] strided views: (O [B, Lq, H, D], LSE [B, H, Lq])."""
  _check_cuda(q, k, v)
  b, l_q, h, d = q.shape
  l_k = k.shape[1]
  out = torch.empty((b, l_q, h, d), dtype=q.dtype, device=q.device)
  lse = torch.empty((b, h, l_q), dtype=torch.float32, device=q.device)
  strides = []
  for t in (q, k, v):
    strides += [t.stride(0), t.stride(2), t.stride(1)]
  kernels.launch('flash_attention_fwd', q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, h, l_q, l_k, d, *strides, float(scale), int(causal),
                 int(q.dtype == torch.bfloat16))
  return out, lse


class _FlashForward(torch.autograd.Function):
  """The forward on [B, L, H, D]; its backward is the training slice's."""

  @staticmethod
  def forward(ctx, q, k, v, causal, scale):
    if q.device.type == 'cpu':
      return flash_attention_plain_blhd(q, k, v, causal, scale)
    if q.device.type != 'cuda':
      raise ValueError('flash_attention runs on CUDA or CPU tensors, not '
                       '{}.'.format(q.device))
    return _flash_fwd_cuda(q, k, v, causal, scale)

  @staticmethod
  def backward(ctx, d_out, d_lse):
    raise NotImplementedError(
        'The flash attention backward (the Pallas kernels of '
        '_flash_bwd_pallas, K5a and K5b) is not ported yet.')


def _resolve(q, k, v, scale, block_q, block_k):
  if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or (
      q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                              k.shape[3]):
    raise ValueError('flash_attention takes q [B, Lq, H, D] and k, v '
                     '[B, Lk, H, D]; got {}, {}, {}.'.format(
                         tuple(q.shape), tuple(k.shape), tuple(v.shape)))
  _check_blocks(q, q.shape[1], k.shape[1], block_q, block_k)
  if scale is None:
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
  return scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 1024, block_k: int = 1024
                    ) -> torch.Tensor:
  """Exact attention over [B, L, H, D] inputs, O(L) memory: O [B, Lq, H, D]
  in q's dtype.

  ``scale`` defaults to ``1 / sqrt(D)``. q, k and v may be strided views
  (of one qkv projection, say) as long as D has unit stride: the CUDA
  kernel reads them where they lie.
  """
  scale = _resolve(q, k, v, scale, block_q, block_k)
  return _FlashForward.apply(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             scale: Optional[float] = None,
                             block_q: int = 1024, block_k: int = 1024
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(O [BH, Lq, D], LSE float32 [BH, Lq]) of [BH, L, D] inputs: the
  contract of the JAX package's ``_flash_bhld``."""
  if q.dim() != 3:
    raise ValueError('flash_attention_with_lse takes [BH, L, D] inputs; got '
                     '{}.'.format(tuple(q.shape)))
  q4, k4, v4 = (x[:, :, None, :] for x in (q, k, v))
  scale = _resolve(q4, k4, v4, scale, block_q, block_k)
  out, lse = _FlashForward.apply(q4, k4, v4, causal, scale)
  return out[:, :, 0, :], lse[:, 0, :]
