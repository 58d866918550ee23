"""Non-overlapping max pool on NHWC: kernel K2 (forward) of the port.

The JAX package pools Grasping44 with ``layers/pooling.py`` ``max_pool``
and keeps a Pallas TPU kernel for the same pool in
``layers/pallas_pooling.py`` (``max_pool_pallas``). Their Hopper
counterpart is the CUDA kernel in ``csrc/max_pool.cu``: ``max_pool``
launches it for a CUDA tensor and runs ``max_pool_plain``, the same
function in plain PyTorch, for a CPU tensor.

Geometry is pooling.py's: the window equals the stride; SAME pads up to a
whole number of windows with the low pad ``total // 2`` and ``-inf`` in the
padded cells; VALID drops the tail that fits no whole window. With
``return_index`` the pool also returns the int8 window index
``k = i1 * ww + j`` under the stage-wise first-max rule of pooling.py and
pallas_pooling.py: the first maximal row within each window column, then
the first maximal column. The index is relative to the padded window.

K2f loads ``vector_width(x)`` channels at once: 16 bytes' worth where the
channel count and the input's address allow it, else one. K2b moves
``vector_width(dy, idx)`` channels of dy and of its index at once, by the
same rule.

``max_pool`` is differentiable: under autograd it runs the forward with the
index (kernel K2f) and its backward routes dy to the indexed cell (kernel
K2b, ``csrc/max_pool_backward.cu``, the counterpart of pallas_pooling.py's
``_pallas_call_bwd``); ``max_pool_backward_plain`` is pooling.py's
``_max_pool_bwd``, its two one-hot compares, in PyTorch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch import kernels

__all__ = ['max_pool', 'max_pool_backward', 'max_pool_backward_plain',
           'max_pool_forward', 'max_pool_plain', 'pool_geometry',
           'vector_width']

_DTYPES = (torch.float32, torch.bfloat16)


def _geometry(size: int, window: int, padding: str) -> Tuple[int, int, int]:
  """(out, pad_lo, pad_hi) for one dim; pad_hi < 0 means crop the tail."""
  if padding == 'VALID':
    out = size // window
    return out, 0, out * window - size
  out = -(-size // window)
  total = out * window - size
  return out, total // 2, total - total // 2


def pool_geometry(x_shape: Sequence[int], window: Sequence[int],
                  strides: Sequence[int], padding: str):
  """Validates a pool; returns ((Ho, Wo), (pad_top, pad_left), (wh, ww))."""
  window, strides = tuple(window), tuple(strides)
  if len(x_shape) != 4:
    raise ValueError('max_pool expects NHWC [B, H, W, C]; got shape {}.'
                     .format(tuple(x_shape)))
  if len(window) != 2 or window != strides:
    raise ValueError('max_pool computes non-overlapping 2-D pools only '
                     '(window == strides); got window {} strides {}.'.format(
                         window, strides))
  if padding not in ('SAME', 'VALID'):
    raise ValueError('padding must be SAME or VALID; got {!r}.'.format(
        padding))
  wh, ww = window
  if wh * ww > 128:
    raise ValueError('The window index is int8: wh * ww must be at most '
                     '128; got {}.'.format(window))
  _, h, w, _ = x_shape
  ho, pad_top, _ = _geometry(h, wh, padding)
  wo, pad_left, _ = _geometry(w, ww, padding)
  if ho < 1 or wo < 1:
    raise ValueError('VALID pool {} leaves no output for spatial size {}.'
                     .format(window, (h, w)))
  return (ho, wo), (pad_top, pad_left), (wh, ww)


def max_pool_plain(x: torch.Tensor, window: Sequence[int],
                   strides: Sequence[int], padding: str = 'VALID',
                   return_index: bool = False):
  """pooling.py's reshape / max / argmax formulation, in PyTorch."""
  (ho, wo), _, (wh, ww) = pool_geometry(x.shape, window, strides, padding)
  b, h, w, c = x.shape
  _, plh, phh = _geometry(h, wh, padding)
  _, plw, phw = _geometry(w, ww, padding)
  if phh < 0 or phw < 0:
    x = x[:, :ho * wh, :wo * ww, :]
  elif plh or phh or plw or phw:
    x = F.pad(x, (0, 0, plw, phw, plh, phh), value=float('-inf'))
  xr = x.reshape(b, ho, wh, wo * ww, c)
  m1 = xr.amax(dim=2)
  m1r = m1.reshape(b, ho, wo, ww, c)
  out = m1r.amax(dim=3)
  if not return_index:
    return out
  i1 = xr.argmax(dim=2).reshape(b, ho, wo, ww, c)
  i2 = m1r.argmax(dim=3, keepdim=True)
  k = torch.gather(i1, 3, i2) * ww + i2
  return out, k.squeeze(3).to(torch.int8)


def vector_width(x: torch.Tensor,
                 index: Optional[torch.Tensor] = None) -> int:
  """The channels K2f loads at once from NHWC ``x``, or K2b from dy ``x``
  and its int8 ``index``: 16 bytes' worth (4 float32, 8 bfloat16) where C
  is a multiple of that, ``x`` starts on 16 bytes and ``index`` on a
  multiple of the width, else 1."""
  width = 16 // x.element_size()
  if x.shape[-1] % width or x.data_ptr() % 16:
    return 1
  if index is not None and index.data_ptr() % width:
    return 1
  return width


def max_pool_forward(x: torch.Tensor, window: Sequence[int],
                     strides: Sequence[int], padding: str = 'VALID',
                     return_index: bool = False):
  """Non-overlapping max pool of NHWC ``x`` (float32 or bfloat16), not
  differentiable.

  Returns the pooled [B, Ho, Wo, C] map in ``x``'s dtype, and with
  ``return_index`` also the int8 window index. A CUDA tensor goes through
  the kernel K2f or raises; a CPU tensor goes through the plain version.
  """
  if x.device.type == 'cpu':
    return max_pool_plain(x, window, strides, padding, return_index)
  if x.device.type != 'cuda':
    raise ValueError('max_pool runs on CUDA or CPU tensors, not {}.'.format(
        x.device))
  (ho, wo), (pad_top, pad_left), (wh, ww) = pool_geometry(
      x.shape, window, strides, padding)
  if x.dtype not in _DTYPES:
    raise ValueError('max_pool takes float32 or bfloat16, not {}.'.format(
        x.dtype))
  if not x.is_contiguous():
    raise ValueError('max_pool expects a contiguous NHWC tensor (a '
                     'channels_last NCHW tensor permuted to NHWC is one).')
  b, h, w, c = x.shape
  out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
  idx = (torch.empty((b, ho, wo, c), dtype=torch.int8, device=x.device)
         if return_index else None)
  if out.numel() == 0:   # an empty map has nothing to pool
    return (out, idx) if return_index else out
  kernels.launch('max_pool', x.device, x.data_ptr(), out.data_ptr(),
                 None if idx is None else idx.data_ptr(), b, h, w, c, wh, ww,
                 ho, wo, pad_top, pad_left, int(x.dtype == torch.bfloat16),
                 vector_width(x))
  return (out, idx) if return_index else out


def max_pool_backward_plain(dy: torch.Tensor, idx: torch.Tensor,
                            x_shape: Sequence[int], window: Sequence[int],
                            padding: str = 'VALID') -> torch.Tensor:
  """pooling.py's ``_max_pool_bwd`` in PyTorch: dy [B, Ho, Wo, C] goes to
  the cell that the window index names, 0 elsewhere; the padded cells are
  cropped away and a VALID tail gets 0. Returns dx [B, H, W, C]."""
  window = tuple(window)
  (ho, wo), _, (wh, ww) = pool_geometry(x_shape, window, window, padding)
  b, h, w, c = x_shape
  _, plh, phh = _geometry(h, wh, padding)
  _, plw, phw = _geometry(w, ww, padding)
  k = idx.long()
  zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
  iota_w = torch.arange(ww, device=dy.device).view(1, 1, 1, ww, 1)
  d1 = torch.where((k % ww)[:, :, :, None, :] == iota_w,
                   dy[:, :, :, None, :], zero)          # [B, Ho, Wo, ww, C]
  d1 = d1.reshape(b, ho, 1, wo * ww, c)
  rows = (k // ww)[:, :, :, None, :].expand(b, ho, wo, ww, c)
  rows = rows.reshape(b, ho, 1, wo * ww, c)
  iota_h = torch.arange(wh, device=dy.device).view(1, 1, wh, 1, 1)
  dx = torch.where(rows == iota_h, d1, zero)            # [B, Ho, wh, Wo*ww, C]
  dx = dx.reshape(b, ho * wh, wo * ww, c)
  if phh < 0 or phw < 0:   # VALID: zero-fill the dropped tail
    dx = F.pad(dx, (0, 0, 0, w - wo * ww, 0, h - ho * wh))
  else:
    dx = dx[:, plh:plh + h, plw:plw + w, :]
  return dx.contiguous()


def max_pool_backward(dy: torch.Tensor, idx: torch.Tensor,
                      x_shape: Sequence[int], window: Sequence[int],
                      padding: str = 'VALID') -> torch.Tensor:
  """The gradient of ``max_pool`` from its window index: dx [B, H, W, C]
  in dy's dtype. A CUDA tensor goes through the kernel K2b or raises; a CPU
  tensor goes through the plain version."""
  if dy.device.type == 'cpu':
    return max_pool_backward_plain(dy, idx, x_shape, window, padding)
  if dy.device.type != 'cuda':
    raise ValueError('max_pool_backward runs on CUDA or CPU tensors, not '
                     '{}.'.format(dy.device))
  window = tuple(window)
  (ho, wo), (pad_top, pad_left), (wh, ww) = pool_geometry(
      x_shape, window, window, padding)
  b, h, w, c = x_shape
  if dy.dtype not in _DTYPES:
    raise ValueError('max_pool_backward takes float32 or bfloat16, not {}.'
                     .format(dy.dtype))
  if idx.dtype != torch.int8 or idx.device != dy.device:
    raise ValueError('The window index must be int8 on the device of dy.')
  if tuple(dy.shape) != (b, ho, wo, c) or tuple(idx.shape) != (b, ho, wo, c):
    raise ValueError('dy and the index must be [B, Ho, Wo, C] = {}; got {} '
                     'and {}.'.format((b, ho, wo, c), tuple(dy.shape),
                                      tuple(idx.shape)))
  if not (dy.is_contiguous() and idx.is_contiguous()):
    raise ValueError('max_pool_backward expects contiguous NHWC dy and '
                     'index.')
  dx = torch.empty((b, h, w, c), dtype=dy.dtype, device=dy.device)
  if dx.numel() == 0:   # an empty map has nothing to route
    return dx
  kernels.launch('max_pool_backward', dy.device, dy.data_ptr(),
                 idx.data_ptr(), dx.data_ptr(), b, h, w, c, wh, ww, ho, wo,
                 pad_top, pad_left, dy.element_size(),
                 vector_width(dy, idx))
  return dx


class _MaxPool(torch.autograd.Function):
  """The pool as an autograd node: the forward keeps only the int8 index
  and the input's shape; the backward routes dy with them."""

  @staticmethod
  def forward(ctx, x, window, padding):
    out, idx = max_pool_forward(x, window, window, padding, True)
    ctx.save_for_backward(idx)
    ctx.geometry = (tuple(x.shape), window, padding)
    return out

  @staticmethod
  def backward(ctx, dy):
    (idx,) = ctx.saved_tensors
    x_shape, window, padding = ctx.geometry
    return (max_pool_backward(dy.contiguous(), idx, x_shape, window,
                              padding), None, None)


def max_pool(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
             padding: str = 'VALID', return_index: bool = False):
  """Non-overlapping max pool of NHWC ``x`` (float32 or bfloat16).

  Without autograd this is ``max_pool_forward``. Where ``x`` needs a
  gradient, the pool is one autograd node: the forward launches K2f with
  the index, and the backward K2b (``max_pool_backward``). The index of a
  differentiable pool stays inside its node, so ``return_index`` asks for
  the forward without autograd.
  """
  if torch.is_grad_enabled() and x.requires_grad:
    if return_index:
      raise ValueError('return_index is for the pool without autograd; a '
                       'differentiable pool keeps its index for backward.')
    pool_geometry(x.shape, window, strides, padding)
    return _MaxPool.apply(x, tuple(window), padding)
  return max_pool_forward(x, window, strides, padding, return_index)
