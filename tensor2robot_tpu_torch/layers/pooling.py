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
the first maximal column. The index is relative to the padded window; the
training slice's backward routes the gradient with it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch import kernels

__all__ = ['max_pool', 'max_pool_plain', 'pool_geometry']

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


def max_pool(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
             padding: str = 'VALID', return_index: bool = False):
  """Non-overlapping max pool of NHWC ``x`` (float32 or bfloat16).

  Returns the pooled [B, Ho, Wo, C] map in ``x``'s dtype, and with
  ``return_index`` also the int8 window index. A CUDA tensor goes through
  the kernel or raises; a CPU tensor goes through the plain version.
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
  kernels.launch('max_pool', x.device, x.data_ptr(), out.data_ptr(),
                 None if idx is None else idx.data_ptr(), b, h, w, c, wh, ww,
                 ho, wo, pad_top, pad_left, int(x.dtype == torch.bfloat16))
  return (out, idx) if return_index else out
