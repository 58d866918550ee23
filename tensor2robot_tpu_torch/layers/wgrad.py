"""Weight gradient of a 5x5, stride 1, SAME conv: kernel K3 of the port.

The JAX package keeps a Pallas TPU kernel for the weight gradient of
Grasping44's 5x5 body convs in ``layers/pallas_wgrad.py``
(``conv5x5_wgrad``). Its Hopper counterpart is the CUDA kernel in
``csrc/conv5x5_wgrad.cu``: ``conv5x5_wgrad`` launches it for CUDA tensors
and runs ``conv5x5_wgrad_plain``, the same function in plain PyTorch, for
CPU tensors. The training slice's body convs (``research/qtopt/networks``)
take their weight gradient from it.

  dW[a, b] = sum over positions p of xpad[p + (a, b)]^T dy[p]

for x and dy NHWC [B, H, W, C] and xpad x padded by 2 on every side: the
HWIO [5, 5, C, C] gradient, summed in float32 whether the inputs are
float32 or bfloat16. Unlike the Pallas wrapper there is no batch tile, so
any batch size goes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch import kernels

__all__ = ['conv5x5_wgrad', 'conv5x5_wgrad_plain']

KERNEL = 5
PAD = 2

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = 64   # (ci, co) tile of a block of csrc/conv5x5_wgrad.cu


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
  if x.dim() != 4 or x.shape != dy.shape:
    raise ValueError('conv5x5_wgrad expects x and dy of one NHWC shape '
                     '[B, H, W, C]; got {} and {}.'.format(
                         tuple(x.shape), tuple(dy.shape)))
  if x.dtype not in _DTYPES or dy.dtype != x.dtype:
    raise ValueError('conv5x5_wgrad takes float32 or bfloat16 x and dy of '
                     'one dtype, not {} and {}.'.format(x.dtype, dy.dtype))


def conv5x5_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
  """The 25 shifted products in PyTorch, in float32."""
  _check(x, dy)
  _, h, w, c = x.shape
  xp = F.pad(x.to(torch.float32), (0, 0, PAD, PAD, PAD, PAD))
  d = dy.to(torch.float32).reshape(-1, c)
  out = torch.empty((KERNEL, KERNEL, c, c), dtype=torch.float32,
                    device=x.device)
  for a in range(KERNEL):
    for b in range(KERNEL):
      out[a, b] = xp[:, a:a + h, b:b + w, :].reshape(-1, c).T @ d
  return out


def _splits(device: torch.device, channels: int) -> int:
  """Blocks of the kernel's grid that share each (row offset, channel tile):
  the most that keep the grid (one block a SM) in one wave."""
  tiles = -(-channels // _TILE)
  sms = torch.cuda.get_device_properties(device).multi_processor_count
  return max(1, sms // (KERNEL * tiles * tiles))


def conv5x5_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
  """dW, HWIO [5, 5, C, C] float32, of a 5x5 stride-1 SAME conv.

  ``x`` is the conv's NHWC input and ``dy`` the gradient of its NHWC
  output. A CUDA tensor goes through the kernel K3 or raises; a CPU tensor
  goes through the plain version.
  """
  if x.device.type == 'cpu':
    return conv5x5_wgrad_plain(x, dy)
  if x.device.type != 'cuda' or dy.device != x.device:
    raise ValueError('conv5x5_wgrad runs on CUDA or CPU tensors (both on '
                     'one device), not {} and {}.'.format(x.device,
                                                          dy.device))
  _check(x, dy)
  b, h, w, c = x.shape
  if c % 4:
    raise ValueError('conv5x5_wgrad loads 4 channels at a time; C must be a '
                     'multiple of 4, not {}.'.format(c))
  if not (x.is_contiguous() and dy.is_contiguous()):
    raise ValueError('conv5x5_wgrad expects contiguous NHWC x and dy (a '
                     'channels_last NCHW tensor permuted to NHWC is one).')
  if x.data_ptr() % 16 or dy.data_ptr() % 16:
    raise ValueError('conv5x5_wgrad expects 16-byte aligned x and dy.')
  splits = _splits(x.device, c)
  partials = torch.empty((splits, KERNEL, KERNEL, c, c), dtype=torch.float32,
                         device=x.device)
  out = torch.empty((KERNEL, KERNEL, c, c), dtype=torch.float32,
                    device=x.device)
  kernels.launch('conv5x5_wgrad', x.device, x.data_ptr(), dy.data_ptr(),
                 partials.data_ptr(), out.data_ptr(), b, h, w, c, splits,
                 int(x.dtype == torch.bfloat16))
  return out
