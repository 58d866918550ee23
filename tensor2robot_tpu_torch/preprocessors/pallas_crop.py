"""Per-frame crop + uint8-to-float convert: kernel K1 of the port.

The JAX package's ``preprocessors/pallas_crop.py`` ``fused_crop_convert``
is a Pallas TPU kernel; its Hopper counterpart is the CUDA kernel in
``csrc/crop_convert.cu``. ``crop_convert`` launches it for a CUDA tensor
and runs ``crop_convert_plain``, the same function in plain PyTorch, for a
CPU tensor. The serving path uses it for the PREDICT center crop and
``/ 255`` of ``DefaultGrasping44ImagePreprocessor``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.preprocessors import image_transformations

__all__ = ['crop_convert', 'crop_convert_plain']

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check(images: torch.Tensor, offsets: torch.Tensor,
           target_shape: Tuple[int, int], out_dtype) -> None:
  if images.dtype != torch.uint8:
    raise ValueError('crop_convert expects uint8 images, got {}.'.format(
        images.dtype))
  if images.dim() != 4:
    raise ValueError('crop_convert expects [B, H, W, C] images, got shape '
                     '{}.'.format(tuple(images.shape)))
  if out_dtype not in _OUT_DTYPES:
    raise ValueError('crop_convert writes float32 or bfloat16, not '
                     '{}.'.format(out_dtype))
  batch, height, width, _ = images.shape
  th, tw = target_shape
  if not (0 < th <= height and 0 < tw <= width):
    raise ValueError('Crop {} does not fit image size {}.'.format(
        target_shape, (height, width)))
  if tuple(offsets.shape) != (batch, 2):
    raise ValueError('offsets must be [B, 2] = [{}, 2]; got {}.'.format(
        batch, tuple(offsets.shape)))


def crop_convert_plain(images: torch.Tensor, offsets: torch.Tensor,
                       target_shape: Tuple[int, int],
                       out_dtype=torch.float32,
                       denom: float = 255.0) -> torch.Tensor:
  """``images[b, y:y+th, x:x+tw].to(float32) * (1 / denom)`` in out_dtype.

  ``1 / denom`` is rounded once to float32 and multiplies: XLA compiles
  the JAX package's ``image / 255.0`` into exactly that, in its jitted
  path and in the Pallas kernel, so this matches both bit for bit.
  """
  offsets = torch.as_tensor(offsets, device=images.device)
  _check(images, offsets, target_shape, out_dtype)
  cropped = image_transformations.crop_images([images], offsets,
                                              target_shape)[0]
  one = torch.ones((), dtype=torch.float32, device=images.device)
  scale = one / torch.tensor(denom, dtype=torch.float32, device=images.device)
  return (cropped.to(torch.float32) * scale).to(out_dtype)


def crop_convert(images: torch.Tensor, offsets: torch.Tensor,
                 target_shape: Tuple[int, int], out_dtype=torch.float32,
                 denom: float = 255.0) -> torch.Tensor:
  """Crops uint8 [B, H, W, C] at per-frame (y, x) and converts, in one pass.

  Returns ``crop * (1 / denom)`` as [B, th, tw, C] of ``out_dtype``
  (float32 or bfloat16); see ``crop_convert_plain``. Offsets
  are int32 [B, 2] and clamp to the valid range. A CUDA tensor goes
  through the kernel or raises; a CPU tensor goes through the plain
  version.
  """
  if images.device.type == 'cpu':
    return crop_convert_plain(images, offsets, target_shape, out_dtype,
                              denom)
  if images.device.type != 'cuda':
    raise ValueError('crop_convert runs on CUDA or CPU tensors, not {}.'
                     .format(images.device))
  offsets = torch.as_tensor(offsets, dtype=torch.int32, device=images.device)
  _check(images, offsets, target_shape, out_dtype)
  if not offsets.is_contiguous():
    raise ValueError('offsets must be contiguous.')
  if not images.is_contiguous():
    raise ValueError('crop_convert expects contiguous NHWC images.')
  batch, height, width, channels = images.shape
  th, tw = target_shape
  if batch > 65535 or th > 65535:
    raise ValueError('crop_convert launches one block row per output row '
                     'and frame; batch and th must be at most 65535.')
  out = torch.empty((batch, th, tw, channels), dtype=out_dtype,
                    device=images.device)
  kernels.launch('crop_convert', images.device, images.data_ptr(),
                 offsets.data_ptr(), out.data_ptr(), batch, height, width,
                 channels, th, tw, float(denom),
                 int(out_dtype == torch.bfloat16))
  return out
