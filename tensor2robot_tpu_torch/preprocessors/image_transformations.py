"""Image crops on NHWC batches (the crops of the JAX package's
``preprocessors/image_transformations.py``).

Like the JAX functions, a crop takes a list of image batches and applies
the same per-example offsets to every view, so that views of one example
stay registered. Offsets past the end clamp to the last valid crop, as
``lax.dynamic_slice`` clamps them; negative offsets clamp to 0, as the
Pallas crop kernel clamps them (``lax.dynamic_slice`` would first wrap
them Python-style).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ['center_crop_episodes', 'center_crop_offsets', 'crop_images',
           'random_crop_offsets']


def _check_shapes(images: Sequence[torch.Tensor]) -> None:
  if not images:
    raise ValueError('Need at least one image batch.')
  first = tuple(images[0].shape[:3])
  for img in images[1:]:
    if tuple(img.shape[:3]) != first:
      raise ValueError(
          'All views must share [B, H, W] for aligned crops; got {} vs {}.'
          .format(first, tuple(img.shape[:3])))


def center_crop_offsets(batch: int, image_shape: Tuple[int, int],
                        target_shape: Tuple[int, int],
                        device='cpu') -> torch.Tensor:
  """The center crop's (y, x) for every example, as int32 [batch, 2]."""
  height, width = image_shape
  th, tw = target_shape
  if th > height or tw > width:
    raise ValueError('Crop {} exceeds image size {}.'.format(
        target_shape, (height, width)))
  offset = torch.tensor([(height - th) // 2, (width - tw) // 2],
                        dtype=torch.int32, device=device)
  return offset.expand(batch, 2).contiguous()


def random_crop_offsets(batch: int, image_shape: Tuple[int, int],
                        target_shape: Tuple[int, int],
                        generator: torch.Generator) -> torch.Tensor:
  """Per-example uniform (y, x) in [0, H - th] x [0, W - tw], as int32
  [batch, 2] on the generator's device. (``jax.random`` gives other
  numbers for the same seed; tests feed both packages the same offsets.)"""
  height, width = image_shape
  th, tw = target_shape
  if th > height or tw > width:
    raise ValueError('Crop {} exceeds image size {}.'.format(
        target_shape, (height, width)))
  device = generator.device
  ys = torch.randint(0, height - th + 1, (batch,), generator=generator,
                     device=device)
  xs = torch.randint(0, width - tw + 1, (batch,), generator=generator,
                     device=device)
  return torch.stack([ys, xs], -1).to(torch.int32)


def crop_images(images: List[torch.Tensor], offsets: torch.Tensor,
                target_shape: Tuple[int, int]) -> List[torch.Tensor]:
  """Crops each [B, H, W, C] batch at its per-example (y, x) offsets.

  ``offsets`` is an integer [B, 2] tensor; out-of-range offsets clamp to
  the nearest valid crop (see the module docstring).
  """
  _check_shapes(images)
  batch, height, width = images[0].shape[:3]
  th, tw = target_shape
  if th > height or tw > width:
    raise ValueError('Crop {} exceeds image size {}.'.format(
        target_shape, (height, width)))
  device = images[0].device
  offsets = torch.as_tensor(offsets, device=device).long()
  oy = offsets[:, 0].clamp(0, height - th)
  ox = offsets[:, 1].clamp(0, width - tw)
  rows = (oy[:, None] + torch.arange(th, device=device))[:, :, None]
  cols = (ox[:, None] + torch.arange(tw, device=device))[:, None, :]
  frames = torch.arange(batch, device=device)[:, None, None]
  return [img[frames, rows, cols] for img in images]


def center_crop_episodes(episodes: torch.Tensor,
                         target_shape: Tuple[int, int]) -> torch.Tensor:
  """Center crop of uint8 [B, T, H, W, C] episodes, converted to float32
  in [0, 1]: [B, T, th, tw, C].

  The JAX package's ``center_crop_episodes`` followed by the preprocessor's
  ``/ 255.0``, in one pass of kernel K1 over the B * T frames, each at the
  same center offset (a CPU tensor takes K1's plain version).
  """
  from tensor2robot_tpu_torch.preprocessors import pallas_crop

  if episodes.dim() != 5:
    raise ValueError('center_crop_episodes takes [B, T, H, W, C] episodes; '
                     'got {}.'.format(tuple(episodes.shape)))
  batch, steps, height, width, channels = episodes.shape
  frames = episodes.reshape(batch * steps, height, width, channels)
  offsets = center_crop_offsets(batch * steps, (height, width),
                                target_shape, device=episodes.device)
  cropped = pallas_crop.crop_convert(frames, offsets, target_shape,
                                     torch.float32, 255.0)
  return cropped.reshape((batch, steps) + tuple(cropped.shape[1:]))
