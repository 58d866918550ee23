"""Image crops and photometric and depth distortions on NHWC batches (the
JAX package's ``preprocessors/image_transformations.py``).

Like the JAX functions, a crop takes a list of image batches and applies
the same per-example offsets to every view, so that views of one example
stay registered. Offsets past the end clamp to the last valid crop, as
``lax.dynamic_slice`` clamps them; negative offsets clamp to 0, as the
Pallas crop kernel clamps them (``lax.dynamic_slice`` would first wrap
them Python-style).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ['DEPTH_DEFAULTS', 'PHOTOMETRIC_DEFAULTS', 'adjust_brightness',
           'adjust_contrast', 'adjust_hue',
           'adjust_saturation', 'apply_depth_image_distortions',
           'apply_photometric_image_distortions', 'center_crop_episodes',
           'center_crop_offsets', 'crop_images', 'draw_depth_parameters',
           'draw_photometric_parameters', 'hsv_to_rgb',
           'random_crop_episodes', 'random_crop_offsets', 'rgb_to_hsv']


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


def random_crop_episodes(episodes: torch.Tensor,
                         target_shape: Tuple[int, int],
                         generator: Optional[torch.Generator] = None,
                         offsets: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
  """Random crop of uint8 [B, T, H, W, C] episodes, converted to float32 in
  [0, 1]: [B, T, th, tw, C].

  One (y, x) per episode, shared by all its frames (a fixed camera does not
  jitter within an episode): drawn uniformly with ``random_crop_offsets``
  from ``generator``, or the caller's int [B, 2] ``offsets``. The JAX
  package's ``random_crop_episodes`` followed by the preprocessor's
  ``/ 255.0``, in one pass of kernel K1 over the B * T frames, the offsets
  repeated over T (a CPU tensor takes K1's plain version).
  """
  from tensor2robot_tpu_torch.preprocessors import pallas_crop

  if episodes.dim() != 5:
    raise ValueError('random_crop_episodes takes [B, T, H, W, C] episodes; '
                     'got {}.'.format(tuple(episodes.shape)))
  batch, steps, height, width, channels = episodes.shape
  if offsets is None:
    if generator is None:
      raise ValueError('random_crop_episodes needs a generator or offsets.')
    offsets = random_crop_offsets(batch, (height, width), target_shape,
                                  generator)
  offsets = torch.as_tensor(offsets, dtype=torch.int32,
                            device=episodes.device)
  if tuple(offsets.shape) != (batch, 2):
    raise ValueError('offsets must be [B, 2] = [{}, 2]; got {}.'.format(
        batch, tuple(offsets.shape)))
  frames = episodes.reshape(batch * steps, height, width, channels)
  cropped = pallas_crop.crop_convert(
      frames, offsets.repeat_interleave(steps, 0), target_shape,
      torch.float32, 255.0)
  return cropped.reshape((batch, steps) + tuple(cropped.shape[1:]))


# -- photometric and depth distortions ---------------------------------------
#
# The JAX package's distortions on float images in [0, 1], NHWC. Each is
# split in two: a draw of the per-example parameters from a
# ``torch.Generator`` on the images' device (``draw_*``), and a
# deterministic part that applies given parameters, so that the same
# parameters (the port's draws, or the JAX package's own) give the same
# images on either package. Everything is elementwise float32 arithmetic
# apart from the contrast's mean; the saturation's grey is a weighted sum
# written out in float32, never a TF32 product.

_GRAY_WEIGHTS = (0.299, 0.587, 0.114)
# The six orders of the RGB channels, as the JAX package lists them.
_CHANNEL_PERMUTATIONS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0),
                         (2, 0, 1), (2, 1, 0))
# The distortions' keyword arguments, with the JAX functions' defaults.
PHOTOMETRIC_DEFAULTS = dict(
    random_brightness=False, max_delta_brightness=0.125,
    random_saturation=False, lower_saturation=0.5, upper_saturation=1.5,
    random_hue=False, max_delta_hue=0.2,
    random_contrast=False, lower_contrast=0.5, upper_contrast=1.5,
    random_noise_level=0.0, random_noise_apply_probability=0.5,
    random_channel_swap=False)
DEPTH_DEFAULTS = dict(random_noise_level=0.05,
                       random_noise_apply_probability=0.5,
                       scale_noise=False, lower_scale=0.8, upper_scale=1.2)


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
  """Python's (and ``jnp``'s) float modulo: the result has the divisor's
  sign."""
  rem = torch.fmod(x, y)
  return torch.where((rem != 0) & ((rem < 0) != (y < 0)), rem + y, rem)


def rgb_to_hsv(image: torch.Tensor) -> torch.Tensor:
  """[..., 3] RGB in [0, 1] -> HSV as ``tf.image.rgb_to_hsv``: hue in
  turns, and 0 where the pixel is grey (max == min)."""
  r, g, b = image[..., 0], image[..., 1], image[..., 2]
  maxc = torch.maximum(torch.maximum(r, g), b)
  minc = torch.minimum(torch.minimum(r, g), b)
  delta = maxc - minc
  one = torch.ones_like(delta)
  safe_delta = torch.where(delta == 0, one, delta)
  saturation = torch.where(maxc == 0, torch.zeros_like(delta),
                           delta / torch.where(maxc == 0, one, maxc))
  hue_r = _mod((g - b) / safe_delta, 6.0)
  hue_g = (b - r) / safe_delta + 2.0
  hue_b = (r - g) / safe_delta + 4.0
  hue = torch.where(maxc == r, hue_r, torch.where(maxc == g, hue_g, hue_b))
  hue = torch.where(delta == 0, torch.zeros_like(hue), hue / 6.0)
  return torch.stack([hue, saturation, maxc], dim=-1)


def hsv_to_rgb(image: torch.Tensor) -> torch.Tensor:
  """[..., 3] HSV (hue in turns) -> RGB in [0, 1]."""
  h, s, v = image[..., 0], image[..., 1], image[..., 2]
  h6 = h * 6.0
  c = v * s
  x = c * (1.0 - torch.abs(_mod(h6, 2.0) - 1.0))
  zeros = torch.zeros_like(c)
  sector = torch.remainder(torch.floor(h6).to(torch.int32), 6)

  def pick(values):
    out = values[5]
    for index in range(4, -1, -1):
      out = torch.where(sector == index, values[index], out)
    return out

  m = v - c
  r = pick((c, x, zeros, zeros, x, c))
  g = pick((x, c, c, x, zeros, zeros))
  b = pick((zeros, zeros, x, c, c, x))
  return torch.stack([r + m, g + m, b + m], dim=-1)


def adjust_brightness(image: torch.Tensor, delta) -> torch.Tensor:
  return image + delta


def adjust_contrast(image: torch.Tensor, factor) -> torch.Tensor:
  """Scales every pixel's distance from its image's mean (over H and W,
  per channel) by ``factor``."""
  mean = image.mean(dim=(-3, -2), keepdim=True)
  return (image - mean) * factor + mean


def adjust_saturation(image: torch.Tensor, factor) -> torch.Tensor:
  """Blends each pixel with its grey (0.299 R + 0.587 G + 0.114 B, a
  float32 weighted sum) by ``factor``."""
  gray = (image[..., 0:1] * _GRAY_WEIGHTS[0] +
          image[..., 1:2] * _GRAY_WEIGHTS[1] +
          image[..., 2:3] * _GRAY_WEIGHTS[2])
  return gray + (image - gray) * factor


def adjust_hue(image: torch.Tensor, delta) -> torch.Tensor:
  """Turns the hue by ``delta`` turns, modulo 1 (``tf.image.adjust_hue``);
  ``delta`` broadcasts against the image without its channel axis."""
  hsv = rgb_to_hsv(image)
  hue = _mod(hsv[..., 0] + delta, 1.0)
  return hsv_to_rgb(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1))


def _options(defaults: dict, kwargs: dict, name: str) -> dict:
  unknown = sorted(set(kwargs) - set(defaults))
  if unknown:
    raise TypeError('{} got unknown arguments {}.'.format(name, unknown))
  return {**defaults, **kwargs}


def _uniform(generator, shape, low: float, high: float) -> torch.Tensor:
  draw = torch.rand(shape, generator=generator, device=generator.device)
  return draw * (high - low) + low


def draw_photometric_parameters(generator: torch.Generator,
                                images: List[torch.Tensor],
                                **kwargs) -> List[dict]:
  """The per-example draws of ``apply_photometric_image_distortions`` for
  each image batch, from ``generator`` (on the images' device), in the
  order the JAX function draws them: ``brightness``, ``saturation`` and
  ``contrast`` [B, 1, 1, 1], ``hue`` [B], ``noise`` (a standard normal of
  the image's shape) with ``noise_draw`` [B, 1, 1, 1] (uniform in [0, 1):
  the noise applies where it is below the probability), and
  ``channel_swap`` [B] (an index into the six channel orders); only those
  that ``kwargs`` turn on."""
  options = _options(PHOTOMETRIC_DEFAULTS, kwargs,
                     'draw_photometric_parameters')
  device = generator.device
  parameters = []
  for image in images:
    batch, column = image.shape[0], (image.shape[0], 1, 1, 1)
    drawn = {}
    if options['random_brightness']:
      delta = options['max_delta_brightness']
      drawn['brightness'] = _uniform(generator, column, -delta, delta)
    if options['random_saturation']:
      drawn['saturation'] = _uniform(generator, column,
                                     options['lower_saturation'],
                                     options['upper_saturation'])
    if options['random_hue']:
      delta = options['max_delta_hue']
      drawn['hue'] = _uniform(generator, (batch,), -delta, delta)
    if options['random_contrast']:
      drawn['contrast'] = _uniform(generator, column,
                                   options['lower_contrast'],
                                   options['upper_contrast'])
    if options['random_noise_level']:
      drawn['noise'] = torch.randn(tuple(image.shape), generator=generator,
                                   device=device, dtype=image.dtype)
      drawn['noise_draw'] = torch.rand(column, generator=generator,
                                       device=device)
    if options['random_channel_swap']:
      drawn['channel_swap'] = torch.randint(
          0, len(_CHANNEL_PERMUTATIONS), (batch,), generator=generator,
          device=device)
    parameters.append(drawn)
  return parameters


def apply_photometric_image_distortions(
    images: List[torch.Tensor], parameters: Optional[List[dict]] = None,
    generator: Optional[torch.Generator] = None,
    **kwargs) -> List[torch.Tensor]:
  """Per-example photometric jitter of float [B, H, W, 3] batches in
  [0, 1], each batch on its own draws (the JAX package's function):
  brightness, saturation, hue, contrast, Gaussian noise applied to an
  example with ``random_noise_apply_probability``, one of the six channel
  orders, then a clip to [0, 1]. The keyword arguments are the JAX
  function's (all off by default). ``parameters`` are the draws
  (``draw_photometric_parameters``'s form); without them they are drawn
  from ``generator``."""
  options = _options(PHOTOMETRIC_DEFAULTS, kwargs,
                     'apply_photometric_image_distortions')
  if parameters is None:
    if generator is None:
      raise ValueError('The photometric distortions need a generator or '
                       'their parameters.')
    parameters = draw_photometric_parameters(generator, images, **kwargs)
  out = []
  for image, drawn in zip(images, parameters):
    if options['random_brightness']:
      image = adjust_brightness(image, drawn['brightness'])
    if options['random_saturation']:
      image = adjust_saturation(image, drawn['saturation'])
    if options['random_hue']:
      image = adjust_hue(image, drawn['hue'][:, None, None])
    if options['random_contrast']:
      image = adjust_contrast(image, drawn['contrast'])
    if options['random_noise_level']:
      noise = drawn['noise'] * options['random_noise_level']
      apply = drawn['noise_draw'] < options['random_noise_apply_probability']
      image = torch.where(apply, image + noise, image)
    if options['random_channel_swap']:
      orders = torch.tensor(_CHANNEL_PERMUTATIONS, device=image.device)
      index = orders[drawn['channel_swap'].long()][:, None, None, :]
      image = torch.gather(image, -1, index.expand(image.shape))
    out.append(image.clamp(0.0, 1.0))
  return out


def draw_depth_parameters(generator: torch.Generator,
                          depth_images: List[torch.Tensor],
                          **kwargs) -> List[dict]:
  """The draws of ``apply_depth_image_distortions`` for each batch, in the
  JAX function's order: ``noise`` (standard normal) with ``noise_draw``
  [B, 1, 1, 1], and ``scale`` [B, 1, 1, 1]; only those that ``kwargs``
  turn on."""
  options = _options(DEPTH_DEFAULTS, kwargs, 'draw_depth_parameters')
  device = generator.device
  parameters = []
  for image in depth_images:
    column = (image.shape[0], 1, 1, 1)
    drawn = {}
    if options['random_noise_level']:
      drawn['noise'] = torch.randn(tuple(image.shape), generator=generator,
                                   device=device, dtype=image.dtype)
      drawn['noise_draw'] = torch.rand(column, generator=generator,
                                       device=device)
    if options['scale_noise']:
      drawn['scale'] = _uniform(generator, column, options['lower_scale'],
                                options['upper_scale'])
    parameters.append(drawn)
  return parameters


def apply_depth_image_distortions(
    depth_images: List[torch.Tensor],
    parameters: Optional[List[dict]] = None,
    generator: Optional[torch.Generator] = None,
    **kwargs) -> List[torch.Tensor]:
  """Gaussian noise (applied to an example with
  ``random_noise_apply_probability``) and a per-example scale on
  [B, H, W, 1] depth maps (the JAX package's function, with its
  defaults); ``parameters`` as ``draw_depth_parameters`` gives them, or
  drawn from ``generator``."""
  options = _options(DEPTH_DEFAULTS, kwargs,
                     'apply_depth_image_distortions')
  if parameters is None:
    if generator is None:
      raise ValueError('The depth distortions need a generator or their '
                       'parameters.')
    parameters = draw_depth_parameters(generator, depth_images, **kwargs)
  out = []
  for image, drawn in zip(depth_images, parameters):
    if options['random_noise_level']:
      noise = drawn['noise'] * options['random_noise_level']
      apply = drawn['noise_draw'] < options['random_noise_apply_probability']
      image = torch.where(apply, image + noise, image)
    if options['scale_noise']:
      image = image * drawn['scale']
    out.append(image)
  return out
