"""The port's photometric and depth distortions against the JAX package's,
on the CPU.

The JAX functions draw from ``jax.random``; the port's draw from a
``torch.Generator``, which gives other numbers. So each test replays the
JAX function's own key splits to get its draws, and feeds them to the
port's deterministic part (``apply_*`` with ``parameters``): the same
draws must give the same images.

Tolerances. Brightness, hue, the HSV conversions, the noise, the channel
swap and the depth distortions are the same float32 operations in the
same order on both sides: bit-equal where a function is tested alone.
The saturation's grey is a three-term float32 sum (XLA may fuse it into
one fma) and the contrast's mean a sum over H x W in another order: each
within 1e-6 of values in [0, 1], and 2e-6 through a chain of every
distortion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.preprocessors import image_transformations as jax_it
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations as it
from tensor2robot_tpu_torch.research.qtopt import t2r_models
# The JAX critic's import shim (a module fixture).
from test_torch_qtopt import ref  # noqa: F401

ALL_ON = {'random_brightness': True, 'random_saturation': True,
          'random_hue': True, 'random_contrast': True,
          'random_noise_level': 0.05, 'random_channel_swap': True}


def _images(seed, shape=(3, 9, 11, 3)):
  """Random pixels in [0, 1] with grey pixels (max == min: hue 0) and
  hues at the wrap (red with a little blue: hue just under 1)."""
  rng = np.random.RandomState(seed)
  images = rng.uniform(0, 1, shape).astype(np.float32)
  images[0, 0, :3] = 0.5
  images[0, 1, :2] = [0.0, 0.0, 0.0]
  images[1, 0, :3] = [1.0, 0.0, 1e-6]
  images[1, 1, :3] = [0.8, 0.2, 0.79]
  return images


def _jax_draws(key, images, **kwargs):
  """The draws of JAX's ``apply_photometric_image_distortions``, in its
  split order, in the port's parameter form."""
  o = dict(it.PHOTOMETRIC_DEFAULTS, **kwargs)
  out = []
  for image in images:
    batch, column, drawn = image.shape[0], (image.shape[0], 1, 1, 1), {}
    if o['random_brightness']:
      key, sub = jax.random.split(key)
      drawn['brightness'] = jax.random.uniform(
          sub, column, minval=-o['max_delta_brightness'],
          maxval=o['max_delta_brightness'])
    if o['random_saturation']:
      key, sub = jax.random.split(key)
      drawn['saturation'] = jax.random.uniform(
          sub, column, minval=o['lower_saturation'],
          maxval=o['upper_saturation'])
    if o['random_hue']:
      key, sub = jax.random.split(key)
      drawn['hue'] = jax.random.uniform(sub, (batch,),
                                        minval=-o['max_delta_hue'],
                                        maxval=o['max_delta_hue'])
    if o['random_contrast']:
      key, sub = jax.random.split(key)
      drawn['contrast'] = jax.random.uniform(
          sub, column, minval=o['lower_contrast'],
          maxval=o['upper_contrast'])
    if o['random_noise_level']:
      key, knoise, kapply = jax.random.split(key, 3)
      drawn['noise'] = jax.random.normal(knoise, image.shape, jnp.float32)
      drawn['noise_draw'] = jax.random.uniform(kapply, column)
    if o['random_channel_swap']:
      key, sub = jax.random.split(key)
      drawn['channel_swap'] = jax.random.randint(sub, (batch,), 0, 6)
    out.append({k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
  return out


def _jax_depth_draws(key, images, **kwargs):
  o = dict(it.DEPTH_DEFAULTS, **kwargs)
  out = []
  for image in images:
    column, drawn = (image.shape[0], 1, 1, 1), {}
    if o['random_noise_level']:
      key, knoise, kapply = jax.random.split(key, 3)
      drawn['noise'] = jax.random.normal(knoise, image.shape, jnp.float32)
      drawn['noise_draw'] = jax.random.uniform(kapply, column)
    if o['scale_noise']:
      key, sub = jax.random.split(key)
      drawn['scale'] = jax.random.uniform(sub, column,
                                          minval=o['lower_scale'],
                                          maxval=o['upper_scale'])
    out.append({k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
  return out


def _close(got, want, atol):
  got = got.numpy() if isinstance(got, torch.Tensor) else got
  np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize('name,args,atol', [
    ('rgb_to_hsv', (), 0.0),
    ('hsv_to_rgb', (), 0.0),
    ('adjust_brightness', (0.1,), 0.0),
    ('adjust_brightness', (-0.3,), 0.0),
    ('adjust_saturation', (1.4,), 1e-6),
    ('adjust_saturation', (0.3,), 1e-6),
    ('adjust_contrast', (1.3,), 1e-6),
    ('adjust_contrast', (0.6,), 1e-6),
    ('adjust_hue', (0.2,), 0.0),
    ('adjust_hue', (-0.2,), 0.0),
    ('adjust_hue', (0.9,), 0.0),
])
def test_each_function_matches_jax(name, args, atol):
  images = _images(0)
  if name == 'hsv_to_rgb':   # HSV inputs: the JAX conversion's, at the wrap
    images = np.array(jax_it.rgb_to_hsv(jnp.asarray(images)))
    images[0, 0, 0, 0] = 1.0 - 1e-7
  want = getattr(jax_it, name)(jnp.asarray(images), *args)
  got = getattr(it, name)(torch.from_numpy(images), *args)
  _close(got, want, atol)


def test_hsv_of_grey_and_wrapped_pixels_is_tf_images():
  hsv = it.rgb_to_hsv(torch.from_numpy(_images(1)))
  assert float(hsv[0, 0, 0, 0]) == 0.0 and float(hsv[0, 0, 0, 1]) == 0.0
  assert 0.99 < float(hsv[1, 0, 0, 0]) < 1.0
  back = it.hsv_to_rgb(hsv)
  _close(back, _images(1), 1e-6)


@pytest.mark.parametrize('kwargs', [
    ALL_ON,
    {'random_hue': True, 'max_delta_hue': 0.5},
    {'random_noise_level': 0.2, 'random_noise_apply_probability': 0.5},
    {'random_channel_swap': True, 'random_brightness': True},
    {},
])
def test_photometric_distortions_match_jax_on_jax_draws(kwargs):
  images = [_images(2), _images(3, (2, 5, 7, 3))]
  key = jax.random.PRNGKey(4)
  want = jax_it.apply_photometric_image_distortions(
      key, [jnp.asarray(x) for x in images], **kwargs)
  draws = _jax_draws(key, images, **kwargs)
  got = it.apply_photometric_image_distortions(
      [torch.from_numpy(x) for x in images], draws, **kwargs)
  for g, w in zip(got, want):
    _close(g, w, 2e-6)
    assert 0.0 <= float(g.min()) and float(g.max()) <= 1.0


@pytest.mark.parametrize('kwargs', [
    {}, {'scale_noise': True}, {'random_noise_level': 0.0,
                                'scale_noise': True}])
def test_depth_distortions_match_jax_on_jax_draws(kwargs):
  rng = np.random.RandomState(5)
  images = [rng.uniform(0, 2, (3, 6, 5, 1)).astype(np.float32)]
  key = jax.random.PRNGKey(6)
  want = jax_it.apply_depth_image_distortions(
      key, [jnp.asarray(x) for x in images], **kwargs)
  got = it.apply_depth_image_distortions(
      [torch.from_numpy(x) for x in images],
      _jax_depth_draws(key, images, **kwargs), **kwargs)
  _close(got[0], want[0], 0.0)


def test_draws_come_from_the_generator_and_keep_their_shapes():
  image = torch.from_numpy(_images(7))
  first = it.draw_photometric_parameters(torch.Generator().manual_seed(1),
                                         [image], **ALL_ON)[0]
  again = it.draw_photometric_parameters(torch.Generator().manual_seed(1),
                                         [image], **ALL_ON)[0]
  assert sorted(first) == sorted(['brightness', 'saturation', 'hue',
                                  'contrast', 'noise', 'noise_draw',
                                  'channel_swap'])
  for key in first:
    assert torch.equal(first[key], again[key]), key
  assert first['brightness'].shape == (3, 1, 1, 1)
  assert first['hue'].shape == (3,) and first['noise'].shape == image.shape
  assert float(first['brightness'].abs().max()) <= 0.125
  assert 0 <= int(first['channel_swap'].min()) <= int(
      first['channel_swap'].max()) < 6
  drawn = it.apply_photometric_image_distortions(
      [image], generator=torch.Generator().manual_seed(1), **ALL_ON)[0]
  assert torch.equal(drawn, it.apply_photometric_image_distortions(
      [image], [first], **ALL_ON)[0])
  with pytest.raises(TypeError, match='random_blur'):
    it.apply_photometric_image_distortions([image], [first],
                                           random_blur=True)
  with pytest.raises(ValueError, match='generator'):
    it.apply_photometric_image_distortions([image], **ALL_ON)


def test_train_preprocessor_distorts_as_jax_after_the_crop(ref):
  """The critic's TRAIN preprocessor with every distortion: JAX's crop
  offsets and distortion draws (its key split in two), the same image;
  EVAL and PREDICT stay undistorted."""
  jax_model = ref.t2r_models.\
      Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device_type='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  jax_pre = ref.t2r_models.DefaultGrasping44ImagePreprocessor(
      jax_model.get_feature_specification,
      jax_model.get_label_specification, distortion_kwargs=ALL_ON)
  port = t2r_models.DefaultGrasping44ImagePreprocessor(
      None, None, distortion_kwargs=ALL_ON)
  rng = np.random.RandomState(8)
  images = rng.randint(0, 256, (2, 512, 640, 3)).astype(np.uint8)
  key = jax.random.PRNGKey(9)
  crop_key, distort_key = jax.random.split(key)
  offsets = np.array(jax_it.random_crop_offsets(
      crop_key, 2, (512, 640), t2r_models.TARGET_SHAPE))
  want = np.asarray(jax_pre._preprocess_fn(
      {'state/image': jnp.asarray(images)}, None, ModeKeys.TRAIN,
      key)[0]['state/image'])
  draws = _jax_draws(distort_key, [np.zeros((2, 472, 472, 3))], **ALL_ON)
  got, _ = port.preprocess({'state/image': torch.from_numpy(images)}, None,
                           ModeKeys.TRAIN, offsets=torch.from_numpy(offsets),
                           distortion_parameters=draws)
  _close(got['state/image'], want, 2e-6)
  plain = port.preprocess_images(torch.from_numpy(images), ModeKeys.EVAL)
  center = np.asarray(jax_pre._preprocess_fn(
      {'state/image': jnp.asarray(images)}, None, ModeKeys.EVAL)[0][
          'state/image'])
  # K1 multiplies by float32 1/255 where the eager JAX divides: one ulp.
  _close(plain, center, 6e-8)
  with pytest.raises(ValueError, match='generator'):
    port.preprocess_images(torch.from_numpy(images), ModeKeys.TRAIN,
                           offsets=torch.from_numpy(offsets))
  with pytest.raises(TypeError, match='random_blur'):
    t2r_models.DefaultGrasping44ImagePreprocessor(
        distortion_kwargs={'random_blur': True})
