"""The port's vrgripper and Watch-Try-Learn models (``research/vrgripper``)
against the JAX package's, on the CPU, through the import shim of
``_torch_jax_qtopt`` (JAX's vrgripper package reaches the qtopt modules).

  * ``DefaultVRGripperPreprocessor``: TRAIN's per-episode crops at JAX's
    offsets (injected), through K1's plain version, the resize and mixup
    at JAX's lambda; EVAL's center crop; and the meta layout's two sides,
    each with the offsets of its share of JAX's key;
  * each model family's TRAIN loss, outputs and every gradient, on the
    same random weights (``_torch_flax_tree``: drawn for the port's
    network, handed to JAX's as a flax tree) and numpy inputs: the
    regression model, MAML over it and over the DAML model (second order;
    the adapted outputs), TEC (MDN, and FiLM with MAF and the end token),
    SNAIL, the state-space trial and retrial models, the vision trial and
    retrial models;
  * the pack functions and ``episode_to_transitions``, array for array and
    byte for byte, and ``MetaRecordInputGenerator``'s batches of episode
    records array for array;
  * the five gins: the registry names, and each gin trained through
    ``train_eval --gin_configs`` from episode records written by the
    port's writer.

Tolerances. float32 on both sides (every JAX network casts its inputs to
float32) unless a test says float64: the preprocessed frames within 1e-5
(the crop and the conversion bit for bit; the antialiased resize's weights
in other float32 roundings, some 2e-6), losses and outputs within 1e-5 of
each one's magnitude, gradients within 1e-4 of each tensor's largest;
MAML's outer gradients within 1e-3 (the adapted weights' roundings carry
through the second-order products, as in ``test_torch_pose_env.py``).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_flax_tree import random_state, to_flax
from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import config
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.meta_learning import MAMLInnerLoopGradientDescent
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research import vrgripper
from tensor2robot_tpu_torch.research.vrgripper import episode_to_transitions
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec
from tensor2robot_tpu_torch.trainer import train_eval
from tensor2robot_tpu_torch.utils import image as image_lib

RTOL = 1e-5
IMAGE_ATOL = 1e-5
GRAD_RTOL = 1e-4
MAML_GRAD_RTOL = 1e-3
T = 12   # >= the temporal reduction's kernel (10)
CONFIGS = 'tensor2robot_tpu_torch/research/vrgripper/configs/'
# JAX config/registry.py's VRGripper / WTL names.
REGISTRY_NAMES = (
    'VRGripperRegressionModel', 'VRGripperDomainAdaptiveModel',
    'DefaultVRGripperPreprocessor', 'VRGripperEnvRegressionModelMAML',
    'VRGripperEnvTecModel', 'VRGripperEnvSequentialModel',
    'VRGripperEnvSimpleTrialModel', 'VRGripperEnvVisionTrialModel',
    'MSEDecoder', 'MDNActionDecoder', 'MAFDecoder', 'DiscreteDecoder')


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture(
      'research.vrgripper', 'research.vrgripper.episode_to_transitions',
      'meta_learning', 'meta_learning.meta_data', 'specs.struct')


def close(got, want, rtol=RTOL, what='', atol=1e-6):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  assert float(np.abs(got - want).max()) <= rtol * scale + atol, (
      what, float(np.abs(got - want).max()), scale)


def uniform(seed, *shape, low=0.0, high=1.0):
  return np.random.RandomState(seed).uniform(low, high, shape).astype(
      np.float32)


def frames(seed, *shape):
  return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def tensors(struct):
  return {k: torch.tensor(np.asarray(v)) for k, v in struct.items()}


# -- the preprocessor -------------------------------------------------------

def jax_offsets(key, batch, src=(220, 300), crop=(200, 280)):
  """The (y, x) offsets that JAX's preprocessor draws from ``key``."""
  _, ky, kx = jax.random.split(key, 3)
  return np.stack([
      np.asarray(jax.random.randint(ky, (batch,), 0, src[0] - crop[0] + 1)),
      np.asarray(jax.random.randint(kx, (batch,), 0, src[1] - crop[1] + 1))],
                  -1).astype(np.int32)


def test_preprocessor_against_jax(ref):
  """TRAIN (crops at JAX's offsets, the resize, mixup at JAX's lambda) and
  EVAL (the center crop) of 2 episodes of 3 frames."""
  struct = ref.struct.SpecStruct
  raw = {'image': frames(0, 2, 3, 220, 300, 3),
         'gripper_pose': uniform(1, 2, 3, 14)}
  labels = {'action': uniform(2, 2, 3, 7, low=-1.0)}
  jax_model = ref.vrgripper.VRGripperRegressionModel(
      episode_length=3, preprocessor_cls=lambda f, l: (
          ref.vrgripper.DefaultVRGripperPreprocessor(f, l, mixup_alpha=0.4)))
  model = vrgripper.VRGripperRegressionModel(
      device='cpu', episode_length=3, preprocessor_cls=lambda f, l: (
          vrgripper.DefaultVRGripperPreprocessor(f, l, mixup_alpha=0.4)))
  key = jax.random.PRNGKey(5)
  want_f, want_l = jax_model.preprocessor.preprocess(
      struct(**raw), struct(**labels), 'train', rng=key)
  rng, _, _ = jax.random.split(key, 3)
  _, kmix = jax.random.split(rng)
  draws = {'offsets': jax_offsets(key, 2),
           'mixup_lambda': float(jax.random.beta(kmix, 0.4, 0.4))}
  got_f, got_l = model.preprocessor.preprocess(tensors(raw), tensors(labels),
                                               ModeKeys.TRAIN, draws=draws)
  close(got_f['image'], want_f['image'], 0.0, 'image', IMAGE_ATOL)
  close(got_f['gripper_pose'], want_f['gripper_pose'])
  close(got_l['action'], want_l['action'])
  assert got_f['image'].shape == (2, 3, 100, 100, 3)
  want_f, _ = jax_model.preprocessor.preprocess(struct(**raw), None, 'eval')
  got_f, _ = model.preprocessor.preprocess(tensors(raw), None,
                                           ModeKeys.EVAL)
  close(got_f['image'], want_f['image'], 0.0, 'eval image', IMAGE_ATOL)
  with pytest.raises(ValueError, match='generator'):
    model.preprocessor.preprocess(tensors(raw), tensors(labels),
                                  ModeKeys.TRAIN)
  draws = model.preprocessor.draw(2, torch.Generator().manual_seed(0))
  assert draws['offsets'].dtype == torch.int32 and (
      0 <= int(draws['offsets'].min()) and
      int(draws['offsets'][:, 0].max()) <= 20 and
      int(draws['offsets'][:, 1].max()) <= 20)
  assert 0.0 <= draws['mixup_lambda'] <= 1.0


def test_meta_preprocessor_sides_against_jax(ref):
  """The vision retrial model's meta batch (2 tasks, 2 condition and 1
  inference episodes of 2 frames): each side cropped at the offsets of its
  share of JAX's key (JAX splits it three ways), the labels passed on."""
  struct = ref.struct.SpecStruct
  kwargs = dict(episode_length=2, num_condition_samples_per_task=2)
  jax_model = ref.vrgripper.VRGripperEnvVisionTrialModel(**kwargs)
  model = vrgripper.VRGripperEnvVisionTrialModel(device='cpu', **kwargs)
  raw = {'condition/features/image': frames(3, 2, 2, 2, 220, 300, 3),
         'condition/features/gripper_pose': uniform(4, 2, 2, 2, 14),
         'condition/labels/action': uniform(5, 2, 2, 2, 7),
         'condition/labels/success': uniform(6, 2, 2, 2, 1),
         'inference/features/image': frames(7, 2, 1, 2, 220, 300, 3),
         'inference/features/gripper_pose': uniform(8, 2, 1, 2, 14)}
  labels = {'action': uniform(9, 2, 1, 2, 7), 'success': uniform(10, 2, 1,
                                                                  2, 1)}
  key = jax.random.PRNGKey(11)
  want_f, want_l = jax.jit(lambda f, l, k: jax_model.preprocessor.preprocess(
      f, l, 'train', rng=k))(struct(**raw), struct(**labels), key)
  condition_key, inference_key, _ = jax.random.split(key, 3)
  draws = {'condition': {'offsets': jax_offsets(condition_key, 4)},
           'inference': {'offsets': jax_offsets(inference_key, 2)}}
  got_f, got_l = model.preprocessor.preprocess(tensors(raw), tensors(labels),
                                               ModeKeys.TRAIN, draws=draws)
  assert set(got_f) == set(want_f)
  for key_name in want_f:
    close(got_f[key_name], want_f[key_name], 0.0, key_name, IMAGE_ATOL)
  for key_name in want_l:
    close(got_l[key_name], want_l[key_name])


# -- the model families -----------------------------------------------------

def compare_step(ref, jax_model, model, features, labels, output_keys,
                 grad_rtol=GRAD_RTOL, x64=False):
  """JAX's jitted value-and-grad of the TRAIN loss against the port's, on
  the same random weights and batch; with ``x64`` the weights and
  features in float64 on both sides (the losses cast to float32 on both,
  as JAX's do)."""
  struct = ref.struct.SpecStruct
  dtype = torch.float64 if x64 else torch.float32
  state = random_state(model.network)
  assert convert.from_flax(to_flax(state))['params'].keys() == state.keys()
  cast = ((lambda tree: jax.tree_util.tree_map(
      lambda a: np.asarray(a, np.float64), tree)) if x64 else
          (lambda tree: tree))
  with jax.enable_x64(x64):
    (want_loss, (want_train, want_outputs, _)), want_grads = jax.jit(
        jax.value_and_grad(jax_model.loss_fn, has_aux=True),
        static_argnums=(4,))(cast(to_flax(state)['params']), {},
                             struct(**cast(features)), struct(**labels),
                             'train', None)
    want_loss, want_train, want_outputs, want_grads = jax.tree_util.tree_map(
        np.asarray, (want_loss, dict(want_train), dict(want_outputs),
                     want_grads))
  params_in = {k: v.to(dtype).requires_grad_() for k, v in state.items()}
  loss, (train_outputs, outputs, _) = model.loss_fn(
      params_in, {}, tensors(cast(features)), tensors(labels),
      ModeKeys.TRAIN)
  grads = dict(zip(params_in, torch.autograd.grad(
      loss, list(params_in.values()), allow_unused=True)))
  close(loss, want_loss, what='loss')
  for key in want_train:
    close(train_outputs[key], want_train[key], what=key)
  for key in output_keys:
    close(outputs[key], want_outputs[key], what=key)
  want_grads = convert.from_flax({'params': want_grads})['params']
  assert want_grads.keys() == grads.keys()
  for name, value in want_grads.items():
    got = grads[name] if grads[name] is not None else torch.zeros_like(value)
    close(got, value.numpy(), grad_rtol, name)
  return outputs


def episode_batch(seed, lead, steps=T, image=True, state=False):
  """Preprocessed features of ``lead`` [..., steps] episodes."""
  out = {}
  if image:
    out['image'] = uniform(seed, *lead, steps, 100, 100, 3)
    out['gripper_pose'] = uniform(seed + 1, *lead, steps, 14, low=-1.0)
  if state:
    out['full_state_pose'] = uniform(seed + 2, *lead, steps, 32, low=-1.0)
  return out


def meta_batch(seed, tasks=2, n_con=1, steps=T, image=True, state=False,
               success=True):
  features = {}
  for side, n in (('condition', n_con), ('inference', 1)):
    for key, value in episode_batch(seed, (tasks, n), steps, image,
                                    state).items():
      features['{}/features/{}'.format(side, key)] = value
    seed += 10
  features['condition/labels/action'] = uniform(seed, tasks, n_con, steps, 7,
                                                low=-1.0)
  labels = {'action': uniform(seed + 1, tasks, 1, steps, 7, low=-1.0)}
  if success:
    features['condition/labels/success'] = (
        np.arange(tasks * n_con * steps).reshape(tasks, n_con, steps, 1) %
        2).astype(np.float32)
    labels['success'] = np.ones((tasks, 1, steps, 1), np.float32)
  return features, labels


def test_regression_model_against_jax(ref):
  """The mixture head's variant (MAML's test below runs the pose net's)."""
  kwargs = dict(episode_length=4, num_mixture_components=3)
  features = episode_batch(20, (2,), 4)
  labels = {'action': uniform(22, 2, 4, 7, low=-1.0)}
  outputs = compare_step(
      ref, ref.vrgripper.VRGripperRegressionModel(**kwargs),
      vrgripper.VRGripperRegressionModel(device='cpu', **kwargs), features,
      labels, ['inference_output', 'feature_points', 'softmax'])
  assert outputs['inference_output'].shape == (2, 4, 7)


@pytest.mark.parametrize('daml', [False, True])
def test_maml_wrappers_against_jax(ref, daml):
  """MAML (2 tasks, one inner step, second order) over the regression
  model, and over the DAML model with ``var_scope='policy'`` (the learned
  loss adapts the policy; 19 frames for its two kernel-10 convs): the
  adapted and unadapted outputs, the inner losses, the loss and every
  outer gradient."""
  steps = 19 if daml else 4
  jax_base = (ref.vrgripper.VRGripperDomainAdaptiveModel if daml
              else ref.vrgripper.VRGripperRegressionModel)
  base = (vrgripper.VRGripperDomainAdaptiveModel if daml
          else vrgripper.VRGripperRegressionModel)
  scope = {'var_scope': 'policy'} if daml else {}
  jax_model = ref.vrgripper.VRGripperEnvRegressionModelMAML(
      base_model=jax_base(episode_length=steps),
      inner_loop=ref.meta_learning.MAMLInnerLoopGradientDescent(
          learning_rate=0.01, **scope))
  model = vrgripper.VRGripperEnvRegressionModelMAML(
      base_model=base(device='cpu', episode_length=steps),
      inner_loop=MAMLInnerLoopGradientDescent(learning_rate=0.01, **scope))
  features, labels = meta_batch(30, steps=steps, success=False)
  outputs = compare_step(
      ref, jax_model, model, features, labels,
      ['full_inference_output/inference_output',
       'full_inference_output_unconditioned/inference_output',
       'full_condition_output/inference_output', 'inner_losses/step_0',
       'inner_losses/step_1'], MAML_GRAD_RTOL)
  diff = (outputs['full_inference_output/inference_output'] - outputs[
      'full_inference_output_unconditioned/inference_output']).abs().max()
  assert float(diff.detach()) > 0   # the adaptation moved the outputs


@pytest.mark.parametrize('variant', ['mdn', 'film_maf_end'])
def test_tec_model_against_jax(ref, variant):
  """TEC as the gin binds it (an MDN decoder, the embedding loss), and
  with FiLM, a MAF decoder and the end token. The latter in float64: the
  FiLM'd tower's float32 roundings reach the embedding's conv gradient as
  1.1e-4 of its largest."""
  kwargs = dict(episode_length=T, embed_loss_weight=0.1,
                action_decoder_kwargs={'num_mixture_components': 2})
  if variant == 'film_maf_end':
    kwargs.update(use_film=True, predict_end_weight=0.5,
                  action_decoder_kwargs={'hidden_layers': (16, 16)})
    jax_model = ref.vrgripper.VRGripperEnvTecModel(
        action_decoder_cls=ref.vrgripper.MAFDecoder, **kwargs)
    model = vrgripper.VRGripperEnvTecModel(
        device='cpu', action_decoder_cls=vrgripper.MAFDecoder, **kwargs)
  else:
    jax_model = ref.vrgripper.VRGripperEnvTecModel(**kwargs)
    model = vrgripper.VRGripperEnvTecModel(device='cpu', **kwargs)
  features, labels = meta_batch(40, success=False)
  compare_step(ref, jax_model, model, features, labels,
               ['inference_output', 'condition_embedding',
                'inference_embedding'], x64=variant != 'mdn')


def test_sequential_model_against_jax(ref):
  kwargs = dict(episode_length=T, num_mixture_components=2)
  features, labels = meta_batch(50, success=False)
  outputs = compare_step(
      ref, ref.vrgripper.VRGripperEnvSequentialModel(**kwargs),
      vrgripper.VRGripperEnvSequentialModel(device='cpu', **kwargs),
      features, labels, ['inference_output', 'attn_probs/0'])
  assert outputs['inference_output'].shape == (2, 1, T, 7)


@pytest.mark.parametrize('kwargs', [
    dict(num_mixture_components=2),
    dict(retrial=True, embed_type='mean'),
    dict(retrial=True, num_mixture_components=3)])
def test_simple_trial_model_against_jax(ref, kwargs):
  features, labels = meta_batch(60, n_con=2 if kwargs.get('retrial') else 1,
                                image=False, state=True)
  compare_step(ref, ref.vrgripper.VRGripperEnvSimpleTrialModel(
      episode_length=T, **kwargs),
               vrgripper.VRGripperEnvSimpleTrialModel(
                   device='cpu', episode_length=T, **kwargs),
               features, labels, ['inference_output'])


@pytest.mark.parametrize('n_con,components', [(1, 20), (2, 1)])
def test_vision_trial_model_against_jax(ref, n_con, components):
  kwargs = dict(episode_length=T, num_condition_samples_per_task=n_con,
                num_mixture_components=components)
  features, labels = meta_batch(70, n_con=n_con)
  compare_step(ref, ref.vrgripper.VRGripperEnvVisionTrialModel(**kwargs),
               vrgripper.VRGripperEnvVisionTrialModel(device='cpu',
                                                      **kwargs),
               features, labels, ['inference_output'])


def test_initial_weights_are_flax_defaults():
  """A fresh state holds flax's defaults: lecun-normal kernels (std 1 /
  sqrt(fan in), truncated at 2 std), zero biases and unit scales, the
  mixture's free scales at softplus 1, MAF kernels xavier-uniform."""
  model = vrgripper.VRGripperEnvTecModel(
      device='cpu', episode_length=T, predict_end_weight=0.5,
      action_decoder_cls=vrgripper.MAFDecoder,
      action_decoder_kwargs={'hidden_layers': (16, 16)})
  params = model.create_train_state(torch.Generator().manual_seed(0)).params
  conv = params['state_features.conv3.weight']
  fan_in = conv[0].numel()
  assert abs(float(conv.std()) * np.sqrt(fan_in) - 1.0) < 0.1
  assert float(conv.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
  reduce = params['fc_reduce.Conv_0.weight']   # [out, in, k]: fan in in*k
  assert abs(float(reduce.std()) * np.sqrt(reduce[0].numel()) - 1.0) < 0.1
  assert float(params['a_func.Dense_0.bias'].abs().max()) == 0.0
  assert float(params['a_func.LayerNorm_0.scale'].min()) == 1.0
  made = params['action_decoder.maf.bijector.made_0.masked_dense_0_kernel']
  assert float(made.abs().max()) <= np.sqrt(6.0 / sum(made.shape))
  assert float(made.abs().max()) > 0.5 * np.sqrt(6.0 / sum(made.shape))
  mdn = vrgripper.VRGripperRegressionModel(device='cpu', episode_length=4,
                                           num_mixture_components=3)
  stddev = mdn.create_train_state(torch.Generator().manual_seed(0)).params[
      'mdn_head.mdn_stddev_inputs']
  np.testing.assert_allclose(torch.nn.functional.softplus(stddev).numpy(),
                             1.0, rtol=1e-6)


# -- pack functions and episode records -------------------------------------

def _episode(length=5, reward=1.0):
  rng = np.random.RandomState(length)
  episode = []
  for t in range(length):
    obs = {'image': rng.randint(0, 256, (22, 30, 3)).astype(np.uint8),
           'pose': rng.normal(size=14).astype(np.float32),
           'full_state_pose': rng.normal(size=32).astype(np.float32)}
    episode.append((obs, rng.normal(size=7).astype(np.float32),
                    reward if t == length - 1 else 0.0, obs,
                    t == length - 1, {'is_demo': True, 'target_idx': 3}))
  return episode


def test_pack_features_and_transitions_against_jax(ref):
  """The pack functions (the same numpy global seed before each side's
  resampling), make_fixed_length, and the transitions' bytes."""
  state = {'image': frames(80, 22, 30, 3), 'pose': uniform(81, 14),
           'full_state_pose': uniform(82, 32)}
  episodes = [_episode(5), _episode(7, reward=0.0)]
  calls = [
      (lambda m: m.pack_vrgripper_meta_features, (state, episodes, 0, T, 2),
       {}),
      (lambda m: m.pack_wtl_meta_features, (state, episodes, 0, T, 2), {}),
      (lambda m: m.pack_wtl_meta_features, (state, episodes, 0, T, 2),
       {'vision': True, 'deterministic_condition': False})]
  for fn, args, kwargs in calls:
    np.random.seed(0)
    want = fn(ref.vrgripper)(*args, **kwargs)
    np.random.seed(0)
    got = fn(vrgripper)(*args, **kwargs)
    assert set(got) == set(want)
    for key in want:
      assert got[key].dtype == want[key].dtype, key
      np.testing.assert_array_equal(got[key], want[key])
  assert got['condition/labels/success'][0, :, 0, 0].tolist() == [1.0, 0.0]
  model = vrgripper.VRGripperEnvVisionTrialModel(
      device='cpu', episode_length=T, num_condition_samples_per_task=2)
  assert model.pack_features(state, episodes, 0)[
      'inference/features/image'].shape == (1, 1, T, 22, 30, 3)
  for randomized in (True, False):
    np.random.seed(1)
    want = ref.episode_to_transitions.make_fixed_length(
        list(range(9)), 6, randomized=randomized)
    np.random.seed(1)
    assert episode_to_transitions.make_fixed_length(
        list(range(9)), 6, randomized=randomized) == want
  assert episode_to_transitions.make_fixed_length([0, 1], 4) is None
  reacher = [(np.zeros(3, np.float32), np.ones(2, np.float32), 0.5,
              np.ones(3, np.float32), t == 2,
              {'is_demo': True, 'target_idx': 1}) for t in range(3)]
  assert (vrgripper.episode_to_transitions_reacher(reacher, is_demo=True) ==
          ref.vrgripper.episode_to_transitions_reacher(reacher, is_demo=True))
  assert (vrgripper.episode_to_transitions_metareacher(reacher) ==
          ref.vrgripper.episode_to_transitions_metareacher(reacher))


# -- the gins ---------------------------------------------------------------

def write_episode_records(directory, tasks=2, episodes=2, steps=T):
  """One file a task of episodes under the vrgripper records' names: 220x300
  JPEG frames ``image0``, ``world_pose_gripper``, ``full_state_pose``,
  ``action_world``, ``success``."""
  spec = {'image': TensorSpec((steps, 220, 300, 3), np.uint8, name='image0',
                              data_format='jpeg'),
          'gripper_pose': TensorSpec((steps, 14), np.float32,
                                     name='world_pose_gripper'),
          'full_state_pose': TensorSpec((steps, 32), np.float32,
                                        name='full_state_pose'),
          'action': TensorSpec((steps, 7), np.float32, name='action_world'),
          'success': TensorSpec((steps, 1), np.float32, name='success')}
  rng = np.random.RandomState(0)
  for task in range(tasks):
    with TFRecordReplayWriter() as writer:
      writer.open(os.path.join(directory, 'task-{}.tfrecord'.format(task)))
      for _ in range(episodes):
        writer.write_numpy(spec, {
            'image': [image_lib.numpy_to_image_string(
                rng.randint(0, 256, (220, 300, 3)).astype(np.uint8), 'jpeg')
                      for _ in range(steps)],
            'gripper_pose': rng.normal(size=(steps, 14)).astype(np.float32),
            'full_state_pose': rng.normal(size=(steps, 32)).astype(
                np.float32),
            'action': rng.uniform(-1, 1, (steps, 7)).astype(np.float32),
            'success': np.full((steps, 1), float(task % 2), np.float32)})
  return os.path.join(directory, 'task-*')


def test_meta_record_generator_against_jax(ref, tmp_path):
  """The port's MetaRecordInputGenerator (every task's records in one
  parse) gives JAX's batches, array for array, on the same task files and
  seed: the vision retrial layout, 2 tasks of 2 condition and 1 inference
  episodes."""
  pattern = write_episode_records(str(tmp_path), episodes=3)
  kwargs = dict(episode_length=T, num_condition_samples_per_task=2)
  got_model = vrgripper.VRGripperEnvVisionTrialModel(device='cpu', **kwargs)
  want_model = ref.vrgripper.VRGripperEnvVisionTrialModel(**kwargs)
  batches = []
  for model, cls, mode in (
      (got_model, meta_data.MetaRecordInputGenerator, ModeKeys.TRAIN),
      (want_model, ref.meta_data.MetaRecordInputGenerator, 'train')):
    generator = cls(file_patterns=pattern, num_condition_samples_per_task=2,
                    num_tasks=2)
    generator.set_specification_from_model(model, mode)
    iterator = generator.create_dataset_iterator(mode, num_epochs=1, seed=3)
    batches.append(next(iter(iterator)))
  (got_f, got_l), (want_f, want_l) = batches
  assert set(got_f) == set(want_f) and set(got_l) == set(want_l)
  for got, want in ((got_f, want_f), (got_l, want_l)):
    for key in want:
      np.testing.assert_array_equal(got[key], np.asarray(want[key]))
  assert got_f['condition/features/image'].shape == (2, 2, T, 220, 300, 3)


@pytest.mark.parametrize('gin,model', [
    ('run_train_wtl_vision_trial.gin', 'VRGripperEnvVisionTrialModel'),
    ('run_train_wtl_vision_retrial.gin', 'VRGripperEnvVisionTrialModel'),
    ('train_vrgripper_tec.gin', 'VRGripperEnvTecModel'),
    ('run_train_wtl_statespace_trial.gin', 'VRGripperEnvSimpleTrialModel'),
    ('run_train_wtl_statespace_retrial.gin',
     'VRGripperEnvSimpleTrialModel')])
def test_gins_train_from_episode_records(tmp_path, gin, model):
  """Each gin as written but its data, its episode length (12), its task
  count (2) and its steps (2), through ``train_eval --gin_configs``:
  every name it binds registered (JAX's registry names among them), the
  losses finite, the bound values in the model."""
  config.register_framework_configurables()
  for name in REGISTRY_NAMES:
    assert config.get_configurable(name) is not None, name
  pattern = write_episode_records(str(tmp_path))
  argv = ['--device', 'cpu', '--model_dir', str(tmp_path / 'model'),
          '--gin_configs', CONFIGS + gin]
  for binding in ('TRAIN_DATA = "{}"'.format(pattern),
                  'TRAIN_BATCH_SIZE = 2',
                  '{}.episode_length = {}'.format(model, T),
                  'train_eval_model.max_train_steps = 2',
                  'train_eval_model.log_every_n_steps = 1'):
    argv += ['--gin_bindings', binding]
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main(argv) == 0
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  assert line['model'] == model and line['step'] == 2
  assert line['data'] == 'python'   # MetaRecordInputGenerator's parser
  assert np.isfinite(line['metrics']['loss'])
  bindings = config.query_parameter
  if 'vision' in gin:
    assert bindings('VRGripperEnvVisionTrialModel.num_mixture_components') == 20
    assert bindings('create_adam_optimizer.learning_rate') == 0.0005
  if 'retrial' in gin:
    assert bindings('train_input_generator/MetaRecordInputGenerator.'
                    'num_condition_samples_per_task') == 2
  if 'tec' in gin:
    assert bindings('VRGripperEnvTecModel.embed_loss_weight') == 0.1
