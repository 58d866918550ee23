"""The port's Grasp2Vec (``research/grasp2vec``) against the JAX package's,
on the CPU.

Inputs are numpy draws from a seed; weights are JAX's, carried across by
``convert.from_flax``; TRAIN's crop offsets and flips are JAX's own draws
from its key, injected into the port (``preprocess(..., draws=)``).

Tolerances. The losses and summaries: float32 on both sides, within 1e-5
of each value's magnitude (1e-6 absolute). The preprocessor: bit-equal
(the crop and K1's ``* float32(1 / 255)``, which is what XLA compiles
``/ 255.0`` to; the flips move bits). The train step: both networks in
float64 (the losses float32 on both, as JAX's cast), so that no ReLU gate
or TRAIN batch statistic of a float32 near-tie decides the comparison;
the loss within 1e-5 relative, every gradient within 1e-5 of its tensor's
largest, the new running statistics within 1e-6.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.research import grasp2vec as jax_grasp2vec
from tensor2robot_tpu.research.grasp2vec import losses as jax_losses
from tensor2robot_tpu.research.grasp2vec import visualization as jax_vis
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research import grasp2vec
from tensor2robot_tpu_torch.research.grasp2vec import losses
from tensor2robot_tpu_torch.research.grasp2vec import visualization
from tensor2robot_tpu_torch.trainer import train_eval
from tensor2robot_tpu_torch.utils import image as image_lib

RTOL = 1e-5
GIN = 'tensor2robot_tpu_torch/research/grasp2vec/configs/train_grasp2vec.gin'
# The small model of JAX's own test (test_grasp2vec.py:203).
SRC = (64, 64, 3)
CROP = (0, 8, 56, 0, 8, 56)


def close(got, want, rtol=RTOL, what=''):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
  err = float(np.abs(got - want).max()) if want.size else 0.0
  assert err <= rtol * scale + 1e-6, (what, err, scale)


def embeddings(seed, batch=8, dim=32):
  rng = np.random.RandomState(seed)
  return [rng.normal(size=(batch, dim)).astype(np.float32)
          for _ in range(3)]


T = torch.from_numpy
J = jnp.asarray
MASK = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32)

LOSSES = {
    'l2_arithmetic_loss': lambda m, e: m.l2_arithmetic_loss(*e, MASK),
    'cosine_arithmetic_loss': lambda m, e: m.cosine_arithmetic_loss(
        *e, MASK),
    'cosine_arithmetic_loss_empty_mask': lambda m, e:
        m.cosine_arithmetic_loss(*e, np.zeros(8, np.float32)),
    'send_to_zero_loss': lambda m, e: m.send_to_zero_loss(e[0], MASK),
    'npairs_loss': lambda m, e: m.npairs_loss(
        np.array([0, 1, 2, 0, 3, 1, 4, 5]), e[0], e[1]),
    'npairs_loss_multilabel': lambda m, e: m.npairs_loss_multilabel(
        (np.random.RandomState(1).rand(8, 5) > 0.5).astype(np.float32),
        e[0], e[1]),
    'n_pairs_loss': lambda m, e: m.n_pairs_loss(*e),
    'n_pairs_loss_non_negative': lambda m, e: m.n_pairs_loss(
        *e, non_negativity_constraint=True),
    'n_pairs_loss_multilabel': lambda m, e: m.n_pairs_loss_multilabel(
        *e, np.array([1, 0, 1, 1, 0, 1, 0, 1])),
    'triplet_semihard_loss': lambda m, e: m.triplet_semihard_loss(
        np.array([0, 1, 0, 2, 1, 2, 3, 3]), e[0]),
    'triplet_loss': lambda m, e: m.triplet_loss(*e),
    'match_norms_loss': lambda m, e: m.match_norms_loss(e[0], e[1]),
    'keypoint_accuracy': lambda m, e: m.keypoint_accuracy(
        np.tanh(embeddings(0)[0][:, :2]),
        np.array([0, 1, 2, 3, 0, 1, 2, 3])),
    'get_softmax_response': lambda m, e: m.get_softmax_response(
        e[0][:2, :4], e[1].reshape(2, 4, 8, 4)),
    'ty_loss': lambda m, e: m.ty_loss(e[0].reshape(2, 4, 8, 4),
                                      e[1].reshape(2, 4, 8, 4),
                                      e[2][:2, :4]),
}


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_loss(name):
  """Every loss of ``losses.py`` against JAX's on the same embeddings."""
  e = embeddings(0)
  want = LOSSES[name](jax_losses, [J(x) for x in e])
  got = LOSSES[name](losses, [T(x) for x in e])
  want = want if isinstance(want, tuple) else (want,)
  got = got if isinstance(got, tuple) else (got,)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    close(g, w, what=name)


def test_match_norms_loss_stops_the_anchor_gradient():
  e = embeddings(1)
  anchor, paired = T(e[0]).requires_grad_(), T(e[1]).requires_grad_()
  losses.match_norms_loss(anchor, paired).backward()
  assert anchor.grad is None or float(anchor.grad.abs().max()) == 0.0
  want = jax.grad(lambda p: jax_losses.match_norms_loss(J(e[0]), p))(
      J(e[1]))
  close(paired.grad, want)


def test_summaries():
  """The heatmaps, their softmax and soft argmax, the keypoint images and
  the distance histograms against JAX's."""
  rng = np.random.RandomState(2)
  outputs = {'pre_vector': rng.normal(size=(4, 8)),
             'post_vector': rng.normal(size=(4, 8)),
             'goal_vector': rng.normal(size=(4, 8)),
             'pre_spatial': rng.normal(size=(4, 3, 5, 8))}
  outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
  features = {'pregrasp_image': rng.uniform(size=(4, 12, 12, 3)).astype(
      np.float32)}
  want = jax_vis.grasp2vec_summaries(features, {k: J(v) for k, v in
                                                outputs.items()})
  got = visualization.grasp2vec_summaries(
      {k: T(v) for k, v in features.items()},
      {k: T(v) for k, v in outputs.items()})
  assert set(got) == set(want)
  for key in want:
    close(got[key], want[key], what=key)
  heat = visualization.compute_heatmaps(T(outputs['goal_vector']),
                                        T(outputs['pre_spatial']))
  close(visualization.heatmap_spatial_soft_argmax(heat, 0.5),
        jax_vis.heatmap_spatial_soft_argmax(J(heat.numpy()), 0.5))


def small_model(port=True, **kwargs):
  if port:
    return grasp2vec.Grasp2VecModel(
        scene_size=(56, 56), goal_size=(56, 56), resnet_size=18,
        device='cpu',
        preprocessor_cls=lambda f, l: grasp2vec.Grasp2VecPreprocessor(
            f, l, scene_crop=CROP, goal_crop=CROP, src_img_shape=SRC),
        **kwargs)
  return jax_grasp2vec.Grasp2VecModel(
      scene_size=(56, 56), goal_size=(56, 56), resnet_size=18,
      preprocessor_cls=lambda f, l: jax_grasp2vec.Grasp2VecPreprocessor(
          f, l, scene_crop=CROP, goal_crop=CROP, src_img_shape=SRC),
      **kwargs)


def raw_features(batch, seed=3):
  rng = np.random.RandomState(seed)
  return {key: rng.randint(0, 256, (batch,) + SRC).astype(np.uint8)
          for key in ('pregrasp_image', 'postgrasp_image', 'goal_image')}


def jax_draws(key, batch):
  """The offsets and flips that JAX's TRAIN preprocessor draws from
  ``key`` (grasp2vec_model.py: four subkeys, a shared scene offset, a goal
  offset, two coins an image per example)."""
  rngs = jax.random.split(key, 4)

  def offset(k):
    kh, kw = jax.random.split(k)
    return [int(jax.random.randint(kh, (), CROP[0], max(CROP[1],
                                                        CROP[0] + 1))),
            int(jax.random.randint(kw, (), CROP[3], max(CROP[4],
                                                        CROP[3] + 1)))]

  flips = []
  for idx in range(3):
    klr, kud = jax.random.split(jax.random.fold_in(rngs[2], idx))
    flips.append([np.asarray(jax.random.bernoulli(klr, shape=(batch,))),
                  np.asarray(jax.random.bernoulli(kud, shape=(batch,)))])
  return {'scene_offset': torch.tensor(offset(rngs[0])),
          'goal_offset': torch.tensor(offset(rngs[1])),
          'flips': torch.from_numpy(np.asarray(flips))}


def jax_preprocess(model, features, mode, key):
  """JAX's preprocessor jitted, as its trainer runs it inside the step
  (where XLA turns ``/ 255.0`` into a multiply by its reciprocal)."""
  return jax.jit(lambda f, k: model.preprocessor.preprocess(
      f, None, mode, rng=k)[0])(dict(features), key)


@pytest.mark.parametrize('mode', [ModeKeys.EVAL, ModeKeys.TRAIN])
def test_preprocessor_bit_equal(mode):
  """EVAL's center crops, and TRAIN's crops and flips on JAX's draws,
  bit-equal to JAX's preprocessor; the draws flip some images and not
  others, and the two offsets differ."""
  features = raw_features(8)
  key = jax.random.PRNGKey(5)
  want = jax_preprocess(small_model(False), features, mode,
                        key if mode == ModeKeys.TRAIN else None)
  draws = jax_draws(key, 8) if mode == ModeKeys.TRAIN else None
  got, _ = small_model().preprocessor.preprocess(
      {k: T(v) for k, v in features.items()}, None, mode, draws=draws)
  for name in features:
    assert got[name].dtype == torch.float32
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
  if draws is not None:
    flips = draws['flips'].numpy()
    assert flips.any() and not flips.all()
    assert not torch.equal(draws['scene_offset'], draws['goal_offset'])


def test_preprocessor_draws_from_the_generator():
  """TRAIN without draws takes them from the generator: the same seed,
  the same crops; offsets inside the window; the specs on disk."""
  model = small_model()
  spec = model.preprocessor.get_in_feature_specification(ModeKeys.TRAIN)
  assert spec['pregrasp_image'].shape == SRC
  assert spec['goal_image'].name == 'present_image'
  assert spec['goal_image'].data_format == 'jpeg'
  features = {k: T(v) for k, v in raw_features(4).items()}
  outs = []
  for _ in range(2):
    draws = model.preprocessor.draw(4, torch.Generator().manual_seed(3))
    assert 0 <= int(draws['scene_offset'][0]) < CROP[1]
    assert 0 <= int(draws['goal_offset'][1]) < CROP[4]
    outs.append(model.preprocessor.preprocess(
        features, None, ModeKeys.TRAIN,
        generator=torch.Generator().manual_seed(3))[0])
  for name in features:
    assert torch.equal(outs[0][name], outs[1][name])
  with pytest.raises(ValueError):
    model.preprocessor.preprocess(features, None, ModeKeys.TRAIN)


def test_train_step_against_jax():
  """One TRAIN step of the small model (ResNet-18, 56x56 crops of 64x64
  frames, batch 4): the same preprocessed batch, JAX's initial weights;
  the loss (n-pairs), every gradient and the new running statistics, both
  networks in float64."""
  features = raw_features(4, seed=4)
  key = jax.random.PRNGKey(7)
  jax_model = small_model(False, compute_dtype=np.float64,
                          device_type='cpu')
  pre = jax_preprocess(jax_model, features, JaxModeKeys.TRAIN, key)
  with jax.enable_x64(True):
    variables = jax.jit(jax_model.init_variables, static_argnums=(3,))(
        jax.random.PRNGKey(0), pre, None, JaxModeKeys.TRAIN)
    params = variables.pop('params')

    def loss_fn(p):
      loss, (_, _, new_state) = jax_model.loss_fn(
          p, variables, pre, None, JaxModeKeys.TRAIN, None)
      return loss, new_state

    (want_loss, new_state), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    want_loss = float(want_loss)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    new_state = jax.tree_util.tree_map(np.asarray, new_state)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = jax.tree_util.tree_map(np.asarray, params)

  model = small_model(compute_dtype=torch.float64)
  got_pre, _ = model.preprocessor.preprocess(
      {k: T(v) for k, v in features.items()}, None, ModeKeys.TRAIN,
      draws=jax_draws(key, 4))
  for name in features:
    np.testing.assert_array_equal(got_pre[name].numpy(),
                                  np.asarray(pre[name]))
  state = convert.train_state_from_flax(_JaxState(params, variables))
  loss, outputs, new_model_state, got_grads = model.gradients(
      state, got_pre, None)
  close(loss, want_loss, what='loss')
  assert set(outputs) == {'embed_loss'}
  for name, value in convert.from_flax({'params': grads})['params'].items():
    close(got_grads[name], value.numpy(), what=name)
  for name, value in convert.from_flax(
      {'params': {}, 'batch_stats': new_state['batch_stats']}
  )['params'].items():
    close(new_model_state[name], value.numpy(), 1e-6, name)


class _JaxState:
  """What ``convert.train_state_from_flax`` reads of a JAX TrainState:
  params and batch stats, a fresh adam count, no EMA."""

  def __init__(self, params, variables):
    import optax
    self.step = 0
    self.params = params
    self.model_state = variables
    self.opt_state = optax.adam(1e-4).init(params)
    self.avg_params = None


def write_records(path, count, seed=0):
  """``count`` Grasp2Vec examples at 64x64: three JPEG frames each under
  the on-disk names, by the port's writer."""
  rng = np.random.RandomState(seed)
  spec = small_model().preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)
  with TFRecordReplayWriter() as writer:
    writer.open(str(path))
    for _ in range(count):
      example = {key: image_lib.numpy_to_image_string(
          rng.randint(0, 256, SRC).astype(np.uint8), 'jpeg')
                 for key in spec}
      writer.write_numpy(spec, example)


def test_gin_trains_two_steps_from_records(tmp_path):
  """``train_grasp2vec.gin`` through ``main_gin`` on the CPU, from 16
  records the port wrote, at the small model's size (bindings: ResNet-18,
  56x56 crops of 64x64 frames, through ``@Grasp2VecPreprocessor``):
  2 steps, an eval batch, the default exporters; the exported model's
  embeddings equal the trained state's."""
  write_records(tmp_path / 'g2v.tfrecord', 16)
  bindings = [
      'TRAIN_DATA = "{}"'.format(tmp_path / 'g2v*'),
      'EVAL_DATA = "{}"'.format(tmp_path / 'g2v*'),
      'TRAIN_BATCH_SIZE = 4', 'EVAL_BATCH_SIZE = 4',
      'Grasp2VecModel.scene_size = (56, 56)',
      'Grasp2VecModel.goal_size = (56, 56)',
      'Grasp2VecModel.resnet_size = 18',
      'Grasp2VecModel.preprocessor_cls = @Grasp2VecPreprocessor',
      'Grasp2VecPreprocessor.scene_crop = {}'.format(CROP),
      'Grasp2VecPreprocessor.goal_crop = {}'.format(CROP),
      'Grasp2VecPreprocessor.src_img_shape = {}'.format(SRC),
      'train_eval_model.max_train_steps = 2',
      'train_eval_model.eval_steps = 1',
      'train_eval_model.eval_throttle_steps = 2',
      'train_eval_model.log_every_n_steps = 1']
  argv = ['--device', 'cpu', '--model_dir', str(tmp_path / 'model'),
          '--gin_configs', GIN]
  for binding in bindings:
    argv += ['--gin_bindings', binding]
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main(argv) == 0
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  assert line['step'] == 2 and line['model'] == 'Grasp2VecModel'
  assert np.isfinite(line['metrics']['loss'])
  assert set(line['eval_metrics']) == {'loss', 'embed_loss'}
  from tensor2robot_tpu_torch import config
  from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
      ExportedModelPredictor)
  from tensor2robot_tpu_torch.trainer import checkpointing




  trained = small_model()
  state = checkpointing.CheckpointManager(
      str(tmp_path / 'model')).restore(2, torch.device('cpu'))
  predictor = ExportedModelPredictor(
      str(tmp_path / 'model' / 'export' / 'latest_exporter'), trained,
      timeout=5)
  assert predictor.restore()
  frames = raw_features(2, seed=9)
  got = predictor.predict(frames)
  pre, _ = trained.preprocessor.preprocess(
      {k: T(v) for k, v in frames.items()}, None, ModeKeys.PREDICT)
  want = trained.predict_step(state.variables(), pre)
  for key in ('pre_vector', 'post_vector', 'goal_vector'):
    np.testing.assert_array_equal(np.asarray(got[key]), want[key].numpy())


def test_convert_round_trip_of_the_towers():
  """JAX's Grasp2Vec variables (ResNet-18 towers) into the port's state
  dict, which the port's network takes whole (strict), and back leaf for
  leaf: conv kernels HWIO <-> OIHW, the batch norms' statistics beside
  the parameters."""
  features = raw_features(2)
  jax_model = small_model(False)
  pre = jax_preprocess(jax_model, features, JaxModeKeys.EVAL, None)
  variables = jax.tree_util.tree_map(np.asarray, jax.jit(
      jax_model.init_variables, static_argnums=(3,))(
          jax.random.PRNGKey(2), pre, None, JaxModeKeys.TRAIN))
  state = convert.from_flax(variables)['params']
  network = small_model().network
  assert set(state) == set(network.state_dict())
  torch.func.functional_call(network, state, (
      {k: torch.from_numpy(np.array(v)) for k, v in pre.items()},),
      {'mode': ModeKeys.EVAL}, strict=True)
  for collection in ('params', 'batch_stats'):
    for path, value in jax.tree_util.tree_flatten_with_path(
        variables[collection])[0]:
      keys = [p.key for p in path]
      leaf = 'weight' if keys[-1] == 'kernel' else keys[-1]
      got = state['.'.join(keys[:-1] + [leaf])].numpy()
      if got.ndim == 4:
        got = got.transpose(2, 3, 1, 0)
      np.testing.assert_array_equal(got, value)
  assert any(k.startswith('scene.resnet.block_layer4_1.') for k in state)
  assert any(k.endswith('.mean') for k in state)
