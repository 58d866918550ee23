"""The port's MAML (``meta_learning/``) against the JAX package's, on the
CPU: the inner loop's SGD step, second against first order, learned inner
rates, ``var_scope`` in JAX's path form, ``MAMLRegressionModel``'s
predictions, loss, outer gradients and batch norm statistics against
JAX's on a base model with a batch norm, the meta layout's specs and
generators, and meta-example records written and read.

Tolerances. The linear model's analytic values within 1e-5 (JAX's own
test's). Against JAX, ``MAMLRegressionModel`` in float64 on both sides
(its test says why), the base loss float32 on both as JAX casts it:
predictions, losses and the new statistics within 1e-5 of each value's
magnitude, every outer gradient within 1e-5 of its tensor's largest.
"""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.layers.basic import BatchNorm, Dense
from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.meta_learning import meta_example
from tensor2robot_tpu_torch.meta_learning import preprocessors
from tensor2robot_tpu_torch.meta_learning.maml_inner_loop import (
    MAMLInnerLoopGradientDescent, flax_path)
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    MAMLRegressionModel)
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

RTOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(scope='module')
def ref():
  """The JAX package's meta-learning modules (their import reaches the
  qtopt modules, through the shim), and its side of the batch-norm base
  model."""
  for modules in jax_qtopt_fixture(
      'meta_learning', 'meta_learning.meta_data',
      'meta_learning.meta_example', 'models.regression_model',
      'specs.struct', 'specs.tensor_spec'):
    struct, spec = modules.struct.SpecStruct, modules.tensor_spec.TensorSpec

    class JaxBNNet(jnn.Module):

      @jnn.compact
      def __call__(self, features, mode='train', train=False):
        h = jnn.Dense(8, name='hidden')(features['x'])
        h = jnn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, name='bn')(h)
        h = jnn.relu(h)
        return {'inference_output': jnn.Dense(2, name='head')(h),
                'hidden': h}

    class JaxBNModel(modules.regression_model.RegressionModel):

      def __init__(self, **kwargs):
        kwargs.setdefault('device_type', 'cpu')
        super().__init__(**kwargs)

      def get_feature_specification(self, mode):
        return struct(x=spec((3,), np.float32, name='x'))

      def get_label_specification(self, mode):
        return struct(target=spec((2,), np.float32, name='target'))

      def create_network(self):
        return JaxBNNet()

    modules.BNModel = JaxBNModel
    yield modules


def close(got, want, rtol=RTOL, what=''):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  assert float(np.abs(got - want).max()) <= rtol * scale + 1e-6, (
      what, float(np.abs(got - want).max()), scale)


# -- the linear model of JAX's own inner-loop tests -------------------------

class _LinearNet(nn.Module):

  def __init__(self):
    super().__init__()
    self.linear = Dense(1, 1, bias=False)

  def forward(self, features, mode=ModeKeys.PREDICT):
    return {'inference_output': self.linear(features['x'])}


class _LinearRegressionModel(RegressionModel):
  """y = w x."""

  def __init__(self, **kwargs):
    super().__init__(device='cpu', **kwargs)

  def get_feature_specification(self, mode):
    return {'x': TensorSpec((1,), np.float32, name='x')}

  def get_label_specification(self, mode):
    return {'target': TensorSpec((1,), np.float32, name='target')}

  def create_network(self):
    return _LinearNet()


def _linear_run(w0, x, y, lr, steps=1, w_grad=False, **kwargs):
  model = _LinearRegressionModel()
  inner = MAMLInnerLoopGradientDescent(learning_rate=lr, **kwargs)
  features = {'x': torch.tensor([[x]])}
  labels = {'target': torch.tensor([[y]])}
  w = torch.tensor([[w0]], requires_grad=w_grad)
  network = model.network
  forward = lambda state, f: torch.func.functional_call(
      network, state, (f,), {'mode': ModeKeys.TRAIN})
  loss = lambda state, f, l, o: model.model_train_fn(state, f, l, o,
                                                     ModeKeys.TRAIN)
  out = inner.inner_loop({'linear.weight': w}, {},
                         [(features, labels)] * steps + [(features, labels)],
                         forward, loss)
  return out, w


def test_inner_loop_sgd_step():
  """loss = (w x - y)^2: w0 = 1, x = 2, y = 0 gives w1 = 1 - 0.1 * 8."""
  ((uncond, cond), inner_outputs, inner_losses), _ = _linear_run(
      1.0, 2.0, 0.0, 0.1)
  close(uncond['inference_output'], [[2.0]])
  close(cond['inference_output'], [[0.4]])
  assert len(inner_outputs) == 2 and len(inner_losses) == 2
  close(inner_losses[0], 4.0)
  close(inner_losses[1], 0.16)


@pytest.mark.parametrize('second_order,want', [(True, 0.32), (False, 1.6)])
def test_second_against_first_order(second_order, want):
  """The outer gradient of (w1 x)^2 through one inner step: w1 = 0.2 w0,
  so 2 0.2^2 x^2 w0 = 0.32 in second order, 2 w1 x^2 = 1.6 in first
  order (JAX's test_second_vs_first_order_gradients)."""
  ((_, cond), _, _), w = _linear_run(1.0, 2.0, 0.0, 0.1, w_grad=True,
                                     use_second_order=second_order)
  (cond['inference_output'] ** 2).mean().backward()
  close(w.grad, [[want]])


def test_var_scope_in_jax_path_form():
  """``var_scope`` matches JAX's '/'-joined flax path, a ``weight`` read
  as ``kernel``: a scope that names nothing adapts nothing."""
  assert flax_path('pose_net.Dense_0.weight') == 'pose_net/Dense_0/kernel'
  assert flax_path('state_features.norm2.bias') == 'state_features/norm2/bias'
  inner = MAMLInnerLoopGradientDescent(var_scope='pose_net/Dense_0/kernel')
  assert inner.adapts('pose_net.Dense_0.weight')
  assert not inner.adapts('pose_net.Dense_0.bias')
  assert not inner.adapts('state_features.conv2.weight')
  ((_, cond), _, _), _ = _linear_run(1.0, 2.0, 0.0, 0.1,
                                     var_scope='some_other_scope')
  close(cond['inference_output'], [[2.0]])
  ((_, cond), _, _), _ = _linear_run(1.0, 2.0, 0.0, 0.1, var_scope='linear')
  close(cond['inference_output'], [[0.4]])


def test_learned_inner_lr_structure():
  inner = MAMLInnerLoopGradientDescent(learning_rate=0.05,
                                       learn_inner_lr=True)
  lrs = inner.create_inner_lr_params({'linear.weight': torch.ones(1, 1)})
  close(lrs['linear.weight'], 0.05)


def test_meta_data():
  struct = {'a': np.arange(24).reshape(2, 3, 4)}
  flat = meta_data.flatten_batch_examples(struct)
  assert flat['a'].shape == (6, 4)
  np.testing.assert_array_equal(
      meta_data.unflatten_batch_examples(flat, 3)['a'], struct['a'])
  out = meta_data.multi_batch_apply(lambda x: x * 2, 2, torch.ones(2, 3, 4))
  assert out.shape == (2, 3, 4)


# -- a base model with a batch norm, on both sides --------------------------

class _BNNet(nn.Module):

  def __init__(self):
    super().__init__()
    self.hidden = Dense(3, 8)
    self.bn = BatchNorm(8, epsilon=1e-5, momentum=0.9)
    self.head = Dense(8, 2)

  def forward(self, features, mode=ModeKeys.PREDICT):
    h = F.relu(self.bn(self.hidden(features['x']), mode == ModeKeys.TRAIN))
    return {'inference_output': self.head(h), 'hidden': h}


class _BNModel(RegressionModel):

  def __init__(self, **kwargs):
    super().__init__(device='cpu', **kwargs)

  def get_feature_specification(self, mode):
    return {'x': TensorSpec((3,), np.float32, name='x')}

  def get_label_specification(self, mode):
    return {'target': TensorSpec((2,), np.float32, name='target')}

  def create_network(self):
    return _BNNet()


def _meta_batch(num_tasks=4, seed=0):
  rng = np.random.RandomState(seed)
  draw = lambda *shape: rng.normal(size=shape).astype(np.float32)
  features = {'condition/features/x': draw(num_tasks, 3, 3),
              'condition/labels/target': draw(num_tasks, 3, 2),
              'inference/features/x': draw(num_tasks, 2, 3)}
  return features, {'target': draw(num_tasks, 2, 2)}


def _port_state(model, variables):
  """The port's TrainState of a JAX ``{'params', 'batch_stats'}``."""
  state = convert.from_flax(jax.tree_util.tree_map(np.asarray,
                                                   variables))['params']
  names = {name for name, _ in model.network.named_parameters()}
  params = {k: v for k, v in state.items() if k in names}
  return TrainState(step=0, params=params,
                    model_state={k: v for k, v in state.items()
                                 if k not in names},
                    opt_state=model.create_optimizer().init(params))


@pytest.mark.parametrize('second_order', [True, False])
@pytest.mark.parametrize('learn_inner_lr', [False, True])
def test_maml_regression_model_against_jax(ref, second_order,
                                           learn_inner_lr):
  """4 tasks of 3 condition and 2 inference samples, 2 inner steps, a
  batch norm in the base model (so TRAIN's new statistics are the tasks'
  mean): every prediction, the loss and its outputs, every outer gradient
  (the learned rates' included) and the new statistics, against JAX's
  vmapped MAML; and EVAL's predictions. In float64 on both sides (the
  base loss casts to float32 on both, as JAX's does): TRAIN's batch norm
  over a task's 2 inference samples divides by their spread, which turns
  float32 roundings of the adapted weights into 1e-4 of the outputs."""
  features, labels = _meta_batch()
  inner_kwargs = dict(learning_rate=0.05, use_second_order=second_order,
                      learn_inner_lr=learn_inner_lr)
  f64 = lambda tree: jax.tree_util.tree_map(
      lambda a: jnp.asarray(a, jnp.float64), tree)
  numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  with jax.enable_x64(True):
    jax_model = ref.meta_learning.MAMLRegressionModel(
        base_model=ref.BNModel(), num_inner_loop_steps=2,
        inner_loop=ref.meta_learning.MAMLInnerLoopGradientDescent(
            **inner_kwargs))
    jax_features = ref.struct.SpecStruct(**f64(features))
    jax_labels = ref.struct.SpecStruct(**f64(labels))
    variables = jax_model.init_variables(jax.random.PRNGKey(0), jax_features,
                                         jax_labels, 'train')
    # Running statistics away from flax's 0 and 1.
    variables['batch_stats'] = {'bn': {
        'mean': np.linspace(-0.5, 0.5, 8).astype(np.float32),
        'var': np.linspace(0.5, 1.5, 8).astype(np.float32)}}
    variables = numpy(variables)
    params = variables.pop('params')
    (want_loss, (want_out, want_pred, want_state)), want_grads = (
        jax.value_and_grad(jax_model.loss_fn, has_aux=True)(
            f64(params), f64(variables), jax_features, jax_labels, 'train',
            None))
    want_eval, _ = jax_model.inference_network_fn(
        f64({'params': params, **variables}), jax_features, None, 'eval')
    want_loss, want_out, want_pred, want_state, want_grads, want_eval = (
        numpy((want_loss, dict(want_out), dict(want_pred), want_state,
               want_grads, dict(want_eval))))

  model = MAMLRegressionModel(
      base_model=_BNModel(compute_dtype=torch.float64),
      num_inner_loop_steps=2,
      inner_loop=MAMLInnerLoopGradientDescent(**inner_kwargs))
  state = _port_state(model, {'params': params, **variables})
  if learn_inner_lr:
    assert {k for k in state.params if k.startswith('maml_inner_lrs.')} == {
        'maml_inner_lrs.hidden.weight', 'maml_inner_lrs.hidden.bias',
        'maml_inner_lrs.bn.scale', 'maml_inner_lrs.bn.bias',
        'maml_inner_lrs.head.weight', 'maml_inner_lrs.head.bias'}
  torch_features = {k: torch.from_numpy(v).double()
                    for k, v in features.items()}
  torch_labels = {k: torch.from_numpy(v).double() for k, v in labels.items()}
  params_in = {k: v.double().requires_grad_()
               for k, v in state.params.items()}
  model_state = {k: v.double() for k, v in state.model_state.items()}
  loss, (train_outputs, predictions, new_state) = model.loss_fn(
      params_in, model_state, torch_features, torch_labels, ModeKeys.TRAIN)
  grads = dict(zip(params_in, torch.autograd.grad(
      loss, list(params_in.values()), allow_unused=True)))
  close(loss, want_loss, what='loss')
  assert set(predictions) == set(want_pred)
  for key in want_pred:
    close(predictions[key], want_pred[key], what=key)
  assert set(train_outputs) == set(want_out)
  for key in want_out:
    close(train_outputs[key], want_out[key], what=key)
  want_grads = convert.from_flax({'params': want_grads})['params']
  assert set(want_grads) == set(grads)
  for name, value in want_grads.items():
    got = grads[name] if grads[name] is not None else torch.zeros_like(value)
    close(got, value.numpy(), GRAD_RTOL, name)
  for name in ('bn.mean', 'bn.var'):
    close(new_state[name], want_state['batch_stats']['bn'][name[3:]],
          what=name)
  # EVAL adapts too, without changing the statistics.
  got_eval = model.inference_network_fn(
      {'params': {**params_in, **model_state}}, torch_features,
      ModeKeys.EVAL)
  for key in ('inference_output', 'condition_output',
              'inner_losses/step_1'):
    close(got_eval[key], want_eval[key], what=key)


def test_maml_specs_and_random_generator(ref):
  """The meta layout's specs (names and the unknown samples dim) and
  MAMLRandomInputGenerator's batches, array for array JAX's."""
  model = MAMLRegressionModel(base_model=_BNModel())
  spec = model.get_feature_specification(ModeKeys.TRAIN)
  assert list(spec) == ['condition/features/x', 'condition/labels/target',
                        'inference/features/x']
  assert spec['condition/features/x'].shape == (None, 3)
  assert spec['condition/labels/target'].name == 'condition_labels/target'
  label_spec = model.get_label_specification(ModeKeys.TRAIN)
  assert label_spec['target'].name == 'meta_labels/target'
  generator = meta_data.MAMLRandomInputGenerator(
      num_tasks=3, num_condition_samples_per_task=2,
      num_inference_samples_per_task=1)
  generator.set_specification_from_model(model, ModeKeys.TRAIN)
  got = next(iter(generator.create_dataset_iterator(ModeKeys.TRAIN, seed=4,
                                                    prefetch=0)))
  jax_model = ref.meta_learning.MAMLRegressionModel(base_model=ref.BNModel())
  jax_generator = ref.meta_data.MAMLRandomInputGenerator(
      num_tasks=3, num_condition_samples_per_task=2,
      num_inference_samples_per_task=1)
  jax_generator.set_specification_from_model(jax_model, 'train')
  want = next(iter(jax_generator.create_dataset_iterator('train', seed=4)))
  for got_part, want_part in zip(got, want):
    assert set(got_part) == set(want_part)
    for key in want_part:
      np.testing.assert_array_equal(got_part[key], np.asarray(want_part[key]))
  features, labels = model.preprocessor.preprocess(
      {k: torch.from_numpy(v) for k, v in got[0].items()},
      {k: torch.from_numpy(v) for k, v in got[1].items()}, ModeKeys.TRAIN)
  assert features['condition/features/x'].shape == (3, 2, 3)
  assert labels['target'].shape == (3, 1, 2)
  fixed = preprocessors.FixedLenMetaExamplePreprocessor(
      model.base_model.preprocessor, 2, 1)
  assert fixed.get_in_feature_specification('train')[
      'inference/features/x'].shape == (1, 3)


def _episode(rng):
  return wire.build_example({'x': rng.normal(size=3).astype(np.float32),
                             'target': rng.normal(size=2).astype(np.float32)})


def test_meta_example_round_trip(ref, tmp_path):
  """Records of 2 condition and 1 inference episodes a task: the port's
  ``make_meta_example`` bytes equal JAX's, and the port's reader gives
  JAX's reader's batches on them."""
  rng = np.random.RandomState(6)
  path = str(tmp_path / 'meta.tfrecord')
  with TFRecordReplayWriter() as writer:
    writer.open(path)
    for _ in range(4):
      condition = [_episode(rng) for _ in range(2)]
      inference = [_episode(rng)]
      record = meta_example.make_meta_example(condition, inference)
      assert record == ref.meta_example.make_meta_example(condition,
                                                          inference)
      writer.write(record)
  model = MAMLRegressionModel(base_model=_BNModel())
  generator = meta_example.MetaExampleInputGenerator(
      path, num_condition_samples_per_task=2,
      num_inference_samples_per_task=1, num_tasks=2, shuffle=False)
  generator.set_specification_from_model(model, ModeKeys.TRAIN)
  got = list(generator.create_dataset_iterator(ModeKeys.TRAIN, num_epochs=1,
                                               seed=0, prefetch=0))
  jax_model = ref.meta_learning.MAMLRegressionModel(base_model=ref.BNModel())
  jax_generator = ref.meta_example.MetaExampleInputGenerator(
      path, num_condition_samples_per_task=2,
      num_inference_samples_per_task=1, num_tasks=2, shuffle=False)
  jax_generator.set_specification_from_model(jax_model, 'train')
  want = list(jax_generator.create_dataset_iterator('train', num_epochs=1,
                                                    seed=0))
  assert len(got) == len(want) == 2
  for (gf, gl), (wf, wl) in zip(got, want):
    for key in wf:
      np.testing.assert_array_equal(gf[key], np.asarray(wf[key]))
    for key in wl:
      np.testing.assert_array_equal(gl[key], np.asarray(wl[key]))
  assert got[0][0]['condition/features/x'].shape == (2, 2, 3)


def test_convert_round_trip_of_learned_rates(ref):
  """JAX's ``{'base', 'maml_inner_lrs'}`` params and adam moments into
  the port's names and back, leaf for leaf."""
  jax_model = ref.meta_learning.MAMLRegressionModel(
      base_model=ref.BNModel(),
      inner_loop=ref.meta_learning.MAMLInnerLoopGradientDescent(learn_inner_lr=True))
  features, labels = _meta_batch()
  variables = jax_model.init_variables(
      jax.random.PRNGKey(1),
      ref.struct.SpecStruct(**{k: jnp.asarray(v) for k, v in features.items()}),
      ref.struct.SpecStruct(**{k: jnp.asarray(v) for k, v in labels.items()}), 'train')
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  assert set(params) == {'base', 'maml_inner_lrs'}

  class JaxState:
    step = 3
    model_state = {'batch_stats': jax.tree_util.tree_map(
        np.asarray, variables['batch_stats'])}
    opt_state = jax.tree_util.tree_map(np.asarray,
                                       optax.adam(1e-3).init(params))
    avg_params = None

  JaxState.params = params
  state = convert.train_state_from_flax(JaxState)
  model = MAMLRegressionModel(
      base_model=_BNModel(),
      inner_loop=MAMLInnerLoopGradientDescent(learn_inner_lr=True))
  names = {n for n, _ in model.network.named_parameters()}
  assert set(state.params) == names
  assert set(state.model_state) == {'bn.mean', 'bn.var'}
  assert set(state.opt_state['mu']) == names
  for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
    keys = [p.key for p in path]
    if keys[0] == 'base':
      keys = keys[1:]
    leaf = 'weight' if keys[-1] == 'kernel' else keys[-1]
    got = state.params['.'.join(keys[:-1] + [leaf])].numpy()
    if got.ndim == 2:
      got = got.T
    np.testing.assert_array_equal(got, value)


class _StubPredictor:
  """A predictor that records its features and answers with the pack's
  candidate count of q values."""

  def __init__(self):
    self.calls = []

  def predict(self, features):
    self.calls.append(features)
    count = features['n']
    q = np.arange(count, dtype=np.float32)[:, None, None]
    return {'inference_output': q, 'condition_output': q + 100.0}


def test_maml_cem_policy_zeroes_values_until_adapted():
  """Before ``adapt`` the CEM values are zeroed (the unadapted critic
  ranks nothing, JAX's MAMLCEMPolicy) and read from ``condition_output``;
  after it, from ``inference_output``; ``reset_task`` forgets the
  episodes."""
  from tensor2robot_tpu_torch.meta_learning import MAMLCEMPolicy

  predictor = _StubPredictor()
  policy = MAMLCEMPolicy(
      t2r_model=None, action_size=2, cem_iters=1, cem_samples=8,
      num_elites=2, predictor=predictor,
      pack_fn=lambda model, state, episodes, timestep, samples: {
          'n': len(samples), 'episodes': episodes})
  np.random.seed(0)
  _, debug = policy._select_action_with_debug(np.zeros(3), None, 0)
  assert debug['q_predicted'] == 0.0
  assert predictor.calls[-1]['episodes'] is None
  policy.adapt([['demo']])
  _, debug = policy._select_action_with_debug(np.zeros(3), None, 0)
  assert debug['q_predicted'] == 7.0
  policy.reset_task()
  assert policy._prev_episode_data is None
