"""The port's optimizers, learning rates and legacy optimizer builder
against optax, on the CPU.

Each optimizer takes three updates on the same parameters and gradients
as its optax counterpart (the same float32 arithmetic written out; XLA's
rsqrt and pow may round a last bit differently from torch's): parameters
and every moment within 1e-6 relative (plus 1e-7 of the tensor's scale).
Schedules are read at int32 counts on the device: within 1e-6 relative
(XLA's float32 ``pow`` is not correctly rounded).
"""

import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.models import optimizers as jax_optimizers
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.research.qtopt import optimizer_builder
# The JAX qtopt package's import shim (a module fixture).
from test_torch_qtopt import ref  # noqa: F401


def _tree(seed):
  rng = np.random.RandomState(seed)
  return {'a': rng.randn(3, 4).astype(np.float32),
          'b': rng.randn(5).astype(np.float32)}


def _torch(tree):
  return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, name=''):
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                             atol=1e-7 * max(1.0, float(np.abs(want).max())),
                             err_msg=name)


def _moments(opt_state):
  """optax's moment trees by name (trace, mu, nu) in a chained state."""
  out = {}

  def walk(node):
    for name in ('trace', 'mu', 'nu'):
      if name in getattr(node, '_fields', ()):
        out[name] = getattr(node, name)
    if isinstance(node, tuple):
      for item in node:
        walk(item)

  walk(opt_state)
  return out


def _three_updates(want_opt, got_opt):
  params = _tree(0)
  p = _torch(params)
  want_state, got_state = want_opt.init(params), got_opt.init(p)
  for i in range(3):
    grads = _tree(i + 1)
    updates, want_state = want_opt.update(grads, want_state, params)
    params = optax.apply_updates(params, updates)
    p, got_state = got_opt.update(_torch(grads), got_state, p)
    assert int(got_state['count']) == i + 1
    assert got_state['count'].dtype == torch.int32
    for key in params:
      _close(p[key], params[key], key)
    for name, tree in _moments(want_state).items():
      for key in params:
        _close(got_state[name][key], tree[key], name + '/' + key)


SCHEDULES = {
    'constant': (optax.constant_schedule(0.1),
                 optimizers.create_constant_learning_rate(0.1)),
    'exponential, stairs': (
        optax.exponential_decay(0.1, 2, 0.5, staircase=True),
        optimizers.create_exponential_decay_learning_rate(0.1, 2, 0.5, True)),
    'exponential, smooth': (
        optax.exponential_decay(0.1, 2, 0.5, staircase=False),
        optimizers.create_exponential_decay_learning_rate(0.1, 2, 0.5,
                                                          False)),
}


@pytest.mark.parametrize('name', ['sgd', 'momentum', 'nesterov',
                                  'rmsprop with momentum', 'rmsprop',
                                  'adam'])
@pytest.mark.parametrize('rate', ['float', 'exponential, smooth'])
def test_three_updates_match_optax(name, rate):
  want_lr, got_lr = ((0.1, 0.1) if rate == 'float' else SCHEDULES[rate])
  want, got = {
      'sgd': (lambda: jax_optimizers.create_sgd_optimizer(want_lr),
              lambda: optimizers.create_sgd_optimizer(got_lr)),
      'momentum': (
          lambda: jax_optimizers.create_momentum_optimizer(want_lr, 0.9),
          lambda: optimizers.create_momentum_optimizer(got_lr, 0.9)),
      'nesterov': (
          lambda: jax_optimizers.create_momentum_optimizer(want_lr, 0.9,
                                                           True),
          lambda: optimizers.create_momentum_optimizer(got_lr, 0.9, True)),
      'rmsprop with momentum': (
          lambda: jax_optimizers.create_rms_prop_optimizer(
              want_lr, 0.9, momentum=0.8, epsilon=1e-3),
          lambda: optimizers.create_rms_prop_optimizer(
              got_lr, 0.9, momentum=0.8, epsilon=1e-3)),
      'rmsprop': (lambda: jax_optimizers.create_rms_prop_optimizer(want_lr),
                  lambda: optimizers.create_rms_prop_optimizer(got_lr)),
      'adam': (lambda: jax_optimizers.create_adam_optimizer(want_lr),
               lambda: optimizers.create_adam_optimizer(got_lr)),
  }[name]
  _three_updates(want(), got())


@pytest.mark.parametrize('name', sorted(SCHEDULES) + ['piecewise'])
def test_schedules_match_optax(name):
  if name == 'piecewise':
    want = jax_optimizers.piecewise_constant_learning_rate(
        [3, 7], [0.1, 0.03, 0.007])
    got = optimizers.piecewise_constant_learning_rate([3, 7],
                                                      [0.1, 0.03, 0.007])
  else:
    want, got = SCHEDULES[name]
  for count in (0, 1, 2, 3, 4, 6, 7, 8, 17):
    value = got(torch.tensor(count, dtype=torch.int32))
    assert value.dtype == torch.float32 and value.dim() == 0
    assert float(value) == pytest.approx(float(want(count)), rel=1e-6), count


@pytest.mark.parametrize('optimizer', ['momentum', 'rmsprop', 'adam'])
def test_build_opt_branches_match_the_jax_builder(ref, optimizer):
  """The legacy hparams' three branches: momentum, rmsprop (its decay,
  epsilon and the momentum on the scaled step) and the adam fallback
  (b1 = momentum, adam_beta2, adam_epsilon), each on the staircase decay
  (steps of 2 updates here)."""
  hparams = dict(optimizer=optimizer, examples_per_epoch=8, batch_size=2,
                 num_epochs_per_decay=0.5, learning_rate=0.05,
                 learning_rate_decay_factor=0.5, momentum=0.7,
                 rmsprop_decay=0.8, rmsprop_epsilon=0.5, adam_beta2=0.99,
                 adam_epsilon=1e-6)
  jax_builder = ref.t2r_models.optimizer_builder
  want = jax_builder.build_opt(jax_builder.default_hparams(**hparams))
  got = optimizer_builder.build_opt(
      optimizer_builder.default_hparams(**hparams))
  assert type(got).__name__ == {'momentum': 'Momentum', 'rmsprop': 'RMSProp',
                                'adam': 'Adam'}[optimizer]
  _three_updates(want, got)


@pytest.mark.parametrize('name', ['sgd', 'rmsprop', 'momentum', 'adam'])
def test_converted_optax_states_go_on_as_optax(name):
  """``convert.train_state_from_flax`` carries each optimizer's state
  (sgd's count alone, rmsprop's trace and nu): two optax updates, the
  state converted, and a third update on each side agree."""
  import types

  from tensor2robot_tpu_torch import convert

  # On a schedule, as the legacy optimizers are: optax keeps an update
  # count only then (or inside adam).
  lr, rate = (optax.constant_schedule(0.1),
              optimizers.create_constant_learning_rate(0.1))
  want_opt, got_opt = {
      'sgd': (optax.sgd(lr), optimizers.create_sgd_optimizer(rate)),
      'rmsprop': (jax_optimizers.create_rms_prop_optimizer(lr, 0.9, 0.5),
                  optimizers.create_rms_prop_optimizer(rate, 0.9, 0.5)),
      'momentum': (optax.sgd(lr, 0.9), optimizers.create_momentum_optimizer(
          rate, 0.9)),
      'adam': (optax.adam(lr), optimizers.create_adam_optimizer(rate)),
  }[name]
  params = {'layer': _tree(0)}
  state = want_opt.init(params)
  for i in range(2):
    updates, state = want_opt.update({'layer': _tree(i + 1)}, state, params)
    params = optax.apply_updates(params, updates)
  jax_state = types.SimpleNamespace(step=2, params=params, model_state={},
                                    opt_state=state, avg_params=None)
  port = convert.train_state_from_flax(jax_state)
  assert int(port.opt_state['count']) == 2
  updates, _ = want_opt.update({'layer': _tree(3)}, state, params)
  want = optax.apply_updates(params, updates)['layer']
  got, _ = got_opt.update({'layer.' + k: v for k, v in _torch(
      _tree(3)).items()}, port.opt_state, port.params)
  for key in want:
    _close(got['layer.' + key], want[key], key)
