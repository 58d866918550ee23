"""The port's training slice against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, and the same weights,
converted with ``convert``, go through both packages.

Tolerances, each with its reason:

  * the pool backward (K2b's plain version) routes dy values: exact, in
    float32 and bfloat16, against ``pooling._max_pool_bwd`` and the Pallas
    kernel in interpret mode;
  * the 5x5 weight gradient (K3's plain version) sums B*H*W products per
    output in float32 in another order than the Pallas kernel: within 1e-5
    of max|want|;
  * the train-mode network and three train steps: XLA and PyTorch's CPU
    convolutions and matrix products sum in different orders, a few
    float32 ulps per layer, and the backward pass doubles the depth; the
    loss within 1e-5, gradients, parameter updates and momentum traces
    within 1e-4 of each tensor's largest magnitude (and rtol 1e-4), batch
    norm statistics within 1e-5. A gradient that is 0 in exact arithmetic
    (the bias of a dense layer in front of a batch norm) is rounding noise
    of some 1e-8 on both sides, hence an absolute floor of 1e-6;
  * the debiased EMA ``avg_params = ema / (1 - 0.9999 ** count)``: XLA's
    float32 ``pow`` is not correctly rounded (0.9999 ** 3 is 0.99969995
    there and 0.9997 in PyTorch), and one ulp of it (6e-8) is 6e-4 / count
    of the divisor, so ``avg_params`` agree within 1e-3 relative, while the
    un-debiased ``ema`` is held to the tolerance of the parameters;
  * the TRAIN crop + ``/ 255`` at JAX's offsets: exact (both multiply by
    the float32 reciprocal);
  * the random input batches: exact.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.layers import pooling
from tensor2robot_tpu_torch.layers import wgrad
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.research.qtopt import optimizer_builder
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval

from tensor2robot_tpu.layers import pallas_pooling
from tensor2robot_tpu.layers import pallas_wgrad
from tensor2robot_tpu.layers import pooling as jax_pooling

NUM_CONVS = (2, 2, 1)
SIZE = 96

# The geometries of tests/test_layers.py TestPallasMaxPool.
PALLAS_CASES = [
    ((2, 35, 35, 8), (3, 3), 'SAME'),
    ((1, 27, 27, 8), (2, 2), 'SAME'),
    ((2, 24, 24, 8), (2, 2), 'VALID'),
    ((1, 29, 31, 8), (3, 3), 'VALID'),
    ((1, 30, 30, 8), (3, 3), 'SAME'),
]
# Low padding, outside the Pallas kernel's gate: the served 79 -> 27 pool
# and a 2/2 pool with one padded column.
LOW_PAD_CASES = [
    ((2, 79, 79, 4), (3, 3), 'SAME'),
    ((2, 25, 25, 8), (3, 3), 'SAME'),
    ((3, 13, 9, 5), (2, 2), 'SAME'),
]
# The critic's stem pool, 236 -> 79: one padded row and column, both high.
STEM_CASES = [((1, 236, 236, 8), (3, 3), 'SAME')]


@pytest.fixture(scope='module')
def ref():
  """The JAX package's qtopt modules (see tests/test_torch_qtopt.py: jax
  0.9's batching proxy gets an ``in`` for the import only)."""
  from jax._src.interpreters import batching

  proxy = batching.PrimitiveBatchersProxy
  shimmed = not hasattr(proxy, '__contains__')
  if shimmed:
    proxy.__contains__ = (
        lambda self, prim: prim in batching.fancy_primitive_batchers)
  try:
    from tensor2robot_tpu.data import input_generators as jax_inputs
    from tensor2robot_tpu.research.qtopt import t2r_models as jax_t2r
  finally:
    if shimmed:
      del proxy.__contains__
  yield types.SimpleNamespace(t2r_models=jax_t2r, inputs=jax_inputs)
  if shimmed:
    for name in [n for n in sys.modules
                 if n.startswith('tensor2robot_tpu.research.qtopt')]:
      del sys.modules[name]
    research = sys.modules.get('tensor2robot_tpu.research')
    if research is not None:
      vars(research).pop('qtopt', None)


def _draw(tree, rng):
  """Random values at fan-in scale for a flax params/batch_stats tree."""
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      out[key] = _draw(value, rng)
      continue
    shape = np.shape(value)
    if key == 'kernel':
      draw = rng.randn(*shape) * np.sqrt(2.0 / int(np.prod(shape[:-1])))
    elif key == 'var':
      draw = rng.uniform(0.5, 1.5, shape)
    elif key == 'scale':
      draw = 1.0 + 0.1 * rng.randn(*shape)
    else:  # bias, mean
      draw = 0.1 * rng.randn(*shape)
    out[key] = draw.astype(np.float32)
  return out


def _close(got, want, rtol=1e-4, scale_atol=1e-4, name='', floor=0.0):
  got = got.detach().to(torch.float32).numpy() if isinstance(
      got, torch.Tensor) else np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  atol = max(scale_atol * float(np.abs(want).max()), floor)
  np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _batch(rng, batch, size=SIZE):
  features = {'state/image': rng.uniform(0, 1, (batch, size, size, 3))
                             .astype(np.float32)}
  for key, width in (t2r_models.ACTION_DIM_LAYOUT +
                     (('gripper_closed', 1), ('height_to_bottom', 1))):
    features['action/' + key] = rng.randn(batch, width).astype(np.float32)
  labels = {'reward': rng.randint(0, 2, (batch, 1)).astype(np.float32)}
  return features, labels


def _torch(tree):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _models(ref, **kwargs):
  jax_model = ref.t2r_models.\
      Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device_type='cpu', network_kwargs={'num_convs': NUM_CONVS},
          **kwargs)
  port = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': NUM_CONVS,
                                    'image_size': SIZE}, **kwargs)
  return jax_model, port


def _flax_variables(jax_model, features, seed):
  shapes = jax.tree_util.tree_map(np.asarray, jax_model.create_network().init(
      jax.random.PRNGKey(0), features, mode=ModeKeys.TRAIN, train=True))
  rng = np.random.RandomState(seed)
  return _draw(shapes['params'], rng), _draw(shapes['batch_stats'], rng)


# -- K2b: the pool backward ---------------------------------------------------

def _port_pool_grad(x, dy, window, padding, dtype):
  xt = torch.from_numpy(x).to(dtype).requires_grad_()
  out = pooling.max_pool(xt, window, window, padding)
  out.backward(torch.from_numpy(dy).to(dtype))
  return xt.grad


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,window,padding',
                         PALLAS_CASES + LOW_PAD_CASES + STEM_CASES)
def test_max_pool_backward_matches_jax_index_path(shape, window, padding,
                                                  dtype):
  rng = np.random.RandomState(0)
  x = rng.randn(*shape).astype(np.float32)
  xj = jnp.asarray(x, dtype)
  out, vjp = jax.vjp(
      lambda v: jax_pooling._max_pool_nonoverlap(v, window, padding), xj)
  dy = rng.randn(*out.shape).astype(np.float32)
  (want,) = vjp(jnp.asarray(dy, dtype))
  got = _port_pool_grad(x, dy, window, padding, getattr(torch, dtype))
  assert got.dtype == getattr(torch, dtype)
  np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                np.asarray(want, np.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,window,padding', PALLAS_CASES)
def test_max_pool_backward_matches_pallas_interpret(shape, window, padding,
                                                    dtype):
  rng = np.random.RandomState(1)
  x = rng.randn(*shape).astype(np.float32)
  xj = jnp.asarray(x, dtype)
  out, vjp = jax.vjp(
      lambda v: pallas_pooling.max_pool_pallas(v, window, padding, True), xj)
  dy = rng.randn(*out.shape).astype(np.float32)
  (want,) = vjp(jnp.asarray(dy, dtype))
  got = _port_pool_grad(x, dy, window, padding, getattr(torch, dtype))
  np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                np.asarray(want, np.float32))
  # The plain version on the forward's index is the autograd node's.
  xt = torch.from_numpy(x).to(getattr(torch, dtype))
  _, idx = pooling.max_pool_forward(xt, window, window, padding, True)
  direct = pooling.max_pool_backward_plain(
      torch.from_numpy(dy).to(xt.dtype), idx, shape, window, padding)
  assert torch.equal(direct, got)


def test_differentiable_pool_launches_nothing_on_the_cpu():
  kernels.reset_launches()
  x = torch.randn(2, 9, 9, 4, requires_grad=True)
  pooling.max_pool(x, (3, 3), (3, 3), 'SAME').sum().backward()
  assert x.grad.shape == x.shape
  assert not any(kernels.LAUNCHES.values())
  with pytest.raises(ValueError, match='return_index'):
    pooling.max_pool(x, (3, 3), (3, 3), 'SAME', return_index=True)


# -- K3: the 5x5 weight gradient ----------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', [(2, 16, 16, 16), (4, 11, 13, 8)])
def test_conv5x5_wgrad_plain_matches_pallas_interpret(shape, dtype):
  rng = np.random.RandomState(2)
  x = rng.randn(*shape).astype(np.float32)
  dy = rng.randn(*shape).astype(np.float32)
  want = np.asarray(pallas_wgrad.conv5x5_wgrad(
      jnp.asarray(x, dtype), jnp.asarray(dy, dtype), interpret=True))
  got = wgrad.conv5x5_wgrad(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(dy).to(getattr(torch, dtype)))
  assert got.dtype == torch.float32 and got.shape == want.shape
  _close(got, want, rtol=0, scale_atol=1e-5)


def test_body_convs_take_their_weight_gradient_from_wgrad(monkeypatch):
  calls = []
  plain = wgrad.conv5x5_wgrad

  def recording(x, dy):
    calls.append((tuple(x.shape), tuple(dy.shape)))
    return plain(x, dy)

  monkeypatch.setattr(wgrad, 'conv5x5_wgrad', recording)
  conv = networks.Conv(8, 8, 5, 1, 'SAME')
  torch.nn.init.normal_(conv.weight)
  x = torch.randn(2, 8, 7, 9, requires_grad=True)
  conv(x).square().sum().backward()
  assert calls == [((2, 7, 9, 8), (2, 7, 9, 8))]
  w = conv.weight.detach().requires_grad_()
  xr = x.detach().requires_grad_()
  torch.nn.functional.conv2d(xr, w, None, 1, 2).square().sum().backward()
  _close(conv.weight.grad, w.grad, rtol=1e-5, scale_atol=1e-5)
  _close(x.grad, xr.grad, rtol=1e-5, scale_atol=1e-5)


# -- the train-mode network ---------------------------------------------------

def test_train_mode_loss_gradients_and_batch_stats_match_jax(ref):
  jax_model, port = _models(ref)
  rng = np.random.RandomState(3)
  features, labels = _batch(rng, 4)
  params, batch_stats = _flax_variables(jax_model, features, 4)
  (loss, (outputs, _, new_state)), grads = jax.value_and_grad(
      jax_model.loss_fn, has_aux=True)(
          params, {'batch_stats': batch_stats}, features, labels,
          ModeKeys.TRAIN, jax.random.PRNGKey(0))

  state = convert.from_flax({'params': params,
                             'batch_stats': batch_stats})['params']
  names = {n for n, _ in port.network.named_parameters()}
  p = {k: v.requires_grad_() for k, v in state.items() if k in names}
  model_state = {k: v for k, v in state.items() if k not in names}
  got_loss, (got_outputs, _, got_state) = port.loss_fn(
      p, model_state, _torch(features), _torch(labels), ModeKeys.TRAIN)
  got_grads = torch.autograd.grad(got_loss, list(p.values()),
                                  allow_unused=True)

  _close(got_loss, loss, rtol=1e-5, scale_atol=1e-5)
  for key in ('grasp_loss', 'l2_loss'):
    _close(got_outputs[key], outputs[key], rtol=1e-5, scale_atol=1e-5)
  want_grads = convert.from_flax({'params': grads})['params']
  assert set(want_grads) == set(p)
  for (name, _), got in zip(p.items(), got_grads):
    if got is None:   # the stem bias: stop_gradient in JAX
      assert name == 'grasping44.conv1_1.bias'
      assert not np.any(want_grads[name].numpy())
      continue
    _close(got, want_grads[name].numpy(), name=name, floor=1e-6)
  want_state = convert.from_flax({'params': {},
                                  'batch_stats': new_state['batch_stats']})
  for name, want in want_state['params'].items():
    _close(got_state[name], want.numpy(), rtol=1e-5, scale_atol=1e-5,
           name=name)
    # The running statistics moved (and the input buffers did not).
    assert not torch.equal(got_state[name], model_state[name])


def test_three_train_steps_match_jax(ref):
  """Each step starts both packages from the same state (the JAX one,
  converted), so that what is compared is one step's arithmetic: at a
  learning rate of 0.1 a difference of 1e-4 in one step grows by an order
  of magnitude in each later one (it does so between jitted and eager JAX
  as well)."""
  jax_model, port = _models(ref, learning_rate=0.1)
  rng = np.random.RandomState(5)
  batches = [_batch(rng, 8) for _ in range(3)]
  params, batch_stats = _flax_variables(jax_model, batches[0][0], 6)
  state = jax_model.create_train_state(jax.random.PRNGKey(0), *batches[0])
  state = state.replace(
      params=params, model_state={'batch_stats': batch_stats},
      opt_state=jax_model.create_optimizer().init(params),
      avg_params=params,
      ema_state=ref.t2r_models.abstract_model.opt_lib.create_ema(
          jax_model.avg_model_params_decay).init(params))
  first = convert.from_flax({'params': params})['params']
  for i, (features, labels) in enumerate(batches):
    before = convert.train_state_from_flax(
        jax.tree_util.tree_map(np.asarray, state))
    state, metrics = jax_model.train_step(state, features, labels,
                                          jax.random.PRNGKey(i))
    got, got_metrics = port.train_step(before, _torch(features),
                                       _torch(labels))
    want = convert.train_state_from_flax(
        jax.tree_util.tree_map(np.asarray, state))
    _close(got_metrics['loss'], metrics['loss'], rtol=1e-5, scale_atol=1e-5)
    assert got.step == want.step == i + 1
    for counts in (got.opt_state, got.ema_state):
      assert int(counts['count']) == i + 1
    for name, value in want.params.items():
      _close(got.params[name] - before.params[name],
             value - before.params[name], name=name, floor=1e-8)
      _close(got.opt_state['trace'][name],
             want.opt_state['trace'][name], name=name, floor=1e-7)
      _close(got.ema_state['ema'][name], want.ema_state['ema'][name],
             name=name, floor=1e-9)
      _close(got.avg_params[name], want.avg_params[name], rtol=1e-3,
             scale_atol=1e-3, name=name)
    for name, value in want.model_state.items():
      _close(got.model_state[name], value, rtol=1e-5, scale_atol=1e-5,
             name=name)
  # The steps moved the weights: a learning rate of 0.1 shows.
  assert max(float((got.params[k] - v).abs().max())
             for k, v in first.items()) > 1e-2


def test_staircase_schedule_and_momentum_match_optax():
  import optax

  schedule = optimizer_builder.build_learning_rate_schedule(
      optimizer_builder.default_hparams(examples_per_epoch=64, batch_size=8,
                                        num_epochs_per_decay=0.5,
                                        learning_rate=0.5,
                                        learning_rate_decay_factor=0.5))
  want = optax.exponential_decay(0.5, 4, 0.5, staircase=True)
  for count in (0, 3, 4, 9, 17):
    assert float(schedule(torch.tensor(count, dtype=torch.int32))) == \
        pytest.approx(float(want(count)), rel=1e-6)
  # The rmsprop branch builds (tests/test_torch_optimizers.py holds it to
  # optax).
  assert isinstance(optimizer_builder.build_opt(
      optimizer_builder.default_hparams(optimizer='rmsprop')),
                    optimizers.RMSProp)


def test_global_norm_clip_and_ema_match_optax():
  import optax

  rng = np.random.RandomState(7)
  params = {'a': rng.randn(3, 4).astype(np.float32),
            'b': rng.randn(5).astype(np.float32)}
  grads = {k: 10 * rng.randn(*v.shape).astype(np.float32)
           for k, v in params.items()}
  sgd = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.1, 0.9))
  updates, _ = sgd.update(grads, sgd.init(params), params)
  want = optax.apply_updates(params, updates)
  clipped = optimizers.maybe_clip_gradients(
      optimizer_builder.Momentum(optimizer_builder.StaircaseSchedule(
          0.1, 10, 1.0), 0.9), 1.0)
  p = _torch(params)
  got, _ = clipped.update(_torch(grads), clipped.init(p), p)
  for key in params:
    _close(got[key], want[key], rtol=1e-6, scale_atol=1e-6)
  ema = optax.ema(0.9, debias=True)
  ema_state = ema.init(params)
  port_ema = optimizers.create_ema(0.9)
  port_state = port_ema.init(p)
  for _ in range(2):
    avg, ema_state = ema.update(params, ema_state)
    got, port_state = port_ema.update(p, port_state)
  for key in params:
    _close(got[key], avg[key], rtol=1e-6, scale_atol=1e-6)


# -- the TRAIN preprocessor ---------------------------------------------------

def test_train_preprocessor_matches_jax_at_its_offsets(ref):
  jax_model, port = _models(ref)
  rng = np.random.RandomState(8)
  images = rng.randint(0, 256, (3, 512, 640, 3)).astype(np.uint8)
  key = jax.random.PRNGKey(9)
  crop_key, _ = jax.random.split(key)
  offsets = np.asarray(ref.t2r_models.image_transformations.
                       random_crop_offsets(crop_key, 3, (512, 640),
                                           t2r_models.TARGET_SHAPE))
  preprocess = jax.jit(
      lambda im, k: jax_model.preprocessor._preprocess_fn(
          {'state/image': im}, None, ModeKeys.TRAIN, k)[0]['state/image'])
  want = np.asarray(preprocess(jnp.asarray(images), key))
  features, labels = port.preprocessor.preprocess(
      {'state/image': torch.from_numpy(images)}, None, ModeKeys.TRAIN,
      offsets=torch.from_numpy(offsets))
  assert labels is None
  np.testing.assert_array_equal(features['state/image'].numpy(), want)

  # From a generator: offsets in range, the same for the same seed.
  gen = torch.Generator().manual_seed(0)
  drawn = t2r_models.image_transformations.random_crop_offsets(
      64, (512, 640), t2r_models.TARGET_SHAPE, gen)
  assert drawn.dtype == torch.int32 and drawn.shape == (64, 2)
  assert 0 <= int(drawn[:, 0].min()) and int(drawn[:, 0].max()) <= 40
  assert 0 <= int(drawn[:, 1].min()) and int(drawn[:, 1].max()) <= 168
  again = t2r_models.image_transformations.random_crop_offsets(
      64, (512, 640), t2r_models.TARGET_SHAPE,
      torch.Generator().manual_seed(0))
  assert torch.equal(drawn, again)
  with pytest.raises(ValueError, match='generator'):
    port.preprocessor.preprocess({'state/image': torch.from_numpy(images)},
                                 None, ModeKeys.TRAIN)
  # The distortions are ported (tests/test_torch_photometric.py); a
  # keyword the JAX function does not take is refused.
  with pytest.raises(TypeError, match='random_blur'):
    t2r_models.DefaultGrasping44ImagePreprocessor(
        distortion_kwargs={'random_blur': True})


# -- input generators ---------------------------------------------------------

def test_random_input_generator_matches_jax(ref):
  jax_model, port = _models(ref)
  want = ref.inputs.DefaultRandomInputGenerator(batch_size=2)
  want.set_specification_from_model(jax_model, ModeKeys.TRAIN)
  got = input_generators.DefaultRandomInputGenerator(batch_size=2)
  got.set_specification_from_model(port, ModeKeys.TRAIN)
  assert list(got.feature_spec) == list(
      jax_model.preprocessor.get_in_feature_specification(
          ModeKeys.TRAIN).keys())
  want_it = want.create_dataset_iterator(ModeKeys.TRAIN, seed=11,
                                         prefetch=0)
  for prefetch in (0, 2):
    got_it = got.create_dataset_iterator(ModeKeys.TRAIN, seed=11,
                                         prefetch=prefetch)
    for (wf, wl), (gf, gl) in zip([next(want_it) for _ in range(2)],
                                  [next(got_it) for _ in range(2)]):
      assert list(gf) == list(wf.keys())
      for key in gf:
        np.testing.assert_array_equal(gf[key], np.asarray(wf[key]))
      np.testing.assert_array_equal(gl['reward'], np.asarray(wl['reward']))
    got_it.close()
    want_it = want.create_dataset_iterator(ModeKeys.TRAIN, seed=11,
                                           prefetch=0)
  assert got.feature_spec['state/image'] == ((512, 640, 3), np.uint8)


def test_generator_input_generator_validates_shapes():
  gen = input_generators.GeneratorInputGenerator(
      lambda b: ({'x': np.zeros((b, 3), np.float32)},
                 {'y': np.zeros((b, 2), np.float32)}), batch_size=2,
      prefetch=0)
  gen.set_specification({'x': ((4,), np.float32)}, {'y': ((2,), np.float32)})
  with pytest.raises(ValueError, match="'x'"):
    next(gen.create_dataset_iterator(ModeKeys.TRAIN))
  gen.set_specification({'x': ((3,), np.float32)}, {'y': ((2,), np.float32)})
  features, labels = next(gen.create_dataset_iterator(ModeKeys.TRAIN,
                                                      num_epochs=1))
  assert features['x'].shape == (2, 3) and labels['y'].shape == (2, 2)
  # An error in the producer thread reaches the consumer.
  gen.set_specification({'z': ((3,), np.float32)}, {})
  with pytest.raises(ValueError, match="'z'"):
    next(gen.create_dataset_iterator(ModeKeys.TRAIN, prefetch=2))


# -- checkpoints and the trainer ----------------------------------------------

def _small_model(**kwargs):
  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)}, **kwargs)


def _states_equal(a, b):
  def flat(tree, prefix=''):
    if isinstance(tree, dict):
      for k, v in tree.items():
        yield from flat(v, prefix + '/' + k)
    else:
      yield prefix, tree
  fa, fb = dict(flat(vars(a))), dict(flat(vars(b)))
  assert fa.keys() == fb.keys()
  for key, value in fa.items():
    if isinstance(value, torch.Tensor):
      assert torch.equal(value, fb[key]), key
    else:
      assert value == fb[key], key


def test_checkpoint_round_trip_and_retention(tmp_path):
  model = _small_model()
  state = model.create_train_state(torch.Generator().manual_seed(0))
  manager = checkpointing.CheckpointManager(str(tmp_path), 2)
  for step in (1, 2, 3):
    state.step = step
    manager.save(state)
  assert checkpointing.all_checkpoint_steps(str(tmp_path)) == [2, 3]
  assert checkpointing.latest_checkpoint_step(str(tmp_path)) == 3
  assert not [p for p in tmp_path.iterdir() if '.tmp' in p.name]
  restored = manager.restore()
  _states_equal(restored, state)
  assert restored.params['grasping44.conv2.weight'].is_contiguous(
      memory_format=torch.channels_last)
  assert checkpointing.latest_checkpoint_step(str(tmp_path / 'none')) is None


def test_train_eval_model_trains_checkpoints_and_serves(tmp_path):
  model = _small_model()
  train = input_generators.DefaultRandomInputGenerator(batch_size=2)
  evaluate = input_generators.DefaultRandomInputGenerator(batch_size=2)
  kernels.reset_launches()
  result = train_eval.train_eval_model(
      model, str(tmp_path), train, evaluate, max_train_steps=2,
      eval_steps=1, eval_throttle_steps=2, log_every_n_steps=1,
      save_checkpoints_steps=5)
  state = result['state']
  assert state.step == 2 and set(result['eval_metrics']) == {'loss'}
  assert np.isfinite(result['eval_metrics']['loss'])
  assert checkpointing.all_checkpoint_steps(str(tmp_path)) == [2]
  _states_equal(checkpointing.CheckpointManager(str(tmp_path)).restore(),
                state)
  trainer = result['trainer']
  assert [w[0] for w in trainer.windows] == [1, 1]
  assert set(trainer.last_metrics) == {'loss', 'grasp_loss', 'l2_loss',
                                       'nonfinite_loss_skipped'}
  assert not any(kernels.LAUNCHES.values())   # the CPU takes plain versions
  for key in ('loss', 'grasp_loss', 'l2_loss'):
    assert trainer.registry.gauge('train/' + key).value == \
        trainer.last_metrics[key]
  assert trainer.registry.gauge('train/examples_per_sec').value > 0
  # The trained variables are the serving dict.
  variables = state.variables()
  assert set(variables) == {'params', 'avg_params'}
  assert set(variables['avg_params']) == set(
      model.network.state_dict().keys())
  rng = np.random.RandomState(0)
  states = {'image': rng.randint(0, 256, (2, 512, 640, 3)).astype(np.uint8),
            'gripper_closed': np.ones(2, np.float32),
            'height_to_bottom': np.zeros(2, np.float32)}
  out = model.make_batched_select_action(4, 1, 2)(variables, states, 0)
  assert torch.isfinite(out['action']).all() and out['action'].shape == (2, 8)
  # A second run resumes from the checkpoint.
  again = train_eval.train_eval_model(model, str(tmp_path), train,
                                      max_train_steps=3)
  assert again['state'].step == 3


def _recorded_crops(monkeypatch):
  """The TRAIN crop offsets drawn from now on, in order."""
  drawn = []
  draw = image_transformations.random_crop_offsets

  def recording(*args, **kwargs):
    offsets = draw(*args, **kwargs)
    drawn.append(offsets.clone())
    return offsets

  monkeypatch.setattr(image_transformations, 'random_crop_offsets',
                      recording)
  return drawn


def test_resumed_run_equals_uninterrupted_run(tmp_path, monkeypatch):
  """2 steps, a checkpoint, and a run that resumes from it for 2 more end
  where 4 steps in one run end, bit for bit: the batch of step k is drawn
  from seed + k and its crops from (seed + 1, k)."""
  data = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                      prefetch=0)
  drawn = _recorded_crops(monkeypatch)
  whole = train_eval.train_eval_model(
      _small_model(), str(tmp_path / 'whole'), data, max_train_steps=4,
      save_checkpoints_steps=4, seed=7)['state']
  whole_crops = list(drawn)
  del drawn[:]
  train_eval.train_eval_model(_small_model(), str(tmp_path / 'resumed'),
                              data, max_train_steps=2,
                              save_checkpoints_steps=2, seed=7)
  resumed = train_eval.train_eval_model(
      _small_model(), str(tmp_path / 'resumed'), data, max_train_steps=4,
      save_checkpoints_steps=2, seed=7)['state']
  assert resumed.step == whole.step == 4
  _states_equal(resumed, whole)
  assert len(drawn) == len(whole_crops) == 4
  for got, want in zip(drawn, whole_crops):
    assert torch.equal(got, want)
  assert not torch.equal(whole_crops[0], whole_crops[1])


def test_nonfinite_loss_is_skipped_or_raises(tmp_path):
  model = _small_model(loss_function=lambda targets, q: q.sum() * np.nan)
  train = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                       prefetch=0)
  trainer = train_eval.Trainer(model, str(tmp_path / 'skip'),
                               log_every_n_steps=2)
  before = trainer.init_state()
  after = trainer.train(train, 2, state=before)
  assert after.step == 2 and trainer.last_metrics[
      'nonfinite_loss_skipped'] == 1
  assert trainer.registry.counter(
      'train/nonfinite_loss_skipped').value >= 2
  after.step = before.step
  _states_equal(after, before)
  raising = train_eval.Trainer(model, str(tmp_path / 'raise'),
                               nan_policy='raise')
  with pytest.raises(train_eval.NonFiniteLossError):
    raising.train(train, 1)
  with pytest.raises(ValueError, match='nan_policy'):
    train_eval.Trainer(model, str(tmp_path), nan_policy='restart')


def test_command_line_trains_on_the_cpu(tmp_path, capsys):
  assert train_eval.main([
      '--device', 'cpu', '--num_convs', '1,1,1', '--max_train_steps', '2',
      '--batch_size', '2', '--model_dir', str(tmp_path),
      '--log_every_n_steps', '1']) == 0
  import json
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['step'] == 2 and line['checkpoint_step'] == 2
  assert line['device'] == 'cpu' and np.isfinite(line['metrics']['loss'])
