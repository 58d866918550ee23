"""The port's Grasping44 critic, CEM and batched CEM selector against the
JAX package, on the CPU.

Weights are drawn with numpy at fan-in scale (std 0.01, the package's own
initializer, shrinks the activations until every score is about 0.5),
converted for the port with ``convert.from_flax``, and the same inputs go
through both packages.

Tolerances. Both sides run float32. XLA and PyTorch's CPU convolutions
and matrix products sum in different orders, which leaves differences of
a few float32 ulps per layer; over up to 19 layers of O(1) activations
that stays below 1e-4, the bound used for logits and feature maps
(predictions, in [0, 1], below 1e-5). The CEM samples are
``mean + std * noise`` from the same noise, so they differ only by the
rounding of the refitted mean and std: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.utils import cross_entropy

ATOL = 1e-4


@pytest.fixture(scope='module')
def ref():
  """The JAX package's qtopt modules, imported under the shim of
  ``_torch_jax_qtopt`` (which leaves ``sys.modules`` as it found it)."""
  yield from jax_qtopt_fixture('research.qtopt.networks',
                               'research.qtopt.t2r_models',
                               'utils.cross_entropy')


def _draw(tree, rng, path=()):
  """Random values at fan-in scale for a flax params/batch_stats tree."""
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      out[key] = _draw(value, rng, path + (key,))
      continue
    shape = np.shape(value)
    if key == 'kernel':
      fan_in = int(np.prod(shape[:-1]))
      draw = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
    elif key == 'var':
      draw = rng.uniform(0.5, 1.5, shape)
    elif key == 'scale':
      draw = 1.0 + 0.1 * rng.randn(*shape)
    else:  # bias, mean
      draw = 0.1 * rng.randn(*shape)
    out[key] = draw.astype(np.float32)
  return out


def _flax_variables(module, args, seed, avg=False, **kwargs):
  shapes = jax.tree_util.tree_map(
      np.asarray, module.init(jax.random.PRNGKey(0), *args, **kwargs))
  rng = np.random.RandomState(seed)
  variables = {'params': _draw(shapes['params'], rng),
               'batch_stats': _draw(shapes['batch_stats'], rng)}
  if avg:
    variables['avg_params'] = _draw(shapes['params'], rng)
  return variables


def _allclose(got, want, atol=ATOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=atol)


def _features(rng, batch, size, rows):
  features = {'state/image': rng.uniform(0, 1, (batch, size, size, 3))
                             .astype(np.float32)}
  for key, width in (t2r_models.ACTION_DIM_LAYOUT +
                     (('gripper_closed', 1), ('height_to_bottom', 1))):
    features['action/' + key] = rng.randn(rows, width).astype(np.float32)
  return features


def test_from_flax_matches_the_port_state_dict(ref):
  jax_net = ref.t2r_models.GraspingQNetwork(
      grasp_param_keys=ref.networks.E2E_GRASP_PARAM_KEYS,
      grasp_param_names=ref.networks.E2E_GRASP_PARAM_NAMES,
      network_kwargs={'num_convs': (2, 2, 1)})
  features = _features(np.random.RandomState(0), 2, 96, 2)
  variables = _flax_variables(jax_net, (features,), 1, avg=True,
                              mode='predict', train=False)
  port = convert.from_flax(variables)
  net = t2r_models.GraspingQNetwork(
      grasp_param_names=networks.E2E_GRASP_PARAM_NAMES,
      network_kwargs={'num_convs': (2, 2, 1)}, image_size=96)
  want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
  for key in ('params', 'avg_params'):
    assert {k: tuple(v.shape) for k, v in port[key].items()} == want
  params = variables['params']['grasping44']
  stats = variables['batch_stats']['grasping44']
  np.testing.assert_array_equal(
      port['params']['grasping44.conv2.weight'].numpy(),
      params['conv2']['kernel'].transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(
      port['params']['grasping44.fc0.weight'].numpy(),
      params['fc0']['kernel'].T)
  np.testing.assert_array_equal(
      port['avg_params']['grasping44.bn3.mean'].numpy(), stats['bn3']['mean'])
  np.testing.assert_array_equal(
      port['avg_params']['grasping44.conv1_1.bias'].numpy(),
      variables['avg_params']['grasping44']['conv1_1']['bias'])


def test_grasping_q_network_matches_flax_on_a_megabatch(ref):
  """The feature-dict adapter: 2 states x 3 candidate actions each."""
  jax_net = ref.t2r_models.GraspingQNetwork(
      grasp_param_keys=ref.networks.E2E_GRASP_PARAM_KEYS,
      grasp_param_names=ref.networks.E2E_GRASP_PARAM_NAMES,
      network_kwargs={'num_convs': (2, 2, 1)})
  features = _features(np.random.RandomState(2), 2, 96, 6)
  variables = _flax_variables(jax_net, (features,), 3, mode='predict',
                              train=False)
  want = jax_net.apply(variables, features, mode='predict', train=False)
  net = t2r_models.GraspingQNetwork(
      grasp_param_names=networks.E2E_GRASP_PARAM_NAMES,
      network_kwargs={'num_convs': (2, 2, 1)}, image_size=96)
  net.load_state_dict(convert.from_flax(variables)['params'])
  got = net({k: torch.from_numpy(v) for k, v in features.items()})
  assert got['q_predicted'].shape == (6,)
  _allclose(got['q_logits'], want['q_logits'])
  _allclose(got['q_predicted'], want['q_predicted'], 1e-5)


@pytest.mark.parametrize('size,num_convs,batch,actions', [
    (96, (2, 2, 1), 2, None),     # rank-2 grasp params
    (96, (2, 2, 1), 2, 3),        # rank-3: the CEM megabatch
    (224, (6, 6, 3), 1, 4),       # full depth
])
def test_grasping44_matches_flax(ref, size, num_convs, batch, actions):
  rng = np.random.RandomState(size + batch)
  image = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
  grasp_shape = (batch, 10) if actions is None else (batch, actions, 10)
  grasp = rng.randn(*grasp_shape).astype(np.float32)
  jax_net = ref.networks.Grasping44Network(
      num_convs=num_convs,
      grasp_param_names=ref.networks.E2E_GRASP_PARAM_NAMES)
  variables = _flax_variables(jax_net, (image, grasp), 5, train=False)
  want = jax_net.apply(variables, image, grasp, train=False)

  net = networks.Grasping44Network(
      num_convs=num_convs, grasp_param_names=networks.E2E_GRASP_PARAM_NAMES,
      image_size=size)
  net.load_state_dict(convert.from_flax(variables)['params'])
  with torch.no_grad():
    got = net(torch.from_numpy(image), torch.from_numpy(grasp))
  for key in ('logits', 'pool2', 'final_conv'):
    assert tuple(got[key].shape) == tuple(want[key].shape), key
    _allclose(got[key], want[key])
  assert tuple(got['predictions'].shape) == tuple(want['predictions'].shape)
  _allclose(got['predictions'], want['predictions'], 1e-5)
  # The logits spread: the comparison is not of constants.
  assert np.ptp(np.asarray(want['logits'])) > 0.1


def test_layout_options_of_the_tpu_raise():
  with pytest.raises(NotImplementedError):
    networks.Grasping44Network(space_to_depth=True)
  with pytest.raises(NotImplementedError):
    networks.Grasping44Network(conv_variant='nchw')


def _jax_noise(key, iters, samples, dim):
  return np.stack([np.asarray(jax.random.normal(k, (samples, dim)))
                   for k in jax.random.split(key, iters)])


def test_normal_cem_matches_jax_normal_cem(ref):
  target = np.linspace(-1.0, 1.0, 8).astype(np.float32)
  key = jax.random.PRNGKey(11)
  mean, std, best = ref.cross_entropy.jax_normal_cem(
      lambda x: -jnp.sum((x - target) ** 2, -1), jnp.zeros(8), jnp.ones(8),
      key, num_samples=64, num_elites=10, num_iterations=3)
  noise = _jax_noise(key, 3, 64, 8)
  t_target = torch.from_numpy(target)
  got = cross_entropy.normal_cem(
      lambda x: -((x - t_target) ** 2).sum(-1), torch.zeros(8),
      torch.ones(8), None, num_samples=64, num_elites=10,
      num_iterations=3, noise=torch.from_numpy(noise))
  for g, w in zip(got, (mean, std, best)):
    _allclose(g, w, 1e-5)

  # Leading batch dims run independent CEMs: row 1 repeats the above.
  batched = cross_entropy.normal_cem(
      lambda x: -((x - t_target) ** 2).sum(-1), torch.zeros(2, 8),
      torch.ones(2, 8), None, num_samples=64, num_elites=10,
      num_iterations=3,
      noise=torch.from_numpy(np.stack([noise[:, ::-1], noise], 1).copy()))
  for g, w in zip(batched, got):
    assert torch.equal(g[1], w)


def test_batched_select_action_matches_jax(ref, monkeypatch):
  seed, batch, samples, iters, elites = 5, 2, 8, 2, 3
  jax_model = ref.t2r_models.\
      Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device_type='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  rng = np.random.RandomState(0)
  init_features = _features(rng, 1, 472, 1)
  variables = _flax_variables(jax_model.create_network(), (init_features,),
                              7, avg=True, mode='predict', train=False)
  # Shrink the logits out of the sigmoid's saturation, so that the CEM's
  # ranking is decided by the scores, not by rounding (the smallest gap is
  # checked below).
  for name in ('params', 'avg_params'):
    variables[name]['grasping44']['logit']['kernel'] *= 0.1
  states = {
      'image': rng.randint(0, 256, (batch, 512, 640, 3)).astype(np.uint8),
      'gripper_closed': rng.uniform(0, 1, batch).astype(np.float32),
      'height_to_bottom': rng.uniform(0, 1, batch).astype(np.float32),
  }
  jax_select = jax.jit(jax_model.make_batched_select_action(
      cem_samples=samples, cem_iters=iters, num_elites=elites))
  want = jax_select(variables, states, np.uint32(seed))

  noise = np.stack([
      _jax_noise(jax.random.fold_in(jax.random.PRNGKey(seed), row), iters,
                 samples, 8) for row in range(batch)], 1)
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  port_variables = {k: model.to_device(v)
                    for k, v in convert.from_flax(variables).items()}
  scores = []
  normal_cem = cross_entropy.normal_cem

  def recording_cem(objective, *args, **kwargs):
    def record(samples_):
      out = objective(samples_)
      scores.append(out.clone())
      return out
    return normal_cem(record, *args, **kwargs)

  monkeypatch.setattr(t2r_models.cross_entropy, 'normal_cem', recording_cem)
  got = model.make_batched_select_action(
      cem_samples=samples, cem_iters=iters, num_elites=elites)(
          port_variables, states, seed, noise=noise)

  assert len(scores) == iters
  ranked = torch.sort(torch.stack(scores), -1, descending=True).values
  gaps = torch.cat([ranked[..., 0] - ranked[..., 1],
                    ranked[..., elites - 1] - ranked[..., elites]])
  assert float(gaps.min()) > 10 * 1e-5, gaps
  assert tuple(got['action'].shape) == (batch, 8)
  _allclose(got['action'], want['action'], 1e-5)
  _allclose(got['q'], want['q'], 1e-5)
  # avg_params served, as the JAX selector serves them: params score
  # differently.
  plain = model.make_batched_select_action(samples, iters, elites)(
      {'params': port_variables['avg_params']}, states, seed, noise=noise)
  other = model.make_batched_select_action(samples, iters, elites)(
      {'params': port_variables['params']}, states, seed, noise=noise)
  assert torch.equal(plain['q'], got['q'])
  assert not torch.allclose(other['q'], got['q'])


def test_single_request_select_is_the_batch_of_one():
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  variables = model.init_variables(torch.Generator().manual_seed(0))
  rng = np.random.RandomState(1)
  state = {'image': rng.randint(0, 256, (512, 640, 3)).astype(np.uint8),
           'gripper_closed': np.float32(1.0),
           'height_to_bottom': np.float32(0.3)}
  noise = np.random.RandomState(2).randn(2, 4, 8).astype(np.float32)
  action, q = model.make_on_device_select_action(4, 2, 2)(
      variables, state, 0, noise=noise)
  batched = model.make_batched_select_action(4, 2, 2)(
      variables, {k: np.asarray(v)[None] for k, v in state.items()}, 0,
      noise=noise[:, None])
  assert action.shape == (8,) and torch.equal(action, batched['action'][0])
  assert torch.equal(q, batched['q'][0])
  # The JAX initializer's weights are kept: std 0.01, zero biases.
  weights = variables['params']['grasping44.conv2.weight']
  assert 0.005 < float(weights.std()) < 0.015
  assert float(variables['params']['grasping44.conv1_1.bias'].abs().max()) == 0


def test_model_predict_forward_serves_the_averaged_weights():
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  variables = model.init_variables(torch.Generator().manual_seed(0))
  gen = torch.Generator().manual_seed(1)
  variables['avg_params'] = {
      k: v + 0.01 * torch.randn(v.shape, generator=gen)
      for k, v in variables['params'].items()}
  features = {k: torch.from_numpy(v) for k, v in
              _features(np.random.RandomState(3), 1, 472, 2).items()}
  with torch.no_grad():
    got = model.inference_network_fn(variables, features)
    reference = model.create_network()
    reference.load_state_dict(variables['avg_params'])
    want = reference(features)
  assert torch.equal(got['q_predicted'], want['q_predicted'])
  model.use_avg_model_params = False
  with torch.no_grad():
    raw = model.inference_network_fn(variables, features)
  assert not torch.equal(raw['q_logits'], got['q_logits'])
