"""The port's five small modules against the JAX package's on the same
seeded inputs: ``utils/subsample.py``, ``utils/global_step_functions.py``,
``research/dql_grasping.py``, ``utils/convert_pkl_assets.py`` and
``models/classification_model.py``. Indices exact, floats within 1e-6,
the converter's files byte-equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_utils as jax_utils_tests

from tensor2robot_tpu_torch.models import classification_model
from tensor2robot_tpu_torch.research import dql_grasping
from tensor2robot_tpu_torch.utils import convert_pkl_assets
from tensor2robot_tpu_torch.utils import global_step_functions
from tensor2robot_tpu_torch.utils import subsample

LENGTHS = np.array([40, 25, 3, 5, 6, 1, 97, 12], np.int32)


@pytest.mark.parametrize('k', [1, 2, 5, 8])
def test_subsample_indices_against_jax(k):
  """The numpy variants (plain and randomized, one RandomState seed each
  side), the torch variant plain and with JAX's uniforms as its noise, and
  the gather."""
  from tensor2robot_tpu.utils import subsample as jax_subsample

  np.testing.assert_array_equal(
      subsample.get_subsample_indices_numpy(LENGTHS, k),
      jax_subsample.get_subsample_indices_numpy(LENGTHS, k))
  np.testing.assert_array_equal(
      subsample.get_subsample_indices_numpy(
          LENGTHS, k, np.random.RandomState(3), randomized=True),
      jax_subsample.get_subsample_indices_numpy(
          LENGTHS, k, np.random.RandomState(3), randomized=True))
  np.testing.assert_array_equal(
      subsample.get_subsample_indices(torch.tensor(LENGTHS), k).numpy(),
      np.asarray(jax_subsample.get_subsample_indices(jnp.asarray(LENGTHS),
                                                     k)))
  key = jax.random.PRNGKey(7)
  noise = np.stack([np.asarray(jax.random.uniform(sub, (k,))) for sub in
                    jax.random.split(key, len(LENGTHS))])
  np.testing.assert_array_equal(
      subsample.get_subsample_indices(torch.tensor(LENGTHS), k,
                                      noise=torch.tensor(noise)).numpy(),
      np.asarray(jax_subsample.get_subsample_indices(jnp.asarray(LENGTHS), k,
                                                     rng=key)))
  drawn = subsample.get_subsample_indices(
      torch.tensor(LENGTHS), k, generator=torch.Generator().manual_seed(0))
  assert drawn.shape == (len(LENGTHS), k)
  assert (drawn >= 0).all() and (drawn < torch.tensor(LENGTHS)[:, None]).all()
  data = np.random.RandomState(1).randn(len(LENGTHS), 97, 3).astype(
      np.float32)
  idx = subsample.get_subsample_indices_numpy(LENGTHS, k)
  want = np.asarray(jax_subsample.subsample_sequence(jnp.asarray(data),
                                                     jnp.asarray(idx)))
  np.testing.assert_array_equal(
      subsample.subsample_sequence(torch.tensor(data), idx).numpy(), want)
  np.testing.assert_array_equal(subsample.subsample_sequence(data, idx), want)


def test_schedules_against_jax():
  from tensor2robot_tpu.utils import global_step_functions as jax_schedules

  steps = np.array([-5, 0, 1, 7, 10, 15, 19.5, 20, 33, 1e4, 2.5e4],
                   np.float32)
  for boundaries, values in (([0, 10, 20], [1.0, 0.5, 0.0]), ([5], [2.0]),
                             ([0, 10, 10, 30], [0.0, 1.0, 3.0, 2.0])):
    got = global_step_functions.piecewise_linear(boundaries, values)(
        torch.tensor(steps))
    want = jax_schedules.piecewise_linear(boundaries, values)(steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(global_step_functions.piecewise_linear(
        boundaries, values)(12)) == pytest.approx(
            float(jax_schedules.piecewise_linear(boundaries, values)(12)),
            abs=1e-6)
  for staircase in (True, False):
    got = global_step_functions.exponential_decay(
        0.1, 1000, 0.5, staircase)(torch.tensor(steps))
    want = jax_schedules.exponential_decay(0.1, 1000, 0.5, staircase)(steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
  with pytest.raises(ValueError, match='equal length'):
    global_step_functions.piecewise_linear([1], [1.0, 2.0])
  with pytest.raises(ValueError, match='sorted'):
    global_step_functions.piecewise_linear([5, 1], [1.0, 2.0])


def test_dql_grasping_context_against_jax():
  from tensor2robot_tpu.research import dql_grasping as jax_dql

  rng = np.random.RandomState(2)
  net = rng.randn(3, 4, 5, 6).astype(np.float32)
  context = rng.randn(3 * 7, 6).astype(np.float32)
  np.testing.assert_array_equal(
      dql_grasping.add_context(torch.tensor(net), torch.tensor(context))
      .numpy(),
      np.asarray(jax_dql.add_context(jnp.asarray(net),
                                     jnp.asarray(context))))
  samples = rng.randn(3, 7, 6).astype(np.float32)
  np.testing.assert_array_equal(
      dql_grasping.tile_to_match_context(torch.tensor(net),
                                         torch.tensor(samples)).numpy(),
      np.asarray(jax_dql.tile_to_match_context(jnp.asarray(net),
                                               jnp.asarray(samples))))
  with pytest.raises(ValueError, match='depth'):
    dql_grasping.add_context(torch.tensor(net), torch.zeros(3, 5))


@pytest.mark.parametrize('with_step', [True, False])
def test_convert_pkl_assets_writes_jax_bytes(tmp_path, with_step):
  """Reference pickles (the JAX test's stand-ins for the reference's
  classes) converted by both packages: the pbtxt and its JSON twin
  byte-equal; a foreign global refused; a missing file named."""
  from tensor2robot_tpu.utils import convert_pkl_assets as jax_convert

  writer = jax_utils_tests.TestConvertPklAssets()
  written = {}
  for side, module in (('port', convert_pkl_assets), ('jax', jax_convert)):
    directory = tmp_path / side
    directory.mkdir()
    writer._write_reference_assets(directory, with_step=with_step)
    path = module.convert(str(directory))
    written[side] = {name: (directory / name).read_bytes()
                     for name in sorted(os.listdir(directory))}
    assert os.path.basename(path) == 't2r_assets.pbtxt'
  assert written['port'] == written['jax']
  import pickle

  (tmp_path / 'evil').mkdir()
  (tmp_path / 'evil' / 'input_specs.pkl').write_bytes(pickle.dumps(
      {'in_feature_spec': print, 'in_label_spec': {}}))
  with pytest.raises(pickle.UnpicklingError, match='Refusing'):
    convert_pkl_assets.convert(str(tmp_path / 'evil'))
  with pytest.raises(ValueError, match='input_specs.pkl'):
    convert_pkl_assets.convert(str(tmp_path / 'missing'))


class _PortClassifier(classification_model.ClassificationModel):

  def get_feature_specification(self, mode):
    return {'x': ((3,), np.float32)}

  def get_label_specification(self, mode):
    return {'target': ((1,), np.float32)}

  def create_network(self):
    return torch.nn.Identity()


def test_classification_losses_and_metrics_against_jax():
  """JAX's sigmoid log-loss and eval metrics of :35-59 and its serving
  outputs, on the same logits and labels."""
  from tensor2robot_tpu.models import classification_model as jax_cls

  rng = np.random.RandomState(4)
  logits = rng.randn(16, 1).astype(np.float32) * 3
  labels = (rng.rand(16, 1) > 0.5).astype(np.float32)
  port = _PortClassifier(device='cpu')
  jax_model = type('JaxClassifier', (jax_cls.ClassificationModel,), {
      'get_feature_specification': lambda self, mode: None,
      'get_label_specification': lambda self, mode: None})()
  outputs = {'logits': torch.tensor(logits)}
  loss, _ = port.model_train_fn(None, None, {'target': torch.tensor(labels)},
                                outputs, 'train')
  want_loss, _ = jax_model.model_train_fn(
      None, None, {'target': jnp.asarray(labels)},
      {'logits': jnp.asarray(logits)}, 'train')
  np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-6)
  got = port.model_eval_fn(None, None, {'target': torch.tensor(labels)},
                           outputs, 'eval')
  want = jax_model.model_eval_fn(None, None, {'target': jnp.asarray(labels)},
                                 {'logits': jnp.asarray(logits)}, 'eval')
  assert set(got) == set(want.keys())
  for key in got:
    np.testing.assert_allclose(float(got[key]), float(want[key]), atol=1e-6,
                               err_msg=key)
  served = port.create_export_outputs_fn(None, outputs, 'predict')
  want_served = jax_model.create_export_outputs_fn(
      None, {'logits': jnp.asarray(logits)}, 'predict')
  for key in ('logits', 'probabilities'):
    np.testing.assert_allclose(served[key].numpy(),
                               np.asarray(want_served[key]), atol=1e-6)
