"""The port's training harness on the CPU: warm start, checkpoints_iterator,
the nan policies, hooks, exporters and export artifacts, the exported
model predictor, continuous eval, and the whole slice from records through
the gin entry to ``serve.py --export_dir``, against the JAX package where
it has the same function.

Tolerances: warm start, the version bookkeeping and the artifacts'
assets are exact (the same values copied, the same names and bytes).
The served actions of an export equal the checkpoint predictor's on the
same weights, states and CEM seed within 1e-4 (they are computed by the
same code on the same tensors, so in practice bit for bit).
"""

import contextlib
import io
import json
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from tensor2robot_tpu.export import export_generators as jax_exports
from tensor2robot_tpu.export import exporters as jax_exporters
from tensor2robot_tpu.trainer import checkpointing as jax_checkpointing
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.export import export_generators
from tensor2robot_tpu_torch.export import exporters
from tensor2robot_tpu_torch.hooks import (CheckpointExportHook, HookBuilder,
                                          LaggedCheckpointExportHook,
                                          TrainHook, VariableLoggerHook)
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.predictors import (CheckpointPredictor,
                                               ExportedModelPredictor)
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.specs import assets
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval

TINY = {'num_convs': (1, 1, 1)}
CEM = dict(cem_samples=4, cem_iters=2, num_elites=2)
PORT_GIN = 'tensor2robot_tpu_torch/research/qtopt/configs/train_qtopt.gin'


def _model(**kwargs):
  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs=TINY, **kwargs)


def _random(batch=2):
  return input_generators.DefaultRandomInputGenerator(batch_size=batch,
                                                      prefetch=0)


# -- warm start ---------------------------------------------------------------


def _flax_tree(seed, dense_width=2):
  rng = np.random.RandomState(seed)
  return {'conv1': {'kernel': rng.randn(3, 3, 2, 4).astype(np.float32)},
          'dense': {'kernel': rng.randn(4, dense_width).astype(np.float32),
                    'bias': rng.randn(dense_width).astype(np.float32)},
          'head': {'bias': rng.randn(3).astype(np.float32)}}


def _flat(tree, prefix=''):
  out = {}
  for key, value in tree.items():
    if isinstance(value, dict):
      out.update(_flat(value, prefix + key + '.'))
    else:
      out[prefix + key] = torch.from_numpy(np.array(value))
  return out


@pytest.mark.parametrize('include', [None, 'no conv1'])
def test_warm_start_merges_as_jax(tmp_path, include):
  """A foreign run's tensors replace the fresh ones of the same name and
  shape that ``include`` passes (the dense kernel changed shape, the head
  is not in the checkpoint): JAX's merge on the flax tree, the port's on
  the same tree's state dict."""
  fresh, saved = _flax_tree(0), _flax_tree(1, dense_width=5)
  del saved['head']
  saved['dense']['bias'] = np.random.RandomState(2).randn(2).astype(
      np.float32)
  jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
  manager = jax_checkpointing.CheckpointManager(jax_dir,
                                                async_checkpoints=False)
  manager.save(3, {'params': saved}, force=True)
  manager.wait_until_finished()
  manager.close()
  checkpointing.CheckpointManager(port_dir).save(TrainState(
      step=3, params=_flat(saved), model_state={}, opt_state={}))
  jax_include = port_include = None
  if include:
    jax_include = lambda path: not path.startswith('conv1')  # noqa: E731
    port_include = lambda name: not name.startswith('conv1')  # noqa: E731
  want = jax_checkpointing.create_warm_start_fn(jax_dir, 3, jax_include)(
      fresh)
  got = checkpointing.create_warm_start_fn(port_dir, None, port_include)(
      _flat(fresh))
  want = _flat(jax_checkpointing.jax.tree_util.tree_map(np.asarray, want))
  assert sorted(got) == sorted(want)
  for name in want:
    assert torch.equal(got[name], want[name]), name
  assert torch.equal(got['dense.bias'], _flat(saved)['dense.bias'])
  assert torch.equal(got['dense.kernel'], _flat(fresh)['dense.kernel'])
  with pytest.raises(FileNotFoundError, match='warm start'):
    checkpointing.create_warm_start_fn(str(tmp_path / 'none'))(_flat(fresh))


def test_a_trainer_starts_from_the_warm_start(tmp_path):
  donor = train_eval.train_eval_model(_model(), str(tmp_path / 'donor'),
                                      _random(), max_train_steps=1,
                                      save_checkpoints_steps=1)['state']
  warm = _model(warm_start_fn=checkpointing.create_warm_start_fn(
      str(tmp_path / 'donor'),
      include=lambda name: 'conv2' in name))
  state = train_eval.Trainer(warm, str(tmp_path / 'warm')).init_state()
  fresh = _model().create_train_state(torch.Generator().manual_seed(0))
  assert state.step == 0
  for name, value in state.params.items():
    want = donor.params if 'conv2' in name else fresh.params
    assert torch.equal(value, want[name]), name
  name = 'grasping44.conv2.weight'
  assert not torch.equal(donor.params[name], fresh.params[name])
  assert torch.equal(state.avg_params[name], donor.params[name])
  assert state.params[name].is_contiguous(
      memory_format=torch.channels_last)


# -- checkpoints_iterator, nan policies, hooks --------------------------------


def test_checkpoints_iterator_follows_a_writer_thread(tmp_path):
  model_dir = str(tmp_path)
  state = TrainState(step=0, params={'w': torch.zeros(2)}, model_state={},
                     opt_state={})
  manager = checkpointing.CheckpointManager(model_dir)

  def writer():
    for step in (2, 4, 6):
      time.sleep(0.15)
      state.step = step
      manager.save(state)

  thread = threading.Thread(target=writer)
  thread.start()
  start = time.monotonic()
  seen = list(checkpointing.checkpoints_iterator(
      model_dir, timeout_secs=0.6, min_interval_secs=0.02))
  thread.join()
  assert seen == [2, 4, 6]
  assert time.monotonic() - start >= 0.6
  stopped = list(checkpointing.checkpoints_iterator(
      model_dir, timeout_secs=30, stop_fn=lambda: True))
  assert stopped == []
  assert list(checkpointing.checkpoints_iterator(
      str(tmp_path / 'empty'), timeout_secs=0.05,
      min_interval_secs=0.01)) == []


class _NanAt:
  """Random batches with a NaN grasp label in the listed batches."""

  def __init__(self, poisoned):
    self.inner = _random()
    self.poisoned = set(poisoned)
    self.drawn = 0
    self.batch_size = self.inner.batch_size

  def set_specification_from_model(self, model, mode):
    self.inner.set_specification_from_model(model, mode)

  def create_dataset_iterator(self, mode, **kwargs):
    inner = self.inner.create_dataset_iterator(mode, **kwargs)
    try:
      for features, labels in inner:
        self.drawn += 1
        if self.drawn in self.poisoned:
          labels = dict(labels, reward=np.full_like(labels['reward'],
                                                    np.nan))
        yield features, labels
    finally:
      inner.close()


class _Recorder(TrainHook):
  def __init__(self, calls):
    self.calls = calls

  def begin(self, trainer):
    self.calls.append('begin')

  def after_step(self, trainer, state, step, metrics):
    self.calls.append(('after_step', step, float(metrics['loss'])))

  def end(self, trainer, state):
    self.calls.append(('end', state.step))


class _Builder(HookBuilder):
  def __init__(self, calls):
    self.calls = calls

  def create_hooks(self, t2r_model, trainer):
    return [_Recorder(self.calls)]


def test_rollback_restores_the_last_checkpoint_and_counts(tmp_path):
  counter = get_registry().counter('reliability/nan_rollbacks')
  before = counter.value
  data, calls = _NanAt({3}), []
  result = train_eval.train_eval_model(
      _model(), str(tmp_path), data, max_train_steps=4,
      save_checkpoints_steps=2, log_every_n_steps=1, nan_policy='rollback',
      train_hook_builders=[_Builder(calls)])
  assert counter.value - before == 1 and data.drawn == 5
  assert result['state'].step == 4
  assert calls[0] == 'begin' and calls[-1] == ('end', 4)
  assert [c[1] for c in calls[1:-1]] == [1, 2, 3, 4]
  assert all(np.isfinite(c[2]) for c in calls[1:-1])
  assert all(torch.isfinite(v).all()
             for v in result['state'].params.values())


def test_rollback_budget_exhausts_and_off_lets_the_nan_in(tmp_path):
  with pytest.raises(train_eval.NonFiniteLossError, match='budget'):
    train_eval.train_eval_model(
        _model(), str(tmp_path / 'budget'), _NanAt({2, 3, 4}),
        max_train_steps=4, save_checkpoints_steps=1, nan_policy='rollback',
        nan_rollback_budget=2)
  with pytest.raises(train_eval.NonFiniteLossError, match='no committed'):
    train_eval.train_eval_model(
        _model(), str(tmp_path / 'nothing'), _NanAt({1}),
        max_train_steps=2, save_checkpoints_steps=2, nan_policy='rollback')
  off = train_eval.train_eval_model(
      _model(), str(tmp_path / 'off'), _NanAt({1}), max_train_steps=1,
      save_checkpoints_steps=1, nan_policy='off')['state']
  assert not all(torch.isfinite(v).all() for v in off.params.values())


# -- exporters, artifacts, the exported model predictor -----------------------


class _Owner:
  """What an exporter reads of a trainer."""

  def __init__(self, model, model_dir):
    self.model, self.model_dir = model, model_dir


def _state(model, step, scale=1.0):
  state = model.create_train_state(torch.Generator().manual_seed(0))
  state.step = step
  state.avg_params = {k: v * scale for k, v in state.avg_params.items()}
  return state


def _jax_specs(specs):
  from tensor2robot_tpu import specs as jax_specs
  from tensor2robot_tpu.specs.struct import SpecStruct

  out = SpecStruct()
  for key, spec in specs.items():
    out[key] = jax_specs.TensorSpec(spec.shape, spec.dtype, **spec.fields())
  return out


def test_artifacts_keep_the_jax_layout_and_assets(tmp_path):
  model = _model()
  port = export_generators.DefaultExportGenerator()
  port.set_specification_from_model(model)
  path = port.export(str(tmp_path / 'port'),
                     exporters.serving_variables(_state(model, 5), True), 5,
                     version=7)
  jax_path = jax_exports.write_serving_artifact(
      str(tmp_path / 'jax'), {'params': {'w': np.zeros(2, np.float32)}},
      _jax_specs(port.serving_feature_spec()),
      _jax_specs(model.get_label_specification('predict')), 5,
      warmup_features={'x': np.zeros(1)}, version=7)
  listing = lambda root: sorted(  # noqa: E731
      os.path.relpath(os.path.join(d, f), root)
      for d, _, files in os.walk(root) for f in files)
  ours = listing(path)
  assert [f for f in listing(jax_path) if not f.startswith('variables/')] \
      == [f for f in ours if not f.startswith('variables/')]
  assert ours.count('variables/variables.pt') == 1
  for name in ('assets.extra/t2r_assets.pbtxt', 'global_step.txt',
               'serving_config.json'):
    with open(os.path.join(path, name), 'rb') as a, open(
        os.path.join(jax_path, name), 'rb') as b:
      assert a.read() == b.read(), name
  assert export_generators.load_exported_variables(path)['params'].keys() \
      == {**model.create_train_state(torch.Generator()).params,
          **model.create_train_state(torch.Generator()).model_state}.keys()


def test_versions_gc_and_tmp_dirs_match_jax(tmp_path):
  for root in (tmp_path / 'a', tmp_path / 'b'):
    for name in ('3', '10', 'tmp-11', 'best_metrics.json', '7', 'serving'):
      (root / name).mkdir(parents=True) if '.' not in name else None
  for module, root in ((export_generators, tmp_path / 'a'),
                       (jax_exports, tmp_path / 'b')):
    assert module.list_exported_versions(str(root)) == [3, 7, 10]
    assert module.next_version(str(root)) > 10
    module.garbage_collect_versions(str(root), 2)
    assert module.list_exported_versions(str(root)) == [7, 10]
  assert sorted(os.listdir(tmp_path / 'a')) == sorted(
      os.listdir(tmp_path / 'b'))


def test_best_and_latest_exporters_decide_as_jax(tmp_path):
  model = _model()
  owner = _Owner(model, str(tmp_path))
  best, latest = exporters.create_default_exporters(model,
                                                    exports_to_keep=2)
  decisions, want = [], []
  for step, loss in enumerate([0.7, 0.8, 0.6, None, 0.65], start=1):
    metrics = {} if loss is None else {'loss': loss}
    state = _state(model, step)
    decisions.append(best.export(owner, state, metrics) is not None)
    latest.export(owner, state, metrics)
    stored = best._load_best(owner)
    want.append(jax_exporters._loss_compare_fn(
        None if step == 1 else previous, metrics))
    previous = stored
  assert decisions == want == [True, False, True, False, False]
  root = os.path.join(str(tmp_path), 'export')
  assert len(export_generators.list_exported_versions(
      os.path.join(root, 'latest_exporter'))) == 2
  assert len(export_generators.list_exported_versions(
      os.path.join(root, 'best_exporter'))) == 2
  # The best survives a restart.
  again, _ = exporters.create_default_exporters(model)
  assert again.export(owner, _state(model, 9), {'loss': 0.61}) is None
  assert again.export(owner, _state(model, 9), {'loss': 0.59}) is not None


def test_the_predictor_skips_tmp_and_falls_back_from_a_vanished_version(
    tmp_path, monkeypatch):
  model = _model()
  root = str(tmp_path)
  generator = export_generators.VariablesExportGenerator()
  generator.set_specification_from_model(model)
  for step, version in ((1, 10), (2, 20), (3, 30)):
    generator.export(root, exporters.serving_variables(
        _state(model, step, 1.0 + step), True), step, version=version)
  os.rename(os.path.join(root, '30'), os.path.join(root, 'tmp-40'))
  load = export_generators.load_exported_variables

  def vanish(version_dir):   # the newest is removed while it is read
    if version_dir.endswith('20'):
      raise FileNotFoundError(version_dir)
    return load(version_dir)

  monkeypatch.setattr(export_generators, 'load_exported_variables', vanish)
  predictor = ExportedModelPredictor(root, model, timeout=1)
  assert predictor.restore()
  assert (predictor.model_version, predictor.global_step) == (10, 1)
  monkeypatch.setattr(export_generators, 'load_exported_variables', load)
  version, variables = predictor.versioned_variables
  assert predictor.restore() and predictor.model_version == 20
  assert predictor.global_step == 2 and version == 10
  assert predictor.versioned_variables[1] is not variables
  assert not ExportedModelPredictor(str(tmp_path / 'none'), model,
                                    timeout=0.05).restore()
  with pytest.raises(ValueError, match='predict function'):
    ExportedModelPredictor(root)


def test_export_hooks_keep_the_lagged_dir_one_behind(tmp_path):
  model, calls = _model(), []
  latest = str(tmp_path / 'latest')
  lagged = str(tmp_path / 'lagged')

  class Builder(HookBuilder):
    def create_hooks(self, t2r_model, trainer):
      return [_Recorder(calls), LaggedCheckpointExportHook(
          latest, lagged, export_every_steps=2,
          export_generator=export_generators.VariablesExportGenerator()),
              CheckpointExportHook(str(tmp_path / 'every'),
                                   export_every_steps=1),
              VariableLoggerHook(log_every_n_steps=2)]

  train_eval.train_eval_model(model, str(tmp_path / 'model'), _random(),
                              max_train_steps=4, save_checkpoints_steps=4,
                              train_hook_builders=[Builder()])
  assert calls[0] == 'begin' and calls[-1] == ('end', 4)
  steps = lambda root: [int(open(os.path.join(  # noqa: E731
      root, str(v), 'global_step.txt')).read())
                        for v in export_generators.list_exported_versions(
                            root)]
  assert steps(latest) == [2, 4] and steps(lagged) == [2]
  assert steps(str(tmp_path / 'every')) == [1, 2, 3, 4][-5:]


# -- continuous eval ------------------------------------------------------------


def test_continuous_eval_evaluates_each_checkpoint_and_writes_none(tmp_path):
  model_dir = str(tmp_path)
  trained = train_eval.train_eval_model(
      _model(), model_dir, _random(), _random(), max_train_steps=4,
      eval_steps=1, eval_throttle_steps=2, save_checkpoints_steps=2)
  with open(os.path.join(model_dir, 'checkpoint_4.pt'), 'rb') as f:
    whole = f.read()
  with open(os.path.join(model_dir, 'checkpoint_5.pt'), 'wb') as f:
    f.write(whole[:len(whole) // 2])   # newest, half written
  before = sorted(os.listdir(model_dir))
  evaluated = train_eval.train_eval_model(
      _model(), model_dir, input_generator_eval=_random(), eval_steps=1,
      eval_timeout_secs=0.5)
  assert [e['step'] for e in evaluated['eval_history']] == [4]
  assert evaluated['eval_metrics'] == trained['eval_metrics']
  after = sorted(os.listdir(model_dir))
  assert [n for n in after if n.startswith('checkpoint_')] == [
      n for n in before if n.startswith('checkpoint_')]
  events = [name for name in os.listdir(os.path.join(model_dir, 'eval'))
            if 'tfevents' in name]
  assert len(events) == 2


# -- the whole slice --------------------------------------------------------------


def _write_records(directory, count=4):
  model = _model()
  pre = model.preprocessor
  spec = {**{'f/' + k: v for k, v in
             pre.get_in_feature_specification('train').items()},
          **{'l/' + k: v for k, v in
             pre.get_in_label_specification('train').items()}}
  rng = np.random.RandomState(3)
  yy, xx = np.mgrid[0:512, 0:640]
  os.makedirs(directory)
  with TFRecordReplayWriter() as writer:
    writer.open(os.path.join(directory, 'train-0.tfrecord'))
    for i in range(count):
      frame = (np.stack([xx + yy, yy * 2, xx], -1) * (i + 1)) % 256
      ok, jpeg = cv2.imencode('.jpg', frame.astype(np.uint8))
      assert ok
      example = {k: rng.uniform(-1, 1, shape).astype(dtype)
                 for k, (shape, dtype) in spec.items()
                 if k.startswith('f/action')}
      example['f/state/image'] = jpeg.tobytes()
      example['l/reward'] = np.float32([i % 2])
      writer.write_numpy(spec, example)
  return os.path.join(directory, 'train-*')


def test_gin_records_to_exports_to_serve_export_dir(tmp_path, capsys):
  """train_qtopt.gin from records written by the port's writer, with
  evals and the default exporters; serve.py --export_dir serves the
  latest export, and its actions equal CheckpointPredictor's on the same
  step."""
  from tensor2robot_tpu_torch.serving import serve

  pattern = _write_records(str(tmp_path / 'data'))
  model_dir = str(tmp_path / 'model')
  argv = ['--device', 'cpu', '--model_dir', model_dir, '--gin_configs',
          PORT_GIN]
  for binding in (
      "TRAIN_DATA = '{}'".format(pattern), 'TRAIN_BATCH_SIZE = 2',
      "Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom."
      "network_kwargs = {'num_convs': (1, 1, 1)}",
      'train_eval_model.input_generator_eval = '
      '@eval_input_generator/DefaultRecordInputGenerator()',
      'eval_input_generator/DefaultRecordInputGenerator.file_patterns = '
      '%TRAIN_DATA',
      'eval_input_generator/DefaultRecordInputGenerator.batch_size = 2',
      'train_eval_model.max_train_steps = 2',
      'train_eval_model.eval_throttle_steps = 1',
      'train_eval_model.eval_steps = 1',
      'train_eval_model.save_checkpoints_steps = 2'):
    argv += ['--gin_bindings', binding]
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main(argv) == 0
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  assert line['data'] == 'native' and line['step'] == 2
  assert [e['step'] for e in line['eval_history']] == [1, 2]
  latest = os.path.join(model_dir, 'export', 'latest_exporter')
  assert len(export_generators.list_exported_versions(latest)) == 2
  assert export_generators.list_exported_versions(
      os.path.join(model_dir, 'export', 'best_exporter'))
  assert os.path.exists(os.path.join(model_dir, 'operative_config.gin'))
  assert os.path.exists(os.path.join(model_dir, 'eval'))
  _, _, step = assets.load_t2r_assets_from_file(os.path.join(
      latest, str(export_generators.list_exported_versions(latest)[-1]),
      'assets.extra', 't2r_assets.pbtxt'))
  assert step == 2

  assert serve.main(['--device', 'cpu', '--export_dir', latest,
                     '--synthetic_load', '2', '--duration', '1',
                     '--num_convs', '1,1,1', '--max_batch_size', '2',
                     '--cem_samples', '4', '--cem_iters', '2',
                     '--num_elites', '2']) == 0
  stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert stats['failed'] == 0 and stats['completed'] > 0
  assert stats['params_version'] == export_generators.list_exported_versions(
      latest)[-1]

  model = _model()
  from_export = ExportedModelPredictor(latest, model)
  from_checkpoint = CheckpointPredictor(model, model_dir)
  assert from_export.restore() and from_checkpoint.restore()
  assert from_export.global_step == from_checkpoint.global_step == 2
  rng = np.random.RandomState(4)
  states = {'image': rng.randint(0, 256, (2, 512, 640, 3)).astype(np.uint8),
            'gripper_closed': rng.rand(2).astype(np.float32),
            'height_to_bottom': rng.rand(2).astype(np.float32)}
  select = model.make_batched_select_action(**CEM)
  got = select(from_export.variables, states, 3)
  want = select(from_checkpoint.variables, states, 3)
  np.testing.assert_allclose(got['action'].numpy(), want['action'].numpy(),
                             rtol=0, atol=1e-4)
  np.testing.assert_allclose(got['q'].numpy(), want['q'].numpy(), rtol=0,
                             atol=1e-4)
  features = {'state/image': states['image'][:1]}
  for key, size in t2r_models.ACTION_DIM_LAYOUT:
    features['action/' + key] = np.zeros((1, size), np.float32)
  for key in ('gripper_closed', 'height_to_bottom'):
    features['action/' + key] = np.zeros((1, 1), np.float32)
  np.testing.assert_allclose(from_export.predict(features)['q_predicted'],
                             from_checkpoint.predict(features)['q_predicted'],
                             rtol=0, atol=1e-6)
