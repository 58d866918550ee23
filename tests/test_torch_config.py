"""The port's config package, gins, t2r_assets and TensorBoard writer
against the JAX package's, on the CPU.

* ``config/ginlike.py``: the same gin texts parse into the same bindings
  (``config_str``), give the same values (``query_parameter``) and the
  same error texts; the port's copies of the QT-Opt gins bind what JAX's
  bind; a gin naming a configurable the port lacks fails, naming it.
* ``specs/assets.py``: the critic's specifications as t2r_assets text,
  byte for byte.
* ``trainer/metrics.py``: event files byte for byte, with the wall time
  and the host fixed, and each package reads the other's.
* Seq2Act's gin parses in the port; its ``device_type = "tpu"`` (bfloat16
  training) is refused by name, and a float32 binding trains.
"""

import contextlib
import io
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu.config import ginlike as jax_ginlike
from tensor2robot_tpu.specs import assets as jax_assets
from tensor2robot_tpu.trainer import metrics as jax_metrics
from tensor2robot_tpu_torch import config
from tensor2robot_tpu_torch.config import ginlike
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.specs import assets
from tensor2robot_tpu_torch.trainer import metrics
from tensor2robot_tpu_torch.trainer import train_eval
# The JAX critic's import shim (a module fixture).
from test_torch_qtopt import ref  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GINS = {
    'train_qtopt.gin': (
        'tensor2robot_tpu/research/qtopt/configs/train_qtopt.gin',
        'tensor2robot_tpu_torch/research/qtopt/configs/train_qtopt.gin'),
    'train_qtopt_sparse.gin': (
        'tensor2robot_tpu/research/qtopt/configs/train_qtopt_sparse.gin',
        'tensor2robot_tpu_torch/research/qtopt/configs/'
        'train_qtopt_sparse.gin'),
}
SEQ2ACT_GIN = os.path.join(
    REPO, 'tensor2robot_tpu/research/seq2act/configs/train_seq2act_bc.gin')


@pytest.fixture
def both():
  """Both engines with empty bindings and the repository as a search path
  (the bindings cleared and the paths restored afterwards)."""
  paths = []
  for engine in (jax_ginlike, ginlike):
    paths.append(list(engine._SEARCH_PATHS))
    engine.clear_config()
    engine.add_config_file_search_path(REPO)
  yield jax_ginlike, ginlike
  for engine, saved in zip((jax_ginlike, ginlike), paths):
    engine.clear_config()
    engine._SEARCH_PATHS[:] = saved


TEXT = '''
# Every form the gins use.
DATA = "/data/train*"
BATCH = 32
RATES = [1e-4, 3e-3]
scope_a/cfg_gen.file_patterns = %DATA
scope_a/cfg_gen.batch_size = %BATCH
cfg_gen.batch_size = 8
cfg_model.rates = %RATES
cfg_model.shape = (472, 472)
cfg_model.kwargs = {'num_convs': (6, 6, 3), 'on': True}
cfg_run.model = @cfg_model()
cfg_run.gen = @scope_a/cfg_gen()
cfg_run.fn = @cfg_gen
cfg_run.name = 'qtopt'  # a comment
'''


def _register(engine):
  calls = []

  def cfg_gen(file_patterns='', batch_size=1):
    return ('gen', file_patterns, batch_size)

  def cfg_model(rates=(), shape=(), kwargs=None):
    return ('model', rates, shape, kwargs)

  def cfg_run(model=None, gen=None, fn=None, name=''):
    calls.append(name)
    return model, gen, fn(), name

  for fn in (cfg_gen, cfg_model, cfg_run):
    engine.external_configurable(fn, module='tests')
  return calls


def test_the_same_text_gives_the_same_bindings_and_values(both):
  jax_engine, engine = both
  for e in both:
    _register(e)
    e.parse_config(TEXT)
  assert engine.config_str() == jax_engine.config_str()
  for key in ('scope_a/cfg_gen.file_patterns', 'cfg_model.rates',
              'cfg_model.kwargs', 'cfg_model.shape', 'cfg_run.name'):
    assert engine.query_parameter(key) == jax_engine.query_parameter(key)
  assert (engine.get_configurable('cfg_run')() ==
          jax_engine.get_configurable('cfg_run')())
  assert engine.get_configurable('tests.cfg_run')()[1] == (
      'gen', '/data/train*', 32)
  # The same bindings consumed (values that are objects print their
  # addresses).
  assert ([line.split(' = ')[0] for line in
           engine.operative_config_str().splitlines()] ==
          [line.split(' = ')[0] for line in
           jax_engine.operative_config_str().splitlines()])
  engine.check_configurables()


@pytest.mark.parametrize('text,call', [
    ('this is not gin', None),
    ('cfg_run.model = @cfg_model(', None),
    ("cfg_run.name = 'a' 'b'", None),
    ('cfg_run.name = %UNDEFINED', 'query'),
    ('cfg_run.model = @cfg_nothing()', 'call'),
    ('cfg_run.bogus = 1', 'call'),
])
def test_errors_have_the_jax_texts(both, text, call):
  messages = []
  for e in both:
    _register(e)
    with pytest.raises(Exception) as error:
      e.parse_config(text)
      if call == 'query':
        e.query_parameter('cfg_run.name')
      elif call == 'call':
        e.get_configurable('cfg_run')()
    messages.append((type(error.value).__name__, str(error.value)))
  assert messages[0] == messages[1]


def test_a_configurable_the_port_lacks_fails_by_name(both):
  _, engine = both
  _register(engine)
  engine.parse_config('cfg_run.model = @MAMLRegressionModel()')
  with pytest.raises(ginlike.ConfigError, match='MAMLRegressionModel'):
    engine.check_configurables()
  engine.clear_config()
  engine.parse_config('PoseEnvRegressionModel.batch = 1')
  with pytest.raises(ginlike.ConfigError, match='PoseEnvRegressionModel'):
    engine.check_configurables()


@pytest.mark.parametrize('name', sorted(GINS))
def test_the_ports_gins_bind_what_jaxs_bind(both, name):
  jax_engine, engine = both
  jax_path, port_path = GINS[name]
  jax_engine.parse_config_files_and_bindings([jax_path])
  engine.parse_config_files_and_bindings([port_path])
  assert engine.config_str() == jax_engine.config_str()
  with open(os.path.join(REPO, jax_path)) as f:
    want = f.read().replace('include \'tensor2robot_tpu/',
                            'include \'tensor2robot_tpu_torch/')
  with open(os.path.join(REPO, port_path)) as f:
    assert f.read() == want
  config.register_framework_configurables()
  engine.check_configurables()


def test_every_gin_name_of_the_two_workloads_is_registered(both):
  _, engine = both
  config.register_framework_configurables()
  for path in (GINS['train_qtopt_sparse.gin'][1], SEQ2ACT_GIN):
    engine.clear_config()
    engine.parse_config_files_and_bindings([path])
    engine.check_configurables()
  for name in ('create_sgd_optimizer', 'create_momentum_optimizer',
               'create_rms_prop_optimizer', 'create_adam_optimizer',
               'create_constant_learning_rate',
               'create_exponential_decay_learning_rate',
               'piecewise_constant_learning_rate', 'create_default_exporters',
               'DefaultExportGenerator', 'AsyncExportHookBuilder',
               'TD3Hooks', 'VariableLoggerHook',
               'DefaultGrasping44ImagePreprocessor',
               'wrap_model_with_device_decode', 'DefaultRecordInputGenerator',
               'Seq2ActBCModel', 'train_eval_model'):
    engine.get_configurable(name)


def test_the_critics_assets_are_jaxs_byte_for_byte(ref, tmp_path):
  jax_model = ref.t2r_models.\
      Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device_type='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': (1, 1, 1)})
  for mode in (ModeKeys.TRAIN, ModeKeys.PREDICT):
    want = jax_assets.specs_to_pbtxt(
        jax_model.preprocessor.get_in_feature_specification(mode),
        jax_model.get_label_specification(mode), 7)
    got = assets.specs_to_pbtxt(
        model.preprocessor.get_in_feature_specification(mode),
        model.get_label_specification(mode), 7)
    assert got == want
  path = str(tmp_path / 'assets.extra' / assets.T2R_ASSETS_FILENAME)
  assets.write_t2r_assets_to_file(
      model.preprocessor.get_in_feature_specification(ModeKeys.PREDICT),
      model.get_label_specification(ModeKeys.PREDICT), 7, path)
  jax_features, jax_labels, step = jax_assets.load_t2r_assets_from_file(path)
  features, labels, again = assets.load_t2r_assets_from_file(path)
  assert step == again == 7
  for key, spec in features.items():
    want = jax_features[key]
    assert (spec.shape, spec.dtype, spec.name, spec.data_format) == (
        tuple(want.shape), want.dtype, want.name, want.data_format), key
  assert set(labels) == set(jax_labels)
  with open(path) as f:
    pbtxt_features, _, pbtxt_step = assets.pbtxt_to_specs(f.read())
  assert pbtxt_step == 7 and pbtxt_features == features


def test_event_files_are_jaxs_byte_for_byte(tmp_path, monkeypatch):
  monkeypatch.setattr(time, 'time', lambda: 1700000000.25)
  monkeypatch.setattr(socket, 'gethostname', lambda: 'host')
  rng = np.random.RandomState(0)
  image = (rng.uniform(0, 1, (2, 4, 5, 3))).astype(np.float32)
  histogram = rng.randn(50)
  written = []
  for writer_cls, name in ((jax_metrics.MetricsWriter, 'jax'),
                           (metrics.MetricsWriter, 'port')):
    writer = writer_cls(str(tmp_path / name))
    writer.write_scalars(3, {'loss': 0.25, 'examples/sec': 1e3})
    writer.write_images(3, {'image': image})
    writer.write_histograms(4, {'weights': histogram})
    writer.close()
    (path,) = [os.path.join(writer.log_dir, f)
               for f in os.listdir(writer.log_dir)]
    with open(path, 'rb') as f:
      written.append(f.read())
  assert written[0] == written[1]
  assert os.listdir(tmp_path / 'port')[0].endswith(
      '.1700000000.host.{}'.format(os.getpid()))
  ours = metrics.read_events(str(tmp_path / 'jax'))
  theirs = jax_metrics.read_events(str(tmp_path / 'port'))
  assert ours == theirs and ours[0] == (3, {'loss': 0.25,
                                            'examples/sec': 1000.0})


def _seq2act_argv(tmp_path, *bindings):
  small = dict(episode_length=2, action_size=3, vocab_size=16,
               img_res=(32, 32), src_img_res=(36, 40), tokens_per_frame=4,
               embed_dim=32, num_layers=1, num_heads=2, head_dim=16,
               mlp_dim=64, tokenizer_widths=(8, 16, 16, 32),
               attention_mode='xla')
  argv = ['--device', 'cpu', '--model_dir', str(tmp_path),
          '--gin_configs', SEQ2ACT_GIN]
  for key, value in small.items():
    argv += ['--gin_bindings', 'Seq2ActBCModel.{} = {!r}'.format(key, value)]
  for binding in ('train_eval_model.input_generator_train = '
                  '@DefaultRandomInputGenerator()',
                  'DefaultRandomInputGenerator.batch_size = 1',
                  'train_eval_model.max_train_steps = 1') + bindings:
    argv += ['--gin_bindings', binding]
  return argv


def test_seq2act_gin_refuses_tpu_and_trains_in_float32(tmp_path):
  with pytest.raises(NotImplementedError,
                     match='Seq2ActBCModel.device_type = "tpu"'):
    train_eval.main(_seq2act_argv(tmp_path / 'tpu'))
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main(_seq2act_argv(
        tmp_path / 'gpu', 'Seq2ActBCModel.device_type = "gpu"')) == 0
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  assert line['model'] == 'Seq2ActBCModel' and line['step'] == 1
  assert np.isfinite(line['metrics']['loss'])
  with open(tmp_path / 'gpu' / 'operative_config.gin') as f:
    operative = f.read()
  assert "Seq2ActBCModel.device_type = 'gpu'" in operative
  assert "Seq2ActBCModel.device = 'cpu'" in operative
  assert torch.get_default_dtype() == torch.float32
