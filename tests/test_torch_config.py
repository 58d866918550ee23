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
* Seq2Act's gins: the port's copies of ``train_seq2act_bc.gin`` and
  ``train_seq2act_moe.gin`` bind what JAX's bind and name only registered
  configurables (``EP_RULES_MOE`` among them); ``main_gin`` trains both on
  the CPU at a small size, their ``device_type = "tpu"`` in bfloat16 (a
  float32 binding trains too), the MoE gin with 8 experts, top 2 and aux
  weight 0.01; the MoE gin's ``tp_rules`` decline (no expert group), and a
  rule that would shard raises. With ``Seq2ActBCModel.attention_mode =
  "ring"`` under a torchrun-like environment of two gloo ranks
  (``_torch_ring_worker.run_gin``), ``main_gin`` builds the group, hands
  it to the model and destroys it, and its loss after 2 steps equals the
  flags path's (``--attention_mode ring``) on the same model and seed.
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
from tensor2robot_tpu_torch.trainer import checkpointing
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
    'train_seq2act_bc.gin': (
        'tensor2robot_tpu/research/seq2act/configs/train_seq2act_bc.gin',
        'tensor2robot_tpu_torch/research/seq2act/configs/'
        'train_seq2act_bc.gin'),
    'train_seq2act_moe.gin': (
        'tensor2robot_tpu/research/seq2act/configs/train_seq2act_moe.gin',
        'tensor2robot_tpu_torch/research/seq2act/configs/'
        'train_seq2act_moe.gin'),
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
  for path in (GINS['train_qtopt_sparse.gin'][1], SEQ2ACT_GIN,
               GINS['train_seq2act_moe.gin'][1]):
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
               'Seq2ActBCModel', 'train_eval_model', 'EP_RULES_MOE'):
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


# Seq2Act at a small size, as --gin_bindings on top of a gin.
SEQ2ACT_SMALL = dict(episode_length=2, action_size=3, vocab_size=16,
                     img_res=(32, 32), src_img_res=(36, 40),
                     tokens_per_frame=4, embed_dim=32, num_layers=1,
                     num_heads=2, head_dim=16, mlp_dim=64,
                     tokenizer_widths=(8, 16, 16, 32), attention_mode='xla')


def _seq2act_argv(tmp_path, *bindings, gin=SEQ2ACT_GIN, steps=1):
  argv = ['--device', 'cpu', '--model_dir', str(tmp_path),
          '--gin_configs', gin]
  for key, value in SEQ2ACT_SMALL.items():
    argv += ['--gin_bindings', 'Seq2ActBCModel.{} = {!r}'.format(key, value)]
  for binding in ('train_eval_model.input_generator_train = '
                  '@DefaultRandomInputGenerator()',
                  'DefaultRandomInputGenerator.batch_size = 1',
                  'train_eval_model.max_train_steps = {}'.format(steps)
                  ) + bindings:
    argv += ['--gin_bindings', binding]
  return argv


def _main_line(argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    assert train_eval.main(argv) == 0
  return json.loads(out.getvalue().strip().splitlines()[-1])


def test_seq2act_gin_refuses_tpu_and_trains_in_float32(tmp_path,
                                                       monkeypatch):
  """The gin's device_type = "tpu" trains in bfloat16 (float32 params and
  loss); a "gpu" binding trains in float32."""
  captured = []
  original = train_eval.Trainer.__init__

  def recording(self, model, *args, **kwargs):
    captured.append(model)
    original(self, model, *args, **kwargs)

  monkeypatch.setattr(train_eval.Trainer, '__init__', recording)
  line = _main_line(_seq2act_argv(tmp_path / 'tpu'))
  assert line['model'] == 'Seq2ActBCModel' and line['step'] == 1
  assert np.isfinite(line['metrics']['loss'])
  assert captured[0].compute_dtype == torch.bfloat16
  state = checkpointing.CheckpointManager(str(tmp_path / 'tpu')).restore()
  assert all(v.dtype == torch.float32 for v in state.params.values())
  line = _main_line(_seq2act_argv(tmp_path / 'gpu',
                                  'Seq2ActBCModel.device_type = "gpu"'))
  assert line['model'] == 'Seq2ActBCModel' and line['step'] == 1
  assert np.isfinite(line['metrics']['loss'])
  with open(tmp_path / 'gpu' / 'operative_config.gin') as f:
    operative = f.read()
  assert "Seq2ActBCModel.device_type = 'gpu'" in operative
  assert "Seq2ActBCModel.device = 'cpu'" in operative
  assert captured[1].compute_dtype == torch.float32
  assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize('name', ['train_seq2act_bc.gin',
                                  'train_seq2act_moe.gin'])
def test_the_seq2act_gins_train_two_steps_through_main_gin(tmp_path, name):
  line = _main_line(_seq2act_argv(
      tmp_path, gin=os.path.join(REPO, GINS[name][1]), steps=2))
  assert line['model'] == 'Seq2ActBCModel' and line['step'] == 2
  assert line['checkpoint_step'] == 2 and line['world_size'] == 1
  assert np.isfinite(line['metrics']['loss'])
  with open(tmp_path / 'operative_config.gin') as f:
    operative = f.read()
  assert "Seq2ActBCModel.device_type = 'tpu'" in operative
  if name == 'train_seq2act_moe.gin':
    assert "Seq2ActBCModel.moe_experts = 8" in operative
    assert 'train_eval_model.tp_rules' in operative
    state = checkpointing.CheckpointManager(str(tmp_path)).restore()
    assert tuple(state.params['transformer.block0.moe.w_in'].shape) == (
        8, 32, 64)


def test_the_moe_gin_builds_its_model_and_its_rules_decline(both):
  _, engine = both
  config.register_framework_configurables()
  engine.parse_config_files_and_bindings(
      [GINS['train_seq2act_moe.gin'][1]],
      ['Seq2ActBCModel.device = "cpu"',
       'Seq2ActBCModel.episode_length = 2',
       'Seq2ActBCModel.num_layers = 1'])
  engine.check_configurables()
  model = engine.query_parameter('train_eval_model.t2r_model')
  assert model.compute_dtype == torch.bfloat16
  assert model._moe_aux_weight == 0.01 and model._ep_axis == 'expert'
  moe = model.network.transformer.block0.moe
  assert moe.num_experts == 8 and moe.top_k == 2
  assert moe.capacity_factor == 1.25 and moe.dtype == torch.bfloat16
  assert tuple(moe.w_in.shape) == (8, 512, 2048)
  rules = engine.query_parameter('train_eval_model.tp_rules')
  from tensor2robot_tpu_torch.parallel import sharding
  assert rules == sharding.EP_RULES_MOE
  params = dict(model.network.state_dict())
  sharding.check_rules_decline(params, rules, {'data': 1})
  sharding.check_rules_decline(params, rules, {'expert': 3})  # indivisible
  assert sharding.param_path('transformer.block0.moe.w_in') == (
      'params/transformer/block0/moe/w_in')
  with pytest.raises(NotImplementedError, match='next slice'):
    sharding.check_rules_decline(params, rules, {'expert': 4})


def test_ring_under_a_gin_equals_the_flags_ring(tmp_path):
  """Two gloo ranks as torchrun starts them: ``train_eval.main`` with
  ``--attention_mode ring`` and with the gin binding it, the same full
  width model (the flags path's), seed and random episodes; rank 0's
  losses after 2 steps are equal."""
  import torch.multiprocessing as torch_mp

  import _torch_ring_worker

  def free_port():
    with socket.socket() as s:
      s.bind(('127.0.0.1', 0))
      return s.getsockname()[1]

  common = ['--device', 'cpu', '--log_every_n_steps', '1']
  flags = common + ['--model', 'seq2act', '--attention_mode', 'ring',
                    '--episode_length', '4', '--batch_size', '1',
                    '--max_train_steps', '2',
                    '--model_dir', str(tmp_path / 'flags')]
  gin = common + ['--model_dir', str(tmp_path / 'gin'),
                  '--gin_configs', SEQ2ACT_GIN]
  for binding in ('Seq2ActBCModel.episode_length = 4',
                  'Seq2ActBCModel.attention_mode = "ring"',
                  'Seq2ActBCModel.device_type = "gpu"',
                  'train_eval_model.input_generator_train = '
                  '@DefaultRandomInputGenerator()',
                  'DefaultRandomInputGenerator.batch_size = 1',
                  'train_eval_model.log_every_n_steps = 1',
                  'train_eval_model.max_train_steps = 2'):
    gin += ['--gin_bindings', binding]
  torch.save({'flags_argv': flags, 'gin_argv': gin,
              'flags_port': free_port(), 'gin_port': free_port()},
             str(tmp_path / 'gin_plan.pt'))
  context = torch_mp.start_processes(
      _torch_ring_worker.run_gin, args=(2, str(tmp_path)), nprocs=2,
      join=False, start_method='spawn')
  deadline = time.monotonic() + 300
  try:
    done = False
    while not done and time.monotonic() < deadline:
      done = context.join(timeout=max(deadline - time.monotonic(), 0.1))
  finally:
    for process in context.processes:
      if process.is_alive():
        process.kill()
  assert done, 'a rank did not finish'
  ranks = [torch.load(str(tmp_path / 'gin_rank{}.pt'.format(r)),
                      weights_only=False) for r in range(2)]
  assert all(r['flags_rc'] == r['gin_rc'] == 0 for r in ranks)
  assert not any(r['flags_group_left'] or r['gin_group_left']
                 for r in ranks)
  assert ranks[1]['gin_out'].strip() == ''        # rank 0 prints
  flags_line = json.loads(ranks[0]['flags_out'].strip().splitlines()[-1])
  gin_line = json.loads(ranks[0]['gin_out'].strip().splitlines()[-1])
  assert gin_line['world_size'] == flags_line['world_size'] == 2
  assert gin_line['step'] == flags_line['step'] == 2
  assert gin_line['model'] == 'Seq2ActBCModel'
  assert np.isfinite(gin_line['metrics']['loss'])
  assert gin_line['metrics'] == flags_line['metrics']
