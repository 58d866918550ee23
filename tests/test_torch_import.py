"""The PyTorch port imports no JAX and nothing of the JAX package.

``tensor2robot_tpu_torch`` starts with ``tensor2robot_tpu``, so every check
matches the JAX package's name followed by a dot or a space, or as a whole
module name, never as a prefix.
"""

import inspect
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'tensor2robot_tpu_torch')

_FORBIDDEN = re.compile(
    r'^\s*(import|from)\s+(jax|flax|optax|orbax)\b|\btensor2robot_tpu[. ]',
    re.MULTILINE)


# The Seq2Act serving slice's modules, each imported by the check above.
SEQ2ACT_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'export.export_generators', 'layers.transformer',
    'meta_learning.meta_data', 'parallel.flash_attention',
    'policies.policies', 'predictors.abstract_predictor',
    'predictors.checkpoint_predictor', 'research.seq2act.seq2act_model',
    'research.vrgripper.decoders'))


# The Seq2Act training slice's modules.
SEQ2ACT_TRAINING_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'convert', 'data.input_generators', 'kernels', 'models.abstract_model',
    'models.optimizers', 'preprocessors.image_transformations',
    'preprocessors.pallas_crop', 'trainer.checkpointing',
    'trainer.train_eval'))


# The ring attention slice's modules.
RING_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'parallel.collectives', 'parallel.mesh', 'parallel.ring_attention'))


# The records-to-serving slice's modules.
RECORDS_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'data.native_loader', 'data.parser', 'data.pipeline', 'data.tfrecord',
    'data.wire', 'data.writer', 'specs.algebra', 'specs.tensor_spec',
    'serving.serve'))


# The split decode slice's modules.
DEVICE_DECODE_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'data.device_feed', 'data.jpeg_device', 'preprocessors.device_decode'))


# The gin-driven slice's modules.
GIN_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'config', 'config.ginlike', 'config.registry', 'export.exporters',
    'hooks', 'hooks.async_export_hook_builder', 'hooks.checkpoint_hooks',
    'hooks.hook_builder', 'hooks.td3', 'hooks.variable_logger_hook',
    'predictors.exported_model_predictor', 'specs.assets',
    'trainer.metrics'))


# The off-policy QT-Opt slice's modules.
OFFPOLICY_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'models.critic_model', 'policies.policies',
    'research.qtopt.grasping_sim', 'rl', 'rl.collect_eval', 'rl.offpolicy',
    'rl.run_collect_eval', 'rl.run_env', 'utils.image'))


# The live actor-learner loop slice's modules.
RL_LOOP_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'envs', 'envs.grasping', 'envs.vec_env', 'observability.rl_metrics',
    'reliability', 'reliability.errors', 'reliability.fault_injection',
    'reliability.quarantine', 'reliability.retry',
    'replay', 'replay.client', 'replay.feed', 'replay.frontend',
    'replay.run_replay', 'replay.sampling', 'replay.service',
    'replay.store', 'replay.wire', 'rl.loop', 'rl.run_rl_loop'))


# The fault-tolerance slice's modules (with the pusher env, the five small
# modules and the initializers).
FAULT_TOLERANCE_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'layers.initializers', 'models.classification_model',
    'observability.goodput', 'observability.spans', 'reliability.preemption',
    'research.dql_grasping', 'research.pusher_env', 'utils.convert_pkl_assets',
    'utils.global_step_functions', 'utils.subsample'))


# The Grasp2Vec and MAML slice's modules.
GRASP2VEC_MAML_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'layers.basic', 'layers.resnet', 'layers.spatial_softmax',
    'layers.vision_layers', 'meta_learning', 'meta_learning.maml_inner_loop',
    'meta_learning.maml_model', 'meta_learning.meta_example',
    'meta_learning.meta_policies', 'meta_learning.preprocessors',
    'meta_learning.run_meta_env', 'models.regression_model',
    'preprocessors.abstract_preprocessor',
    'preprocessors.spec_transformation_preprocessor', 'research.grasp2vec',
    'research.grasp2vec.grasp2vec_model', 'research.grasp2vec.losses',
    'research.grasp2vec.visualization', 'research.pose_env',
    'research.pose_env.episode_to_transitions', 'research.pose_env.pose_env',
    'research.pose_env.pose_env_maml_models',
    'research.pose_env.pose_env_models'))

# The vrgripper and Watch-Try-Learn slice's modules and gins.
VRGRIPPER_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'layers.maf', 'layers.mdn', 'layers.snail', 'layers.tec',
    'research.vrgripper', 'research.vrgripper.decoders',
    'research.vrgripper.episode_to_transitions',
    'research.vrgripper.vrgripper_env_meta_models',
    'research.vrgripper.vrgripper_env_models',
    'research.vrgripper.vrgripper_env_wtl_models'))
VRGRIPPER_GINS = tuple('research/vrgripper/configs/' + name for name in (
    'run_train_wtl_vision_trial.gin', 'run_train_wtl_vision_retrial.gin',
    'train_vrgripper_tec.gin', 'run_train_wtl_statespace_trial.gin',
    'run_train_wtl_statespace_retrial.gin'))
# The gins of that slice.
GRASP2VEC_MAML_GINS = (
    'research/grasp2vec/configs/train_grasp2vec.gin',
    'research/pose_env/configs/run_collect_pose_env.gin',
    'research/pose_env/configs/train_pose_env.gin',
    'research/pose_env/configs/train_pose_env_from_records.gin',
    'research/pose_env/configs/run_train_reg_maml.gin')

# The serving fleet slice's modules.
FLEET_MODULES = tuple('tensor2robot_tpu_torch.' + name for name in (
    'serving.admission', 'serving.batcher', 'serving.fleet',
    'serving.fleet_bench', 'serving.router'))


def _port_sources():
  for root, _, files in os.walk(PORT):
    for name in sorted(files):
      if name.endswith(('.py', '.cu', '.cuh', '.cc')):
        yield os.path.join(root, name)
  yield os.path.join(REPO, 'chip_smoke.py')
  yield os.path.join(REPO, 'flash_ab.py')


def test_importing_every_module_loads_no_jax():
  script = textwrap.dedent('''
      import importlib, pkgutil, sys
      import tensor2robot_tpu_torch as port
      names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                     'tensor2robot_tpu_torch.')]
      for name in names:
        importlib.import_module(name)
      import chip_smoke
      bad = sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                          'tensor2robot_tpu'))
      assert not bad, bad
      print(' '.join(names))
      ''')
  env = dict(os.environ, PYTHONPATH=REPO)
  result = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr
  names = set(result.stdout.split())
  assert len(names) >= 40
  assert set(SEQ2ACT_MODULES) <= names, set(SEQ2ACT_MODULES) - names
  assert set(SEQ2ACT_TRAINING_MODULES) <= names, (
      set(SEQ2ACT_TRAINING_MODULES) - names)
  assert set(RING_MODULES) <= names, set(RING_MODULES) - names
  assert set(RECORDS_MODULES) <= names, set(RECORDS_MODULES) - names
  assert set(DEVICE_DECODE_MODULES) <= names, (
      set(DEVICE_DECODE_MODULES) - names)
  assert set(GIN_MODULES) <= names, set(GIN_MODULES) - names
  assert set(OFFPOLICY_MODULES) <= names, set(OFFPOLICY_MODULES) - names
  assert set(RL_LOOP_MODULES) <= names, set(RL_LOOP_MODULES) - names
  assert set(GRASP2VEC_MAML_MODULES) <= names, (
      set(GRASP2VEC_MAML_MODULES) - names)
  assert set(VRGRIPPER_MODULES) <= names, set(VRGRIPPER_MODULES) - names
  assert set(FAULT_TOLERANCE_MODULES) <= names, (
      set(FAULT_TOLERANCE_MODULES) - names)
  assert set(FLEET_MODULES) <= names, set(FLEET_MODULES) - names


def test_registering_the_configurables_loads_no_jax():
  script = textwrap.dedent('''
      import sys
      from tensor2robot_tpu_torch import config
      config.register_framework_configurables()
      for gin in ('train_qtopt_sparse.gin', 'run_collect_grasping_sim.gin',
                  'run_collect_grasping_sim_cem.gin'):
        config.clear_config()
        config.parse_config_files_and_bindings([
            'tensor2robot_tpu_torch/research/qtopt/configs/' + gin])
        config.check_configurables()
      bad = sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                          'orbax', 'tensor2robot_tpu'))
      assert not bad, bad
      ''')
  env = dict(os.environ, PYTHONPATH=REPO)
  result = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr


@pytest.mark.parametrize('gin', GRASP2VEC_MAML_GINS)
def test_the_grasp2vec_and_pose_env_gins_load_no_jax(gin):
  """Each gin of the Grasp2Vec and MAML slice parses and names only
  registered configurables, its model built on the default card, with no
  JAX loaded."""
  script = textwrap.dedent('''
      import sys
      import torch
      from tensor2robot_tpu_torch import config
      config.register_framework_configurables()
      config.parse_config_files_and_bindings([
          'tensor2robot_tpu_torch/{}'])
      config.check_configurables()
      try:
        model = config.query_parameter('train_eval_model.t2r_model')
      except config.ConfigError:
        model = None
      if model is not None:
        assert model.device == torch.device('cuda'), model.device
      bad = sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                          'orbax', 'tensor2robot_tpu'))
      assert not bad, bad
      ''').format(gin)
  env = dict(os.environ, PYTHONPATH=REPO)
  result = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr


def test_the_vrgripper_gins_load_no_jax():
  """The five vrgripper and Watch-Try-Learn gins parse and name only
  registered configurables, each model built on the default card, with no
  JAX loaded (one process for the five)."""
  script = textwrap.dedent('''
      import sys
      import torch
      from tensor2robot_tpu_torch import config
      config.register_framework_configurables()
      for gin in {!r}:
        config.clear_config()
        config.parse_config_files_and_bindings(['tensor2robot_tpu_torch/' +
                                                gin])
        config.check_configurables()
        model = config.query_parameter('train_eval_model.t2r_model')
        assert model.device == torch.device('cuda'), (gin, model.device)
      bad = sorted(m for m in sys.modules
                   if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                          'orbax', 'tensor2robot_tpu'))
      assert not bad, bad
      ''').format(VRGRIPPER_GINS)
  env = dict(os.environ, PYTHONPATH=REPO)
  result = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode == 0, result.stderr


def test_static_scan_finds_no_jax_import():
  hits = []
  for path in _port_sources():
    with open(path, encoding='utf-8') as f:
      for match in _FORBIDDEN.finditer(f.read()):
        hits.append('{}: {!r}'.format(os.path.relpath(path, REPO),
                                      match.group(0)))
  assert not hits, hits


def test_the_port_builds_its_own_record_loader():
  from tensor2robot_tpu_torch.data import native_loader

  assert os.path.commonpath([str(native_loader.SOURCE), PORT]) == PORT
  assert native_loader.SOURCE.name == 'record_loader.cc'


def test_scan_pattern_tells_the_packages_apart():
  assert _FORBIDDEN.search('from tensor2robot_tpu.serving import x')
  assert _FORBIDDEN.search('import tensor2robot_tpu as t')
  assert _FORBIDDEN.search('  import jax.numpy as jnp')
  assert _FORBIDDEN.search('from flax import linen')
  assert not _FORBIDDEN.search('from tensor2robot_tpu_torch.serving import x')
  assert not _FORBIDDEN.search('weights from flax are converted')


def test_entry_points_default_to_cuda():
  from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.research.qtopt import grasping_sim
  from tensor2robot_tpu_torch.rl import run_collect_eval
  from tensor2robot_tpu_torch.serving import serve

  from tensor2robot_tpu_torch.trainer import train_eval

  args = serve.make_parser().parse_args(['--init_randomly'])
  assert args.device == 'cuda'
  assert train_eval.make_parser().parse_args(
      ['--model_dir', 'unused']).device == 'cuda'
  seq2act_args = train_eval.make_parser().parse_args(
      ['--model_dir', 'unused', '--model', 'seq2act'])
  assert train_eval.make_model(seq2act_args, torch.device(
      seq2act_args.device)).device == torch.device('cuda')
  assert inspect.signature(serve.build_policy).parameters[
      'device'].default == 'cuda'
  assert inspect.signature(AbstractT2RModel).parameters[
      'device'].default == 'cuda'
  assert run_collect_eval.make_parser().parse_args([]).device == 'cuda'
  assert grasping_sim.make_sim_critic_model().device == torch.device('cuda')
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel

  model = (t2r_models.
           Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom())
  assert model.device == torch.device('cuda')
  assert Seq2ActBCModel().device == torch.device('cuda')
  assert Seq2ActBCModel().compute_dtype == torch.float32
  # The GPU serves float32; bf16 only where asked for (or on a TPU).
  assert model.compute_dtype == torch.float32
  assert (t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16)


def test_chip_smoke_refuses_to_run_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('this check needs a machine without a CUDA card')
  result = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode != 0
  assert '"ok"' not in result.stdout


def test_flash_ab_refuses_to_run_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('this check needs a machine without a CUDA card')
  result = subprocess.run([sys.executable, 'flash_ab.py', REPO], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
  assert result.returncode != 0
  assert 'needs a CUDA card' in result.stderr


def test_the_grasp2vec_and_pose_env_models_run_on_the_card_unless_asked():
  from tensor2robot_tpu_torch.research import grasp2vec
  from tensor2robot_tpu_torch.research import pose_env

  for model in (grasp2vec.Grasp2VecModel(), pose_env.PoseEnvRegressionModel(),
                pose_env.PoseEnvContinuousMCModel(),
                pose_env.PoseEnvRegressionModelMAML()):
    assert model.device == torch.device('cuda'), type(model).__name__
    assert model.compute_dtype == torch.float32


def test_the_live_loop_runs_on_the_card_unless_asked():
  from tensor2robot_tpu_torch.envs import VecGraspingEnv
  from tensor2robot_tpu_torch.rl import loop
  from tensor2robot_tpu_torch.rl import run_rl_loop

  assert inspect.signature(VecGraspingEnv).parameters[
      'device'].default == 'cuda'
  assert inspect.signature(loop.build_grasping_loop).parameters[
      'device'].default == 'cuda'
  assert run_rl_loop.make_parser().parse_args([]).device == 'cuda'


def test_the_fleet_runs_on_the_card_unless_asked():
  from tensor2robot_tpu_torch.serving import fleet_bench
  from tensor2robot_tpu_torch.serving import serve

  args = serve.make_parser().parse_args(['--init_randomly', '--replicas',
                                         '4', '--autoscale_max', '8'])
  assert args.device == 'cuda' and args.replicas == 4
  assert inspect.signature(fleet_bench.run_bench).parameters[
      'device'].default == 'cuda'
  assert inspect.signature(fleet_bench.build_sim_batch_select).parameters[
      'device'].default == 'cuda'
