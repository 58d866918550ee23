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
    r'^\s*(import|from)\s+(jax|flax|optax)\b|\btensor2robot_tpu[. ]',
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


def _port_sources():
  for root, _, files in os.walk(PORT):
    for name in sorted(files):
      if name.endswith(('.py', '.cu', '.cuh')):
        yield os.path.join(root, name)
  yield os.path.join(REPO, 'chip_smoke.py')


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


def test_static_scan_finds_no_jax_import():
  hits = []
  for path in _port_sources():
    with open(path, encoding='utf-8') as f:
      for match in _FORBIDDEN.finditer(f.read()):
        hits.append('{}: {!r}'.format(os.path.relpath(path, REPO),
                                      match.group(0)))
  assert not hits, hits


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
