"""The collect and eval job from gin files (the JAX package's
``bin/run_collect_eval.py``): ``collect_eval_loop`` as the gins configure
it, on ``cuda`` unless ``--device cpu`` (which binds every registered
model's ``device``) or a binding asks for the CPU::

    python -m tensor2robot_tpu_torch.rl.run_collect_eval \\
        --gin_configs tensor2robot_tpu_torch/research/qtopt/configs/run_collect_grasping_sim.gin \\
        --gin_bindings "collect_eval_loop.root_dir = '/tmp/collect'"

It prints one JSON line: the seconds the loop took, and the records and
files it left under ``policy_collect/`` and ``policy_eval/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from tensor2robot_tpu_torch.data import tfrecord

__all__ = ['GIN_MODELS', 'count_records', 'main', 'make_parser']

# The model configurables that ``--device`` binds.
GIN_MODELS = ('Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom',
              'PoseEnvRegressionModel', 'PoseEnvContinuousMCModel',
              'PoseEnvRegressionModelMAML')


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='A gin file (repeatable).')
  parser.add_argument('--gin_bindings', action='append', default=[],
                      help='One binding, e.g. "a.b = 1" (repeatable).')
  parser.add_argument('--device', default='cuda',
                      help="Where the models run: 'cuda' (the default) or "
                      "'cpu'.")
  return parser


def count_records(root_dir: str) -> Dict[str, Dict[str, int]]:
  """``{tag: {'files', 'records'}}`` of the record files under
  ``root_dir/policy_<tag>``."""
  counts = {}
  for tag in ('collect', 'eval'):
    files = sorted(glob.glob(os.path.join(root_dir, 'policy_' + tag, '*')))
    if files:
      counts[tag] = {'files': len(files), 'records': sum(
          sum(1 for _ in tfrecord.tfrecord_iterator(path)) for path in files)}
  return counts


def main(argv: Optional[List[str]] = None) -> int:
  args = make_parser().parse_args(argv)
  from tensor2robot_tpu_torch import config
  from tensor2robot_tpu_torch import kernels

  config.register_framework_configurables()
  config.add_config_file_search_path(
      os.path.dirname(os.path.dirname(os.path.dirname(
          os.path.abspath(__file__)))))
  config.clear_config()
  config.parse_config_files_and_bindings(args.gin_configs, [
      '{}.device = {!r}'.format(name, args.device) for name in GIN_MODELS
  ] + list(args.gin_bindings))
  config.check_configurables()
  if torch.device(args.device).type == 'cuda':
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
  try:
    root_dir = config.query_parameter('collect_eval_loop.root_dir')
  except config.ConfigError:
    root_dir = ''
  start = time.perf_counter()
  config.get_configurable('collect_eval_loop')()
  seconds = time.perf_counter() - start
  print(json.dumps({'seconds': seconds, 'device': args.device,
                    'root_dir': root_dir,
                    'written': count_records(root_dir) if root_dir else {}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
