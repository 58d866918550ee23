"""Checkpoints of the port's ``TrainState``.

One file per step, ``<model_dir>/checkpoint_<step>.pt``, written with
``torch.save`` to a temporary name in the same directory and renamed into
place, so a reader never sees half a checkpoint. The newest
``keep_checkpoint_max`` steps are kept. Tensors are saved from the CPU and
restored to the device the caller names; ``torch.load`` runs with
``weights_only=True``, as the files hold only tensors, numbers and dicts.

``checkpoints_iterator`` yields each new step as it lands (continuous
eval); ``create_warm_start_fn`` merges a foreign run's weights into fresh
ones (warm start).

(Restoring the JAX package's Orbax checkpoints without JAX is not ported
yet; ``convert.train_state_from_flax`` converts a JAX state given as
numpy arrays.)
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import re
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from tensor2robot_tpu_torch.models.abstract_model import TrainState

__all__ = ['CheckpointManager', 'SKIP_ERRORS', 'all_checkpoint_steps',
           'checkpoints_iterator', 'create_warm_start_fn',
           'latest_checkpoint_step']

_PATTERN = re.compile(r'^checkpoint_(\d+)\.pt$')
# A checkpoint that fails to load with one of these (half written, removed
# by the trainer's retention while being read) is skipped by its readers.
SKIP_ERRORS = (OSError, RuntimeError, EOFError, pickle.UnpicklingError)


def _path(model_dir: str, step: int) -> str:
  return os.path.join(model_dir, 'checkpoint_{}.pt'.format(step))


def all_checkpoint_steps(model_dir: str) -> List[int]:
  """The steps with a committed checkpoint, oldest first."""
  if not os.path.isdir(model_dir):
    return []
  steps = [int(m.group(1)) for m in map(_PATTERN.match, os.listdir(model_dir))
           if m]
  return sorted(steps)


def latest_checkpoint_step(model_dir: str) -> Optional[int]:
  steps = all_checkpoint_steps(model_dir)
  return steps[-1] if steps else None


def _to(tree, device):
  if isinstance(tree, torch.Tensor):
    return tree.detach().to(device)
  if isinstance(tree, dict):
    return {k: _to(v, device) for k, v in tree.items()}
  return tree


class CheckpointManager:
  """Saves and restores ``TrainState``s under ``model_dir``."""

  def __init__(self, model_dir: str, keep_checkpoint_max: int = 5):
    if keep_checkpoint_max < 1:
      raise ValueError('keep_checkpoint_max must be at least 1.')
    self.model_dir = model_dir
    self.keep_checkpoint_max = keep_checkpoint_max
    os.makedirs(model_dir, exist_ok=True)

  def save(self, state: TrainState) -> str:
    """Writes ``state`` as its step's checkpoint; drops the oldest beyond
    ``keep_checkpoint_max``. Returns the path."""
    path = _path(self.model_dir, state.step)
    tmp = '{}.tmp{}'.format(path, os.getpid())
    torch.save(_to(dataclasses.asdict(state), 'cpu'), tmp)
    os.replace(tmp, path)
    for step in all_checkpoint_steps(self.model_dir)[:-self.keep_checkpoint_max]:
      os.remove(_path(self.model_dir, step))
    return path

  def restore(self, step: Optional[int] = None,
              device='cpu') -> TrainState:
    """The checkpoint of ``step`` (the newest when None) on ``device``."""
    if step is None:
      step = latest_checkpoint_step(self.model_dir)
      if step is None:
        raise FileNotFoundError('No checkpoint in {}.'.format(
            self.model_dir))
    saved = torch.load(_path(self.model_dir, step), map_location='cpu',
                       weights_only=True)
    # Tensors keep their strides through save and load (channels_last
    # weights stay channels_last).
    return TrainState(**_to(saved, torch.device(device)))


def checkpoints_iterator(model_dir: str, timeout_secs: float = 600.0,
                         min_interval_secs: float = 1.0,
                         stop_fn: Optional[Callable[[], bool]] = None
                         ) -> Iterator[int]:
  """Yields the newest checkpoint step each time it changes.

  Ends when no new checkpoint lands within ``timeout_secs`` of the last
  one (on the monotonic clock, which no wall-clock jump moves), or when
  ``stop_fn`` returns True.
  """
  last_step = None
  deadline = time.monotonic() + timeout_secs
  while True:
    if stop_fn is not None and stop_fn():
      return
    step = latest_checkpoint_step(model_dir)
    if step is not None and step != last_step:
      last_step = step
      deadline = time.monotonic() + timeout_secs
      yield step
      continue
    if time.monotonic() > deadline:
      return
    time.sleep(min_interval_secs)


def create_warm_start_fn(checkpoint_dir: str, step: Optional[int] = None,
                         include: Optional[Callable[[str], bool]] = None):
  """``params -> params``, merging the trainable weights of another run's
  checkpoint (``step``, the newest when None) into fresh ones.

  A fresh tensor is replaced where the checkpoint holds one under the same
  name with the same shape and ``include`` (given the name) passes it;
  every other keeps its fresh value. The merged tensors keep the fresh
  ones' dtype, device and layout. The checkpoint is only read.
  """

  def warm_start(params: Dict[str, torch.Tensor]) -> Dict[str,
                                                          torch.Tensor]:
    restore_step = step if step is not None else latest_checkpoint_step(
        checkpoint_dir)
    if restore_step is None:
      raise FileNotFoundError(
          'No checkpoint to warm start from in {}.'.format(checkpoint_dir))
    restored = torch.load(_path(checkpoint_dir, restore_step),
                          map_location='cpu', weights_only=True)['params']
    merged = {}
    for name, value in params.items():
      candidate = restored.get(name)
      if (candidate is not None and (include is None or include(name)) and
          tuple(candidate.shape) == tuple(value.shape)):
        value = torch.empty_like(value).copy_(candidate)
      merged[name] = value
    return merged

  return warm_start
