"""Checkpoints of the port's ``TrainState``.

One file per step, ``<model_dir>/checkpoint_<step>.pt``, written with
``torch.save`` to a temporary name in the same directory and renamed into
place, so a reader never sees half a checkpoint. The newest
``keep_checkpoint_max`` steps are kept. Tensors are saved from the CPU and
restored to the device the caller names; ``torch.load`` runs with
``weights_only=True``, as the files hold only tensors, numbers and dicts.

Saves and restores go through ``reliability.retry`` (``DEFAULT_CKPT_RETRY``:
3 attempts), each attempt past the ``ckpt.save`` or ``ckpt.restore`` fault
site, inside a ``span`` of the same name. A transient failure (an
``OSError``, an injected fault) that outlasts the retries raises
``RetryError``. A checkpoint that ``torch.load`` refuses (truncated, not a
checkpoint archive) is damaged: the manager that owns the directory (the
trainer's) renames it aside to ``checkpoint_<step>.pt.corrupt``, and every
manager raises ``CorruptCheckpointError``. Readers skip those two,
``reliability.errors.CHECKPOINT_SKIP_ERRORS``, for an older step or the
next poll; any other error propagates.

``checkpoints_iterator`` yields each new step as it lands (continuous
eval); ``create_warm_start_fn`` merges a foreign run's weights into fresh
ones (warm start).

(Restoring the JAX package's Orbax checkpoints without JAX is not ported
yet; ``convert.train_state_from_flax`` converts a JAX state given as
numpy arrays.)
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import re
import time
import zipfile
from typing import Callable, Dict, Iterator, List, Optional

import torch

from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.observability.spans import span
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.reliability.errors import CorruptCheckpointError
from tensor2robot_tpu_torch.reliability.retry import RetryPolicy, retry

__all__ = ['CheckpointManager', 'DEFAULT_CKPT_RETRY', 'all_checkpoint_steps',
           'checkpoints_iterator', 'create_warm_start_fn',
           'latest_checkpoint_step']

_LOGGER = logging.getLogger(__name__)
_PATTERN = re.compile(r'^checkpoint_(\d+)\.pt$')
# Checkpoint I/O sits in the train loop: 3 attempts, 0.05 then 0.1 s apart.
# A filesystem down for longer fails the run (RetryError) rather than
# stalling it.
DEFAULT_CKPT_RETRY = RetryPolicy(max_attempts=3, base_delay_secs=0.05)
# How torch.load refuses a damaged file (a truncated archive, bytes that
# are no checkpoint); its other errors are not a file's damage.
_DAMAGE_ERRORS = (RuntimeError, EOFError, pickle.UnpicklingError)


class _Damaged(Exception):
  """A restore attempt met a damaged file: not retried (not an OSError)."""


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


def _damage(path: str) -> str:
  """What is visibly wrong with a checkpoint that ``torch.load`` refused."""
  if not os.path.exists(path):
    return 'file missing'
  if os.path.getsize(path) == 0:
    return 'empty file'
  if not zipfile.is_zipfile(path):
    return 'truncated or not a checkpoint archive'
  return 'torch.load refused it'


class CheckpointManager:
  """Saves and restores ``TrainState``s under ``model_dir`` (see the
  module's note on retries and damage)."""

  def __init__(self, model_dir: str, keep_checkpoint_max: int = 5,
               quarantine_damaged: bool = True):
    """Args:
      model_dir: the run's directory.
      keep_checkpoint_max: the newest checkpoints kept.
      quarantine_damaged: rename a damaged checkpoint aside. Only the
        directory's writer (the trainer) does; a reader (a continuous
        eval, a predictor) passes False and never touches a live run's
        files.
    """
    if keep_checkpoint_max < 1:
      raise ValueError('keep_checkpoint_max must be at least 1.')
    self.model_dir = model_dir
    self.keep_checkpoint_max = keep_checkpoint_max
    self.quarantine_damaged = quarantine_damaged
    os.makedirs(model_dir, exist_ok=True)

  def save(self, state: TrainState) -> str:
    """Writes ``state`` as its step's checkpoint; drops the oldest beyond
    ``keep_checkpoint_max``. Returns the path."""
    path = _path(self.model_dir, state.step)
    tmp = '{}.tmp{}'.format(path, os.getpid())
    saved = _to(dataclasses.asdict(state), 'cpu')

    def _save():
      fault_injection.maybe_fail(fault_injection.SITE_CKPT_SAVE)
      torch.save(saved, tmp)
      os.replace(tmp, path)

    with span('ckpt.save'):
      retry(_save, DEFAULT_CKPT_RETRY, site=fault_injection.SITE_CKPT_SAVE)
    kept = self.keep_checkpoint_max
    for step in all_checkpoint_steps(self.model_dir)[:-kept]:
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
    path = _path(self.model_dir, step)

    def _restore():
      fault_injection.maybe_fail(fault_injection.SITE_CKPT_RESTORE)
      try:
        return torch.load(path, map_location='cpu', weights_only=True)
      except _DAMAGE_ERRORS as e:
        raise _Damaged() from e
      except OSError as e:
        # The zip reader's seek past a truncated archive is an OSError too;
        # only one of a whole file is retried.
        if os.path.exists(path) and not zipfile.is_zipfile(path):
          raise _Damaged() from e
        raise

    try:
      with span('ckpt.restore'):
        saved = retry(_restore, DEFAULT_CKPT_RETRY,
                      site=fault_injection.SITE_CKPT_RESTORE)
    except _Damaged as e:
      # A damaged file does not get better with backoff.
      damage = _damage(path)
      self._quarantine(path, damage)
      raise CorruptCheckpointError(self.model_dir, step,
                                   damage) from e.__cause__
    # Tensors keep their strides through save and load (channels_last
    # weights stay channels_last).
    return TrainState(**_to(saved, torch.device(device)))

  def _quarantine(self, path: str, damage: str) -> None:
    """Renames a damaged checkpoint aside (never deletes it: the bytes stay
    for a post-mortem), where this manager owns the directory."""
    if not self.quarantine_damaged:
      return
    dest, suffix = path + '.corrupt', 1
    while os.path.exists(dest):
      dest, suffix = '{}.corrupt{}'.format(path, suffix), suffix + 1
    try:
      os.replace(path, dest)
      _LOGGER.warning('Quarantined a damaged checkpoint (%s): %s -> %s',
                      damage, path, dest)
    except OSError as e:
      _LOGGER.warning('Could not quarantine the damaged checkpoint %s: %s',
                      path, e)


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
