"""Off-policy QT-Opt: Bellman backups of a critic against a lagged target
network kept on the filesystem (the JAX package's ``rl/offpolicy.py``).

  * The target network is the newest version in the lagged export
    directory that ``LaggedCheckpointExportHook`` keeps: the live weights
    one export interval back, found by polling the directory as any
    consumer of the exports would. ``refresh_target`` loads only a newly
    committed version, onto the critic's device, so the target moves in
    steps of ``target_update_steps``.
  * The labels ``y = r + gamma * (1 - done) * max_a' Q_t(s', a')`` come
    from one forward of the target over the B next states and their B*K
    candidate actions (the critic's megabatch), without gradient; then the
    trainer's own step trains the critic on ``{'reward': y}``.
  * Timeouts carry ``done=0`` (the target bootstraps through a time
    limit); only terminals carry ``done=1``.

The target forward runs in TRAIN mode by default: batch norm normalizes
with the statistics of the B next states, as the JAX target does (early in
training the running statistics are cold, and targets through them are
wrong for thousands of steps). It runs on copies of the running statistics,
so neither the target's nor the live critic's are changed by it.

A step's candidates are drawn from a generator on the critic's device
seeded from ``(seed + 1, step)`` plus ``CANDIDATE_SEED_OFFSET``, a stream
apart from the crops' (``Trainer.crop_generator``): a resumed run draws
what an uninterrupted one would have. They are not JAX's ``jax.random``
draws.

The split decode: the records carry the next frame (``next/image_1``)
beside the frame, and both ship as coefficients; the trainer's feed knows
only the critic's own image, so this module's ``SparseCoefFeed`` unpacks
the ``next/`` mirrors too, before the step.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.data import device_feed
from tensor2robot_tpu_torch.export import export_generators
from tensor2robot_tpu_torch.hooks.checkpoint_hooks import (
    LaggedCheckpointExportHook)
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.trainer.train_eval import CROP_SEED_STRIDE

__all__ = ['CANDIDATE_SEED_OFFSET', 'DONE_KEY', 'NEXT_PREFIX',
           'BellmanQTOptTrainer', 'concat_ranking_pairs',
           'pairwise_ranking_accuracy', 'ranking_accuracy_from_scores',
           'split_offpolicy_batch', 'strip_offpolicy_features']

DONE_KEY = 'done'
NEXT_PREFIX = 'next/'
# The candidates of global step k are drawn from the crops' seed of step k
# plus this (modulo 2 ** 63): a stream of their own, apart from the crops'
# and the dropout's (train_eval.DROPOUT_SEED_OFFSET).
CANDIDATE_SEED_OFFSET = 1 << 61


def strip_offpolicy_features(features):
  """``features`` without the off-policy extras (``done``, ``next/*``):
  the critic's own keys."""
  return {key: features[key] for key in features
          if key != DONE_KEY and not key.startswith(NEXT_PREFIX)}


def split_offpolicy_batch(features):
  """(train_features, next_features, done) from a replay batch.

  The records carry the critic's keys, ``next/<key>`` mirrors of the state
  and a scalar ``done``; the ``next/`` keys come back under their own
  names, so that the next state is a (partial) critic input. ``done`` is
  float32 on the features' device.
  """
  train_features, next_features = {}, {}
  done = None
  for key in features:
    if key == DONE_KEY:
      done = torch.as_tensor(features[key]).to(torch.float32)
    elif key.startswith(NEXT_PREFIX):
      next_features[key[len(NEXT_PREFIX):]] = features[key]
    else:
      train_features[key] = features[key]
  if done is None:
    raise ValueError("off-policy batches need a '{}' feature.".format(
        DONE_KEY))
  return train_features, next_features, done


class BellmanQTOptTrainer:
  """Trains a critic by Bellman backups against a lagged filesystem target.

  Args:
    model: a ``CriticModel``; its reward label becomes the Bellman target.
    trainer: the ``Trainer`` of ``model``, whose step trains on the labels.
    candidate_actions_fn: ``(generator, batch, next_features) ->
      {action key: [B*K, ...] tensor}``, every action key of the critic,
      state-major (row b*K + j is state b's j-th candidate), on the next
      state's device; keys that carry the next state's gripper status are
      read from ``next_features``.
    num_candidates: K.
    gamma: the discount.
    target_update_steps: the export (and so target refresh) interval.
    target_forward_mode: TRAIN (batch statistics; the default, see the
      module's note), or EVAL / PREDICT (the running statistics).
    exports_to_keep: versions kept in both export directories.
  """

  def __init__(self,
               model,
               trainer,
               candidate_actions_fn: Callable,
               num_candidates: int,
               gamma: float = 0.9,
               target_update_steps: int = 20,
               target_forward_mode: str = ModeKeys.TRAIN,
               exports_to_keep: int = 3):
    from tensor2robot_tpu_torch.preprocessors.device_decode import (
        DeviceDecodePreprocessor)

    self.model = model
    self.trainer = trainer
    self.gamma = float(gamma)
    self.num_candidates = int(num_candidates)
    self.target_update_steps = int(target_update_steps)
    self._candidate_actions_fn = candidate_actions_fn
    self._target_forward_mode = target_forward_mode
    self.export_dir = os.path.join(trainer.model_dir, 'export',
                                   'latest_exporter')
    self.lagged_export_dir = os.path.join(trainer.model_dir, 'export',
                                          'lagged_exporter')
    # Raw receivers: the artifact declares the model's own specification;
    # the in-process target never feeds it coefficient streams.
    self._hook = LaggedCheckpointExportHook(
        self.export_dir,
        self.lagged_export_dir,
        export_every_steps=self.target_update_steps,
        exports_to_keep=exports_to_keep,
        export_generator=export_generators.VariablesExportGenerator(
            export_raw_receivers=True))
    self.target_variables: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    self.target_version: Optional[int] = None
    # Target versions loaded after the seed.
    self.refreshes = 0
    self._candidate_generator = None
    preprocessor = model.preprocessor
    if isinstance(preprocessor, DeviceDecodePreprocessor):
      shapes = dict(preprocessor.image_shapes(ModeKeys.TRAIN))
      shapes.update({NEXT_PREFIX + key: value
                     for key, value in list(shapes.items())})
      self._feed = device_feed.SparseCoefFeed(shapes, model.device)
    else:
      self._feed = trainer.feed
    self._buffers = frozenset(name for name, _ in
                              model.network.named_buffers())

  # -- the target network ----------------------------------------------------

  def seed_target(self, state) -> None:
    """Exports ``state``'s weights, which the first export also commits to
    the lagged directory, and loads them: the target starts equal to
    them."""
    self._hook._export(self.trainer, state)  # noqa: SLF001
    if not self.refresh_target():
      raise RuntimeError('seeding the lagged export dir failed '
                         '({}).'.format(self.lagged_export_dir))
    self.refreshes = 0

  def refresh_target(self) -> bool:
    """Loads the target's weights onto the critic's device if a new
    lagged version has committed; True if it did."""
    versions = export_generators.list_exported_versions(
        self.lagged_export_dir)
    if not versions or versions[-1] == self.target_version:
      return False
    variables = export_generators.load_exported_variables(
        os.path.join(self.lagged_export_dir, str(versions[-1])))
    self.target_variables = {name: self.model.to_device(weights)
                             for name, weights in variables.items()}
    self.target_version = versions[-1]
    self.refreshes += 1
    return True

  def after_step(self, state, step: int) -> None:
    """Exports on the interval, then loads whatever newly lagged."""
    self._hook.after_step(self.trainer, state, step, None)
    self.refresh_target()

  # -- the Bellman step ------------------------------------------------------

  def candidate_generator(self, step: int) -> torch.Generator:
    """The device generator of step ``step``'s candidate actions."""
    if self._candidate_generator is None:
      self._candidate_generator = torch.Generator(device=self.model.device)
    self._candidate_generator.manual_seed(
        ((self.trainer.seed + 1) * CROP_SEED_STRIDE + step +
         CANDIDATE_SEED_OFFSET) % (1 << 63))
    return self._candidate_generator

  def target_outputs(self, target_variables, features):
    """The target network's outputs on preprocessed ``features``, in the
    target forward's mode; a TRAIN forward updates copies of the running
    statistics, which are dropped."""
    weights = target_variables['params']
    if self._target_forward_mode != ModeKeys.TRAIN:
      return self.model.inference_network_fn({'params': weights}, features,
                                             self._target_forward_mode)
    state = {name: value.clone() if name in self._buffers else value
             for name, value in weights.items()}
    return torch.func.functional_call(
        self.model.network, state, (features,),
        self.model.network_kwargs(ModeKeys.TRAIN), strict=True)

  def bellman_targets(self, target_variables, next_features, reward, done,
                      generator: torch.Generator) -> torch.Tensor:
    """``y = r + gamma * (1 - done) * max over K candidates`` [B].

    ``next_features`` are the next state's features as the loader gives
    them, under the critic's keys, on the critic's device; the candidate
    actions are drawn from ``generator``, and the critic's preprocessor
    (PREDICT: the center crop) and state tiling make the megabatch that
    the target scores.
    """
    model = self.model
    reward = torch.as_tensor(reward).to(torch.float32).reshape(-1)
    batch = reward.shape[0]
    with torch.no_grad():
      candidates = self._candidate_actions_fn(generator, batch,
                                              next_features)
      # The candidates own every action key; the next state the rest.
      features = {key: value for key, value in next_features.items()
                  if not key.startswith('action/')}
      features.update(candidates)
      features, _ = model.preprocessor.preprocess(features, None,
                                                  ModeKeys.PREDICT)
      features = model.tile_state_for_action_batch(features)
      outputs = self.target_outputs(target_variables, features)
      q = outputs[model.q_key].to(torch.float32).reshape(
          batch, self.num_candidates)
      done = torch.as_tensor(done).to(torch.float32).reshape(batch)
      return reward + self.gamma * (1.0 - done) * q.max(dim=-1).values

  def step(self, state, features, labels):
    """One Bellman step on a batch on the critic's device: (new state,
    metrics, y). ``features`` carry the critic's keys, ``next/`` and
    ``done``; ``labels['reward']`` is the immediate reward."""
    train_features, next_features, done = split_offpolicy_batch(features)
    y = self.bellman_targets(self.target_variables, next_features,
                             labels['reward'], done,
                             self.candidate_generator(state.step))
    new_state, metrics = self.trainer._step(  # noqa: SLF001
        state, (train_features, {'reward': y[:, None]}))
    metrics = dict(metrics)
    metrics['bellman_target_mean'] = y.mean()
    metrics['done_fraction'] = done.mean()
    return new_state, metrics, y

  def put_batch(self, host_batch):
    """A host batch ``{'features', 'labels'}`` of numpy arrays on the
    critic's device, the coefficient streams (``next/`` too) unpacked."""
    return self._feed.put_batch((host_batch['features'],
                                 host_batch['labels']))

  def train_step(self, state, host_batch):
    """One off-policy step from a host batch; exports and refreshes the
    target on the interval. Returns (new state, metrics).

    The step counter is the state's host integer, so an off-interval step
    neither waits for the device nor lists the export directory."""
    if self.target_variables is None:
      self.seed_target(state)
    features, labels = self.put_batch(host_batch)
    state, metrics, _ = self.step(state, features, labels)
    if state.step % self.target_update_steps == 0:
      self.after_step(state, state.step)
    return state, metrics

  def close(self) -> None:
    self.trainer.close()


def concat_ranking_pairs(pairs):
  """Every arm of (better, worse) pairs in one batch.

  Returns ``(combined, arm_rows)``: one feature dict with the arms stacked
  in pair order (better0, worse0, better1, ...) and each arm's row count,
  to split the scores back out (``ranking_accuracy_from_scores``).
  """
  arms = [arm for pair in pairs for arm in pair]
  if not arms:
    return {}, []
  keys = list(arms[0])
  combined = {
      k: np.concatenate([np.asarray(arm[k]) for arm in arms])
      for k in keys
  }
  first = keys[0]
  arm_rows = [int(np.asarray(arm[first]).shape[0]) for arm in arms]
  return combined, arm_rows


def ranking_accuracy_from_scores(scores, arm_rows) -> float:
  """The share of pairs ranked correctly, from one score vector over the
  arms of ``concat_ranking_pairs``."""
  scores = np.asarray(scores).ravel()
  if scores.size != sum(arm_rows):
    raise ValueError(
        'Got {} scores for arms totalling {} rows — q_fn must return one '
        'score per row.'.format(scores.size, sum(arm_rows)))
  correct = total = 0
  offset = 0
  for i in range(0, len(arm_rows), 2):
    rows_better, rows_worse = arm_rows[i], arm_rows[i + 1]
    if rows_better != rows_worse:
      raise ValueError(
          'Pair {} has mismatched arm sizes {} vs {}.'.format(
              i // 2, rows_better, rows_worse))
    better = scores[offset:offset + rows_better]
    worse = scores[offset + rows_better:offset + rows_better + rows_worse]
    correct += int((better > worse).sum())
    total += rows_better
    offset += rows_better + rows_worse
  return correct / max(total, 1)


def pairwise_ranking_accuracy(q_fn, pairs) -> float:
  """The share of (better, worse) pairs that ``q_fn(features) -> [B]``
  ranks correctly.

  Both arms of every pair go through one forward: a critic normalized with
  batch statistics removes any feature that is constant within a forward
  batch, and each arm holds a constant action, the very signal measured.
  """
  combined, arm_rows = concat_ranking_pairs(pairs)
  if not arm_rows:
    return 0.0
  scores = q_fn(combined)
  if isinstance(scores, torch.Tensor):
    scores = scores.detach().cpu().numpy()
  return ranking_accuracy_from_scores(scores, arm_rows)
