"""Train (and evaluate) a model on the GPU: the port's counterpart of the
JAX package's ``trainer/train_eval.py`` (``Trainer``, ``train_eval_model``),
train-only and train+eval.

Each train step, on the model's device:

  1. the next batch of numpy arrays (made ahead by the input generator)
     goes through the model's feed (``data/device_feed.py``): pinned
     staging buffers and a copy stream to a CUDA device, the split
     decode's coefficient streams unpacked there (with ``feed_depth`` > 1,
     that many batches ahead in a thread);
  2. the model's preprocessor runs in TRAIN mode (under the split decode
     it first finishes the JPEG decode on the device; then the random
     crop and
     ``/ 255`` through kernel K1: one offset per frame for the Grasping44
     critic, one per episode for Seq2Act), the random offsets of global
     step k drawn from a device generator seeded from ``(seed + 1, k)``, as
     the JAX step folds the step into its key;
  3. ``model.train_step``: loss, autograd, optimizer, EMA; the network's
     own draws (Seq2Act's dropout) from a device generator seeded from
     ``(seed + 1, k)`` and ``DROPOUT_SEED_OFFSET``, a stream apart from the
     crops'.

A step whose loss is not finite follows ``nan_policy``: ``'skip'`` (the
default, as in the JAX trainer) keeps every tensor of the state at its
value before the step, on the device and without waiting for it, while
the step counter advances, and reports ``nonfinite_loss_skipped``;
``'raise'`` checks the loss on the host and raises ``NonFiniteLossError``;
``'rollback'`` checks it so too and restores the newest committed
checkpoint, at most ``nan_rollback_budget`` times a ``train`` call (then
it raises), counting ``reliability/nan_rollbacks``; ``'off'`` neither
checks nor guards. The host's check runs every ``nan_check_every_n_steps``
and on every step about to be checkpointed (an unchecked save could commit
the poison that a rollback would then restore). Every
``log_every_n_steps`` the metrics reach the host and the observability
registry (gauges ``train/loss``, ``train/grasp_loss`` and
``train/l2_loss`` (the critic), ``train/action_accuracy`` and
``train/action_mae`` (Seq2Act), ``train/steps_per_sec``,
``train/examples_per_sec``; counter ``train/nonfinite_loss_skipped``),
and, with ``write_metrics``, a TensorBoard event under ``model_dir``
(``trainer/metrics.py``) with the registry's scalars and the goodput split
(``observability/goodput.py``: each second of the loop charged to
productive, data, checkpoint or retry time through the loop's ``span``s);
each eval writes its metrics under ``model_dir/eval``. Checkpoints are
written every ``save_checkpoints_steps`` and at the end; a trainer starts
from the newest checkpoint in ``model_dir`` that restores, else from fresh
weights (merged with the model's ``warm_start_fn`` where it has one).
Hooks (``train_hook_builders``) see ``begin``, ``after_step`` after every
step and ``end``; exporters (``create_exporters_fn``) run after every
eval.

Faults (``reliability/``), as in the JAX trainer. The loop runs under
``graceful_shutdown``: a SIGTERM or SIGINT, or the injected
``host.preempt`` site, is seen at the next step boundary, where the
checkpoint of that step is committed, ``reliability/preemptions`` counted
and ``TrainingPreempted(signum, step)`` raised; a new trainer resumes from
that step. Any other exception out of the loop first commits the state it
had (the emergency save), except ``NonFiniteLossError``, whose state is
poisoned. The checkpoint manager retries its I/O and quarantines a damaged
checkpoint (``trainer/checkpointing.py``); readers skip
``CHECKPOINT_SKIP_ERRORS``. The trainer's fault sites: ``step.nan`` makes
the step's loss NaN on the device (no host sync under ``'skip'``: the
flag is the host's, as PyTorch runs eagerly and has no trace to keep
stable), ``step.slow`` sleeps after the step (productive time), and
``host.preempt``; the feed's ``data.stall``, the reader's ``data.read``
and the manager's ``ckpt.save`` and ``ckpt.restore`` are theirs.

The train batch of global step k is drawn from ``seed + k`` and every
eval's batches from ``seed + EVAL_SEED_OFFSET`` on, apart from every train
batch: a segment after an eval and a resumed run go on with the batches
and crops that an uninterrupted run would have drawn. A record generator
(``--train_data``) takes the same number as its shuffle seed: TRAIN
shuffles files and records, EVAL reads them in order. Its native loader
decodes JPEG frames on the model's card where it decodes with nvJPEG.

Ring attention (``--attention_mode ring``) trains one model over the N
ranks of a ``torch.distributed`` group, one process per card, each holding
its T/N frames of every episode (``model.frame_shard``). Each rank draws
or reads only those frames of the batch (random episodes frame by frame
from seeds of their own; records with the loader decoding only those
frames, in an order that the seed alone decides), and the per-episode keys
(``task_id``) and the crop offsets alike on every rank: the ranks' shares
concatenate to the batch that one rank draws or reads alone. Rank 0 writes
the checkpoints (and the command line's JSON line); every rank restores
them.

The split decode (``--device_decode``, ``train_qtopt_sparse.gin``'s
wrapper): the loader ships each frame's quantized DCT coefficients, dense
('dense'), as the sparse stream ('sparse', the gin's) or as the packed
wire ('packed'), decoded on the host by the port's own Huffman decoder;
the feed unpacks them on the card and the step finishes the decode there.

Without a train generator, ``train_eval_model`` is a continuous eval: it
evaluates each checkpoint that lands in ``model_dir`` (skipping one that
does not restore yet) until none lands for ``eval_timeout_secs``, and
never writes a checkpoint there.

Not ported yet: the compiled-artifact store, and the JAX trainer's
telemetry records (``run_start``, ``preempted``, ``run_abort``,
``run_end``), its recovery marker and timeline, watchdog, auto-profiler,
pipeline X-ray and fleet observer.

Command line, from gin files (``--gin_configs`` and ``--gin_bindings``,
as ``bin/run_t2r_trainer.py`` takes them, parsed by the port's own
``config`` package; ``--model_dir`` and ``--device`` still apply)::

    python -m tensor2robot_tpu_torch.trainer.train_eval \
        --gin_configs tensor2robot_tpu_torch/research/qtopt/configs/train_qtopt.gin \
        --gin_bindings "TRAIN_DATA = '/data/qtopt/train*'" \
        --model_dir /tmp/qtopt

or with ``train_qtopt.gin``'s bindings as flags (``--model
qtopt``, the default) or ``train_seq2act_bc.gin``'s (``--model seq2act``:
``--episode_length``, ``--attention_mode``, ``--learning_rate``). For
either model ``--train_data`` and ``--eval_data`` are the record file
patterns of its ``DefaultRecordInputGenerator``s (the critic's grasp
examples, or Seq2Act's episodes: the JPEG frame list ``image0`` and
``action``), read by the native loader where it reads the specs; without
them, random batches::

    python -m tensor2robot_tpu_torch.trainer.train_eval \\
        --model_dir /tmp/qtopt --max_train_steps 100 \\
        --train_data '/data/qtopt/train*'
    python -m tensor2robot_tpu_torch.trainer.train_eval --device cpu \\
        --num_convs 1,1,1 --max_train_steps 2 --batch_size 2 \\
        --model_dir /tmp/qtopt_cpu
    python -m tensor2robot_tpu_torch.trainer.train_eval \\
        --model_dir /tmp/qtopt_sparse --max_train_steps 100 \\
        --train_data '/data/qtopt/train*' --device_decode sparse
    python -m tensor2robot_tpu_torch.trainer.train_eval --model seq2act \\
        --episode_length 512 --attention_mode flash --batch_size 8 \\
        --model_dir /tmp/seq2act --max_train_steps 100 \\
        --train_data '/data/episodes/train*'
    torchrun --nproc_per_node 4 -m tensor2robot_tpu_torch.trainer.train_eval \\
        --model seq2act --episode_length 512 --attention_mode ring \\
        --batch_size 32 --model_dir /tmp/seq2act_ring --max_train_steps 100 \\
        --train_data '/data/episodes/train*'
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data import device_feed
from tensor2robot_tpu_torch.data.input_generators import (
    AbstractInputGenerator, DefaultRandomInputGenerator,
    DefaultRecordInputGenerator)
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.observability import goodput as goodput_lib
from tensor2robot_tpu_torch.observability.spans import span
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.reliability import fault_injection
from tensor2robot_tpu_torch.reliability import quarantine as quarantine_lib
from tensor2robot_tpu_torch.reliability.errors import (
    CHECKPOINT_SKIP_ERRORS, NonFiniteLossError, TrainingPreempted)
from tensor2robot_tpu_torch.reliability.preemption import graceful_shutdown
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer.checkpointing import (
    CheckpointManager, latest_checkpoint_step)

__all__ = ['DEVICE_DECODE', 'MODELS', 'NAN_POLICIES', 'NonFiniteLossError',
           'Trainer', 'TrainingPreempted', 'main', 'make_input_generators',
           'make_model', 'make_parser', 'train_eval_model']

NAN_POLICIES = ('off', 'skip', 'raise', 'rollback')
# The model configurables of the gins: ``--device`` binds their device.
GIN_MODELS = ('Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom',
              'Seq2ActBCModel', 'Grasp2VecModel', 'PoseEnvRegressionModel',
              'PoseEnvContinuousMCModel', 'PoseEnvRegressionModelMAML',
              'VRGripperRegressionModel', 'VRGripperDomainAdaptiveModel',
              'VRGripperEnvRegressionModelMAML', 'VRGripperEnvTecModel',
              'VRGripperEnvSequentialModel', 'VRGripperEnvSimpleTrialModel',
              'VRGripperEnvVisionTrialModel')
MODELS = ('qtopt', 'seq2act')
# --device_decode: off (pixels), or the split decode's wire.
DEVICE_DECODE = ('off', 'dense', 'sparse', 'packed')
# Eval batches are drawn from seeds this far above the train batches' (batch
# i of an iterator seeded s draws seeds s + i and s + i + 977).
EVAL_SEED_OFFSET = 1 << 30
# The crops of global step k are drawn from seed (seed + 1) * this + k.
CROP_SEED_STRIDE = 1 << 32
# The network's draws of global step k (dropout) from the crops' seed plus
# this (modulo 2 ** 63): a stream of its own.
DROPOUT_SEED_OFFSET = 1 << 62


def _tree_where(good: torch.Tensor, new, old):
  if isinstance(new, dict):
    return {k: _tree_where(good, v, old[k]) for k, v in new.items()}
  if isinstance(new, torch.Tensor):
    return torch.where(good, new, old)
  return new


class Trainer:
  """Owns the train and eval loops, the checkpoints and the metrics files
  of one model."""

  def __init__(self, model, model_dir: str, seed: int = 0,
               keep_checkpoint_max: int = 5,
               save_checkpoints_steps: int = 500,
               log_every_n_steps: int = 100, nan_policy: str = 'skip',
               feed_depth: int = 1, nan_rollback_budget: int = 3,
               write_metrics: bool = True, eval_name: Optional[str] = None,
               nan_check_every_n_steps: int = 1,
               owns_checkpoint_dir: bool = True):
    """``owns_checkpoint_dir``: whether this trainer writes ``model_dir``'s
    checkpoints. False for a continuous eval beside a live trainer: its
    manager then never renames a damaged checkpoint aside."""
    if nan_policy not in NAN_POLICIES:
      raise ValueError('nan_policy must be one of {}; got {!r}.'.format(
          NAN_POLICIES, nan_policy))
    self.model = model
    self.model_dir = model_dir
    self.seed = seed
    self.save_checkpoints_steps = save_checkpoints_steps
    self.log_every_n_steps = max(1, int(log_every_n_steps))
    self.nan_policy = nan_policy
    self.nan_rollback_budget = int(nan_rollback_budget)
    self.nan_check_every_n_steps = max(1, int(nan_check_every_n_steps))
    # > 1: the train batches are transferred this many ahead, in a thread.
    self.feed_depth = max(1, int(feed_depth))
    self._feed = None
    self.checkpoint_manager = CheckpointManager(
        model_dir, keep_checkpoint_max,
        quarantine_damaged=owns_checkpoint_dir)
    # Rank 0 of the model's group writes the checkpoints and metrics.
    self.is_chief = collectives.rank(model.process_group) == 0
    self.registry = get_registry()
    self._crop_generator = self._dropout_generator = None
    self._write_metrics = write_metrics and self.is_chief
    self._eval_dir = os.path.join(
        model_dir, 'eval' if not eval_name else 'eval_' + eval_name)
    self._train_writer = self._eval_writer = None
    # (steps, seconds, seconds waiting for data) of every log window.
    self.windows: List[tuple] = []
    self.last_metrics: Dict[str, float] = {}
    self.last_eval_state: Optional[TrainState] = None
    # The last train generator (its reader and batch size go in the
    # command's line).
    self.train_generator = None
    # The goodput split of the last ``train`` call, and the seconds of its
    # checkpoint at a preemption (None without one).
    self.last_goodput: Optional[goodput_lib.GoodputTracker] = None
    self.last_preemption_save_s: Optional[float] = None

  @property
  def train_metrics_writer(self):
    """Event files of the log windows, under ``model_dir``."""
    if self._write_metrics and self._train_writer is None:
      from tensor2robot_tpu_torch.trainer.metrics import MetricsWriter
      self._train_writer = MetricsWriter(self.model_dir)
    return self._train_writer

  @property
  def eval_metrics_writer(self):
    """Event files of the evals, under ``model_dir/eval``."""
    if self._write_metrics and self._eval_writer is None:
      from tensor2robot_tpu_torch.trainer.metrics import MetricsWriter
      self._eval_writer = MetricsWriter(self._eval_dir)
    return self._eval_writer

  def crop_generator(self, step: int) -> torch.Generator:
    """The device generator of the TRAIN preprocessor's random draws (the
    crops, then the distortions) at global step ``step``, seeded from
    ``(seed + 1, step)``: a resumed run draws what an uninterrupted one
    would have."""
    if self._crop_generator is None:
      self._crop_generator = torch.Generator(device=self.model.device)
    self._crop_generator.manual_seed(
        ((self.seed + 1) * CROP_SEED_STRIDE + step) % (1 << 63))
    return self._crop_generator

  def dropout_generator(self, step: int) -> torch.Generator:
    """The device generator of the network's random draws in TRAIN (the
    dropout masks) at global step ``step``: apart from the crops' stream,
    and as reproducible (a resumed run drops what an uninterrupted one
    would have)."""
    if self._dropout_generator is None:
      self._dropout_generator = torch.Generator(device=self.model.device)
    self._dropout_generator.manual_seed(
        ((self.seed + 1) * CROP_SEED_STRIDE + step + DROPOUT_SEED_OFFSET) %
        (1 << 63))
    return self._dropout_generator

  def restore_latest(self) -> TrainState:
    """The newest checkpoint in ``model_dir`` that restores: a newer one
    that does not (half written by a concurrent trainer, removed by its
    retention while read) falls back to the one before it. Raises the last
    error when none restores, FileNotFoundError when there is none."""
    steps = checkpointing.all_checkpoint_steps(self.model_dir)
    if not steps:
      raise FileNotFoundError('No checkpoint in {}.'.format(self.model_dir))
    error = None
    for step in reversed(steps):
      try:
        return self.checkpoint_manager.restore(step, self.model.device)
      except CHECKPOINT_SKIP_ERRORS as e:
        error = e
        logging.warning('Checkpoint %d in %s failed to restore (%s); trying '
                        'the one before.', step, self.model_dir, e)
    raise error

  def init_state(self) -> TrainState:
    """The newest checkpoint in ``model_dir`` that restores, else a fresh
    state from ``seed`` (the model's warm start merged in, where it has
    one)."""
    if checkpointing.all_checkpoint_steps(self.model_dir):
      return self.restore_latest()
    return self.model.create_train_state(
        torch.Generator().manual_seed(self.seed))

  @property
  def feed(self) -> device_feed.HostDeviceFeed:
    """The model's feed (``device_feed.feed_for_model``), made at first
    use: every batch goes through it."""
    if self._feed is None:
      self._feed = device_feed.feed_for_model(self.model)
    return self._feed

  def put_batch(self, arrays, channel: str = 'train'
                ) -> Optional[Dict[str, torch.Tensor]]:
    """One dict of numpy arrays -> tensors on the model's device, through
    the feed (coefficient streams unpacked)."""
    if arrays is None:
      return None
    return self.feed.put_batch((arrays, None), channel)[0]

  def device_batches(self, iterator, channel: str = 'train'):
    """The batches of ``iterator`` on the device, through the feed: the
    train channel ``feed_depth`` ahead in a thread where that is > 1.
    Closing the result closes ``iterator``."""
    if channel == 'train' and self.feed_depth > 1:
      return device_feed.PipelinedFeed(iterator, self.feed,
                                       self.feed_depth, channel)
    return self._fed(iterator, channel)

  def _fed(self, iterator, channel: str):
    try:
      for batch in iterator:
        yield self.feed.put_batch(batch, channel)
    finally:
      iterator.close()

  def dataset_iterator(self, input_generator: AbstractInputGenerator,
                       mode: str, step: int = 0):
    """This rank's share (``model.frame_shard``) of the batches of
    ``mode``, TRAIN's from global step ``step`` on, decoded on the model's
    card where the reader decodes on one."""
    seed = self.seed + (EVAL_SEED_OFFSET if mode == ModeKeys.EVAL else step)
    device = self.model.device
    index = None
    if device.type == 'cuda':
      index = (torch.cuda.current_device() if device.index is None
               else device.index)
    return input_generator.create_dataset_iterator(
        mode, seed=seed, frames=self.model.frame_shard(), device=index)

  def _step(self, state: TrainState, batch, force_nan: bool = False):
    """One train step on a device batch; ``force_nan`` (the ``step.nan``
    site) makes its loss NaN on the device, ahead of the nan policy."""
    features, labels = batch   # on the device
    features, labels = self.model.preprocessor.preprocess(
        features, labels, ModeKeys.TRAIN,
        generator=self.crop_generator(state.step))
    draws = ({'generator': self.dropout_generator(state.step)}
             if self.model.draws_in_training else {})
    new_state, metrics = self.model.train_step(state, features, labels,
                                               **draws)
    if force_nan:
      metrics['loss'] = torch.full_like(metrics['loss'], math.nan)
    if self.nan_policy != 'skip':
      return new_state, metrics
    good = torch.isfinite(metrics['loss']).all()
    guarded = _tree_where(good, vars(new_state), vars(state))
    guarded['step'] = new_state.step
    metrics['nonfinite_loss_skipped'] = (~good).to(torch.int32)
    return TrainState(**guarded), metrics

  def _rollback(self, step: int, budget: int) -> TrainState:
    """The newest committed checkpoint, in place of a state whose loss at
    ``step`` was not finite; raises ``NonFiniteLossError`` past the budget
    or without a checkpoint."""
    if budget <= 0:
      raise NonFiniteLossError(
          step, 'rollback budget exhausted after {} rollback(s)'.format(
              self.nan_rollback_budget))
    try:
      restored = self.restore_latest()
    except FileNotFoundError as e:
      raise NonFiniteLossError(
          step, 'no committed checkpoint to roll back to ({})'.format(e))
    except Exception as e:  # noqa: BLE001 — still unwinds as a poisoned run
      raise NonFiniteLossError(step, 'rollback failed: {}'.format(e)) from e
    logging.warning('Non-finite loss at step %d: rolled back to checkpoint '
                    '%d (%d rollback(s) left).', step, restored.step,
                    budget - 1)
    self.registry.counter('reliability/nan_rollbacks').inc()
    return restored

  def _log(self, metrics, steps: int, seconds: float, data_s: float,
           batch_size: int, step: int,
           tracker: goodput_lib.GoodputTracker) -> None:
    values = {k: float(v) for k, v in metrics.items()}
    self.last_metrics = values
    self.windows.append((steps, seconds, data_s))
    registry = self.registry
    for key in ('loss', 'grasp_loss', 'l2_loss', 'action_accuracy',
                'action_mae'):
      if key in values:
        registry.gauge('train/' + key).set(values[key])
    steps_per_sec = steps / max(seconds, 1e-9)
    registry.gauge('train/steps_per_sec').set(steps_per_sec)
    registry.gauge('train/examples_per_sec').set(steps_per_sec * batch_size)
    writer = self.train_metrics_writer
    if writer is not None:
      scalars = dict(values)
      scalars['global_step/sec'] = steps_per_sec
      scalars['examples/sec'] = steps_per_sec * batch_size
      scalars.update(registry.scalars())
      scalars.update(tracker.scalars())
      writer.write_scalars(step, scalars)
      writer.flush()

  def train(self, input_generator: AbstractInputGenerator,
            max_train_steps: int, state: Optional[TrainState] = None,
            hooks: Sequence[Any] = ()) -> TrainState:
    """Trains up to global step ``max_train_steps``; returns the state.
    ``hooks`` see ``begin`` before the first step, ``after_step`` after
    every step and ``end`` after the last. Raises ``TrainingPreempted`` at
    a signal or the ``host.preempt`` site, its step committed first."""
    input_generator.set_specification_from_model(self.model, ModeKeys.TRAIN)
    self.train_generator = input_generator
    if state is None:
      state = self.init_state()
    if state.step >= max_train_steps:
      return state
    registry = self.registry
    skipped = registry.counter('train/nonfinite_loss_skipped')
    # Registered up front, so that a clean run shows an explicit 0.
    for name in ('reliability/nan_rollbacks', 'reliability/preemptions',
                 quarantine_lib.RECORDS_SKIPPED_COUNTER,
                 quarantine_lib.FILES_ABANDONED_COUNTER):
      registry.counter(name)
    host_check = self.nan_policy in ('raise', 'rollback')
    budget = self.nan_rollback_budget
    # Every second of the loop lands in one of the goodput categories.
    tracker = self.last_goodput = goodput_lib.GoodputTracker()
    self.last_preemption_save_s = None
    for hook in hooks:
      hook.begin(self)
    iterator = self.device_batches(self.dataset_iterator(
        input_generator, ModeKeys.TRAIN, state.step))
    window_start, window_steps, window_data_s = time.perf_counter(), 0, 0.0
    window_skipped = 0
    # The batch after a rollback is recovery, not data time.
    refetch = False
    completed = False
    with graceful_shutdown() as shutdown:
      try:
        while state.step < max_train_steps:
          iter_start = time.perf_counter()
          data_s = ckpt_s = retry_s = 0.0
          # An iteration that ends by continue, preemption or an exception
          # is still charged.
          try:
            with span('data.next') as sp:
              batch = next(iterator)
            if refetch:
              retry_s += sp.elapsed
              refetch = False
            else:
              data_s += sp.elapsed
            force_nan = fault_injection.fires(fault_injection.SITE_STEP_NAN)
            with span('train.step'):
              state, metrics = self._step(state, batch, force_nan)
            # A host stall that counts as productive time, as a real slow
            # step would.
            slow_s = fault_injection.slow_step_seconds()
            if slow_s > 0.0:
              time.sleep(slow_s)
            step = state.step
            if host_check and (step % self.nan_check_every_n_steps == 0 or
                               step % self.save_checkpoints_steps == 0 or
                               step == max_train_steps):
              with span('train.nan_check') as sp:
                finite = bool(torch.isfinite(metrics['loss']).all())
                if not finite:
                  if self.nan_policy == 'raise':
                    raise NonFiniteLossError(step, 'nan_policy="raise"')
                  state = self._rollback(step, budget)
              if not finite:
                retry_s += sp.elapsed
                budget -= 1
                refetch = True
                window_start, window_steps = time.perf_counter(), 0
                window_data_s = 0.0
                continue
            window_steps += 1
            window_data_s += data_s
            # Summed on the device; read at the log cadence only.
            window_skipped = window_skipped + metrics.get(
                'nonfinite_loss_skipped', 0)
            if step % self.log_every_n_steps == 0 or step == max_train_steps:
              self._log(metrics, window_steps,
                        time.perf_counter() - window_start, window_data_s,
                        input_generator.batch_size, step, tracker)
              skipped.inc(float(window_skipped))
              window_start, window_steps = time.perf_counter(), 0
              window_data_s, window_skipped = 0.0, 0
            if step % self.save_checkpoints_steps == 0:
              with span('train.checkpoint') as sp:
                self.save(state)
              ckpt_s += sp.elapsed
            for hook in hooks:
              hook.after_step(self, state, step, metrics)
            signum = None
            if shutdown.requested:
              signum = int(shutdown.signum)
            elif fault_injection.fires(fault_injection.SITE_HOST_PREEMPT):
              signum = fault_injection.INJECTED_PREEMPT_SIGNUM
            if signum is not None:
              # The restart resumes from this step, not the last periodic
              # checkpoint.
              with span('train.checkpoint') as sp:
                self._save_once(state)
              ckpt_s += sp.elapsed
              self.last_preemption_save_s = sp.elapsed
              registry.counter('reliability/preemptions').inc()
              raise TrainingPreempted(signum, step)
          finally:
            # Productive time is the remainder: the four categories
            # partition the iteration.
            tracker.add(goodput_lib.DATA, data_s)
            tracker.add(goodput_lib.CHECKPOINT, ckpt_s)
            tracker.add(goodput_lib.RETRY, retry_s)
            tracker.add(goodput_lib.PRODUCTIVE,
                        time.perf_counter() - iter_start - data_s - ckpt_s -
                        retry_s)
        completed = True
      finally:
        iterator.close()
        if not completed:
          # A NonFiniteLossError's state is poisoned ('raise', or a
          # rollback past its budget): committing it would make the poison
          # the newest checkpoint.
          self._emergency_save(state, skip_save=isinstance(
              sys.exc_info()[1], NonFiniteLossError))
    if state.step % self.save_checkpoints_steps:
      with span('train.checkpoint') as sp:
        self.save(state)
      tracker.add(goodput_lib.CHECKPOINT, sp.elapsed)
    for hook in hooks:
      hook.end(self, state)
    return state

  def _save_once(self, state: TrainState) -> None:
    """Saves ``state`` unless its step's checkpoint is already committed."""
    if state.step not in checkpointing.all_checkpoint_steps(self.model_dir):
      self.save(state)

  def _emergency_save(self, state: TrainState, skip_save: bool) -> None:
    """The failure path's cleanup: commit the state it has, flush the
    writers. The exception that is unwinding stays the one raised: a
    failing save or flush is logged."""
    if not skip_save:
      try:
        self._save_once(state)
      except Exception as e:  # noqa: BLE001
        logging.warning('Emergency checkpoint failed: %s', e)
    for writer in (self._train_writer, self._eval_writer):
      if writer is not None:
        try:
          writer.flush()
        except Exception as e:  # noqa: BLE001
          logging.warning('Writer flush on the failure path failed: %s', e)

  def save(self, state: TrainState) -> None:
    if self.is_chief:
      self.checkpoint_manager.save(state)

  def evaluate(self, input_generator: AbstractInputGenerator,
               eval_steps: int,
               state: Optional[TrainState] = None) -> Dict[str, float]:
    """Eval metrics averaged over ``eval_steps`` batches, on ``state`` (the
    newest checkpoint that restores when None), written to the eval
    event files at its step."""
    if state is None:
      state = self.restore_latest()
    self.last_eval_state = state
    input_generator.set_specification_from_model(self.model, ModeKeys.EVAL)
    iterator = self.device_batches(
        self.dataset_iterator(input_generator, ModeKeys.EVAL), 'eval')
    totals: Dict[str, float] = {}
    count = 0
    try:
      for features, labels in iterator:
        if count == eval_steps:
          break
        features, labels = self.model.preprocessor.preprocess(
            features, labels, ModeKeys.EVAL)
        for key, value in self.model.eval_step(state, features,
                                               labels).items():
          totals[key] = totals.get(key, 0.0) + float(value)
        count += 1
    finally:
      iterator.close()
    averaged = {k: v / max(count, 1) for k, v in totals.items()}
    writer = self.eval_metrics_writer
    if writer is not None:
      writer.write_scalars(state.step, averaged)
      writer.flush()
    return averaged

  def close(self) -> None:
    for writer in (self._train_writer, self._eval_writer):
      if writer is not None:
        writer.close()
    self._train_writer = self._eval_writer = None


def _snapshot_config(model_dir: str, filename: str,
                     operative: bool = False) -> None:
  """Writes the gin bindings (all of them, or those that configurables
  consumed) into ``model_dir``, where there are any."""
  from tensor2robot_tpu_torch.config import ginlike

  text = (ginlike.operative_config_str() if operative
          else ginlike.config_str())
  if text.strip():
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, filename), 'w') as f:
      f.write(text)


def train_eval_model(t2r_model, model_dir: str,
                     input_generator_train: Optional[
                         AbstractInputGenerator] = None,
                     input_generator_eval: Optional[
                         AbstractInputGenerator] = None,
                     max_train_steps: int = 1000,
                     eval_steps: int = 100,
                     eval_throttle_steps: int = 500,
                     create_exporters_fn: Optional[Callable] = None,
                     train_hook_builders: Sequence[Any] = (),
                     keep_checkpoint_max: int = 5,
                     save_checkpoints_steps: int = 500,
                     log_every_n_steps: int = 100,
                     nan_policy: str = 'skip',
                     nan_rollback_budget: int = 3,
                     nan_check_every_n_steps: int = 1,
                     seed: int = 0, feed_depth: int = 1,
                     eval_timeout_secs: float = 30.0,
                     write_metrics: bool = True,
                     eval_name: Optional[str] = None,
                     tp_rules: Optional[Sequence[Any]] = None,
                     async_checkpoints: bool = False
                     ) -> Dict[str, Any]:
  """The main entry point, in the JAX function's three modes:

    * train and eval: train ``eval_throttle_steps`` at a time, then an eval
      of ``eval_steps`` batches and the exporters, up to
      ``max_train_steps``;
    * train only (no eval generator);
    * eval only (no train generator): continuous eval of each checkpoint
      that lands in ``model_dir`` (``checkpoints_iterator``), the
      exporters after each, until none lands for ``eval_timeout_secs``.
      It never writes, removes or renames a checkpoint.

  ``feed_depth`` > 1 transfers that many train batches ahead.
  ``async_checkpoints`` (the pose env gins bind it False) asks JAX's
  trainer to write checkpoints in the background; the port writes each
  before the next step either way, so it changes nothing.
  ``tp_rules`` (``train_seq2act_moe.gin``'s ``@EP_RULES_MOE()``): rules
  that shard parameters over a group of the run decline where the run has
  no such group, as JAX's decline on a mesh without their axis; one that
  would shard raises (``parallel/sharding.py``). Writes the gin bindings
  it was given into ``config_snapshot.gin`` and those it used into
  ``operative_config.gin`` (on rank 0). Returns ``{'state',
  'eval_metrics', 'eval_history', 'trainer'}``; ``eval_history`` lists
  every eval's ``{'step', 'metrics', 'wall_time'}``.
  """
  del async_checkpoints
  if tp_rules:
    from tensor2robot_tpu_torch.parallel import sharding

    # The port's one group holds the sequence, JAX's 'data' axis.
    sharding.check_rules_decline(
        dict(t2r_model.network.state_dict()), tp_rules,
        {'data': collectives.world_size(t2r_model.process_group)})
  if input_generator_train is None and input_generator_eval is None:
    raise ValueError('Provide at least one of train/eval input generators.')
  if eval_name is None and input_generator_eval is not None:
    eval_name = getattr(input_generator_eval, 'multi_eval_name', None)
  trainer = Trainer(t2r_model, model_dir, seed=seed,
                    keep_checkpoint_max=keep_checkpoint_max,
                    save_checkpoints_steps=save_checkpoints_steps,
                    log_every_n_steps=log_every_n_steps,
                    nan_policy=nan_policy, feed_depth=feed_depth,
                    nan_rollback_budget=nan_rollback_budget,
                    nan_check_every_n_steps=nan_check_every_n_steps,
                    write_metrics=write_metrics, eval_name=eval_name,
                    # A continuous eval reads a live trainer's directory: it
                    # never renames a checkpoint there.
                    owns_checkpoint_dir=input_generator_train is not None)
  if trainer.is_chief:
    _snapshot_config(model_dir, 'config_snapshot.gin')
  hooks: List[Any] = []
  for builder in train_hook_builders:
    hooks.extend(builder.create_hooks(t2r_model, trainer))
  exporters = create_exporters_fn(t2r_model) if create_exporters_fn else []
  state, eval_metrics, history = None, {}, []

  def evaluated(current_state, metrics):
    history.append({'step': current_state.step, 'metrics': metrics,
                    'wall_time': time.time()})
    if trainer.is_chief:
      for exporter in exporters:
        exporter.export(trainer, current_state, metrics)

  try:
    if input_generator_train is not None and input_generator_eval is not None:
      target = 0
      while target < max_train_steps:
        target = min(target + eval_throttle_steps, max_train_steps)
        state = trainer.train(input_generator_train, target, state=state,
                              hooks=hooks)
        eval_metrics = trainer.evaluate(input_generator_eval, eval_steps,
                                        state)
        evaluated(state, eval_metrics)
    elif input_generator_train is not None:
      state = trainer.train(input_generator_train, max_train_steps,
                            hooks=hooks)
    else:
      for step in checkpointing.checkpoints_iterator(
          model_dir, timeout_secs=eval_timeout_secs):
        try:
          state = trainer.restore_latest()
        except CHECKPOINT_SKIP_ERRORS as e:
          # No step restores right now (a concurrent trainer may be
          # mid-commit): keep polling. Any other error, of the data path
          # or a checkpoint's contents, is not a checkpoint's transient and
          # propagates.
          logging.warning('Continuous eval: checkpoint %d does not restore '
                          '(%s); skipping it.', step, e)
          continue
        eval_metrics = trainer.evaluate(input_generator_eval, eval_steps,
                                        state)
        evaluated(state, eval_metrics)
  finally:
    if trainer.is_chief:
      _snapshot_config(model_dir, 'operative_config.gin', operative=True)
    trainer.close()
  return {'state': state, 'eval_metrics': eval_metrics,
          'eval_history': history, 'trainer': trainer}


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--model_dir', default='',
                      help='where checkpoints are written (and resumed '
                      'from); with --gin_configs, in place of the gin\'s '
                      'train_eval_model.model_dir')
  parser.add_argument('--gin_configs', action='append', default=[],
                      help='a gin file configuring train_eval_model '
                      '(repeatable); the flags below other than '
                      '--model_dir and --device then do not apply')
  parser.add_argument('--gin_bindings', action='append', default=[],
                      help='one gin binding, e.g. "train_eval_model.'
                      'max_train_steps = 100" (repeatable)')
  parser.add_argument('--model', default='qtopt', choices=MODELS,
                      help="'qtopt': the Grasping44 critic "
                      "(train_qtopt.gin); 'seq2act': the RT-1-style policy "
                      '(train_seq2act_bc.gin)')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  parser.add_argument('--batch_size', type=int, default=32,
                      help='TRAIN_BATCH_SIZE')
  parser.add_argument('--max_train_steps', type=int, default=1000000)
  parser.add_argument('--learning_rate', type=float, default=1e-4)
  parser.add_argument('--use_avg_model_params', type=int, default=None,
                      choices=(0, 1),
                      help="the model's own default when not given (1 for "
                      'qtopt, 0 for seq2act)')
  parser.add_argument('--num_convs', default='6,6,3',
                      help='qtopt: depth of the three conv stacks')
  parser.add_argument('--episode_length', type=int, default=6,
                      help='seq2act: frames an episode (512 in the '
                      'long-context binding)')
  parser.add_argument('--attention_mode', default='auto',
                      choices=('auto', 'xla', 'flash', 'ring'),
                      help="seq2act: the attention backend ('flash' in the "
                      "long-context binding; 'ring' shards the episodes' "
                      'frames over the ranks that torchrun starts, one a '
                      'card)')
  parser.add_argument('--seed', type=int, default=0,
                      help='seed of the initial weights, of the random '
                      'batches (plus the step) and, plus 1, of the random '
                      'crops')
  parser.add_argument('--save_checkpoints_steps', type=int, default=500)
  parser.add_argument('--keep_checkpoint_max', type=int, default=5)
  parser.add_argument('--log_every_n_steps', type=int, default=100)
  parser.add_argument('--train_data', default='',
                      help="TFRecord file patterns ('a*,b*') to train "
                      "from: the critic's grasp examples (qtopt) or "
                      "Seq2Act's episodes (seq2act); random batches when "
                      'not given')
  parser.add_argument('--eval_data', default='',
                      help='TFRecord file patterns to evaluate on (needs '
                      '--eval_steps); random batches when not given')
  parser.add_argument('--eval_steps', type=int, default=0,
                      help='> 0: evaluate this many batches every '
                      '--eval_throttle_steps')
  parser.add_argument('--eval_throttle_steps', type=int, default=500)
  parser.add_argument('--nan_policy', default='skip', choices=NAN_POLICIES)
  parser.add_argument('--device_decode', default='off',
                      choices=DEVICE_DECODE,
                      help="the split decode of the records' JPEG frames: "
                      "'off' (pixels, train_qtopt.gin), or the wire the "
                      "loader ships their DCT coefficients in, decoded on "
                      "the device: 'dense', 'sparse' "
                      "(train_qtopt_sparse.gin) or 'packed'")
  parser.add_argument('--sparse_density', type=float, default=0.5,
                      help="the sparse and packed wires' capacity a frame, "
                      'as a fraction of its DCT coefficients')
  parser.add_argument('--feed_depth', type=int, default=1,
                      help='> 1: transfer this many train batches ahead, '
                      'in a thread')
  return parser


def make_model(args, device: torch.device, process_group=None):
  """The ``--model`` of the command line, on ``device`` (a rank of
  ``process_group`` under ring attention), wrapped for the split decode
  where ``--device_decode`` asks for it."""
  kwargs = {'device': device, 'learning_rate': args.learning_rate}
  if args.use_avg_model_params is not None:
    kwargs['use_avg_model_params'] = bool(args.use_avg_model_params)
  if args.model == 'seq2act':
    from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel

    model = Seq2ActBCModel(episode_length=args.episode_length,
                           attention_mode=args.attention_mode,
                           process_group=process_group, **kwargs)
  else:
    from tensor2robot_tpu_torch.research.qtopt import t2r_models

    model = (t2r_models.
             Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
                 network_kwargs={'num_convs': tuple(
                     int(n) for n in args.num_convs.split(','))}, **kwargs))
  if args.device_decode != 'off':
    from tensor2robot_tpu_torch.preprocessors.device_decode import (
        wrap_model_with_device_decode)

    wrap_model_with_device_decode(model, wire_format=args.device_decode,
                                  sparse_density=args.sparse_density)
  return model


def loader_threads(ranks: int) -> int:
  """The native loader's worker threads for one of ``ranks`` training
  processes on a host: its share of the host's cores, up to 16, so that
  the ranks' loaders do not each take every core."""
  return max(1, min(16, (os.cpu_count() or 2) // max(1, ranks)))


def make_input_generators(args, ranks: int = 1):
  """The train and eval input generators of the command line: records
  where ``--train_data`` / ``--eval_data`` name them, their loaders on one
  of ``ranks`` shares of the host's cores (``loader_threads``), else
  random batches; no eval generator unless ``--eval_steps`` > 0."""

  def generator(patterns):
    if not patterns:
      return DefaultRandomInputGenerator(batch_size=args.batch_size)
    return DefaultRecordInputGenerator(
        file_patterns=patterns, batch_size=args.batch_size,
        num_native_threads=loader_threads(ranks))

  return (generator(args.train_data),
          generator(args.eval_data) if args.eval_steps > 0 else None)


def _print_line(result, model_name: str, device, world_size: int,
                seconds: float, **extra) -> None:
  """The command's JSON line: the loop's numbers, the metrics, the
  checkpoint."""
  trainer = result['trainer']
  train = trainer.train_generator
  windows = trainer.windows
  steps = sum(w[0] for w in windows)
  # A step's wall time and its wait for data, medians over the log windows
  # after the first (which pays for the first launches).
  later = windows[1:] or windows
  state = result['state']
  print(json.dumps({
      'data': (getattr(train, 'reader', None) or 'random') if train
              else 'none',
      # Seconds the loop waited for its batches, over all steps.
      'data_wait_sec': sum(w[2] for w in windows),
      'step_ms': statistics.median(w[1] / w[0] * 1e3 for w in later)
                 if later else None,
      'data_wait_ms': statistics.median(w[2] / w[0] * 1e3 for w in later)
                      if later else None,
      'step': state.step if state is not None else None,
      'model': model_name, **extra,
      # A batch's copies to the device, median ms (on the card, events).
      'transfer_ms': trainer.feed.transfer_ms(),
      'device': str(device), 'world_size': world_size,
      'metrics': trainer.last_metrics, 'eval_metrics': result['eval_metrics'],
      'eval_history': result['eval_history'],
      # Episodes (or critic examples) a second, however many ranks share
      # them.
      'examples_per_sec': steps * (train.batch_size if train else 0) / max(
          sum(w[1] for w in windows), 1e-9),
      'checkpoint_step': latest_checkpoint_step(trainer.model_dir),
      # The loop's seconds by goodput category, as fractions of them all.
      'goodput': (trainer.last_goodput.fractions()
                  if trainer.last_goodput is not None else None),
      'seconds': seconds}))


def _prepare_device(device: torch.device) -> None:
  if device.type == 'cuda':
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('built CUDA kernels in {:.1f}s'.format(kernels.build()))


def _gin_attention_mode() -> str:
  from tensor2robot_tpu_torch import config

  try:
    return config.query_parameter('Seq2ActBCModel.attention_mode')
  except config.ConfigError:
    return 'auto'


def _arm_faults_from_gin() -> None:
  """Installs the fault injector that the gins configure, where they bind
  ``configure_fault_injector.failures``."""
  from tensor2robot_tpu_torch import config

  try:
    config.query_parameter('configure_fault_injector.failures')
  except config.ConfigError:
    return
  config.get_configurable('configure_fault_injector')()


def main_gin(args) -> int:
  """``train_eval_model`` as the gin files and bindings configure it (the
  port's ``bin/run_t2r_trainer.py``), with ``--model_dir`` and
  ``--device`` applied. Every configurable that the gins name must be one
  the port registers (``config.check_configurables``). Where they bind
  ``Seq2ActBCModel.attention_mode = "ring"``, the ranks that torchrun
  starts build the sequence group first (JAX's gin binds its mesh) and the
  model gets it as its ``process_group`` on ``cuda:LOCAL_RANK``. Where
  they bind ``configure_fault_injector.failures``, that injector is
  installed before the run (the faults of ``reliability/``)."""
  from tensor2robot_tpu_torch import config

  config.register_framework_configurables()
  config.add_config_file_search_path(
      os.path.dirname(os.path.dirname(os.path.dirname(
          os.path.abspath(__file__)))))
  config.clear_config()
  config.parse_config_files_and_bindings(args.gin_configs, [
      '{}.device = {!r}'.format(name, args.device) for name in GIN_MODELS
  ] + list(args.gin_bindings))
  config.check_configurables()
  _arm_faults_from_gin()
  device, group, world = torch.device(args.device), None, 1
  if _gin_attention_mode() == 'ring':
    from tensor2robot_tpu_torch.parallel import mesh

    sequence = mesh.init_sequence_group(args.device)
    device, group, world = (sequence.device, sequence.group,
                            sequence.world_size)
    config.bind_parameter('Seq2ActBCModel.process_group', group)
    config.bind_parameter('Seq2ActBCModel.device', str(device))
  overrides = {'model_dir': args.model_dir} if args.model_dir else {}
  try:
    _prepare_device(device)
    start = time.perf_counter()
    result = config.get_configurable('train_eval_model')(**overrides)
  finally:
    if group is not None:
      dist.destroy_process_group()
  trainer = result['trainer']
  if trainer.is_chief:
    _print_line(result, type(trainer.model).__name__, device, world,
                time.perf_counter() - start, gin_configs=args.gin_configs)
  return 0


def main(argv=None) -> int:
  parser = make_parser()
  args = parser.parse_args(argv)
  if args.gin_configs or args.gin_bindings:
    return main_gin(args)
  if not args.model_dir:
    parser.error('--model_dir is required without --gin_configs.')
  if args.eval_data and args.eval_steps <= 0:
    parser.error('--eval_data needs --eval_steps > 0.')
  if args.device_decode != 'off' and (
      not args.train_data or (args.eval_steps > 0 and not args.eval_data)):
    parser.error('--device_decode decodes records: it needs --train_data '
                 '(and --eval_data with --eval_steps).')
  device, group = torch.device(args.device), None
  if args.attention_mode == 'ring':
    if args.model != 'seq2act':
      raise ValueError('--attention_mode ring trains --model seq2act.')
    from tensor2robot_tpu_torch.parallel import mesh

    sequence = mesh.init_sequence_group(args.device)
    device, group = sequence.device, sequence.group
  try:
    _prepare_device(device)
    model = make_model(args, device, group)
    # The ranks of a ring are torchrun's processes on this host.
    train, evaluate = make_input_generators(
        args, collectives.world_size(group))
    start = time.perf_counter()
    result = train_eval_model(
        model, args.model_dir, train, evaluate,
        max_train_steps=args.max_train_steps, eval_steps=args.eval_steps,
        eval_throttle_steps=args.eval_throttle_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        save_checkpoints_steps=args.save_checkpoints_steps,
        log_every_n_steps=args.log_every_n_steps, nan_policy=args.nan_policy,
        seed=args.seed, feed_depth=args.feed_depth)
  finally:
    if group is not None:
      dist.destroy_process_group()
  if not result['trainer'].is_chief:
    return 0
  _print_line(result, args.model, device, collectives.world_size(group),
              time.perf_counter() - start,
              device_decode=args.device_decode, feed_depth=args.feed_depth)
  return 0


if __name__ == '__main__':
  sys.exit(main())
