"""Train (and evaluate) a model on the GPU: the port's counterpart of the
JAX package's ``trainer/train_eval.py`` (``Trainer``, ``train_eval_model``),
train-only and train+eval.

Each train step, on the model's device:

  1. the next batch of numpy arrays (made ahead by the input generator)
     is copied to the device from pinned memory;
  2. the model's preprocessor runs in TRAIN mode (the random crop and
     ``/ 255`` through kernel K1: one offset per frame for the Grasping44
     critic, one per episode for Seq2Act), the random offsets of global
     step k drawn from a device generator seeded from ``(seed + 1, k)``, as
     the JAX step folds the step into its key;
  3. ``model.train_step``: loss, autograd, optimizer, EMA.

A step whose loss is not finite follows ``nan_policy``: ``'skip'`` (the
default, as in the JAX trainer) keeps every tensor of the state at its
value before the step, on the device and without waiting for it, while
the step counter advances, and reports ``nonfinite_loss_skipped``;
``'raise'`` checks the loss on the host after every step and raises
``NonFiniteLossError``. Every ``log_every_n_steps`` the metrics reach the
host and the observability registry (gauges ``train/loss``,
``train/grasp_loss`` and ``train/l2_loss`` (the critic),
``train/action_accuracy`` and ``train/action_mae`` (Seq2Act),
``train/steps_per_sec``, ``train/examples_per_sec``; counter
``train/nonfinite_loss_skipped``).
Checkpoints are written every ``save_checkpoints_steps`` and at the end;
a trainer starts from the newest checkpoint in ``model_dir`` when there is
one.

The train batch of global step k is drawn from ``seed + k`` and every
eval's batches from ``seed + EVAL_SEED_OFFSET`` on, apart from every train
batch: a segment after an eval and a resumed run go on with the batches
and crops that an uninterrupted run would have drawn.

Ring attention (``--attention_mode ring``) trains one model over the N
ranks of a ``torch.distributed`` group, one process per card, each holding
its T/N frames of every episode (``model.frame_shard``). Each rank draws
only those frames of the batch, frame by frame from seeds of their own, and
the per-episode keys (``task_id``) and the crop offsets alike on every rank:
the ranks' shares concatenate to the batch that one rank draws alone. Rank
0 writes the checkpoints (and the command line's JSON line); every rank
restores them.

Not ported yet: continuous eval (eval-only), hooks, exporters, fault
injection, the compiled-artifact store.

Command line, with ``train_qtopt.gin``'s bindings as flags (``--model
qtopt``, the default) or ``train_seq2act_bc.gin``'s (``--model seq2act``:
``--episode_length``, ``--attention_mode``, ``--learning_rate``; random
input batches; reading records from disk is not ported yet)::

    python -m tensor2robot_tpu_torch.trainer.train_eval \\
        --model_dir /tmp/qtopt --max_train_steps 100
    python -m tensor2robot_tpu_torch.trainer.train_eval --device cpu \\
        --num_convs 1,1,1 --max_train_steps 2 --batch_size 2 \\
        --model_dir /tmp/qtopt_cpu
    python -m tensor2robot_tpu_torch.trainer.train_eval --model seq2act \\
        --episode_length 512 --attention_mode flash --batch_size 8 \\
        --model_dir /tmp/seq2act --max_train_steps 100
    torchrun --nproc_per_node 4 -m tensor2robot_tpu_torch.trainer.train_eval \\
        --model seq2act --episode_length 512 --attention_mode ring \\
        --batch_size 32 --model_dir /tmp/seq2act_ring --max_train_steps 100
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data.input_generators import (
    AbstractInputGenerator, DefaultRandomInputGenerator)
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.trainer.checkpointing import (
    CheckpointManager, latest_checkpoint_step)

__all__ = ['MODELS', 'NAN_POLICIES', 'NonFiniteLossError', 'Trainer',
           'main', 'make_model', 'make_parser', 'train_eval_model']

NAN_POLICIES = ('skip', 'raise')
MODELS = ('qtopt', 'seq2act')
# Eval batches are drawn from seeds this far above the train batches' (batch
# i of an iterator seeded s draws seeds s + i and s + i + 977).
EVAL_SEED_OFFSET = 1 << 30
# The crops of global step k are drawn from seed (seed + 1) * this + k.
CROP_SEED_STRIDE = 1 << 32


class NonFiniteLossError(RuntimeError):
  """The loss of a step was not finite under ``nan_policy='raise'``."""

  def __init__(self, step: int):
    super().__init__('Non-finite loss at step {}.'.format(step))
    self.step = step


def _tree_where(good: torch.Tensor, new, old):
  if isinstance(new, dict):
    return {k: _tree_where(good, v, old[k]) for k, v in new.items()}
  if isinstance(new, torch.Tensor):
    return torch.where(good, new, old)
  return new


class Trainer:
  """Owns the train and eval loops and the checkpoints of one model."""

  def __init__(self, model, model_dir: str, seed: int = 0,
               keep_checkpoint_max: int = 5,
               save_checkpoints_steps: int = 500,
               log_every_n_steps: int = 100, nan_policy: str = 'skip'):
    if nan_policy not in NAN_POLICIES:
      raise ValueError('nan_policy must be one of {}; got {!r}.'.format(
          NAN_POLICIES, nan_policy))
    self.model = model
    self.model_dir = model_dir
    self.seed = seed
    self.save_checkpoints_steps = save_checkpoints_steps
    self.log_every_n_steps = max(1, int(log_every_n_steps))
    self.nan_policy = nan_policy
    self.checkpoint_manager = CheckpointManager(model_dir,
                                                keep_checkpoint_max)
    # Rank 0 of the model's group writes the checkpoints.
    self.is_chief = collectives.rank(model.process_group) == 0
    self.registry = get_registry()
    self._crop_generator = None
    # (steps, seconds, seconds waiting for data) of every log window.
    self.windows: List[tuple] = []
    self.last_metrics: Dict[str, float] = {}

  def crop_generator(self, step: int) -> torch.Generator:
    """The device generator of the TRAIN preprocessor's random draws at
    global step ``step``, seeded from ``(seed + 1, step)``: a resumed run
    draws the crops that an uninterrupted one would have."""
    if self._crop_generator is None:
      self._crop_generator = torch.Generator(device=self.model.device)
    self._crop_generator.manual_seed(
        ((self.seed + 1) * CROP_SEED_STRIDE + step) % (1 << 63))
    return self._crop_generator

  def init_state(self) -> TrainState:
    """The newest checkpoint in ``model_dir``, else a fresh state from
    ``seed``."""
    step = latest_checkpoint_step(self.model_dir)
    if step is not None:
      return self.checkpoint_manager.restore(step, self.model.device)
    return self.model.create_train_state(
        torch.Generator().manual_seed(self.seed))

  def put_batch(self, arrays) -> Optional[Dict[str, torch.Tensor]]:
    """numpy arrays -> tensors on the model's device (through pinned memory
    to a CUDA device)."""
    if arrays is None:
      return None
    device = self.model.device
    out = {}
    for key, value in arrays.items():
      tensor = torch.from_numpy(np.ascontiguousarray(value))
      if device.type == 'cuda':
        tensor = tensor.pin_memory().to(device, non_blocking=True)
      else:
        tensor = tensor.to(device)
      out[key] = tensor
    return out

  def dataset_iterator(self, input_generator: AbstractInputGenerator,
                       mode: str, step: int = 0):
    """This rank's share (``model.frame_shard``) of the batches of
    ``mode``, TRAIN's from global step ``step`` on."""
    seed = self.seed + (EVAL_SEED_OFFSET if mode == ModeKeys.EVAL else step)
    return input_generator.create_dataset_iterator(
        mode, seed=seed, frames=self.model.frame_shard())

  def _step(self, state: TrainState, batch):
    features, labels = batch
    features, labels = self.model.preprocessor.preprocess(
        self.put_batch(features), self.put_batch(labels), ModeKeys.TRAIN,
        generator=self.crop_generator(state.step))
    new_state, metrics = self.model.train_step(state, features, labels)
    if self.nan_policy == 'raise':
      if not bool(torch.isfinite(metrics['loss']).all()):
        raise NonFiniteLossError(new_state.step)
      return new_state, metrics
    good = torch.isfinite(metrics['loss']).all()
    guarded = _tree_where(good, vars(new_state), vars(state))
    guarded['step'] = new_state.step
    metrics['nonfinite_loss_skipped'] = (~good).to(torch.int32)
    return TrainState(**guarded), metrics

  def _log(self, metrics, steps: int, seconds: float, data_s: float,
           batch_size: int) -> None:
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

  def train(self, input_generator: AbstractInputGenerator,
            max_train_steps: int,
            state: Optional[TrainState] = None) -> TrainState:
    """Trains up to global step ``max_train_steps``; returns the state."""
    input_generator.set_specification_from_model(self.model, ModeKeys.TRAIN)
    if state is None:
      state = self.init_state()
    if state.step >= max_train_steps:
      return state
    skipped = self.registry.counter('train/nonfinite_loss_skipped')
    iterator = self.dataset_iterator(input_generator, ModeKeys.TRAIN,
                                     state.step)
    try:
      window_start, window_steps, data_s = time.perf_counter(), 0, 0.0
      window_skipped = 0
      while state.step < max_train_steps:
        wait_start = time.perf_counter()
        batch = next(iterator)
        data_s += time.perf_counter() - wait_start
        state, metrics = self._step(state, batch)
        window_steps += 1
        # Summed on the device; read at the log cadence only.
        window_skipped = window_skipped + metrics.get(
            'nonfinite_loss_skipped', 0)
        if (state.step % self.log_every_n_steps == 0 or
            state.step == max_train_steps):
          self._log(metrics, window_steps,
                    time.perf_counter() - window_start, data_s,
                    input_generator.batch_size)
          skipped.inc(float(window_skipped))
          window_start, window_steps, data_s = time.perf_counter(), 0, 0.0
          window_skipped = 0
        if state.step % self.save_checkpoints_steps == 0:
          self.save(state)
    finally:
      iterator.close()
    if state.step % self.save_checkpoints_steps:
      self.save(state)
    return state

  def save(self, state: TrainState) -> None:
    if self.is_chief:
      self.checkpoint_manager.save(state)

  def evaluate(self, input_generator: AbstractInputGenerator,
               eval_steps: int, state: TrainState) -> Dict[str, float]:
    """Eval metrics averaged over ``eval_steps`` batches."""
    input_generator.set_specification_from_model(self.model, ModeKeys.EVAL)
    iterator = self.dataset_iterator(input_generator, ModeKeys.EVAL)
    totals: Dict[str, float] = {}
    count = 0
    try:
      for features, labels in iterator:
        if count == eval_steps:
          break
        features, labels = self.model.preprocessor.preprocess(
            self.put_batch(features), self.put_batch(labels), ModeKeys.EVAL)
        for key, value in self.model.eval_step(state, features,
                                               labels).items():
          totals[key] = totals.get(key, 0.0) + float(value)
        count += 1
    finally:
      iterator.close()
    return {k: v / max(count, 1) for k, v in totals.items()}


def train_eval_model(t2r_model, model_dir: str,
                     input_generator_train: Optional[
                         AbstractInputGenerator] = None,
                     input_generator_eval: Optional[
                         AbstractInputGenerator] = None,
                     max_train_steps: int = 1000,
                     eval_steps: int = 100,
                     eval_throttle_steps: int = 500,
                     keep_checkpoint_max: int = 5,
                     save_checkpoints_steps: int = 500,
                     log_every_n_steps: int = 100,
                     nan_policy: str = 'skip',
                     seed: int = 0) -> Dict[str, Any]:
  """The main entry point: train-only (no eval generator), or train with
  an eval of ``eval_steps`` batches every ``eval_throttle_steps`` and at
  the end. Returns ``{'state', 'eval_metrics', 'trainer'}``."""
  if input_generator_train is None:
    raise NotImplementedError('Eval-only (continuous eval) is not ported '
                              'yet; pass input_generator_train.')
  trainer = Trainer(t2r_model, model_dir, seed=seed,
                    keep_checkpoint_max=keep_checkpoint_max,
                    save_checkpoints_steps=save_checkpoints_steps,
                    log_every_n_steps=log_every_n_steps,
                    nan_policy=nan_policy)
  eval_metrics: Dict[str, float] = {}
  if input_generator_eval is None:
    state = trainer.train(input_generator_train, max_train_steps)
  else:
    state, target = None, 0
    while target < max_train_steps:
      target = min(target + eval_throttle_steps, max_train_steps)
      state = trainer.train(input_generator_train, target, state=state)
      eval_metrics = trainer.evaluate(input_generator_eval, eval_steps,
                                      state)
  return {'state': state, 'eval_metrics': eval_metrics, 'trainer': trainer}


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--model_dir', required=True,
                      help='where checkpoints are written (and resumed '
                      'from)')
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
  parser.add_argument('--eval_steps', type=int, default=0,
                      help='> 0: evaluate this many random batches every '
                      '--eval_throttle_steps')
  parser.add_argument('--eval_throttle_steps', type=int, default=500)
  parser.add_argument('--nan_policy', default='skip', choices=NAN_POLICIES)
  return parser


def make_model(args, device: torch.device, process_group=None):
  """The ``--model`` of the command line, on ``device`` (a rank of
  ``process_group`` under ring attention)."""
  kwargs = {'device': device, 'learning_rate': args.learning_rate}
  if args.use_avg_model_params is not None:
    kwargs['use_avg_model_params'] = bool(args.use_avg_model_params)
  if args.model == 'seq2act':
    from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel

    return Seq2ActBCModel(episode_length=args.episode_length,
                          attention_mode=args.attention_mode,
                          process_group=process_group, **kwargs)
  from tensor2robot_tpu_torch.research.qtopt import t2r_models

  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      network_kwargs={'num_convs': tuple(
          int(n) for n in args.num_convs.split(','))}, **kwargs)


def main(argv=None) -> int:
  args = make_parser().parse_args(argv)
  device, group = torch.device(args.device), None
  if args.attention_mode == 'ring':
    if args.model != 'seq2act':
      raise ValueError('--attention_mode ring trains --model seq2act.')
    from tensor2robot_tpu_torch.parallel import mesh

    sequence = mesh.init_sequence_group(args.device)
    device, group = sequence.device, sequence.group
  try:
    if device.type == 'cuda':
      torch.backends.cudnn.allow_tf32 = False
      torch.backends.cuda.matmul.allow_tf32 = False
      print('built CUDA kernels in {:.1f}s'.format(kernels.build()))
    model = make_model(args, device, group)
    train = DefaultRandomInputGenerator(batch_size=args.batch_size)
    evaluate = (DefaultRandomInputGenerator(batch_size=args.batch_size)
                if args.eval_steps > 0 else None)
    start = time.perf_counter()
    result = train_eval_model(
        model, args.model_dir, train, evaluate,
        max_train_steps=args.max_train_steps, eval_steps=args.eval_steps,
        eval_throttle_steps=args.eval_throttle_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        save_checkpoints_steps=args.save_checkpoints_steps,
        log_every_n_steps=args.log_every_n_steps, nan_policy=args.nan_policy,
        seed=args.seed)
  finally:
    if group is not None:
      dist.destroy_process_group()
  trainer = result['trainer']
  if not trainer.is_chief:
    return 0
  steps = sum(w[0] for w in trainer.windows)
  seconds = sum(w[1] for w in trainer.windows)
  print(json.dumps({
      'step': result['state'].step, 'model': args.model,
      'device': str(device),
      'world_size': collectives.world_size(group),
      'metrics': trainer.last_metrics, 'eval_metrics': result['eval_metrics'],
      # Episodes (or critic examples) a second, however many ranks share
      # them.
      'examples_per_sec': steps * args.batch_size / max(seconds, 1e-9),
      'checkpoint_step': latest_checkpoint_step(args.model_dir),
      'seconds': time.perf_counter() - start}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
