"""The trainer's fault tolerance, as the JAX package's
``tests/test_reliability.py`` holds JAX's (its classes
``TestCheckpointRetry``, ``TestPreemptionAndCleanup``,
``TestContinuousEvalSurvival`` and ``TestSingleRunSurvivesAllFaults``), on
the pusher's critic (a 64-wide MLP that trains on the CPU in milliseconds a
step): retried and exhausted checkpoint I/O, SIGTERM and ``host.preempt``
committing their step, the emergency save, readers falling back past
injected failures and damaged checkpoints, one run surviving a corrupt
record, a NaN and a save failure, and the corruption budget naming its
file. Also: a preempted-then-resumed run equal to an uninterrupted one bit
for bit, the goodput split summing to 1 with each fault in its category,
and a gin binding arming the injector."""

import os
import signal

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.data import tfrecord
from tensor2robot_tpu_torch.data import wire
from tensor2robot_tpu_torch.data.input_generators import (
    DefaultRandomInputGenerator, DefaultRecordInputGenerator)
from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.reliability import (
    CorruptCheckpointError, CorruptionBudgetExceeded, FaultInjector,
    NonFiniteLossError, RetryError, RetryPolicy, TrainingPreempted,
    fault_injection, set_injector)
from tensor2robot_tpu_torch.research import pusher_env
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval
from tensor2robot_tpu_torch.trainer.checkpointing import (
    CheckpointManager, latest_checkpoint_step)

# No sleeps: injected faults never wait.
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay_secs=0.0, jitter=0.0)


@pytest.fixture(autouse=True)
def _clean_injector(monkeypatch):
  monkeypatch.setattr(checkpointing, 'DEFAULT_CKPT_RETRY', FAST_RETRY)
  set_injector(None)
  yield
  set_injector(None)


@pytest.fixture
def model_dir(tmp_path):
  return str(tmp_path / 'run')


def _model():
  return pusher_env.PusherCriticModel(device='cpu')


def _trainer(model_dir, **kwargs):
  kwargs.setdefault('save_checkpoints_steps', 10 ** 9)
  kwargs.setdefault('log_every_n_steps', 100)
  return train_eval.Trainer(_model(), model_dir, **kwargs)


def _random(batch_size=8):
  return DefaultRandomInputGenerator(batch_size=batch_size)


def _counter(name):
  return get_registry().counter(name).value


def _states_equal(a, b):
  def flat(tree, prefix=''):
    if isinstance(tree, dict):
      for key, value in tree.items():
        yield from flat(value, prefix + '/' + key)
    else:
      yield prefix, tree
  left, right = dict(flat(vars(a))), dict(flat(vars(b)))
  assert left.keys() == right.keys()
  for key, value in left.items():
    if isinstance(value, torch.Tensor):
      assert torch.equal(value, right[key]), key
    else:
      assert value == right[key], key


def _write_records(path, count, seed=0):
  rng = np.random.RandomState(seed)
  with tfrecord.TFRecordWriter(path) as writer:
    for _ in range(count):
      writer.write(wire.build_example({
          'state': rng.randn(6).astype(np.float32),
          'action': rng.uniform(-1, 1, 2).astype(np.float32),
          'reward': rng.rand(1).astype(np.float32)}))


class _AtStep:
  """A hook that calls ``fn`` after step ``step``."""

  def __init__(self, step, fn):
    self._step, self._fn = step, fn

  def begin(self, trainer):
    pass

  def after_step(self, trainer, state, step, metrics):
    if step == self._step:
      self._fn()

  def end(self, trainer, state):
    pass


# -- retrying checkpoint I/O ------------------------------------------------


def _state(step=1):
  state = _model().create_train_state(torch.Generator().manual_seed(0))
  state.step = step
  return state


def test_save_retries_past_transient_failures(model_dir):
  injector = FaultInjector().fail('ckpt.save', times=2)
  set_injector(injector)
  before = get_registry().counter_family(
      'reliability/io_retries', ('site',)).series('ckpt.save').value
  CheckpointManager(model_dir).save(_state())
  assert injector.fired_count('ckpt.save') == 2
  assert latest_checkpoint_step(model_dir) == 1
  assert get_registry().counter_family(
      'reliability/io_retries', ('site',)).series('ckpt.save').value == (
          before + 2)


def test_save_exhaustion_raises_retry_error(model_dir):
  set_injector(FaultInjector().fail('ckpt.save', times=10))
  with pytest.raises(RetryError, match='ckpt.save'):
    CheckpointManager(model_dir).save(_state())
  assert latest_checkpoint_step(model_dir) is None


def test_restore_retries_past_transient_failures(model_dir):
  manager = CheckpointManager(model_dir)
  manager.save(_state(4))
  injector = FaultInjector().fail('ckpt.restore', times=2)
  set_injector(injector)
  _states_equal(manager.restore(4), _state(4))
  assert injector.fired_count('ckpt.restore') == 2


# -- preemption and the failure path -----------------------------------------


def test_sigterm_commits_its_step_and_a_new_trainer_resumes(model_dir):
  trainer = _trainer(model_dir)
  before = _counter('reliability/preemptions')
  with pytest.raises(TrainingPreempted) as raised:
    trainer.train(_random(), 50, hooks=[_AtStep(3, lambda: os.kill(
        os.getpid(), signal.SIGTERM))])
  assert raised.value.signum == signal.SIGTERM and raised.value.step == 3
  assert latest_checkpoint_step(model_dir) == 3
  assert _counter('reliability/preemptions') == before + 1
  # The handler was restored: the test process still has its own.
  assert signal.getsignal(signal.SIGTERM) is not None
  state = _trainer(model_dir).train(_random(), 5)
  assert state.step == 5


def test_a_midloop_exception_saves_its_step(model_dir):
  def boom():
    raise RuntimeError('boom')

  with pytest.raises(RuntimeError, match='boom'):
    _trainer(model_dir).train(_random(), 50, hooks=[_AtStep(3, boom)])
  assert latest_checkpoint_step(model_dir) == 3


def test_a_poisoned_state_is_not_saved(model_dir):
  set_injector(FaultInjector().fail('step.nan', times=1, after=2))
  with pytest.raises(NonFiniteLossError):
    _trainer(model_dir, nan_policy='raise').train(_random(), 50)
  assert latest_checkpoint_step(model_dir) is None


@pytest.mark.parametrize('nan_step, raised_at, committed', [
    (1, None, [2, 4, 6]),   # between checks: missed, as the cadence allows
    (2, 2, []),             # about to be checkpointed: checked, not saved
    (5, 5, [2, 4]),         # at the cadence
])
def test_the_nan_check_runs_at_its_cadence_and_before_every_save(
    model_dir, nan_step, raised_at, committed):
  """nan_check_every_n_steps=5, a save every 2 steps, nan_policy 'raise':
  the host checks steps 5 and 2, 4, 6, so a NaN at step 2 never reaches a
  checkpoint."""
  set_injector(FaultInjector().fail('step.nan', times=1, after=nan_step - 1))
  trainer = _trainer(model_dir, nan_policy='raise', nan_check_every_n_steps=5,
                     save_checkpoints_steps=2)
  if raised_at is None:
    assert trainer.train(_random(), 6).step == 6
  else:
    with pytest.raises(NonFiniteLossError) as raised:
      trainer.train(_random(), 6)
    assert raised.value.step == raised_at
  assert checkpointing.all_checkpoint_steps(model_dir) == committed


def test_preempted_then_resumed_equals_uninterrupted(tmp_path):
  """host.preempt at step 5 of 8 (saves every 4, a NaN skipped at step 2 on
  both sides): the emergency checkpoint at 5, a new trainer restores it
  (one injected restore failure retried) and finishes bit for bit as the
  run without the preemption."""
  set_injector(FaultInjector().fail('step.nan', times=1, after=1))
  whole = _trainer(str(tmp_path / 'whole'), save_checkpoints_steps=4).train(
      _random(), 8)
  set_injector(FaultInjector().fail('step.nan', times=1, after=1)
               .fail('host.preempt', times=1, after=4))
  preempted = _trainer(str(tmp_path / 'cut'), save_checkpoints_steps=4)
  with pytest.raises(TrainingPreempted) as raised:
    preempted.train(_random(), 8)
  assert raised.value.signum == fault_injection.INJECTED_PREEMPT_SIGNUM
  assert raised.value.step == 5
  assert checkpointing.all_checkpoint_steps(str(tmp_path / 'cut')) == [4, 5]
  assert preempted.last_preemption_save_s > 0
  injector = fault_injection.get_injector()
  injector.fail('ckpt.restore', times=1)
  resumed = _trainer(str(tmp_path / 'cut'), save_checkpoints_steps=4).train(
      _random(), 8)
  assert injector.fired_count('ckpt.restore') == 1
  assert injector.fired_count('step.nan') == 1
  _states_equal(resumed, whole)


def test_goodput_split_sums_to_one_with_each_fault_in_its_category(
    model_dir, monkeypatch):
  """A data stall lands in data time, a slow step in productive time, the
  saves in checkpoint time, a rollback's restore in retry time; the four
  fractions sum to 1; the event file and the registry carry them."""
  monkeypatch.setattr(fault_injection, 'DATA_STALL_SECONDS', 0.2)
  monkeypatch.setattr(fault_injection, 'SLOW_STEP_SECONDS', 0.2)
  set_injector(FaultInjector().fail('data.stall', times=1, after=1)
               .fail('step.slow', times=1, after=2)
               .fail('step.nan', times=1, after=4))
  trainer = _trainer(model_dir, save_checkpoints_steps=2,
                     log_every_n_steps=2, nan_policy='rollback')
  state = trainer.train(_random(), 6)
  assert state.step == 6
  seconds = trainer.last_goodput.seconds()
  fractions = trainer.last_goodput.fractions()
  assert abs(sum(fractions.values()) - 1.0) <= 1e-9
  assert seconds['data'] >= 0.2 and seconds['productive'] >= 0.2
  assert seconds['checkpoint'] > 0 and seconds['retry'] > 0
  scalars = trainer.last_goodput.scalars()
  assert scalars['goodput/data_seconds'] == seconds['data']
  assert get_registry().histogram('span/train.step').count >= 6
  trainer.close()


def test_a_gin_binding_arms_the_injector():
  from tensor2robot_tpu_torch import config

  config.register_framework_configurables()
  config.clear_config()
  try:
    config.parse_config_files_and_bindings([], [
        "configure_fault_injector.failures = [('ckpt.save', 2), "
        "('host.preempt', 1, 8)]"])
    config.check_configurables()
    train_eval._arm_faults_from_gin()
    injector = fault_injection.get_injector()
    assert [injector.fires('ckpt.save') for _ in range(3)] == [
        True, True, False]
    assert [injector.fires('host.preempt') for _ in range(10)] == (
        [False] * 8 + [True, False])
  finally:
    config.clear_config()


# -- readers that fall back --------------------------------------------------


def _pretrain(model_dir):
  """Checkpoints at 3 and 6."""
  _trainer(model_dir, save_checkpoints_steps=3).train(_random(), 6)


def test_restore_falls_back_past_injected_failures(model_dir):
  _pretrain(model_dir)
  set_injector(FaultInjector().fail('ckpt.restore', times=3))
  assert _trainer(model_dir).init_state().step == 3


def test_a_truncated_newest_is_quarantined_by_its_owner(model_dir):
  _pretrain(model_dir)
  path = os.path.join(model_dir, 'checkpoint_6.pt')
  with open(path, 'rb') as f:
    whole = f.read()
  with open(path, 'wb') as f:
    f.write(whole[:len(whole) // 2])
  with pytest.raises(CorruptCheckpointError, match='step 6'):
    CheckpointManager(model_dir, quarantine_damaged=False).restore(6)
  assert os.path.exists(path)
  assert _trainer(model_dir).init_state().step == 3
  assert not os.path.exists(path) and os.path.exists(path + '.corrupt')


@pytest.mark.parametrize('damage', ['injected', 'truncated'])
def test_predictor_and_continuous_eval_fall_back(model_dir, damage):
  """Past an injected restore failure that outlasts the retries, or a
  truncated newest checkpoint; neither reader renames the file."""
  from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
      CheckpointPredictor)

  _pretrain(model_dir)
  path = os.path.join(model_dir, 'checkpoint_6.pt')
  if damage == 'truncated':
    with open(path, 'rb') as f:
      whole = f.read()
    with open(path, 'wb') as f:
      f.write(whole[:len(whole) // 3])
  else:
    set_injector(FaultInjector().fail('ckpt.restore', times=3))
  predictor = CheckpointPredictor(_model(), model_dir, timeout=5.0)
  assert predictor.restore() and predictor.global_step == 3
  if damage == 'injected':
    set_injector(FaultInjector().fail('ckpt.restore', times=3))
  result = train_eval.train_eval_model(
      _model(), model_dir, input_generator_eval=_random(), eval_steps=1,
      eval_timeout_secs=0.2, write_metrics=False)
  assert [e['step'] for e in result['eval_history']] == [3]
  assert 'loss' in result['eval_metrics']
  assert os.path.exists(path)


# -- one run, all faults -----------------------------------------------------


def test_one_run_survives_a_corrupt_record_a_nan_and_a_save_failure(
    model_dir, tmp_path):
  path = str(tmp_path / 'train.tfrecord')
  _write_records(path, 64)
  injector = (FaultInjector().fail('data.read', times=1, after=5)
              .fail('step.nan', times=1, after=2)
              .fail('ckpt.save', times=1, after=1))
  set_injector(injector)
  skipped = _counter('train/nonfinite_loss_skipped')
  generator = DefaultRecordInputGenerator(
      file_patterns=path, batch_size=8, skip_corrupt_records=True,
      shuffle_buffer_size=8)
  trainer = _trainer(model_dir, save_checkpoints_steps=2,
                     log_every_n_steps=2)
  state = trainer.train(generator, 6)
  assert generator.reader == 'python'
  for site in ('data.read', 'step.nan', 'ckpt.save'):
    assert injector.fired_count(site) == 1, site
  assert state.step == 6 and latest_checkpoint_step(model_dir) == 6
  assert generator.quarantine.records_skipped == 1
  assert _counter('train/nonfinite_loss_skipped') == skipped + 1
  assert all(torch.isfinite(v).all() for v in state.params.values())
  trainer.close()


def test_budget_exhaustion_fails_loudly_with_the_filename(tmp_path):
  path = str(tmp_path / 'hopeless.tfrecord')
  _write_records(path, 32)
  set_injector(FaultInjector().fail('data.read', times=1000))
  generator = DefaultRecordInputGenerator(
      file_patterns=path, batch_size=4, skip_corrupt_records=True,
      max_corrupt_records_per_file=3)
  generator.set_specification_from_model(_model(), 'eval')
  with pytest.raises(CorruptionBudgetExceeded, match='hopeless.tfrecord'):
    list(generator.create_dataset_iterator('eval', num_epochs=1))
