"""The exceptions of the port's fault-tolerance layer (a copy of the JAX
package's ``reliability/errors.py``).

  * transient (retry): ``InjectedFault`` and ``OSError`` / ``TimeoutError``;
    bounded retry with backoff, then ``RetryError``.
  * data-local (skip and budget): ``CorruptRecordError``, charged to a
    ``RecordQuarantine`` until ``CorruptionBudgetExceeded``.
  * checkpoint-local (fall back to an older step): ``RetryError`` and
    ``CorruptCheckpointError``, together ``CHECKPOINT_SKIP_ERRORS``.
  * run-level (stop or roll back): ``NonFiniteLossError``,
    ``TrainingPreempted``.
"""

from __future__ import annotations

from typing import Optional

__all__ = ['CHECKPOINT_SKIP_ERRORS', 'CorruptCheckpointError',
           'CorruptRecordError', 'CorruptionBudgetExceeded', 'InjectedFault',
           'NonFiniteLossError', 'RetryError', 'TRANSIENT_IO_ERRORS',
           'TrainingPreempted']


class InjectedFault(IOError):
  """A failure forced by the ``FaultInjector`` at a named site; an
  ``IOError``, so that the default ``RetryPolicy`` retries it as the
  transient I/O error it stands for."""

  def __init__(self, site: str, call_index: int):
    super().__init__(
        'Injected fault at site {!r} (call #{})'.format(site, call_index))
    self.site = site
    self.call_index = call_index


class RetryError(IOError):
  """All retry attempts exhausted; ``last`` holds the final cause."""

  def __init__(self, site: Optional[str], attempts: int,
               last: BaseException):
    super().__init__(
        'Gave up after {} attempt(s){}: {}'.format(
            attempts, ' at site {!r}'.format(site) if site else '', last))
    self.site = site
    self.attempts = attempts
    self.last = last


class CorruptRecordError(IOError):
  """One unreadable record (bad CRC or truncation)."""

  def __init__(self, path: str, reason: str,
               record_index: Optional[int] = None):
    at = '' if record_index is None else ' (record #{})'.format(record_index)
    super().__init__('Corrupt TFRecord {} in {}{}'.format(reason, path, at))
    self.path = path
    self.reason = reason
    self.record_index = record_index


class CorruptionBudgetExceeded(IOError):
  """More corrupt records than the quarantine's budget allows; names the
  last offender (a file, or a replay shard)."""

  def __init__(self, path: str, scope: str, limit: int):
    super().__init__(
        'Corrupt-record budget exhausted: more than {} corrupt record(s) {} '
        '- last offender: {}. The data is damaged beyond the configured '
        'tolerance; repair or exclude it.'.format(
            limit, 'in one file' if scope == 'file' else 'across the run',
            path))
    self.path = path
    self.scope = scope
    self.limit = limit


class CorruptCheckpointError(IOError):
  """A checkpoint whose file is visibly damaged (truncated, or refused by
  ``torch.load``). Transient from its reader's side: skip to another step
  or wait for the next one."""

  def __init__(self, directory: str, step: int, detail: str):
    super().__init__(
        'Checkpoint step {} in {} is damaged ({}).'.format(
            step, directory, detail))
    self.directory = directory
    self.step = step


class NonFiniteLossError(RuntimeError):
  """The loss of a step was not finite and the nan policy stops (or its
  rollback budget ran out, or there was nothing to roll back to)."""

  def __init__(self, step: int, reason: str = ''):
    super().__init__('Non-finite loss at step {}{}.'.format(
        step, ': ' + reason if reason else ''))
    self.step = step


class TrainingPreempted(Exception):
  """SIGTERM or SIGINT (or the injected ``host.preempt``) reached the
  train loop; the checkpoint of ``step`` was committed before this was
  raised."""

  def __init__(self, signum: int, step: int):
    super().__init__(
        'Training preempted by signal {} at step {} (emergency checkpoint '
        'committed).'.format(signum, step))
    self.signum = signum
    self.step = step


# What the retrying wrappers treat as transient by default (IOError is
# OSError; InjectedFault and FileNotFoundError are OSErrors).
TRANSIENT_IO_ERRORS = (OSError, TimeoutError)

# What a checkpoint's reader skips past (to an older step, or to the next
# poll): the checkpoint manager's restore fails transiently only as these.
# Narrower than TRANSIENT_IO_ERRORS: an OSError of a data path (a missing
# dataset, an exhausted corruption budget) is not a checkpoint's and
# propagates.
CHECKPOINT_SKIP_ERRORS = (RetryError, CorruptCheckpointError)
