"""The exceptions of the port's fault-tolerance layer (a copy of the part of
the JAX package's ``reliability/errors.py`` that the port uses).

  * transient (retry): ``OSError`` / ``TimeoutError``; bounded retry with
    backoff, then ``RetryError``.
  * data-local (skip and budget): ``CorruptRecordError``, charged to a
    ``RecordQuarantine`` until ``CorruptionBudgetExceeded``.
"""

from __future__ import annotations

from typing import Optional

__all__ = ['CorruptRecordError', 'CorruptionBudgetExceeded', 'RetryError',
           'TRANSIENT_IO_ERRORS']


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


# What the retrying wrappers treat as transient by default (IOError is
# OSError).
TRANSIENT_IO_ERRORS = (OSError, TimeoutError)
