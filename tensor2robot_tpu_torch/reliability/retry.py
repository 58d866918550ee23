"""Bounded retry with exponential backoff and jitter (a copy of the JAX
package's ``reliability/retry.py``).

Synchronous and dependency-free: callers wrap the smallest failing
operation, not whole loops, so that a retry never replays side effects that
already landed. The replay client retries its HTTP calls through it.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from tensor2robot_tpu_torch.observability import get_registry
from tensor2robot_tpu_torch.reliability.errors import (
    RetryError,
    TRANSIENT_IO_ERRORS,
)

__all__ = ['RetryPolicy', 'retry']

T = TypeVar('T')

# Every retried failure is charged here, labeled by site. The family
# resolves lazily, so that a swapped test registry is honored.
_RETRY_COUNTER_NAME = 'reliability/io_retries'


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """How to retry one site.

  Attributes:
    max_attempts: total tries (1 = no retry).
    base_delay_secs: delay before the first retry.
    backoff: multiplier per further retry.
    max_delay_secs: delay ceiling.
    jitter: extra uniform-random fraction of the delay in [0, jitter],
      decorrelating fleets that fail together; jitter=0 disables.
    retryable: exception types worth retrying. Everything else propagates
      immediately (a deterministic error does not get better with sleep).
  """

  max_attempts: int = 3
  base_delay_secs: float = 0.05
  backoff: float = 2.0
  max_delay_secs: float = 5.0
  jitter: float = 0.1
  retryable: Tuple[Type[BaseException], ...] = TRANSIENT_IO_ERRORS

  def delay_secs(self, retry_index: int) -> float:
    delay = min(self.base_delay_secs * (self.backoff ** retry_index),
                self.max_delay_secs)
    if self.jitter:
      delay *= 1.0 + self.jitter * random.random()
    return delay


def retry(fn: Callable[[], T],
          policy: Optional[RetryPolicy] = None,
          site: Optional[str] = None) -> T:
  """Calls ``fn`` until it succeeds or the policy is exhausted.

  Args:
    fn: zero-arg operation; its return value is passed through.
    policy: RetryPolicy; None uses the defaults.
    site: name for error messages and the retry counter's label.

  Raises:
    RetryError: wrapping the last retryable failure once attempts run out.
    Any non-retryable exception: immediately, unwrapped.
  """
  policy = policy or RetryPolicy()
  attempts = max(1, policy.max_attempts)
  last: Optional[BaseException] = None
  for attempt in range(attempts):
    try:
      return fn()
    except policy.retryable as e:  # pylint: disable=catching-non-exception
      last = e
      if attempt + 1 >= attempts:
        break
      get_registry().counter_family(
          _RETRY_COUNTER_NAME, ('site',)).series(site or 'unknown').inc()
      time.sleep(policy.delay_secs(attempt))
  raise RetryError(site, attempts, last) from last
