"""Deterministic, site-addressed fault injection (a copy of the JAX
package's ``reliability/fault_injection.py``, with the sites the port has).

A ``FaultInjector`` arms failures at named call sites; each wired site calls
``maybe_fail(site)`` (a raising site) or ``fires(site)`` (a boolean one) on
every pass. Determinism comes from counting calls per site: "fail calls 3
and 4 of ``ckpt.save``" reproduces exactly, with no randomness.

Sites wired in the port:
  * ``ckpt.save``: ``trainer/checkpointing.py`` ``CheckpointManager.save``,
    inside its retry loop.
  * ``ckpt.restore``: ``CheckpointManager.restore``, inside its retry loop.
  * ``data.read``: the Python TFRecord reader (``data/tfrecord.py``), a
    read record treated as corrupt.
  * ``step.nan``: the trainer's step; a device-side flag makes its loss
    NaN.
  * ``step.slow``: the trainer's loop sleeps ``SLOW_STEP_SECONDS`` after
    the step, charged to productive time as a real slowdown would be.
  * ``data.stall``: ``data/device_feed.py`` ``HostDeviceFeed``, a sleep of
    ``DATA_STALL_SECONDS`` before a batch's transfer.
  * ``host.preempt``: the trainer's step boundary, the path that SIGTERM
    takes (emergency checkpoint, ``TrainingPreempted``), signum
    ``INJECTED_PREEMPT_SIGNUM``.
  * ``replay.append``: the replay service's append corrupts the arriving
    record (truncation), driving the per-shard quarantine budget.
  * ``replay.sample``: the replay service's draw sleeps
    ``REPLAY_SAMPLE_STALL_SECONDS``.
  * ``actor.stall``: the RL loop's acting step sleeps
    ``ACTOR_STALL_SECONDS``, while the concurrent learner keeps stepping.
  * ``learner.swap``: the RL loop drops one actor-side weight poll; the
    next poll adopts the snapshot (at least once, not exactly once).

``configure_fault_injector`` is registered for the gins
(``config/registry.py``): a gin arms faults for a whole run.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from tensor2robot_tpu_torch.reliability.errors import InjectedFault

__all__ = ['ACTOR_STALL_SECONDS', 'DATA_STALL_SECONDS', 'FaultInjector',
           'INJECTED_PREEMPT_SIGNUM',
           'REPLAY_SAMPLE_STALL_SECONDS', 'SITE_ACTOR_STALL',
           'SITE_CKPT_RESTORE', 'SITE_CKPT_SAVE', 'SITE_DATA_READ',
           'SITE_DATA_STALL', 'SITE_HOST_PREEMPT', 'SITE_LEARNER_SWAP',
           'SITE_REPLAY_APPEND', 'SITE_REPLAY_SAMPLE', 'SITE_STEP_NAN',
           'SITE_STEP_SLOW', 'SLOW_STEP_SECONDS', 'actor_stall_seconds',
           'configure_fault_injector', 'fires', 'get_injector', 'maybe_fail',
           'replay_sample_stall_seconds', 'set_injector',
           'slow_step_seconds', 'stall_data_seconds']

SITE_CKPT_SAVE = 'ckpt.save'
SITE_CKPT_RESTORE = 'ckpt.restore'
SITE_DATA_READ = 'data.read'
SITE_STEP_NAN = 'step.nan'
SITE_STEP_SLOW = 'step.slow'
SITE_DATA_STALL = 'data.stall'
SITE_HOST_PREEMPT = 'host.preempt'
SITE_REPLAY_APPEND = 'replay.append'
SITE_REPLAY_SAMPLE = 'replay.sample'
SITE_ACTOR_STALL = 'actor.stall'
SITE_LEARNER_SWAP = 'learner.swap'

# The signum of a preemption driven by the injected 'host.preempt' site (no
# signal was delivered).
INJECTED_PREEMPT_SIGNUM = -1

# How long one fired 'step.slow' stalls the loop, and one fired
# 'data.stall' the host-to-device feed. Module-level, so that tests tune
# them with a monkeypatch.
SLOW_STEP_SECONDS = 0.25
DATA_STALL_SECONDS = 0.25

# How long one fired 'replay.sample' stalls a replay draw.
REPLAY_SAMPLE_STALL_SECONDS = 0.25

# How long one fired 'actor.stall' wedges the RL loop's acting step.
ACTOR_STALL_SECONDS = 0.25


class FaultInjector:
  """Counts calls per site and fires armed failures deterministically."""

  def __init__(self):
    self._lock = threading.Lock()
    # site -> the call indices (0-based) that must fail.
    self._armed: Dict[str, List[int]] = {}
    self._calls: Dict[str, int] = {}
    self._fired: Dict[str, int] = {}

  def fail(self, site: str, times: int = 1, after: int = 0) -> 'FaultInjector':
    """Arms ``times`` consecutive failures at ``site``, skipping the first
    ``after`` calls. Returns self for chaining."""
    with self._lock:
      already = self._calls.get(site, 0)
      armed = self._armed.setdefault(site, [])
      start = already + after
      armed.extend(range(start, start + times))
    return self

  def fires(self, site: str) -> bool:
    """Consumes one call at ``site``; True when an armed failure fires."""
    with self._lock:
      index = self._calls.get(site, 0)
      self._calls[site] = index + 1
      if index in self._armed.get(site, ()):
        self._fired[site] = self._fired.get(site, 0) + 1
        return True
      return False

  def maybe_fail(self, site: str) -> None:
    """Consumes one call at ``site``; raises ``InjectedFault`` when an
    armed failure fires."""
    if self.fires(site):
      raise InjectedFault(site, self.call_count(site) - 1)

  def call_count(self, site: str) -> int:
    with self._lock:
      return self._calls.get(site, 0)

  def fired_count(self, site: str) -> int:
    with self._lock:
      return self._fired.get(site, 0)


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_LOCK = threading.Lock()


def get_injector() -> Optional[FaultInjector]:
  """The process-wide injector, or None when injection is off."""
  return _INJECTOR


def set_injector(injector: Optional[FaultInjector]) -> None:
  """Installs the process-wide injector (None turns injection off)."""
  global _INJECTOR
  with _INJECTOR_LOCK:
    _INJECTOR = injector


def fires(site: str) -> bool:
  """The hook of a wired site; False when injection is off."""
  injector = _INJECTOR
  if injector is not None:
    return injector.fires(site)
  return False


def maybe_fail(site: str) -> None:
  """The hook of a raising site; nothing when injection is off."""
  injector = _INJECTOR
  if injector is not None:
    injector.maybe_fail(site)


def slow_step_seconds() -> float:
  """Seconds the 'step.slow' site stalls THIS step; 0.0 when unarmed."""
  return SLOW_STEP_SECONDS if fires(SITE_STEP_SLOW) else 0.0


def stall_data_seconds() -> float:
  """Seconds the 'data.stall' site wedges THIS batch; 0.0 when unarmed."""
  return DATA_STALL_SECONDS if fires(SITE_DATA_STALL) else 0.0


def replay_sample_stall_seconds() -> float:
  """Seconds the 'replay.sample' site stalls THIS draw; 0.0 when unarmed."""
  return REPLAY_SAMPLE_STALL_SECONDS if fires(SITE_REPLAY_SAMPLE) else 0.0


def actor_stall_seconds() -> float:
  """Seconds the 'actor.stall' site wedges THIS acting step; 0.0 when
  unarmed."""
  return ACTOR_STALL_SECONDS if fires(SITE_ACTOR_STALL) else 0.0


FaultSpec = Union[Dict[str, int], Sequence[Union[Tuple[str, int],
                                                 Tuple[str, int, int]]]]


def configure_fault_injector(
    failures: Optional[FaultSpec] = None) -> Optional[FaultInjector]:
  """Installs a process-wide injector from a spec a gin can bind.

  ``failures`` is ``{'ckpt.save': 2}`` (fail the first 2 calls of a site)
  or ``[('data.read', 1, 5), ...]``, tuples of ``(site, times[, after])``.
  None or empty uninstalls the injector.
  """
  if not failures:
    set_injector(None)
    return None
  injector = FaultInjector()
  if isinstance(failures, dict):
    items = [(site, times, 0) for site, times in failures.items()]
  else:
    items = [tuple(entry) + (0,) * (3 - len(entry)) for entry in failures]
  for site, times, after in items:
    injector.fail(site, times=int(times), after=int(after))
  set_injector(injector)
  return injector
