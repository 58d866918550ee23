"""Deterministic, site-addressed fault injection (the part of the JAX
package's ``reliability/fault_injection.py`` that the port wires).

A ``FaultInjector`` arms failures at named call sites; each wired site calls
``fires(site)`` on every pass. Determinism comes from counting calls per
site: "fail calls 3 and 4 of ``replay.append``" reproduces exactly, with no
randomness.

Sites wired in the port:
  * ``replay.append``: the replay service's append corrupts the arriving
    record (truncation), driving the per-shard quarantine budget.
  * ``replay.sample``: the replay service's draw sleeps
    ``REPLAY_SAMPLE_STALL_SECONDS``.
  * ``actor.stall``: the RL loop's acting step sleeps
    ``ACTOR_STALL_SECONDS``, while the concurrent learner keeps stepping.
  * ``learner.swap``: the RL loop drops one actor-side weight poll; the
    next poll adopts the snapshot (at least once, not exactly once).

The JAX trainer's sites (``ckpt.save``, ``ckpt.restore``, ``data.read``,
``step.nan``, ``step.slow``, ``data.stall``, ``host.preempt``) are not
wired in the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ['ACTOR_STALL_SECONDS', 'FaultInjector',
           'REPLAY_SAMPLE_STALL_SECONDS', 'SITE_ACTOR_STALL',
           'SITE_LEARNER_SWAP', 'SITE_REPLAY_APPEND', 'SITE_REPLAY_SAMPLE',
           'actor_stall_seconds', 'fires', 'replay_sample_stall_seconds',
           'set_injector']

SITE_REPLAY_APPEND = 'replay.append'
SITE_REPLAY_SAMPLE = 'replay.sample'
SITE_ACTOR_STALL = 'actor.stall'
SITE_LEARNER_SWAP = 'learner.swap'

# How long one fired 'replay.sample' stalls a replay draw. Module-level,
# so that tests tune it with a monkeypatch.
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

  def call_count(self, site: str) -> int:
    with self._lock:
      return self._calls.get(site, 0)

  def fired_count(self, site: str) -> int:
    with self._lock:
      return self._fired.get(site, 0)


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_LOCK = threading.Lock()


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


def replay_sample_stall_seconds() -> float:
  """Seconds the 'replay.sample' site stalls THIS draw; 0.0 when unarmed."""
  return REPLAY_SAMPLE_STALL_SECONDS if fires(SITE_REPLAY_SAMPLE) else 0.0


def actor_stall_seconds() -> float:
  """Seconds the 'actor.stall' site wedges THIS acting step; 0.0 when
  unarmed."""
  return ACTOR_STALL_SECONDS if fires(SITE_ACTOR_STALL) else 0.0
