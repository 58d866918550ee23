"""Goodput: where every second of the train loop went (the JAX package's
``observability/goodput.py``).

The trainer charges each second of its loop to one category:

  * ``productive``: the step's dispatch and device time, and everything not
    claimed below (logging, hooks, an injected slow step);
  * ``data``: waiting for the batch (the reader and the host-to-device
    copy);
  * ``checkpoint``: saving checkpoints (periodic, forced and final);
  * ``retry``: recovery: a NaN rollback's restore and the batch fetched
    again after it.

``productive`` is the remainder of each iteration, so the four partition
the loop's wall time and their fractions sum to 1. The trainer writes
``goodput/<category>_seconds`` and ``goodput/<category>_fraction`` with its
event file's scalars at the log cadence, and the command line's JSON line
carries the fractions.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ['CATEGORIES', 'CHECKPOINT', 'DATA', 'GoodputTracker',
           'PRODUCTIVE', 'RETRY']

PRODUCTIVE = 'productive'
DATA = 'data'
CHECKPOINT = 'checkpoint'
RETRY = 'retry'

CATEGORIES = (PRODUCTIVE, DATA, CHECKPOINT, RETRY)


class GoodputTracker:
  """Seconds per category; their totals and fractions."""

  def __init__(self):
    self._lock = threading.Lock()
    self._seconds = {category: 0.0 for category in CATEGORIES}

  def add(self, category: str, seconds: float) -> None:
    if category not in self._seconds:
      raise ValueError('Unknown goodput category {!r}; expected one of {}.'
                       .format(category, CATEGORIES))
    with self._lock:
      # The clock's resolution must not make a category negative.
      self._seconds[category] += max(0.0, seconds)

  def seconds(self) -> Dict[str, float]:
    with self._lock:
      return dict(self._seconds)

  def total_seconds(self) -> float:
    with self._lock:
      return sum(self._seconds.values())

  def fractions(self) -> Dict[str, float]:
    """Each category's share of the accounted time: they sum to 1 (all 0
    before any time is recorded)."""
    with self._lock:
      total = sum(self._seconds.values())
      if total <= 0.0:
        return {category: 0.0 for category in CATEGORIES}
      return {category: value / total
              for category, value in self._seconds.items()}

  def scalars(self, prefix: str = 'goodput/') -> Dict[str, float]:
    """The event file's scalars: cumulative seconds and fractions."""
    out = {'{}{}_seconds'.format(prefix, category): value
           for category, value in self.seconds().items()}
    out.update({'{}{}_fraction'.format(prefix, category): value
                for category, value in self.fractions().items()})
    out[prefix + 'total_seconds'] = self.total_seconds()
    return out
