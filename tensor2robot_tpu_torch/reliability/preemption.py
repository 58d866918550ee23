"""Preemption-safe shutdown: SIGTERM / SIGINT become a clean save point (a
copy of the JAX package's ``reliability/preemption.py``).

A scheduler preempts with SIGTERM and a grace window. The trainer wraps its
loop in ``graceful_shutdown()``: the handler only sets a flag, the loop sees
it at the next step boundary, commits the checkpoint of that step and
raises ``TrainingPreempted``, so that the restart resumes where the signal
landed.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator, Optional, Sequence

__all__ = ['ShutdownFlag', 'graceful_shutdown']


class ShutdownFlag:
  """Set by the signal handler, polled by the train loop."""

  def __init__(self):
    self.signum: Optional[int] = None

  @property
  def requested(self) -> bool:
    return self.signum is not None


@contextlib.contextmanager
def graceful_shutdown(
    signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT)
) -> Iterator[ShutdownFlag]:
  """Defers ``signals`` to the returned flag; restores the handlers on exit.

  Only the main thread can install a handler: from any other thread this
  yields a flag that never fires, and the default handlers stay.
  """
  flag = ShutdownFlag()
  if threading.current_thread() is not threading.main_thread():
    yield flag
    return
  previous = {}

  def _handler(signum, frame):  # noqa: ARG001 — the signal API's
    flag.signum = signum

  for sig in signals:
    try:
      previous[sig] = signal.signal(sig, _handler)
    except (ValueError, OSError):  # not a signal of this platform
      continue
  try:
    yield flag
  finally:
    for sig, handler in previous.items():
      signal.signal(sig, handler)
