"""Trace spans: wall-time histograms that line up with the profiler's trace
(the JAX package's ``observability/spans.py``).

``span('data.next')`` times a region with ``time.perf_counter`` and records
its milliseconds into the registry histogram ``span/data.next``. Inside a
``torch.profiler`` window the span also enters
``torch.profiler.record_function`` of the same name (where JAX enters a
``TraceAnnotation``), so that the host's seams (the data wait, a
checkpoint's save, the step's dispatch) are named rows of the same trace
as the device's kernels. Outside a window a span is two ``perf_counter``
reads and one histogram bump.

As a context manager it exposes ``elapsed`` (seconds) after exit, so that
a site that also feeds the goodput split times the region once::

    with span('data.next') as sp:
      batch = next(iterator)
    data_s += sp.elapsed
"""

from __future__ import annotations

import sys
import time

from tensor2robot_tpu_torch.observability import registry as registry_lib

__all__ = ['SPAN_BUCKETS_MS', 'span']

# Milliseconds, 0.01 ms up to minutes (a slow checkpoint, a cold reader).
SPAN_BUCKETS_MS = registry_lib.exponential_buckets(0.01, 2.0, 25)


class span:  # noqa: N801 — reads as a keyword at its sites
  """Times one region into ``span/<name>`` (ms); annotates a profiler
  window."""

  __slots__ = ('_name', '_start', '_annotation', 'elapsed')

  def __init__(self, name: str):
    self._name = name
    self._start = 0.0
    self._annotation = None
    self.elapsed = 0.0

  def __enter__(self) -> 'span':
    # Without torch loaded (the replay service) no profiler window is open.
    profiler = sys.modules.get('torch.autograd.profiler')
    if profiler is not None and profiler._is_profiler_enabled:  # noqa: SLF001
      import torch

      self._annotation = torch.profiler.record_function(self._name)
      self._annotation.__enter__()
    self._start = time.perf_counter()
    return self

  def __exit__(self, exc_type, exc, tb) -> None:
    self.elapsed = time.perf_counter() - self._start
    if self._annotation is not None:
      self._annotation.__exit__(exc_type, exc, tb)
      self._annotation = None
    registry_lib.get_registry().histogram(
        'span/' + self._name, bounds=SPAN_BUCKETS_MS).record(
            self.elapsed * 1e3)
