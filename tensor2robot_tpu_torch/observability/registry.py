"""Telemetry registry: process-wide counters, gauges and histograms.

A copy of the JAX package's ``observability/registry.py``, cut to what the
serving path uses. Names, bucket edges and the ``scalars()`` /
``snapshot()`` export forms are the same, so the JAX package's readers see
the same metrics from either package.

  * Thread-safe: every instrument takes its own small lock; the registry
    lock is held only while an instrument is created.
  * No allocation on the hot path: ``Counter.inc``, ``Gauge.set`` and
    ``Histogram.record`` build no containers and format no strings.
  * Fixed buckets: percentiles interpolate inside the owning bucket,
    clamped to the observed min/max, so they are exact to one bucket width.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    'Counter',
    'Gauge',
    'Histogram',
    'TelemetryRegistry',
    'exponential_buckets',
    'get_registry',
    'set_registry',
    'DEFAULT_LATENCY_BUCKETS_MS',
    'DEFAULT_SECONDS_BUCKETS',
    'SLO_LATENCY_BUCKETS_MS',
]


def exponential_buckets(start: float, factor: float, count: int
                        ) -> Tuple[float, ...]:
  """``count`` upper bounds: start, start*factor, ... (an +inf overflow
  bucket is implicit in every histogram)."""
  if start <= 0 or factor <= 1 or count < 1:
    raise ValueError('exponential_buckets needs start>0, factor>1, count>=1; '
                     'got ({}, {}, {}).'.format(start, factor, count))
  return tuple(start * factor ** i for i in range(count))


# 0.05ms .. ~105s in x2 steps: wide enough for an on-device CEM dispatch at
# the bottom and a cold-start XLA compile at the top.
DEFAULT_LATENCY_BUCKETS_MS = exponential_buckets(0.05, 2.0, 21)
# 1ms .. ~1000s in x2 steps: span durations (data waits, checkpoint saves).
DEFAULT_SECONDS_BUCKETS = exponential_buckets(0.001, 2.0, 20)
# SLO-resolution latency edges: the default x2 edges
# put the 30 Hz envelope between 26.2 and 52.4 ms — a 26 ms-wide bucket,
# which makes "p99 < 33 ms" unanswerable from the histogram. These edges
# keep sub-ms resolution at the bottom (0.05..0.8 ms, x2) and 1 ms
# resolution across 1..100 ms, so any percentile inside the SLO band is
# interpolated to within 1 ms; >100 ms lands in x2 overflow decades up
# to ~1.6 s (a wedged batch is still measured, just coarsely).
SLO_LATENCY_BUCKETS_MS = (exponential_buckets(0.05, 2.0, 5)
                          + tuple(float(i) for i in range(1, 101))
                          + exponential_buckets(200.0, 2.0, 4))


class Counter:
  """Monotonic float counter."""

  __slots__ = ('_lock', '_value')

  def __init__(self):
    self._lock = threading.Lock()
    self._value = 0.0

  def inc(self, amount: float = 1.0) -> None:
    if amount < 0:
      raise ValueError('Counter can only increase; got {}.'.format(amount))
    with self._lock:
      self._value += amount

  @property
  def value(self) -> float:
    with self._lock:
      return self._value

  def reset(self) -> None:
    with self._lock:
      self._value = 0.0


class Gauge:
  """Last-write-wins instantaneous value."""

  __slots__ = ('_lock', '_value')

  def __init__(self):
    self._lock = threading.Lock()
    self._value = 0.0

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  def inc(self, amount: float = 1.0) -> None:
    with self._lock:
      self._value += amount

  @property
  def value(self) -> float:
    with self._lock:
      return self._value

  def reset(self) -> None:
    with self._lock:
      self._value = 0.0


class Histogram:
  """Fixed-bucket histogram with interpolated percentiles.

  ``bounds`` are inclusive upper bucket edges; one overflow bucket
  (+inf) is appended. Observations are unitless here — by convention the
  registry's metric name carries the unit (``..._ms``, ``..._seconds``).
  """

  __slots__ = ('_lock', '_bounds', '_counts', '_count', '_sum', '_min',
               '_max')

  def __init__(self, bounds: Sequence[float]):
    bounds = tuple(float(b) for b in bounds)
    if not bounds:
      raise ValueError('Histogram needs at least one bucket bound.')
    if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
      raise ValueError('Histogram bounds must be strictly increasing.')
    self._lock = threading.Lock()
    self._bounds = bounds
    self._counts = [0] * (len(bounds) + 1)  # +1: overflow bucket
    self._count = 0
    self._sum = 0.0
    self._min = math.inf
    self._max = -math.inf

  def record(self, value: float) -> None:
    index = bisect.bisect_left(self._bounds, value)
    with self._lock:
      self._counts[index] += 1
      self._count += 1
      self._sum += value
      if value < self._min:
        self._min = value
      if value > self._max:
        self._max = value

  @property
  def count(self) -> int:
    with self._lock:
      return self._count

  @property
  def sum(self) -> float:
    with self._lock:
      return self._sum

  @property
  def mean(self) -> float:
    with self._lock:
      return self._sum / self._count if self._count else 0.0

  def percentile(self, p: float) -> float:
    """Interpolated percentile estimate, exact to one bucket width.

    The rank lands in some bucket; the estimate interpolates linearly
    between that bucket's edges (clamped to the observed min/max, so the
    first/overflow buckets stay finite and single-value distributions
    return the value itself).
    """
    if not 0.0 <= p <= 100.0:
      raise ValueError('percentile must be in [0, 100]; got {}.'.format(p))
    with self._lock:
      return self._percentile_locked(p)

  def _percentile_locked(self, p: float) -> float:
    if self._count == 0:
      return 0.0
    rank = (p / 100.0) * self._count
    cumulative = 0
    for index, bucket_count in enumerate(self._counts):
      if bucket_count == 0:
        continue
      if cumulative + bucket_count >= rank:
        lower = self._bounds[index - 1] if index > 0 else self._min
        upper = (self._bounds[index] if index < len(self._bounds)
                 else self._max)
        lower = max(lower, self._min)
        upper = min(upper, self._max)
        if upper <= lower:
          return lower
        fraction = (rank - cumulative) / bucket_count
        return lower + fraction * (upper - lower)
      cumulative += bucket_count
    return self._max  # numerically unreachable; guards fp drift

  def summary(self) -> Dict[str, float]:
    """The scalar digest the trainer exports: count/mean/p50/p95/p99.

    Computed under ONE lock acquisition so a concurrent record()/reset()
    can never produce a torn digest (count from one state, max from
    another, or a -inf sentinel leaking into TensorBoard).
    """
    with self._lock:
      if self._count == 0:
        return {'count': 0.0}
      return {
          'count': float(self._count),
          'mean': self._sum / self._count,
          'p50': self._percentile_locked(50.0),
          'p95': self._percentile_locked(95.0),
          'p99': self._percentile_locked(99.0),
          'max': self._max,
      }

  def state(self) -> Dict[str, object]:
    """Full bucket state for snapshot export / jsonl round-trips."""
    with self._lock:
      return {
          'bounds': list(self._bounds),
          'counts': list(self._counts),
          'count': self._count,
          'sum': self._sum,
          'min': None if self._count == 0 else self._min,
          'max': None if self._count == 0 else self._max,
      }

  def reset(self) -> None:
    with self._lock:
      self._counts = [0] * (len(self._bounds) + 1)
      self._count = 0
      self._sum = 0.0
      self._min = math.inf
      self._max = -math.inf


class _Family:
  """A named instrument family keyed by label values.

  Histogram families additionally support **per-series bucket edges**:
  ``series(*labels, bounds=...)`` creates that one
  series with its own edges while every other series keeps the family
  default — the serving latency series needs 1 ms SLO resolution, but
  re-bucketing every existing predictor series for it would invalidate
  their history. A later ``series()`` call without ``bounds`` returns
  the existing instrument whatever its edges; a later call with
  DIFFERENT explicit bounds raises (same torn-layout rationale as
  ``TelemetryRegistry`` re-registration).
  """

  def __init__(self, make, label_names: Tuple[str, ...],
               supports_bounds: bool = False):
    self._make = make
    self._label_names = label_names
    self._supports_bounds = supports_bounds
    self._lock = threading.Lock()
    self._series: Dict[Tuple[str, ...], object] = {}
    # key -> explicit per-series bounds (None = family default).
    self._series_bounds: Dict[Tuple[str, ...], Optional[Tuple[float, ...]]] \
        = {}

  @property
  def label_names(self) -> Tuple[str, ...]:
    return self._label_names

  def series(self, *label_values: str,
             bounds: Optional[Sequence[float]] = None):
    """The child instrument for one label combination (cached).

    Resolve once outside hot loops; the instrument handle itself is then
    allocation-free to write. ``bounds`` (histogram families only)
    overrides the family's bucket edges for THIS series at creation.
    """
    if len(label_values) != len(self._label_names):
      raise ValueError('Expected {} label value(s) {}; got {}.'.format(
          len(self._label_names), self._label_names, label_values))
    explicit = tuple(float(b) for b in bounds) if bounds is not None \
        else None
    if explicit is not None and not self._supports_bounds:
      raise ValueError('Per-series bounds are only supported on histogram '
                       'families.')
    key = tuple(str(v) for v in label_values)
    with self._lock:
      child = self._series.get(key)
      if child is None:
        child = self._make(explicit) if self._supports_bounds \
            else self._make()
        self._series[key] = child
        if self._supports_bounds:
          # Record the RESOLVED edges, so re-requesting with explicit
          # bounds equal to the family default is consistent, not an
          # error.
          self._series_bounds[key] = tuple(child._bounds)  # noqa: SLF001
      elif explicit is not None and \
          self._series_bounds.get(key) != explicit:
        raise ValueError(
            'Series {!r} already created with bounds={!r}; requested '
            '{!r}.'.format(key, self._series_bounds.get(key), explicit))
      return child

  def items(self) -> List[Tuple[Tuple[str, ...], object]]:
    with self._lock:
      return list(self._series.items())

  def reset(self) -> None:
    with self._lock:
      for child in self._series.values():
        child.reset()


class TelemetryRegistry:
  """Name -> instrument map with typed get-or-create registration.

  Re-registering a name with the same kind (and, when given, the same
  bounds/labels) returns the existing instrument, so call sites need no
  module-level caching discipline. Re-registering with a different kind,
  different explicit histogram bounds, or different label names is a bug
  and raises — a milliseconds histogram silently landing in a seconds
  bucket layout would corrupt every percentile with no error. Omitting
  ``bounds`` on a later lookup means "whatever it was registered with".
  """

  def __init__(self):
    self._lock = threading.Lock()
    # name -> (kind, config dict, instrument)
    self._instruments: Dict[str, Tuple[str, Dict[str, object], object]] = {}

  def _get_or_create(self, name: str, kind: str, make,
                     requested: Optional[Dict[str, object]] = None,
                     config: Optional[Dict[str, object]] = None):
    """``config`` is stored at creation; ``requested`` holds this call's
    explicit constraints (None values mean unconstrained) and must match
    the stored config on a re-registration."""
    with self._lock:
      existing = self._instruments.get(name)
      if existing is not None:
        existing_kind, existing_config, instrument = existing
        if existing_kind != kind:
          raise ValueError(
              'Telemetry name {!r} already registered as {} (requested {}).'
              .format(name, existing_kind, kind))
        for key, value in (requested or {}).items():
          if value is not None and existing_config.get(key) != value:
            raise ValueError(
                'Telemetry name {!r} already registered with {}={!r}; '
                'requested {!r}.'.format(name, key,
                                         existing_config.get(key), value))
        return instrument
      instrument = make()
      self._instruments[name] = (kind, dict(config or {}), instrument)
      return instrument

  def counter(self, name: str) -> Counter:
    return self._get_or_create(name, 'counter', Counter)

  def gauge(self, name: str) -> Gauge:
    return self._get_or_create(name, 'gauge', Gauge)

  def histogram(self, name: str,
                bounds: Optional[Sequence[float]] = None) -> Histogram:
    explicit = tuple(bounds) if bounds is not None else None
    resolved = explicit if explicit is not None else DEFAULT_SECONDS_BUCKETS
    return self._get_or_create(
        name, 'histogram', lambda: Histogram(resolved),
        requested={'bounds': explicit}, config={'bounds': resolved})

  def counter_family(self, name: str,
                     label_names: Sequence[str]) -> _Family:
    labels = tuple(label_names)
    return self._get_or_create(
        name, 'counter_family', lambda: _Family(Counter, labels),
        requested={'labels': labels}, config={'labels': labels})

  def gauge_family(self, name: str, label_names: Sequence[str]) -> _Family:
    labels = tuple(label_names)
    return self._get_or_create(
        name, 'gauge_family', lambda: _Family(Gauge, labels),
        requested={'labels': labels}, config={'labels': labels})

  def histogram_family(self, name: str, label_names: Sequence[str],
                       bounds: Optional[Sequence[float]] = None) -> _Family:
    """``bounds`` is the family DEFAULT; individual series may override
    it at creation via ``family.series(..., bounds=...)`` (per-series
    SLO-resolution edges without re-bucketing sibling series)."""
    labels = tuple(label_names)
    explicit = tuple(bounds) if bounds is not None else None
    resolved = explicit if explicit is not None else DEFAULT_SECONDS_BUCKETS
    return self._get_or_create(
        name, 'histogram_family',
        lambda: _Family(
            lambda series_bounds: Histogram(
                series_bounds if series_bounds is not None else resolved),
            labels, supports_bounds=True),
        requested={'labels': labels, 'bounds': explicit},
        config={'labels': labels, 'bounds': resolved})

  # -- export ----------------------------------------------------------------

  def _walk(self):
    """[(flat_name, kind, instrument)] with labels joined as path segments."""
    with self._lock:
      items = list(self._instruments.items())
    out = []
    for name, (kind, _, instrument) in items:
      if kind.endswith('_family'):
        base_kind = kind[:-len('_family')]
        for label_values, child in instrument.items():
          out.append(('/'.join((name,) + label_values), base_kind, child))
      else:
        out.append((name, kind, instrument))
    return out

  def scalars(self) -> Dict[str, float]:
    """Flat scalar view for the TensorBoard writer.

    Counters/gauges export their value under their own tag; histograms
    export ``<tag>/{count,mean,p50,p95,p99,max}`` (only once non-empty,
    so TensorBoard is not littered with dead series).
    """
    out: Dict[str, float] = {}
    for name, kind, instrument in self._walk():
      if kind == 'histogram':
        summary = instrument.summary()
        if summary.get('count'):
          for stat, value in summary.items():
            out['{}/{}'.format(name, stat)] = float(value)
      else:
        out[name] = float(instrument.value)
    return out

  def snapshot(self) -> Dict[str, Dict[str, object]]:
    """Structured state: {'counters': {...}, 'gauges': {...},
    'histograms': {name: full bucket state}} — the jsonl export form."""
    snap: Dict[str, Dict[str, object]] = {
        'counters': {}, 'gauges': {}, 'histograms': {},
    }
    for name, kind, instrument in self._walk():
      if kind == 'counter':
        snap['counters'][name] = instrument.value
      elif kind == 'gauge':
        snap['gauges'][name] = instrument.value
      else:
        snap['histograms'][name] = instrument.state()
    return snap

  def reset(self) -> None:
    """Zeroes every instrument (registrations survive). Test hook."""
    with self._lock:
      items = list(self._instruments.values())
    for _, _, instrument in items:
      instrument.reset()


_REGISTRY = TelemetryRegistry()
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> TelemetryRegistry:
  """The process-wide default registry every built-in layer reports to."""
  return _REGISTRY


def set_registry(registry: TelemetryRegistry) -> TelemetryRegistry:
  """Swaps the process default (test isolation); returns the previous one."""
  global _REGISTRY
  with _REGISTRY_LOCK:
    previous = _REGISTRY
    _REGISTRY = registry
  return previous
