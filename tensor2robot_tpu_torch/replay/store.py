"""In-RAM shard stores: records at rest, bounded, evicting (a copy of the JAX
package's ``replay/store.py``).

One :class:`ShardStore` holds one shard's examples as the raw replay records
the wire delivered, never decoded copies. Two retention disciplines:

  * ``ring``: a FIFO window; at capacity the oldest example is evicted.
  * ``reservoir``: Vitter's Algorithm R over the append stream; at capacity
    an arrival replaces a uniformly random slot with probability
    ``capacity / appends_seen``, else it is dropped, so that the store stays
    a uniform sample of everything ever appended.

Capacity is bounded by examples and by bytes, whichever trips first.
Priorities ride along per record for the prioritized policy. Records are
addressed by ids that stay stable across evictions. Every public method
takes the shard's lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ['ShardStore', 'RETENTIONS']

RETENTIONS = ('ring', 'reservoir')


class ShardStore:
  """Bounded packed-record store for one shard."""

  def __init__(self,
               capacity_examples: int = 4096,
               capacity_bytes: Optional[int] = None,
               retention: str = 'ring',
               seed: Optional[int] = None):
    if capacity_examples < 1:
      raise ValueError('capacity_examples must be >= 1; got {}.'.format(
          capacity_examples))
    if retention not in RETENTIONS:
      raise ValueError('retention must be one of {}; got {!r}.'.format(
          RETENTIONS, retention))
    self.capacity_examples = int(capacity_examples)
    self.capacity_bytes = None if capacity_bytes is None \
        else int(capacity_bytes)
    self.retention = retention
    self._lock = threading.Lock()
    self._rng = np.random.RandomState(seed)
    self._blobs: List[bytes] = []
    self._priorities: List[float] = []
    self._ids: List[int] = []           # stable per-record ids, slot-parallel
    self._id_to_slot: Dict[int, int] = {}
    self._next_id = 0
    self._bytes = 0
    self._appends = 0       # accepted appends (reservoir stream length)
    self._evictions = 0     # slots overwritten / dropped arrivals
    self._samples = 0       # examples drawn

  # -- occupancy -------------------------------------------------------------

  def __len__(self) -> int:
    with self._lock:
      return len(self._blobs)

  @property
  def occupancy_examples(self) -> int:
    with self._lock:
      return len(self._blobs)

  @property
  def occupancy_bytes(self) -> int:
    with self._lock:
      return self._bytes

  def counters(self) -> Dict[str, int]:
    with self._lock:
      return {
          'occupancy_examples': len(self._blobs),
          'occupancy_bytes': self._bytes,
          'appends': self._appends,
          'evictions': self._evictions,
          'samples': self._samples,
      }

  # -- append / evict --------------------------------------------------------

  def _over_bytes_locked(self, incoming: int) -> bool:
    return (self.capacity_bytes is not None
            and self._bytes + incoming > self.capacity_bytes
            and bool(self._blobs))

  def _insert_locked(self, blob: bytes, priority: float) -> None:
    slot = len(self._blobs)
    self._blobs.append(blob)
    self._priorities.append(float(priority))
    self._ids.append(self._next_id)
    if self.retention == 'reservoir':
      # Ring slots hold CONSECUTIVE ids (insert at tail, evict at head),
      # so their id->slot map is arithmetic; only reservoir replacement
      # scatters ids and needs the dict.
      self._id_to_slot[self._next_id] = slot
    self._next_id += 1
    self._bytes += len(blob)

  def append(self, blob: bytes, priority: float = 1.0) -> bool:
    """Stores one packed record; returns whether it is now resident.

    ``ring``: evicts from the FRONT until both capacity bounds admit the
    arrival. ``reservoir``: replaces a uniform random slot once full
    (with the Algorithm-R acceptance probability), so a False return
    means the arrival was sampled OUT, not lost to an error.
    """
    size = len(blob)
    with self._lock:
      self._appends += 1
      if self.retention == 'ring':
        while (len(self._blobs) >= self.capacity_examples
               or self._over_bytes_locked(size)):
          self._evict_front_locked()
        self._insert_locked(blob, priority)
        return True
      # reservoir
      if (len(self._blobs) < self.capacity_examples
          and not self._over_bytes_locked(size)):
        self._insert_locked(blob, priority)
        return True
      slot = int(self._rng.randint(0, self._appends))
      if slot >= len(self._blobs):
        self._evictions += 1  # arrival sampled out
        return False
      self._bytes += size - len(self._blobs[slot])
      self._blobs[slot] = blob
      self._priorities[slot] = float(priority)
      del self._id_to_slot[self._ids[slot]]
      self._ids[slot] = self._next_id
      self._id_to_slot[self._next_id] = slot
      self._next_id += 1
      self._evictions += 1
      # A replacement can GROW the byte footprint (records grow with
      # scene entropy); the byte bound must hold on this path too —
      # trim uniformly random slots (the reservoir is unordered, so a
      # uniform victim keeps the retained set a uniform sample) until
      # the documented 'whichever trips first' cap is honored again.
      while (self.capacity_bytes is not None
             and self._bytes > self.capacity_bytes
             and len(self._blobs) > 1):
        self._evict_reservoir_slot_locked(
            int(self._rng.randint(0, len(self._blobs))))
      return True

  def _evict_front_locked(self) -> None:
    victim = self._blobs.pop(0)
    self._priorities.pop(0)
    self._ids.pop(0)
    self._bytes -= len(victim)
    self._evictions += 1

  def _evict_reservoir_slot_locked(self, slot: int) -> None:
    """O(1) unordered removal: swap the last slot in, pop the tail."""
    victim = self._blobs[slot]
    del self._id_to_slot[self._ids[slot]]
    last = len(self._blobs) - 1
    if slot != last:
      self._blobs[slot] = self._blobs[last]
      self._priorities[slot] = self._priorities[last]
      self._ids[slot] = self._ids[last]
      self._id_to_slot[self._ids[slot]] = slot
    self._blobs.pop()
    self._priorities.pop()
    self._ids.pop()
    self._bytes -= len(victim)
    self._evictions += 1

  def _slot_for_locked(self, record_id: int) -> Optional[int]:
    if self.retention == 'reservoir':
      return self._id_to_slot.get(record_id)
    if not self._ids or not self._ids[0] <= record_id <= self._ids[-1]:
      return None
    return record_id - self._ids[0]

  # -- sampling --------------------------------------------------------------

  def priorities(self) -> np.ndarray:
    with self._lock:
      return np.asarray(self._priorities, np.float64)

  def snapshot(self) -> Tuple[List[int], np.ndarray]:
    """Atomic ``(stable ids, priorities)`` view for one draw.

    A policy draws slot indices against THIS snapshot and the fetch
    goes back through the ids (:meth:`get_by_ids`) — a ring slide
    between snapshot and fetch can therefore never resolve a drawn
    slot to a neighboring record; the dead id is skipped and the
    service redraws the shortfall.
    """
    with self._lock:
      return list(self._ids), np.asarray(self._priorities, np.float64)

  def get_many(self, slots: Sequence[int]) -> Tuple[List[bytes], List[int]]:
    """(blob refs, stable ids) for CURRENT slot indices; out-of-range
    slots are skipped. Direct-slot access for tests/tools — the
    sampling path goes through :meth:`snapshot` + :meth:`get_by_ids`."""
    with self._lock:
      n = len(self._blobs)
      live = [slot for slot in slots if 0 <= slot < n]
      blobs = [self._blobs[slot] for slot in live]
      ids = [self._ids[slot] for slot in live]
      self._samples += len(blobs)
      return blobs, ids

  def get_by_ids(self, record_ids: Sequence[int]
                 ) -> Tuple[List[bytes], List[int]]:
    """(blob refs, ids) for the drawn ids that are STILL resident
    (counted as samples); evicted ids are skipped, not an error — a
    concurrent append on a byte-bounded shard can evict several
    records for one arrival, and the caller redraws the shortfall
    (service.sample) instead of crashing the learner on a race."""
    with self._lock:
      blobs: List[bytes] = []
      live: List[int] = []
      for record_id in record_ids:
        slot = self._slot_for_locked(int(record_id))
        if slot is not None:
          blobs.append(self._blobs[slot])
          live.append(int(record_id))
      self._samples += len(blobs)
      return blobs, live

  def update_priorities(self, record_ids: Sequence[int],
                        priorities: Sequence[float]) -> int:
    """Re-weights resident records (prioritized replay's learner half).

    Ids evicted since the draw are skipped silently — a ring store may
    have slid past them, and a stale priority update must not crash the
    learner (or land on a DIFFERENT record: ids are stable, slots are
    not). Returns how many updates landed.
    """
    landed = 0
    with self._lock:
      for record_id, priority in zip(record_ids, priorities):
        slot = self._slot_for_locked(int(record_id))
        if slot is not None:
          self._priorities[slot] = float(priority)
          landed += 1
    return landed
