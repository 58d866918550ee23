"""Spec-conforming random numpy batches (the JAX package's
``specs/generators.py`` ``make_random_numpy``, over the port's flat
``{key: (shape, dtype)}`` specifications).

The draws are the JAX function's: one ``np.random.RandomState(seed)``,
the keys in the specification's order, uint8 from ``[0, 255]``, other
integers from ``[0, 10]``, booleans ``rand > 0.5``, floats ``rand`` cast to
the dtype. The same specification and seed give the same arrays in both
packages. ``make_random_frames`` draws episodes frame by frame instead, so
that a rank can draw only its share of them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ['make_random_frames', 'make_random_numpy', 'validate_batch']

Spec = Dict[str, tuple]


def _draw(rng: np.random.RandomState, shape: tuple, dtype) -> np.ndarray:
  dtype = np.dtype(dtype)
  if dtype.kind in 'ui':
    high = 255 if dtype == np.uint8 else 10
    return rng.randint(0, high + 1, size=shape).astype(dtype)
  if dtype == np.bool_:
    return rng.rand(*shape) > 0.5
  return rng.rand(*shape).astype(dtype)


def make_random_numpy(spec: Spec, batch_size: Optional[int] = 1,
                      seed: Optional[int] = None) -> Dict[str, np.ndarray]:
  """One random batch of ``spec``; ``batch_size`` None adds no batch dim."""
  rng = np.random.RandomState(seed)
  batch = () if batch_size is None else (int(batch_size),)
  return {key: _draw(rng, batch + tuple(int(d) for d in shape), dtype)
          for key, (shape, dtype) in spec.items()}


def make_random_frames(spec: Spec, batch_size: int, seed: Optional[int],
                       frame_keys: Sequence[str], start: int,
                       stop: int) -> Dict[str, np.ndarray]:
  """Frames ``[start, stop)`` of one random batch of episodes.

  A key in ``frame_keys`` has the episode's frames as its first
  per-example axis ([batch, T, ...]); the others are drawn whole, as
  ``make_random_numpy`` draws them over the specification without the frame
  keys. Frame t of every frame key is drawn from a generator seeded
  ``(seed, t)`` of its own, the keys in the specification's order. So the
  frames of any split of ``[0, T)`` concatenate to the whole episode's: the
  ranks of a sequence-parallel group each draw only their own frames. A
  ``seed`` of None draws one at random for the batch.
  """
  if seed is None:
    seed = int(np.random.randint(0, 2**31 - 1))
  out = make_random_numpy(
      {k: v for k, v in spec.items() if k not in frame_keys}, batch_size,
      seed)
  framed = [(key, shape, dtype) for key, (shape, dtype) in spec.items()
            if key in frame_keys]
  frames = {key: [] for key, _, _ in framed}
  for t in range(start, stop):
    rng = np.random.RandomState([seed, t])
    for key, shape, dtype in framed:
      frames[key].append(_draw(rng, (int(batch_size), 1) + tuple(
          int(d) for d in shape[1:]), dtype))
  for key, _, _ in framed:
    out[key] = np.concatenate(frames[key], 1)
  return {key: out[key] for key in spec}


def validate_batch(spec: Spec, batch) -> Dict[str, np.ndarray]:
  """The batch's arrays for ``spec``'s keys, in its order; raises where a
  key is missing or an array's dtype or per-example shape differs."""
  out = {}
  for key, (shape, dtype) in spec.items():
    if key not in batch:
      raise ValueError('The batch has no {!r}; the specification asks for '
                       '{}.'.format(key, sorted(spec)))
    value = np.asarray(batch[key])
    if value.dtype != np.dtype(dtype) or value.shape[1:] != tuple(shape):
      raise ValueError('{!r} is {} {}; the specification asks for {} {} per '
                       'example.'.format(key, value.dtype, value.shape,
                                         np.dtype(dtype), tuple(shape)))
    out[key] = value
  return out
