"""VRGripper episodes as serialized records (the JAX package's
``research/vrgripper/episode_to_transitions.py``):

  * ``make_fixed_length``: an episode resampled to a fixed length (its
    endpoints kept, the rest drawn with replacement from numpy's global
    generator, as JAX's does), or spread evenly where not randomized;
  * ``episode_to_transitions_reacher``: one tf.Example a transition;
  * ``episode_to_transitions_metareacher``: one tf.SequenceExample an
    episode, its steps as feature lists.
"""

from __future__ import annotations

import collections
from typing import List, Optional

import numpy as np

from tensor2robot_tpu_torch.data import wire

__all__ = ['episode_to_transitions_metareacher',
           'episode_to_transitions_reacher', 'make_fixed_length']


def make_fixed_length(input_list, fixed_length: int,
                      always_include_endpoints: bool = True,
                      randomized: bool = True) -> Optional[list]:
  """``input_list`` resampled to ``fixed_length`` entries, in order; None
  for an episode of 2 steps or fewer."""
  original_length = len(input_list)
  if original_length <= 2:
    return None
  if not randomized:
    indices = np.sort(np.mod(np.arange(fixed_length), original_length))
    return [input_list[i] for i in indices]
  if always_include_endpoints:
    endpoint_indices = np.array([0, original_length - 1])
    other_indices = 1 + np.random.choice(
        original_length - 2, fixed_length - 2, replace=True)
    indices = np.concatenate((endpoint_indices, other_indices), axis=0)
  else:
    indices = np.random.choice(original_length, fixed_length, replace=True)
  indices = np.sort(indices)
  return [input_list[i] for i in indices]


def episode_to_transitions_reacher(episode_data, is_demo: bool = False
                                   ) -> List[bytes]:
  """(obs, action, reward, obs_tp1, done, debug) steps -> one tf.Example
  each: ``pose_t``, ``pose_tp1``, ``action``, ``reward``, ``done`` and
  ``is_demo``."""
  transitions = []
  for obs_t, action, reward, obs_tp1, done, _ in episode_data:
    transitions.append(wire.build_example({
        'pose_t': np.asarray(obs_t, np.float32),
        'pose_tp1': np.asarray(obs_tp1, np.float32),
        'action': np.asarray(action, np.float32),
        'reward': np.asarray([reward], np.float32),
        'done': np.asarray([int(done)], np.int64),
        'is_demo': np.asarray([int(is_demo)], np.int64),
    }))
  return transitions


def episode_to_transitions_metareacher(episode_data) -> List[bytes]:
  """A meta-reacher episode -> one tf.SequenceExample: ``is_demo`` and
  ``target_idx`` (from the first step's debug) in its context, the steps'
  ``pose_t``, ``pose_tp1``, ``action``, ``reward`` and ``done`` as feature
  lists."""
  context = {
      'is_demo': np.asarray([int(episode_data[0][-1]['is_demo'])], np.int64),
      'target_idx': np.asarray([episode_data[0][-1]['target_idx']],
                               np.int64),
  }
  feature_lists = collections.defaultdict(list)
  for obs_t, action, reward, obs_tp1, done, _ in episode_data:
    feature_lists['pose_t'].append(np.asarray(obs_t, np.float32))
    feature_lists['pose_tp1'].append(np.asarray(obs_tp1, np.float32))
    feature_lists['action'].append(np.asarray(action, np.float32))
    feature_lists['reward'].append(np.asarray([reward], np.float32))
    feature_lists['done'].append(np.asarray([int(done)], np.int64))
  return [wire.build_sequence_example(context, dict(feature_lists))]
