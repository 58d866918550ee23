"""Vectorized environments on the card (the JAX package's ``envs/``):
``VecEnv`` / ``VecStep``, the contract, and ``VecGraspingEnv``, B grasping
MDPs advanced in one step, each slot its own sampled scenario."""

from tensor2robot_tpu_torch.envs.grasping import (
    GraspState,
    ScenarioConfig,
    Scenarios,
    VecGraspingEnv,
    sample_scenarios,
)
from tensor2robot_tpu_torch.envs.vec_env import VecEnv, VecStep

__all__ = ['GraspState', 'ScenarioConfig', 'Scenarios', 'VecEnv', 'VecStep',
           'VecGraspingEnv', 'sample_scenarios']
