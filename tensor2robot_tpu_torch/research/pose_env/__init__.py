"""The duck pose toy task (the JAX package's ``research/pose_env``): the
numpy env, its regression and critic models, and their MAML model."""

from tensor2robot_tpu_torch.research.pose_env.episode_to_transitions import (
    episode_to_transitions_pose_toy,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnvRandomPolicy,
    PoseToyEnv,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
    PoseEnvRegressionModelMAML,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    DefaultPoseEnvContinuousPreprocessor,
    DefaultPoseEnvRegressionPreprocessor,
    PoseEnvContinuousMCModel,
    PoseEnvRegressionModel,
)

__all__ = [
    'DefaultPoseEnvContinuousPreprocessor',
    'DefaultPoseEnvRegressionPreprocessor',
    'PoseEnvContinuousMCModel',
    'PoseEnvRandomPolicy',
    'PoseEnvRegressionModel',
    'PoseEnvRegressionModelMAML',
    'PoseToyEnv',
    'episode_to_transitions_pose_toy',
]
