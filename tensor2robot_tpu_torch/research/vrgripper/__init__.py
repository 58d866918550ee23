"""VRGripper and Watch-Try-Learn, in PyTorch (the JAX package's
``research/vrgripper``): behavior cloning and meta behavior cloning of a
gripper (arXiv:1906.03352)."""

from tensor2robot_tpu_torch.research.vrgripper.decoders import (
    DiscreteDecoder, MAFDecoder, MDNActionDecoder, MSEDecoder,
    get_discrete_action_loss, get_discrete_actions, get_discrete_bins)
from tensor2robot_tpu_torch.research.vrgripper.episode_to_transitions import (
    episode_to_transitions_metareacher, episode_to_transitions_reacher,
    make_fixed_length)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    DefaultVRGripperPreprocessor, VRGripperDomainAdaptiveModel,
    VRGripperRegressionModel)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_meta_models \
    import (VRGripperEnvRegressionModelMAML, VRGripperEnvSequentialModel,
            VRGripperEnvTecModel, pack_vrgripper_meta_features)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_wtl_models \
    import (VRGripperEnvSimpleTrialModel, VRGripperEnvVisionTrialModel,
            pack_wtl_meta_features)

__all__ = [
    'DefaultVRGripperPreprocessor',
    'DiscreteDecoder',
    'MAFDecoder',
    'MDNActionDecoder',
    'MSEDecoder',
    'VRGripperDomainAdaptiveModel',
    'VRGripperEnvRegressionModelMAML',
    'VRGripperEnvSequentialModel',
    'VRGripperEnvSimpleTrialModel',
    'VRGripperEnvTecModel',
    'VRGripperEnvVisionTrialModel',
    'VRGripperRegressionModel',
    'episode_to_transitions_metareacher',
    'episode_to_transitions_reacher',
    'get_discrete_action_loss',
    'get_discrete_actions',
    'get_discrete_bins',
    'make_fixed_length',
    'pack_vrgripper_meta_features',
    'pack_wtl_meta_features',
]
