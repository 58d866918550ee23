"""Robot-time policies of the port (the JAX package's ``policies/``)."""

from tensor2robot_tpu_torch.policies.policies import (
    CEMPolicy,
    DeviceCEMPolicy,
    LSTMCEMPolicy,
    OUExploreRegressionPolicy,
    POLICY_LATENCY_HISTOGRAM,
    PerEpisodeSwitchPolicy,
    Policy,
    RegressionPolicy,
    ScheduledExplorationRegressionPolicy,
    SequentialRegressionPolicy,
)

__all__ = ['CEMPolicy', 'DeviceCEMPolicy', 'LSTMCEMPolicy',
           'OUExploreRegressionPolicy', 'POLICY_LATENCY_HISTOGRAM',
           'PerEpisodeSwitchPolicy', 'Policy', 'RegressionPolicy',
           'ScheduledExplorationRegressionPolicy',
           'SequentialRegressionPolicy']
