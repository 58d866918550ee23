"""Robot-time policies of the port (the JAX package's ``policies/``)."""

from tensor2robot_tpu_torch.policies.policies import (
    CEMPolicy,
    POLICY_LATENCY_HISTOGRAM,
    Policy,
    RegressionPolicy,
    SequentialRegressionPolicy,
)

__all__ = ['CEMPolicy', 'POLICY_LATENCY_HISTOGRAM', 'Policy',
           'RegressionPolicy', 'SequentialRegressionPolicy']
