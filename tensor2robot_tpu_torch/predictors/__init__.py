"""Predictors of the port (the JAX package's ``predictors/``)."""

from tensor2robot_tpu_torch.predictors.abstract_predictor import (
    AbstractPredictor,
)
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor,
)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
    ExportedModelPredictor,
)

__all__ = ['AbstractPredictor', 'CheckpointPredictor',
           'ExportedModelPredictor']
