"""A preprocessor whose in specifications are the model's, each mapped by
``update_spec_transform`` (the JAX package's
``preprocessors/spec_transformation_preprocessor.py``): a subclass says
how each model spec looks on disk, e.g. that the float32 (472, 472, 3)
image the network takes is a (512, 640, 3) JPEG in the records.
"""

from __future__ import annotations

from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor)
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['SpecTransformationPreprocessor']


class SpecTransformationPreprocessor(AbstractPreprocessor):

  def update_spec_transform(self, key: str, spec: TensorSpec,
                            mode: str) -> TensorSpec:
    """One model spec's on-disk (in) spec; the same spec by default."""
    del key, mode
    return spec

  def _transform(self, spec_structure, mode: str):
    flat = algebra.flat_specs(spec_structure)
    return algebra.add_sequence_length_specs(
        {key: self.update_spec_transform(key, spec, mode)
         for key, spec in flat.items()})

  def get_in_feature_specification(self, mode):
    return self._transform(self._model_feature_specification(mode), mode)

  def get_in_label_specification(self, mode):
    return self._transform(self._model_label_specification(mode), mode)

  def get_out_feature_specification(self, mode):
    return algebra.add_sequence_length_specs(
        self._model_feature_specification(mode))

  def get_out_label_specification(self, mode):
    return algebra.add_sequence_length_specs(
        self._model_label_specification(mode))
