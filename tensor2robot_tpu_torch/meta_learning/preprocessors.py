"""The MAML preprocessors: a base preprocessor's specifications in the meta
layout (the JAX package's ``meta_learning/preprocessors.py``):

  condition/features/<k>   [num_tasks, num_condition_samples, ...]
  condition/labels/<k>     the inner loop's adaptation data
  inference/features/<k>   [num_tasks, num_inference_samples, ...]
  <label k>                the outer loss's labels (names 'meta_labels/')

The base preprocessor's transform runs over the [task, sample] dims
(``meta_data.multi_batch_apply``).
"""

from __future__ import annotations

from typing import Optional

from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor)
from tensor2robot_tpu_torch.specs import algebra
from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

__all__ = ['FixedLenMetaExamplePreprocessor', 'MAMLPreprocessorV2',
           'copy_tensorspec', 'create_maml_feature_spec',
           'create_maml_label_spec']


def copy_tensorspec(spec_structure, batch_size: Optional[int] = None,
                    prefix: str = ''):
  """The flat specs with a leading dim of ``batch_size`` (-1: unknown,
  None: none) and ``prefix/`` before each name."""
  out = {}
  for key, spec in algebra.flat_specs(spec_structure).items():
    name = spec.name
    if prefix and name is not None:
      name = prefix + '/' + name
    shape = spec.shape
    if batch_size is not None:
      shape = (None if batch_size < 0 else int(batch_size),) + shape
    out[key] = TensorSpec(shape, spec.dtype, **{**spec.fields(),
                                                'name': name})
  return out


def create_maml_feature_spec(feature_spec, label_spec,
                             num_condition_samples_per_task: int = -1,
                             num_inference_samples_per_task: int = -1):
  """The base feature and label specs -> the meta feature spec; each spec
  gains a leading samples dim, unknown by default."""
  meta = {}
  for key, spec in copy_tensorspec(feature_spec,
                                   num_condition_samples_per_task,
                                   'condition_features').items():
    meta['condition/features/' + key] = spec
  for key, spec in copy_tensorspec(label_spec,
                                   num_condition_samples_per_task,
                                   'condition_labels').items():
    meta['condition/labels/' + key] = spec
  for key, spec in copy_tensorspec(feature_spec,
                                   num_inference_samples_per_task,
                                   'inference_features').items():
    meta['inference/features/' + key] = spec
  return meta


def create_maml_label_spec(label_spec,
                           num_inference_samples_per_task: int = -1):
  """The base label spec -> the outer loss's label spec."""
  return copy_tensorspec(label_spec, num_inference_samples_per_task,
                         'meta_labels')


def _sub(struct, prefix: str):
  return {key[len(prefix):]: value for key, value in (struct or {}).items()
          if key.startswith(prefix)}


class MAMLPreprocessorV2(AbstractPreprocessor):
  """The meta layout around a base preprocessor."""

  def __init__(self, base_preprocessor):
    super().__init__()
    self._base_preprocessor = base_preprocessor

  @property
  def base_preprocessor(self):
    return self._base_preprocessor

  def _counts(self):
    return -1, -1

  def get_in_feature_specification(self, mode: str):
    base = self._base_preprocessor
    return create_maml_feature_spec(base.get_in_feature_specification(mode),
                                    base.get_in_label_specification(mode),
                                    *self._counts())

  def get_in_label_specification(self, mode: str):
    return create_maml_label_spec(
        self._base_preprocessor.get_in_label_specification(mode),
        self._counts()[1])

  def get_out_feature_specification(self, mode: str):
    base = self._base_preprocessor
    return create_maml_feature_spec(base.get_out_feature_specification(mode),
                                    base.get_out_label_specification(mode),
                                    *self._counts())

  def get_out_label_specification(self, mode: str):
    return create_maml_label_spec(
        self._base_preprocessor.get_out_label_specification(mode),
        self._counts()[1])

  def _preprocess_fn(self, features, labels, mode, generator=None,
                     draws=None):
    """The base transform over the [task, sample] dims, of the condition
    side with its labels and of the inference side with the meta labels
    (which see the same label transform as the condition labels). Each
    side is one call of the base transform, which draws for itself from
    ``generator`` (JAX splits its key in three here; the port's sides
    draw one after the other from the one stream); ``draws`` given is
    ``{'condition': ..., 'inference': ...}``, each side's base draws."""
    base = self._base_preprocessor

    def apply(feats, labs, side):
      side_draws = None if draws is None else draws[side]

      def fn(f, l):
        return base._preprocess_fn(f, l or None, mode, generator,
                                   side_draws)
      return meta_data.multi_batch_apply(fn, 2, feats, labs or {})

    cond_f, cond_l = apply(_sub(features, 'condition/features/'),
                           _sub(features, 'condition/labels/'), 'condition')
    inf_f, out_labels = apply(_sub(features, 'inference/features/'),
                              labels, 'inference')
    out = {'condition/features/' + k: v for k, v in cond_f.items()}
    out.update({'condition/labels/' + k: v
                for k, v in (cond_l or {}).items()})
    out.update({'inference/features/' + k: v for k, v in inf_f.items()})
    return out, (dict(out_labels) if labels is not None and out_labels
                 else None)


class FixedLenMetaExamplePreprocessor(MAMLPreprocessorV2):
  """The meta layout with fixed condition and inference sample counts (the
  meta models that read the layout whole, with known episode counts)."""

  def __init__(self, base_preprocessor,
               num_condition_samples_per_task: int = 1,
               num_inference_samples_per_task: int = 1):
    super().__init__(base_preprocessor)
    self._num_condition_samples_per_task = num_condition_samples_per_task
    self._num_inference_samples_per_task = num_inference_samples_per_task

  @property
  def num_condition_samples_per_task(self) -> int:
    return self._num_condition_samples_per_task

  @property
  def num_inference_samples_per_task(self) -> int:
    return self._num_inference_samples_per_task

  def _counts(self):
    return (self._num_condition_samples_per_task,
            self._num_inference_samples_per_task)
