"""Grasp2Vec: self-supervised object embeddings (the JAX package's
``research/grasp2vec``)."""

from tensor2robot_tpu_torch.research.grasp2vec import losses
from tensor2robot_tpu_torch.research.grasp2vec import visualization
from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    EmbeddingNet,
    Grasp2VecModel,
    Grasp2VecNet,
    Grasp2VecPreprocessor,
    maybe_crop_images,
)

__all__ = [
    'EmbeddingNet',
    'Grasp2VecModel',
    'Grasp2VecNet',
    'Grasp2VecPreprocessor',
    'losses',
    'maybe_crop_images',
    'visualization',
]
