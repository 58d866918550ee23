"""Task-embedded control: embedding layers and the contrastive loss (the
JAX package's ``layers/tec.py``).

  * ``EmbedFullstate``: an MLP of a state vector (``Dense_i``,
    ``LayerNorm_i``, relu; a last ``Dense``);
  * ``EmbedConditionImages``: the keypoint tower
    (``ImagesToFeaturesNet_0``) and an optional MLP head;
  * ``ReduceTemporalEmbeddings``: [N, T, F] -> [N, out]: VALID 1-D convs
    without bias (kernel 10), each followed by relu and a layer norm, the
    result flattened, then an MLP;
  * ``contrastive_loss`` (Hadsell et al.) and
    ``compute_embedding_contrastive_loss``: task 0's mean inference
    embedding against every task's mean condition embedding.

flax names its layers by type and order (``Conv_0``, ``LayerNorm_0``,
``Dense_0``, ...); the modules here keep those names, so that
``convert.from_flax`` maps JAX's parameters leaf for leaf. The input
widths that flax infers are arguments here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.basic import Conv1D, Dense
from tensor2robot_tpu_torch.layers.transformer import LayerNorm
from tensor2robot_tpu_torch.layers.vision_layers import ImagesToFeaturesNet

__all__ = ['EmbedConditionImages', 'EmbedFullstate',
           'ReduceTemporalEmbeddings', 'compute_embedding_contrastive_loss',
           'contrastive_loss']


class _MLP(nn.Module):
  """A module with an MLP in its own scope: ``Dense_i`` /
  ``LayerNorm_{first_norm + i}`` / relu for each hidden width, then
  ``Dense_n`` to ``output_size`` (``add_mlp``, ``mlp``)."""

  def add_mlp(self, in_features: int, hidden: Sequence[int],
              output_size: int, first_norm: int = 0) -> None:
    self._layers = []
    width = in_features
    for i, hidden_width in enumerate(hidden):
      dense, norm = 'Dense_{}'.format(i), 'LayerNorm_{}'.format(
          first_norm + i)
      self.add_module(dense, Dense(width, hidden_width))
      self.add_module(norm, LayerNorm(hidden_width))
      self._layers.append((dense, norm))
      width = hidden_width
    self._out = 'Dense_{}'.format(len(hidden))
    self.add_module(self._out, Dense(width, output_size))

  def mlp(self, x: torch.Tensor) -> torch.Tensor:
    for dense, norm in self._layers:
      x = F.relu(getattr(self, norm)(getattr(self, dense)(x)))
    return getattr(self, self._out)(x)


class EmbedFullstate(_MLP):
  """[N, F] state -> [N, embed_size]."""

  def __init__(self, in_features: int, embed_size: int,
               fc_layers: Sequence[int] = (100,)):
    super().__init__()
    self.add_mlp(in_features, fc_layers, embed_size)

  def forward(self, fullstate: torch.Tensor) -> torch.Tensor:
    return self.mlp(fullstate)


class EmbedConditionImages(_MLP):
  """[N, H, W, 3] images -> the tower's keypoints [N, 64], through the MLP
  of ``fc_layers`` where given."""

  def __init__(self, fc_layers: Optional[Sequence[int]] = None):
    super().__init__()
    self.ImagesToFeaturesNet_0 = ImagesToFeaturesNet()
    self.fc_layers = None if fc_layers is None else tuple(fc_layers)
    if self.fc_layers is not None:
      self.add_mlp(64, self.fc_layers[:-1], self.fc_layers[-1])

  def forward(self, condition_image: torch.Tensor,
              train: bool = False) -> torch.Tensor:
    if condition_image.dim() != 4:
      raise ValueError('Image has unexpected shape {}.'.format(
          tuple(condition_image.shape)))
    embedding, _ = self.ImagesToFeaturesNet_0(condition_image, train=train)
    if self.fc_layers is not None:
      embedding = self.mlp(embedding)
    return embedding


class ReduceTemporalEmbeddings(_MLP):
  """[N, T, F] -> [N, output_size]; ``sequence_length`` is T."""

  def __init__(self, in_features: int, sequence_length: int,
               output_size: int,
               conv1d_layers: Optional[Sequence[int]] = (64,),
               fc_hidden_layers: Sequence[int] = (100,),
               kernel_size: int = 10):
    super().__init__()
    self._convs = []
    width, length = in_features, sequence_length
    for i, filters in enumerate(conv1d_layers or ()):
      conv, norm = 'Conv_{}'.format(i), 'LayerNorm_{}'.format(i)
      self.add_module(conv, Conv1D(width, filters, kernel_size, bias=False))
      self.add_module(norm, LayerNorm(filters))
      self._convs.append((conv, norm))
      width, length = filters, length - kernel_size + 1
    if length < 1:
      raise ValueError('A sequence of {} is shorter than the {} VALID '
                       'convs of kernel {}.'.format(
                           sequence_length, len(self._convs), kernel_size))
    self.add_mlp(width * length, fc_hidden_layers, output_size,
                 first_norm=len(self._convs))

  def forward(self, temporal_embedding: torch.Tensor) -> torch.Tensor:
    if temporal_embedding.dim() != 3:
      raise ValueError('Temporal embedding has unexpected shape {}.'.format(
          tuple(temporal_embedding.shape)))
    x = temporal_embedding
    for conv, norm in self._convs:
      x = getattr(self, norm)(F.relu(getattr(self, conv)(x)))
    return self.mlp(x.reshape(x.shape[0], -1))


def contrastive_loss(labels: torch.Tensor, embeddings_anchor: torch.Tensor,
                     embeddings_positive: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
  """Hadsell et al.'s loss of pairs: the squared distance of a match (label
  1), the squared hinge ``margin - distance`` of a mismatch."""
  distances = torch.sqrt(((embeddings_anchor - embeddings_positive) ** 2)
                         .sum(-1) + 1e-12)
  labels = torch.as_tensor(labels).to(distances.device, distances.dtype)
  match = labels * distances ** 2
  mismatch = (1.0 - labels) * torch.clamp(margin - distances, min=0.0) ** 2
  return (match + mismatch).mean()


def compute_embedding_contrastive_loss(
    inf_embedding: torch.Tensor, con_embedding: torch.Tensor,
    positives: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Task 0's mean inference embedding (anchor) against each task's mean
  condition embedding; ``inf_embedding`` [tasks, n_inf, K],
  ``con_embedding`` [tasks, n_con, K]; only task 0 is a match unless
  ``positives`` [tasks] says otherwise."""
  if inf_embedding.dim() != 3:
    raise ValueError('Unexpected inf_embedding shape: {}.'.format(
        tuple(inf_embedding.shape)))
  if con_embedding.dim() != 3:
    raise ValueError('Unexpected con_embedding shape: {}.'.format(
        tuple(con_embedding.shape)))
  avg_inf = inf_embedding.mean(1)
  avg_con = con_embedding.mean(1)
  labels = positives if positives is not None else (
      torch.arange(avg_con.shape[0], device=avg_con.device) == 0)
  return contrastive_loss(labels, avg_inf[0:1].expand_as(avg_con), avg_con)
