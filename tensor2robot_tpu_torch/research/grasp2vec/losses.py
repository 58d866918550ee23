"""Grasp2Vec's embedding losses, in PyTorch.

The counterpart of the JAX package's ``research/grasp2vec/losses.py``:
the arithmetic losses (l2, cosine, send-to-zero) with their masks, the
n-pairs losses (tf-slim's ``npairs_loss`` and its multilabel variant, and
Grasp2Vec's bidirectional ``n_pairs_loss`` on (pregrasp - postgrasp,
goal)), the semi-hard triplet loss and ``triplet_loss``,
``match_norms_loss``, ``keypoint_accuracy``, ``get_softmax_response`` and
``ty_loss``. Every loss computes in float32, as JAX's do, and the masked
means are arithmetic (exactly 0.0 for an empty mask), with no
data-dependent control flow.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ['cosine_arithmetic_loss', 'get_softmax_response',
           'keypoint_accuracy', 'l2_arithmetic_loss', 'match_norms_loss',
           'n_pairs_loss', 'n_pairs_loss_multilabel', 'npairs_loss',
           'npairs_loss_multilabel', 'send_to_zero_loss', 'triplet_loss',
           'triplet_semihard_loss', 'ty_loss']


def _f32(x) -> torch.Tensor:
  return torch.as_tensor(x).to(torch.float32)


def _masked_mean(values: torch.Tensor, mask) -> torch.Tensor:
  """Mean over the mask's 1 entries; exactly 0.0 when it has none."""
  mask = _f32(mask).to(values.device).reshape(values.shape)
  total = mask.sum()
  return torch.where(total > 0, (values * mask).sum() / total.clamp_min(1.0),
                     torch.zeros_like(total))


def _l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
  return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(
      1e-12)


def l2_arithmetic_loss(pregrasp_embedding, goal_embedding,
                       postgrasp_embedding, mask) -> torch.Tensor:
  """Masked mean of ``||pre - goal - post||^2``."""
  raw = (_f32(pregrasp_embedding) - _f32(goal_embedding) -
         _f32(postgrasp_embedding))
  return _masked_mean((raw ** 2).sum(1), mask)


def cosine_arithmetic_loss(pregrasp_embedding, goal_embedding,
                           postgrasp_embedding, mask) -> torch.Tensor:
  """Masked mean cosine distance of (pre - post) and goal."""
  pair_a = _l2_normalize(_f32(pregrasp_embedding) -
                         _f32(postgrasp_embedding))
  pair_b = _l2_normalize(_f32(goal_embedding))
  return _masked_mean(1.0 - (pair_a * pair_b).sum(1), mask)


def send_to_zero_loss(tensor, mask) -> torch.Tensor:
  """Masked mean L2 norm."""
  return _masked_mean(torch.linalg.vector_norm(_f32(tensor), dim=1), mask)


def _l2_regularizer(anchor, positive, reg_lambda):
  return 0.25 * reg_lambda * ((anchor ** 2).sum(1).mean() +
                              (positive ** 2).sum(1).mean())


def npairs_loss(labels, embeddings_anchor, embeddings_positive,
                reg_lambda: float = 0.002) -> torch.Tensor:
  """tf-slim's npairs loss: the cross entropy of the similarity matrix
  against the row-normalized label equality, plus ``0.25 reg_lambda
  (mean ||a||^2 + mean ||b||^2)``."""
  anchor, positive = _f32(embeddings_anchor), _f32(embeddings_positive)
  labels = torch.as_tensor(labels, device=anchor.device)
  equal = (labels[:, None] == labels[None, :]).to(torch.float32)
  remapped = equal / equal.sum(1, keepdim=True)
  xent = -(remapped * F.log_softmax(anchor @ positive.T, dim=1)).sum(1)
  return xent.mean() + _l2_regularizer(anchor, positive, reg_lambda)


def npairs_loss_multilabel(multilabels, embeddings_anchor,
                           embeddings_positive,
                           reg_lambda: float = 0.002) -> torch.Tensor:
  """tf-slim's multilabel npairs loss on dense [batch, classes] {0, 1}
  labels: the label similarity is their normalized intersection."""
  anchor, positive = _f32(embeddings_anchor), _f32(embeddings_positive)
  multilabels = _f32(multilabels).to(anchor.device)
  intersection = multilabels @ multilabels.T
  remapped = intersection / intersection.sum(1, keepdim=True).clamp_min(
      1e-12)
  xent = -(remapped * F.log_softmax(anchor @ positive.T, dim=1)).sum(1)
  return xent.mean() + _l2_regularizer(anchor, positive, reg_lambda)


def n_pairs_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                 non_negativity_constraint: bool = False) -> torch.Tensor:
  """Grasp2Vec's loss: npairs on (pre - post, goal) both ways."""
  pair_a = _f32(pregrasp_embedding) - _f32(postgrasp_embedding)
  if non_negativity_constraint:
    pair_a = F.relu(pair_a)
  pair_b = _f32(goal_embedding)
  labels = torch.arange(pair_a.shape[0], device=pair_a.device)
  return (npairs_loss(labels, pair_a, pair_b) +
          npairs_loss(labels, pair_b, pair_a))


def n_pairs_loss_multilabel(pregrasp_embedding, goal_embedding,
                            postgrasp_embedding, grasp_success
                            ) -> torch.Tensor:
  """The multilabel n-pairs loss: failed grasps share label 0."""
  pair_a = _f32(pregrasp_embedding) - _f32(postgrasp_embedding)
  pair_b = _f32(goal_embedding)
  batch = pair_a.shape[0]
  success = torch.as_tensor(grasp_success, device=pair_a.device).reshape(
      batch).to(torch.int64)
  range_tensor = torch.arange(batch, device=pair_a.device) * success
  multilabels = F.one_hot(range_tensor, batch + 1).to(torch.float32)
  return (npairs_loss_multilabel(multilabels, pair_a, pair_b) +
          npairs_loss_multilabel(multilabels, pair_b, pair_a))


def _pairwise_squared_distances(a: torch.Tensor) -> torch.Tensor:
  sq = (a ** 2).sum(1)
  return (sq[:, None] - 2.0 * (a @ a.T) + sq[None, :]).clamp_min(0.0)


def _masked_minimum(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  axis_max = data.max(1, keepdim=True).values
  return ((data - axis_max) * mask).min(1, keepdim=True).values + axis_max


def _masked_maximum(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  axis_min = data.min(1, keepdim=True).values
  return ((data - axis_min) * mask).max(1, keepdim=True).values + axis_min


def triplet_semihard_loss(labels, embeddings,
                          margin: float = 1.0) -> torch.Tensor:
  """tf-slim's semi-hard triplet loss: for each positive pair (i, j) the
  negative is the closest one farther than d(i, j) where one exists,
  else the farthest; the loss is the mean over positive pairs of
  ``relu(margin + d_ij - d_in)``."""
  embeddings = _f32(embeddings)
  labels = torch.as_tensor(labels, device=embeddings.device).reshape(-1)
  batch = embeddings.shape[0]
  pdist = _pairwise_squared_distances(embeddings)
  adjacency = labels[:, None] == labels[None, :]
  adjacency_not = (~adjacency).to(torch.float32)
  # Row j * batch + i of the tiled matrix holds d(i, k) against d(i, j).
  pdist_tile = pdist.repeat(batch, 1)
  mask = adjacency_not.repeat(batch, 1) * (
      pdist_tile > pdist.T.reshape(-1, 1)).to(torch.float32)
  mask_final = (mask.sum(1, keepdim=True) > 0.0).reshape(batch, batch).T
  negatives_outside = _masked_minimum(pdist_tile, mask).reshape(
      batch, batch).T
  negatives_inside = _masked_maximum(pdist, adjacency_not).repeat(1, batch)
  semi_hard = torch.where(mask_final, negatives_outside, negatives_inside)
  loss_mat = margin + pdist - semi_hard
  mask_positives = adjacency.to(torch.float32) - torch.eye(
      batch, device=embeddings.device)
  num_positives = mask_positives.sum().clamp_min(1e-16)
  return (loss_mat * mask_positives).clamp_min(0.0).sum() / num_positives


def triplet_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                 margin: float = 3.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """The semi-hard triplet loss on normalized (pre - post, goal) pairs;
  returns (loss, pairs, labels)."""
  pair_a = _l2_normalize(_f32(pregrasp_embedding) -
                         _f32(postgrasp_embedding), 1)
  pair_b = _l2_normalize(_f32(goal_embedding), 1)
  labels = torch.arange(pair_a.shape[0], device=pair_a.device).repeat(2)
  pairs = torch.cat([pair_a, pair_b], 0)
  return triplet_semihard_loss(labels, pairs, margin=margin), pairs, labels


def match_norms_loss(anchor_tensors, paired_tensors) -> torch.Tensor:
  """Pulls the paired norms toward the anchors' (no gradient through the
  anchors)."""
  anchor_norms = torch.linalg.vector_norm(_f32(anchor_tensors),
                                          dim=1).detach()
  paired_norms = torch.linalg.vector_norm(_f32(paired_tensors), dim=1)
  return (0.5 * (anchor_norms - paired_norms) ** 2).mean()


def keypoint_accuracy(keypoints, labels
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(accuracy, sigmoid loss) of spatial-softmax keypoints against their
  quadrant labels."""
  keypoints = _f32(keypoints).reshape(-1, 2)
  centers = torch.tensor([[0.5, -0.5], [-0.5, -0.5], [0.5, 0.5],
                          [-0.5, 0.5]], device=keypoints.device)
  logits = keypoints @ centers.T
  labels = torch.as_tensor(labels, device=keypoints.device).reshape(-1)
  correct = (labels == logits.argmax(1)).to(torch.float32)
  onehot = F.one_hot(labels.to(torch.int64), 4).to(torch.float32)
  loss = (logits.clamp_min(0) - logits * onehot +
          torch.log1p(torch.exp(-logits.abs()))).mean()
  return correct.mean(), loss


def get_softmax_response(goal_embedding, scene_spatial
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(max heat, max softmax) of a goal embedding's heatmap in a scene."""
  goal = _f32(goal_embedding)
  batch, dim = goal.shape
  heatmap = (_f32(scene_spatial) * goal.reshape(batch, 1, 1, dim)).sum(3)
  flat = heatmap.reshape(batch, -1)
  return flat.max(1).values, F.softmax(flat, dim=1).max(1).values


def ty_loss(pregrasp_spatial, postgrasp_spatial, goal_embedding
            ) -> torch.Tensor:
  """The likelihood-ratio detection loss: the goal's best normalized
  response after the grasp minus before."""
  pre = _l2_normalize(_f32(pregrasp_spatial))
  post = _l2_normalize(_f32(postgrasp_spatial))
  goal = _l2_normalize(_f32(goal_embedding))[:, None, None, :]
  pre_max = (pre * goal).sum(-1).amax((1, 2))
  post_max = (post * goal).sum(-1).amax((1, 2))
  return (post_max - pre_max).mean()
