"""Grasp2Vec's heatmaps, keypoints and distance histograms.

The counterpart of the JAX package's ``research/grasp2vec/visualization.
py``: pure functions of the embeddings, and ``grasp2vec_summaries``, the
``{name: array}`` dict that ``Grasp2VecModel.add_summaries`` splits into
images and histograms for ``trainer/metrics.py``'s writer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['compute_heatmaps', 'distance_histograms', 'grasp2vec_summaries',
           'heatmap_spatial_soft_argmax', 'np_render_keypoints',
           'softmax_heatmaps']


def compute_heatmaps(feature_query, feature_map) -> torch.Tensor:
  """[B, D] queries dotted with a [B, h, w, D] map: [B, h, w, 1]."""
  query = torch.as_tensor(feature_query).to(torch.float32)
  batch, dim = query.shape
  return (torch.as_tensor(feature_map).to(torch.float32) *
          query.reshape(batch, 1, 1, dim)).sum(3, keepdim=True)


def softmax_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
  """The heatmaps softmaxed over their positions, same shape."""
  batch = heatmaps.shape[0]
  return F.softmax(heatmaps.reshape(batch, -1), dim=1).reshape(
      heatmaps.shape)


def heatmap_spatial_soft_argmax(heatmaps: torch.Tensor,
                                temperature: float = 0.1) -> torch.Tensor:
  """The expected (x, y) in [-1, 1] of the softmaxed heatmap: [B, 1, 2]."""
  batch, height, width, _ = heatmaps.shape
  probs = F.softmax(heatmaps.reshape(batch, -1) / temperature, dim=1)
  probs = probs.reshape(batch, height, width)
  ys = torch.linspace(-1.0, 1.0, height, device=heatmaps.device)
  xs = torch.linspace(-1.0, 1.0, width, device=heatmaps.device)
  expected_y = (probs * ys[None, :, None]).sum((1, 2))
  expected_x = (probs * xs[None, None, :]).sum((1, 2))
  return torch.stack([expected_x, expected_y], -1)[:, None, :]


def np_render_keypoints(image: np.ndarray, locations: np.ndarray,
                        num_images: int = 3, dot_radius: int = 3
                        ) -> np.ndarray:
  """Red dots at [N, C, 2] (x, y) locations in [-1, 1] on copies of the
  first ``num_images`` [N, H, W, 3] images."""
  image = np.asarray(image, np.float32)
  locations = np.asarray(locations)
  num_images = min(num_images, image.shape[0])
  out = image[:num_images].copy()
  height, width = image.shape[1:3]
  for n in range(num_images):
    for c in range(locations.shape[1]):
      x, y = locations[n, c]
      col = int((x + 1.0) / 2.0 * (width - 1))
      row = int((y + 1.0) / 2.0 * (height - 1))
      r0, r1 = max(0, row - dot_radius), min(height, row + dot_radius + 1)
      c0, c1 = max(0, col - dot_radius), min(width, col + dot_radius + 1)
      out[n, r0:r1, c0:c1] = np.asarray([1.0, 0.0, 0.0])
  return out


def distance_histograms(pregrasp, goal, postgrasp) -> Dict[str, np.ndarray]:
  """The evaluation histograms of the embeddings' distances and sizes."""
  pregrasp = np.asarray(pregrasp, np.float32)
  goal = np.asarray(goal, np.float32)
  postgrasp = np.asarray(postgrasp, np.float32)
  goal_normalized = goal / (1e-7 + np.linalg.norm(goal, axis=1,
                                                  keepdims=True))
  return {
      'correct_distances': np.linalg.norm(pregrasp - (goal + postgrasp),
                                          axis=1),
      'incorrect_distances': np.linalg.norm(pregrasp - pregrasp[::-1],
                                            axis=1),
      'goal_distances': np.linalg.norm(goal - goal[::-1], axis=1),
      'pregrasp_sizes': np.linalg.norm(pregrasp, axis=1),
      'postgrasp_sizes': np.linalg.norm(postgrasp, axis=1),
      'goal_sizes': np.linalg.norm(goal, axis=1),
      'goal_cosine_similarity': np.sum(
          goal_normalized[:-1] * goal_normalized[1:], axis=1),
  }


def _numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def grasp2vec_summaries(features, inference_outputs
                        ) -> Dict[str, np.ndarray]:
  """Every summary as ``{name: array}``: [N, H, W, C] images, and 1-D
  histogram samples under ``hist/``."""
  out: Dict[str, np.ndarray] = {}
  for key in ('pregrasp', 'postgrasp', 'goal'):
    name = key + '_image'
    if name in features:
      out['image/' + key] = _numpy(features[name])[:3]
  heatmaps = compute_heatmaps(inference_outputs['goal_vector'],
                              inference_outputs['pre_spatial'])
  out['goal_pregrasp_map'] = _numpy(heatmaps)[:3]
  out['goal_pregrasp_map_softmax'] = _numpy(softmax_heatmaps(heatmaps))[:3]
  locations = heatmap_spatial_soft_argmax(heatmaps)
  if 'pregrasp_image' in features:
    out['keypoints'] = np_render_keypoints(_numpy(features['pregrasp_image']),
                                           _numpy(locations))
  for name, values in distance_histograms(
      _numpy(inference_outputs['pre_vector']),
      _numpy(inference_outputs['goal_vector']),
      _numpy(inference_outputs['post_vector'])).items():
    out['hist/' + name] = values
  return out
