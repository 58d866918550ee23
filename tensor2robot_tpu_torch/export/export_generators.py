"""The one serving function of a model.

The counterpart of the JAX package's ``export/export_generators.py``
``make_serve_fn``: PREDICT preprocessing, then ``model.predict_step`` on
the served weights. The predictors and ``chip_smoke.py`` serve through it,
so serving means the same thing everywhere.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from tensor2robot_tpu_torch.modes import ModeKeys

__all__ = ['make_serve_fn']


def make_serve_fn(model) -> Callable[..., Dict[str, torch.Tensor]]:
  """``serve(variables, features) -> outputs`` on the model's device.

  ``features`` are arrays or tensors (numpy in, from a robot); they move to
  the model's device, go through the preprocessor in PREDICT mode, and
  ``model.predict_step`` turns them into the export outputs (tensors on
  the device).
  """

  def serve(variables, features) -> Dict[str, torch.Tensor]:
    features = {key: torch.as_tensor(value).to(model.device)
                for key, value in features.items()}
    features, _ = model.preprocessor.preprocess(features, None,
                                                ModeKeys.PREDICT)
    return model.predict_step(variables, features)

  return serve
