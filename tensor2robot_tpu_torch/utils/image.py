"""Image encoding (the JAX package's ``utils/image.py``): a numpy frame to
the encoded bytes of a replay record."""

from __future__ import annotations

import io

import numpy as np
from PIL import Image

__all__ = ['numpy_to_image_string']


def numpy_to_image_string(image_array: np.ndarray,
                          image_format: str = 'jpeg',
                          data_type=np.uint8) -> bytes:
  """Encodes an [H, W, C] array by PIL in ``image_format`` at PIL's default
  settings (JPEG at quality 75), as the JAX package encodes its records."""
  image = Image.fromarray(np.asarray(image_array, dtype=data_type))
  buf = io.BytesIO()
  image.save(buf, format=image_format.upper())
  return buf.getvalue()

