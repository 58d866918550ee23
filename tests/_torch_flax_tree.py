"""Random weights for a port module and the same weights as a flax tree,
for the tests that hold a port network against its JAX original without
running JAX's initializers (one JAX compile a comparison, not two).

``random_state(module)`` draws every parameter with numpy at a fan-in
scale (so that keypoints spread and no layer norm sees a near-constant
row); ``to_flax(state)`` is ``convert.from_flax``'s inverse for networks
without batch norm or learned inner rates.
"""

import numpy as np
import torch


def random_state(module, seed=0):
  """``module``'s state dict drawn from ``seed``: a kernel normal over
  sqrt(fan in), norm scales near 1, everything else (biases,
  ``bias_transform``, the mixture's free scales) normal times 0.1."""
  rng = np.random.RandomState(seed)
  state = {}
  for name, value in module.state_dict().items():
    shape = tuple(value.shape)
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight' or leaf.endswith('_kernel'):
      fan_in = (shape[0] if leaf.endswith('_kernel')
                else int(np.prod(shape[1:])))
      draw = rng.normal(size=shape) / np.sqrt(fan_in)
    elif leaf == 'scale':
      draw = 1.0 + 0.1 * rng.normal(size=shape)
    else:
      draw = 0.1 * rng.normal(size=shape)
    state[name] = torch.tensor(draw, dtype=torch.float32)
  return state


def to_flax(state):
  """A port state dict as flax ``{'params': ...}``: dotted names nested,
  ``weight`` as ``kernel`` in flax's layout (dense [in, out], 1-D conv
  [k, in, out], 2-D conv HWIO)."""
  tree = {}
  for name, value in state.items():
    *path, leaf = name.split('.')
    array = value.numpy()
    if leaf == 'weight':
      leaf = 'kernel'
      array = {2: lambda a: a.T, 3: lambda a: a.transpose(2, 1, 0),
               4: lambda a: a.transpose(2, 3, 1, 0)}[array.ndim](array)
    node = tree
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = np.ascontiguousarray(array)
  return {'params': tree}
