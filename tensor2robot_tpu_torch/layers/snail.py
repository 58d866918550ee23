"""SNAIL's temporal blocks (the JAX package's ``layers/snail.py``; Mishra
et al., arXiv:1707.03141), over [batch, time, channels]:

  * ``CausalConv``: a dilated 1-D conv (``Conv_0``, with bias), the input
    padded on the left so that step t sees steps <= t only;
  * ``DenseBlock``: tanh(``xf``) * sigmoid(``xg``) of two causal convs,
    concatenated onto the input;
  * ``TCBlock``: ``DenseBlock_1`` .. ``DenseBlock_n`` at dilations 2, 4,
    .., 2^n, n = ceil(log2(sequence_length));
  * ``causally_masked_softmax`` and ``AttentionBlock``: single-head causal
    attention (key ``Dense_0``, query ``Dense_1``, value ``Dense_2``), its
    read concatenated onto the input.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.basic import Conv1D, Dense

__all__ = ['AttentionBlock', 'CausalConv', 'DenseBlock', 'TCBlock',
           'causally_masked_softmax']


class CausalConv(nn.Module):

  def __init__(self, in_features: int, filters: int, dilation_rate: int = 1,
               kernel_size: int = 2):
    super().__init__()
    self.causal_pad = (kernel_size - 1) * dilation_rate
    self.Conv_0 = Conv1D(in_features, filters, kernel_size, dilation_rate)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.Conv_0(F.pad(x, (0, 0, self.causal_pad, 0)))


class DenseBlock(nn.Module):

  def __init__(self, in_features: int, filters: int, dilation_rate: int = 1):
    super().__init__()
    self.xf = CausalConv(in_features, filters, dilation_rate)
    self.xg = CausalConv(in_features, filters, dilation_rate)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    activations = torch.tanh(self.xf(x)) * torch.sigmoid(self.xg(x))
    return torch.cat([x, activations], 2)


class TCBlock(nn.Module):
  """Output channels: in_features + filters ceil(log2(sequence_length))."""

  def __init__(self, in_features: int, sequence_length: int, filters: int):
    super().__init__()
    self.num_blocks = int(np.ceil(np.log2(sequence_length)))
    width = in_features
    for i in range(1, self.num_blocks + 1):
      self.add_module('DenseBlock_%d' % i, DenseBlock(width, filters, 2 ** i))
      width += filters
    self.out_features = width

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(1, self.num_blocks + 1):
      x = getattr(self, 'DenseBlock_%d' % i)(x)
    return x


def causally_masked_softmax(logits: torch.Tensor) -> torch.Tensor:
  """The softmax of each row of [..., T, T] over j <= i, exact zeros
  above the diagonal."""
  t = logits.shape[-1]
  mask = torch.ones((t, t), dtype=torch.bool, device=logits.device).tril()
  probs = torch.softmax(logits.masked_fill(~mask, float('-inf')), -1)
  return torch.where(mask, probs, torch.zeros_like(probs))


class AttentionBlock(nn.Module):
  """``forward(x) -> (cat(x, read), {'attn_prob': probs})``."""

  def __init__(self, in_features: int, key_size: int, value_size: int):
    super().__init__()
    self.key_size = key_size
    self.Dense_0 = Dense(in_features, key_size)
    self.Dense_1 = Dense(in_features, key_size)
    self.Dense_2 = Dense(in_features, value_size)
    self.out_features = in_features + value_size

  def forward(self, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    key, query = self.Dense_0(x), self.Dense_1(x)
    logits = torch.einsum('btk,bsk->bts', query, key)
    probs = causally_masked_softmax(logits / np.sqrt(self.key_size))
    read = torch.einsum('bts,bsv->btv', probs, self.Dense_2(x))
    return torch.cat([x, read], 2), {'attn_prob': probs}
