"""Transformer layers for sequence-to-action policies (RT-1-style).

The counterpart of the JAX package's ``layers/transformer.py``: a causal
transformer over per-frame visual tokens, with the same module names
(so ``convert.from_flax`` maps a flax tree onto the state dict name for
name) and the same arithmetic:

  * dense layers compute in the module's dtype (flax ``nn.Dense(dtype=)``);
  * layer norms compute in float32 as flax does (``E[x^2] - E[x]^2``
    clipped at 0, epsilon 1e-6) and are cast back to the compute dtype by
    the caller, as the JAX modules cast them;
  * GELU is flax's, the tanh approximation;
  * the tokenizer's 3x3 stride-2 convolutions pad TF-style SAME (0 low, 1
    high on even sizes), and its map flattens in H, W, C order.

Attention modes: ``'xla'`` is the dense oracle (``scaled_dot_attention``);
``'flash'`` is ``parallel.flash_attention`` (kernel K4 forward and K5a,
K5b backward on a CUDA tensor, the plain versions on a CPU tensor);
``'auto'`` picks flash for a CUDA tensor when L >= 2048 and L % 128 == 0,
where the JAX package picks it on a TPU, and dense otherwise. ``'ring'``
(sequence-sharded ring attention, kernel K6), tensor parallelism
(``tp_axis``), the MoE MLP (``moe_experts``), the pipelined stack
(``pipe_axis``) and dropout in training are not ported yet and raise. (Dropout is the identity outside training, as flax's is.)

Causality is at token granularity: tokens are frame-major, so a frame's
tokens see all earlier frames and their predecessors within the frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.parallel import flash_attention as flash_lib
from tensor2robot_tpu_torch.research.qtopt.networks import Conv

__all__ = ['CausalTransformer', 'Dense', 'ImageTokenizer', 'LayerNorm',
           'MultiHeadAttention', 'TokenLearner', 'TransformerBlock',
           'gelu', 'resolve_attention_mode', 'run_attention',
           'scaled_dot_attention']

_FLASH_MIN_LENGTH = 2048


def gelu(x: torch.Tensor) -> torch.Tensor:
  """flax's ``nn.gelu``: the tanh approximation."""
  return F.gelu(x, approximate='tanh')


class Dense(nn.Module):
  """flax ``nn.Dense(features, dtype=dtype)``: input, kernel and bias cast
  to ``dtype``, then ``x @ kernel + bias``. ``weight`` is the flax kernel
  [in, out] transposed."""

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.weight = nn.Parameter(torch.empty(features, in_features))
    self.bias = nn.Parameter(torch.empty(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                    self.bias.to(self.dtype))


class LayerNorm(nn.Module):
  """flax ``nn.LayerNorm(dtype=jnp.float32)`` over the last dim: float32
  out, whatever the input's dtype."""

  def __init__(self, features: int, epsilon: float = 1e-6):
    super().__init__()
    self.epsilon = epsilon
    self.scale = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + self.epsilon) * self.scale
    return (x - mean) * mul + self.bias


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
  """Dense [B, L, H, D] attention in float32 (the oracle path)."""
  scale = 1.0 / np.sqrt(q.shape[-1])
  scores = torch.einsum('bqhd,bkhd->bhqk', q.to(torch.float32),
                        k.to(torch.float32)) * scale
  if causal:
    l_q, l_k = q.shape[1], k.shape[1]
    mask = torch.ones((l_q, l_k), dtype=torch.bool,
                      device=q.device).tril(l_k - l_q)
    scores = scores.masked_fill(~mask, float('-inf'))
  probs = torch.softmax(scores, -1)
  return torch.einsum('bhqk,bkhd->bqhd', probs,
                      v.to(torch.float32)).to(q.dtype)


def resolve_attention_mode(mode: str, seq_length: int,
                           device: torch.device) -> str:
  """'auto' -> 'flash' for a CUDA tensor of a long, 128-aligned sequence,
  else 'xla'; the other modes pass through."""
  if mode != 'auto':
    return mode
  return ('flash' if (torch.device(device).type == 'cuda' and
                      seq_length >= _FLASH_MIN_LENGTH and
                      seq_length % 128 == 0) else 'xla')


def run_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str, causal: bool) -> torch.Tensor:
  """[B, L, H, D] self-attention by the selected backend."""
  mode = resolve_attention_mode(mode, q.shape[1], q.device)
  if mode == 'xla':
    return scaled_dot_attention(q, k, v, causal)
  if mode == 'flash':
    return flash_lib.flash_attention(q, k, v, causal=causal)
  if mode == 'ring':
    raise NotImplementedError(
        "attention_mode='ring' (ring attention over torch.distributed, "
        'kernel K6) is not ported yet; see ROADMAP queue 1.')
  raise ValueError('Unknown attention mode: {!r}'.format(mode))


class MultiHeadAttention(nn.Module):
  """Self-attention with a head-major qkv projection: its columns are
  grouped [H, 3, Dh], so q, k and v are strided views of one tensor that
  the flash kernel reads in place."""

  def __init__(self, in_features: int, num_heads: int, head_dim: int,
               attention_mode: str = 'auto', causal: bool = True,
               tp_axis: Optional[str] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if tp_axis:
      raise NotImplementedError('Tensor parallelism (tp_axis) is not ported '
                                'yet.')
    self.num_heads, self.head_dim = num_heads, head_dim
    self.attention_mode, self.causal = attention_mode, causal
    features = num_heads * head_dim
    self.qkv = Dense(in_features, 3 * features, dtype)
    self.out = Dense(features, in_features, dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, l, _ = x.shape
    qkv = self.qkv(x).reshape(b, l, self.num_heads, 3, self.head_dim)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    out = run_attention(q, k, v, mode=self.attention_mode,
                        causal=self.causal)
    return self.out(out.reshape(b, l, self.num_heads * self.head_dim))


class TransformerBlock(nn.Module):
  """Pre-LN block: LN -> MHA -> +res, LN -> MLP(gelu) -> +res."""

  def __init__(self, features: int, num_heads: int, head_dim: int,
               mlp_dim: int, attention_mode: str = 'auto',
               causal: bool = True, tp_axis: Optional[str] = None,
               moe_experts: int = 0, dropout_rate: float = 0.0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if moe_experts:
      raise NotImplementedError('The MoE MLP (moe_experts > 0) is not '
                                'ported yet.')
    self.dtype, self.dropout_rate = dtype, dropout_rate
    self.ln_attn = LayerNorm(features)
    self.attn = MultiHeadAttention(features, num_heads, head_dim,
                                   attention_mode, causal, tp_axis, dtype)
    self.ln_mlp = LayerNorm(features)
    self.mlp_in = Dense(features, mlp_dim, dtype)
    self.mlp_out = Dense(mlp_dim, features, dtype)

  def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
    if train and self.dropout_rate:
      raise NotImplementedError(
          'Dropout in training (dropout_rate > 0) is not ported yet: it '
          'needs an explicit generator (see ROADMAP queue 1).')
    h = self.attn(self.ln_attn(x).to(self.dtype))
    x = x + h
    h = self.mlp_out(gelu(self.mlp_in(self.ln_mlp(x).to(self.dtype))))
    return x + h


class TokenLearner(nn.Module):
  """Pools N tokens to K with K learned softmax maps over N (RT-1)."""

  def __init__(self, features: int, num_tokens: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.ln = LayerNorm(features)
    self.map_in = Dense(features, num_tokens * 2, dtype)
    self.map_out = Dense(num_tokens * 2, num_tokens, dtype)

  def forward(self, tokens: torch.Tensor) -> torch.Tensor:
    # tokens: [B, N, D] -> [B, K, D]
    maps = self.map_out(gelu(self.map_in(self.ln(tokens).to(self.dtype))))
    maps = torch.softmax(maps.to(torch.float32), 1)     # over N
    return torch.einsum('bnk,bnd->bkd', maps,
                        tokens.to(torch.float32)).to(tokens.dtype)


class ImageTokenizer(nn.Module):
  """Four 3x3 stride-2 SAME convs (each + LN + gelu) turning [N, H, W, 3]
  frames into an H/16 x W/16 map, a dense embedding of its tokens, then
  TokenLearner down to ``num_tokens``.

  flax creates the TokenLearner at the first call, only where the stem
  makes more tokens than ``num_tokens``; here the frame size
  ``image_size`` (H, W) decides it when the module is built.
  """

  def __init__(self, image_size, num_tokens: int = 8, embed_dim: int = 512,
               widths: tuple = (32, 64, 128, 256),
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.num_tokens, self.dtype = num_tokens, dtype
    self.widths = tuple(widths)
    self.image_size = tuple(image_size)
    for i, (c_in, c_out) in enumerate(zip((3,) + self.widths, self.widths)):
      self.add_module('conv{}'.format(i), Conv(c_in, c_out, 3, 2, 'SAME',
                                               bias=True))
      self.add_module('ln{}'.format(i), LayerNorm(c_out))
    self.embed = Dense(self.widths[-1], embed_dim, dtype)
    h, w = self.image_size
    for _ in self.widths:
      h, w = -(-h // 2), -(-w // 2)
    if num_tokens and num_tokens > h * w:
      raise ValueError(
          'num_tokens={} exceeds the conv stem\'s {} spatial tokens for '
          'this input size; lower num_tokens or raise the resolution.'
          .format(num_tokens, h * w))
    # As many tokens as the stem makes: the identity, as in flax.
    self.token_learner = (TokenLearner(embed_dim, num_tokens, dtype)
                          if num_tokens and num_tokens < h * w else None)

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    if tuple(images.shape[1:3]) != self.image_size:
      raise ValueError('ImageTokenizer was built for {} frames, got {}.'
                       .format(self.image_size, tuple(images.shape[1:3])))
    x = images.to(self.dtype)                  # [N, H, W, 3]
    for i in range(len(self.widths)):
      # Convs run on NCHW views of channels_last maps; LN and gelu on NHWC.
      x = getattr(self, 'conv{}'.format(i))(x.permute(0, 3, 1, 2))
      x = x.permute(0, 2, 3, 1)
      x = gelu(getattr(self, 'ln{}'.format(i))(x).to(self.dtype))
    x = self.embed(x.reshape(x.shape[0], -1, x.shape[-1]))  # [N, hw, D]
    if self.token_learner is not None:
      x = self.token_learner(x)
    return x


class CausalTransformer(nn.Module):
  """Learned positions (a float32 parameter) + N causal blocks + a final
  float32 LN; returns float32 [B, L, D]."""

  def __init__(self, features: int, num_layers: int, num_heads: int,
               head_dim: int, mlp_dim: int, max_length: int,
               attention_mode: str = 'auto', tp_axis: Optional[str] = None,
               moe_experts: int = 0, pipe_axis: Optional[str] = None,
               dropout_rate: float = 0.0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if pipe_axis:
      raise NotImplementedError('The pipelined stack (pipe_axis) is not '
                                'ported yet.')
    self.num_layers, self.max_length = num_layers, max_length
    self.pos_embedding = nn.Parameter(torch.empty(max_length, features))
    for i in range(num_layers):
      self.add_module('block{}'.format(i), TransformerBlock(
          features, num_heads, head_dim, mlp_dim, attention_mode,
          causal=True, tp_axis=tp_axis, moe_experts=moe_experts,
          dropout_rate=dropout_rate, dtype=dtype))
    self.ln_final = LayerNorm(features)

  def forward(self, tokens: torch.Tensor, train: bool = False
              ) -> torch.Tensor:
    l = tokens.shape[1]
    if l > self.max_length:
      raise ValueError('Sequence length {} exceeds max_length {}.'.format(
          l, self.max_length))
    x = tokens + self.pos_embedding[None, :l].to(tokens.dtype)
    for i in range(self.num_layers):
      x = getattr(self, 'block{}'.format(i))(x, train=train)
    return self.ln_final(x)
