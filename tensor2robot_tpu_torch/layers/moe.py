"""Mixture-of-Experts MLP on one card: the JAX package's ``layers/moe.py``.

The same routing as the JAX module's dense path (``mesh=None``, or an
``ep_axis`` that no mesh provides), value for value:

  * the router is a float32 Dense over the float32 input, its softmax the
    probabilities over the experts, ``torch.topk`` each token's k choices;
  * each expert has ``capacity`` slots: ceil(k T f / E), rounded up to a
    multiple of 8 and capped at T, for a group of T tokens (the whole
    sequence);
  * the slots are given out k-major: the running count of assignments to
    an expert runs over the [K * T] (choice, token) pairs with the choice
    outermost, so that every first choice precedes every second one; a
    pair past its expert's capacity is dropped, and a token all of whose
    choices are dropped puts out 0;
  * the gate of a kept pair is the raw router probability for k == 1 and
    the probability over the sum of the token's kept ones for k > 1;
  * the expert MLP is ``gelu(x @ w_in[e]) @ w_out[e]`` in the compute
    dtype, flax's gelu (tanh);
  * the auxiliary loss is Switch's, float32: E * sum_e (share of tokens
    whose first choice is e) * (mean probability of e), before capacity.

Where JAX multiplies one-hot [B, T, E, C] dispatch and combine tensors,
this module gathers each kept token into its slot of an [E, B, C, d]
buffer and adds the gated expert outputs back by index: each one-hot
einsum sums one nonzero term, so the values are the same, and no
[B, T, E, C] tensor is made (at B 8, T 4096, E 8, C 1280 each would take
1.34 GB in float32 a layer). The gathers are ``index_select``s, whose
backward adds into the tokens by atomics: the empty slots and dropped
pairs read filler rows spread over the tokens (and are zeroed), since
pointing them all at one zero row makes that row's sum in the backward
serial: with advanced indexing so, PyTorch's indexing backward took most
of an H100's step at the long-context binding.

The parameters keep flax's names, so ``convert.from_flax`` maps them
unchanged: ``router`` (a Dense), ``w_in`` [E, d, h] and ``w_out`` [E, h,
d], float32.

Expert parallelism (an ``expert_group`` of ranks, JAX's all-to-all
dispatch over the mesh's expert axis) is not ported: it raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.transformer import Dense
from tensor2robot_tpu_torch.layers.transformer import gelu

__all__ = ['MoEMlp', 'Routing', 'capacity', 'route', 'switch_aux_loss']

# The next slice of the port, which brings expert parallelism.
NEXT_SLICE = ('expert parallelism over an expert group is not ported yet '
              '(the next slice: all-to-all dispatch, EP_RULES_MOE)')


def capacity(k: int, tokens: int, factor: float, num_experts: int) -> int:
  """Per-expert slots for a group of ``tokens``: ceil(k T f / E), rounded
  up to a multiple of 8 (at least 8), at most T. Integer arithmetic on the
  float quotient, as the JAX ``_capacity``."""
  slots = int(math.ceil(k * tokens * factor / num_experts))
  slots = max(8, -(-slots // 8) * 8)
  return min(slots, tokens)


class Routing:
  """Where each (token, choice) pair goes: ``expert`` and ``slot``
  [B, T, K] (int64), ``kept`` [B, T, K] (bool: within its expert's
  capacity), ``gate`` [B, T, K] (float32, 0 where dropped) and the
  ``capacity``."""

  def __init__(self, expert, slot, kept, gate, slots):
    self.expert, self.slot, self.kept, self.gate = expert, slot, kept, gate
    self.capacity = slots

  def dropped_share(self) -> torch.Tensor:
    """The share of (token, choice) pairs dropped over capacity."""
    return 1.0 - self.kept.to(torch.float32).mean()


def route(probs: torch.Tensor, k: int, factor: float) -> Routing:
  """Top-k routing of ``probs`` [B, T, E] (float32) over the whole T."""
  b, t, e = probs.shape
  slots = capacity(k, t, factor, e)
  top, expert = torch.topk(probs, k, dim=-1)            # [B, T, K]
  # k-major: the pairs of choice 0 for every token, then those of choice 1;
  # each expert's running count along its own row (an inner-dim scan).
  pairs = expert.transpose(1, 2).reshape(b, 1, k * t)
  onehot = (pairs == torch.arange(e, device=probs.device)[:, None]).to(
      torch.int32)                                       # [B, E, KT]
  before = onehot.cumsum(-1, dtype=torch.int32) - onehot
  slot = (before * onehot).sum(1).long().reshape(b, k, t).transpose(1, 2)
  kept = slot < slots
  gate = top * kept
  if k > 1:
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
  return Routing(expert, slot, kept, gate, slots)


def switch_aux_loss(probs: torch.Tensor, first_choice: torch.Tensor
                    ) -> torch.Tensor:
  """E * sum_e fraction_e * mean_prob_e over all tokens (float32)."""
  e = probs.shape[-1]
  fraction = F.one_hot(first_choice.reshape(-1), e).to(torch.float32).mean(0)
  mean_prob = probs.reshape(-1, e).mean(0)
  return e * (fraction * mean_prob).sum()


class MoEMlp(nn.Module):
  """Top-k routed expert MLP: [B, L, d] -> ([B, L, d] in x's dtype,
  float32 aux loss)."""

  def __init__(self, features: int, num_experts: int, expert_dim: int,
               top_k: int = 2, capacity_factor: float = 1.25,
               ep_axis: Optional[str] = None, expert_group=None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if expert_group is not None:
      raise NotImplementedError('MoEMlp(ep_axis={!r}): {}.'.format(
          ep_axis, NEXT_SLICE))
    # ep_axis without an expert group is the dense path, as JAX's MoEMlp
    # takes it without a mesh.
    self.num_experts, self.top_k = num_experts, min(top_k, num_experts)
    self.capacity_factor, self.dtype = capacity_factor, dtype
    self.router = Dense(features, num_experts, torch.float32)
    self.w_in = nn.Parameter(torch.empty(num_experts, features, expert_dim))
    self.w_out = nn.Parameter(torch.empty(num_experts, expert_dim, features))

  def routing(self, x: torch.Tensor) -> Tuple[torch.Tensor, Routing]:
    """(probs [B, L, E] float32, the routing of ``x``)."""
    probs = torch.softmax(self.router(x.to(torch.float32)), -1)
    return probs, route(probs, self.top_k, self.capacity_factor)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, d = x.shape
    e, k = self.num_experts, self.top_k
    probs, r = self.routing(x)
    slots = e * b * r.capacity
    # The [E, B, C] slot of each (token, choice) pair; a dropped pair gets
    # the spare entry past them (writes) or a filler row (reads, gate 0).
    batch = torch.arange(b, device=x.device)[:, None, None]
    slot_row = (r.expert * b + batch) * r.capacity + r.slot
    token = torch.arange(b * l, device=x.device).reshape(b, l, 1).expand(
        b, l, k)
    rows = torch.where(r.kept, slot_row, slots).reshape(-1)
    # Each slot's token. An empty slot reads a filler row, zeroed by
    # ``filled``: spread over the tokens, so that the backward's sums into
    # the tokens meet no one row that every empty slot adds to.
    source = torch.arange(slots + 1, device=x.device) % (b * l)
    source[rows] = token.reshape(-1)
    filled = torch.zeros(slots + 1, dtype=self.dtype, device=x.device)
    filled[rows] = 1
    expert_in = (x.to(self.dtype).reshape(b * l, d).index_select(
        0, source[:slots]) * filled[:slots, None]).reshape(e, -1, d)
    h = gelu(torch.matmul(expert_in, self.w_in.to(self.dtype)))
    expert_out = torch.matmul(h, self.w_out.to(self.dtype))  # [E, B*C, d]
    # The gated sum over the kept choices in float32, rounded once to the
    # compute dtype (JAX's combine einsum, its gates in the compute dtype);
    # a dropped pair reads a filler row and its gate, 0, zeroes it.
    read = torch.where(r.kept, slot_row, token % slots).reshape(-1)
    picked = expert_out.reshape(slots, d).index_select(0, read).reshape(
        b, l, k, d).to(torch.float32)
    gate = r.gate.to(self.dtype).to(torch.float32)
    out = (picked * gate[..., None]).sum(2).to(self.dtype)
    return out.to(x.dtype), switch_aux_loss(probs, r.expert[..., 0])
