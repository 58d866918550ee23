"""RT-1-style transformer behaviour cloning: episodes of frames -> actions.

The counterpart of the JAX package's ``research/seq2act/seq2act_model.py``,
for serving and training:

  * ``Seq2ActPreprocessor`` crops uint8 episodes at source resolution and
    converts them to float32 in [0, 1] in one pass of kernel K1 over the
    episode's frames: the center in PREDICT and EVAL, one random offset
    per episode in TRAIN;
  * ``RT1StyleNet`` tokenizes every frame (conv stem + TokenLearner), runs
    the causal transformer over the episode's frame-major tokens and reads
    each frame's last token into a per-step binned action head (float32);
  * ``Seq2ActBCModel`` holds the configuration, the specifications, the
    robot-time ``pack_features`` window, the export outputs, the discrete
    action loss with its ``action_accuracy`` and ``action_mae`` metrics,
    and adam as its optimizer.

With ``attention_mode='flash'`` (the long-context binding of
``train_seq2act_bc.gin``: 512-frame episodes, 4,096 tokens) every block's
attention on a CUDA tensor runs kernel K4 forward and kernels K5a and K5b
backward.

With ``attention_mode='ring'`` and a ``process_group`` of N ranks (the
gin's long-context training variant; JAX's ``mesh=``), rank r holds frames
``[r T/N, (r + 1) T/N)`` of every episode (``shard_batch``): the tokenizer,
the transformer's per-token layers and the action head run on those frames
alone, and every hop of every block's attention on a CUDA tensor runs
kernel K6. The loss, ``action_accuracy`` and ``action_mae`` are means over
the whole episodes (local sums and counts summed over the group), and the
gradients are summed over it, so the step is the unsharded model's.

The MoE, tensor-parallel and pipelined variants, and dropout in training,
are not ported yet: they raise.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.data.input_generators import FrameShard
from tensor2robot_tpu_torch.layers import transformer as transformer_lib
from tensor2robot_tpu_torch.meta_learning.meta_data import multi_batch_apply
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.models.abstract_model import Variables
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.vrgripper import decoders

__all__ = ['RT1StyleNet', 'Seq2ActBCModel', 'Seq2ActPreprocessor']

# The float32 std of a unit normal truncated to [-2, 2] (flax's
# lecun_normal draws a truncated normal and divides by it).
_TRUNCATED_STD = 0.87962566103423978


def _is_image_key(key: str) -> bool:
  return key == 'image' or key.endswith('/image')


class Seq2ActPreprocessor:
  """uint8 episode frames at source resolution -> cropped float32 in [0, 1].

  EVAL and PREDICT crop the center of every frame, TRAIN one random offset
  per episode (shared by its frames and by every ``*image`` view, so that
  the views stay registered), each through K1 (float32 whatever the
  compute dtype, as the JAX preprocessor outputs).
  """

  def __init__(self, feature_spec_fn=None, label_spec_fn=None,
               src_img_res: Tuple[int, int] = (136, 168)):
    self._feature_spec_fn = feature_spec_fn
    self._label_spec_fn = label_spec_fn
    self._src_img_res = tuple(src_img_res)

  def get_in_feature_specification(self, mode: str) -> Dict[str, tuple]:
    spec = {}
    for key, (shape, dtype) in self._feature_spec_fn(mode).items():
      if _is_image_key(key):
        shape = tuple(shape[:-3]) + self._src_img_res + tuple(shape[-1:])
        dtype = np.uint8
      spec[key] = (tuple(shape), dtype)
    return spec

  def get_in_label_specification(self, mode: str) -> Dict[str, tuple]:
    return dict(self._label_spec_fn(mode))

  def get_out_feature_specification(self, mode: str) -> Dict[str, tuple]:
    return dict(self._feature_spec_fn(mode))

  def preprocess(self, features, labels, mode: str,
                 generator: Optional[torch.Generator] = None,
                 offsets: Optional[torch.Tensor] = None):
    """(features, labels) with every ``*image`` cropped and converted.

    TRAIN draws its per-episode offsets from ``generator`` (or takes the
    caller's int [B, 2] ``offsets``) and raises without either.
    """
    if mode == ModeKeys.TRAIN and generator is None and offsets is None:
      raise ValueError('TRAIN-mode preprocessing needs a generator (or '
                       'offsets) for its random crop.')
    out_spec = self.get_out_feature_specification(mode)
    features = dict(features)
    for key in features:
      if not _is_image_key(key):
        continue
      images = torch.as_tensor(features[key])
      squeeze = images.dim() == 4  # one unbatched episode
      if squeeze:
        images = images[None]
      target_hw = tuple(out_spec[key][0][-3:-1])
      if mode == ModeKeys.TRAIN:
        if offsets is None:
          offsets = image_transformations.random_crop_offsets(
              images.shape[0], tuple(images.shape[2:4]), target_hw,
              generator)
        images = image_transformations.random_crop_episodes(
            images, target_hw, offsets=offsets)
      else:
        images = image_transformations.center_crop_episodes(images,
                                                            target_hw)
      features[key] = images[0] if squeeze else images
    return features, labels


class TaskEmbedding(nn.Module):
  """flax ``nn.Embed``: ``embedding`` [num, features] rows in ``dtype``."""

  def __init__(self, num_embeddings: int, features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

  def forward(self, ids: torch.Tensor) -> torch.Tensor:
    return self.embedding.to(self.dtype)[ids]


class RT1StyleNet(nn.Module):
  """Tokenize frames -> causal transformer -> per-step binned action head.

  ``img_res`` is the (H, W) of the frames it takes (flax decides at the
  first call whether the tokenizer needs its TokenLearner).
  ``forward(features, mode)`` takes ``image`` float [B, T, H, W, 3] (and
  ``task_id`` int [B, 1], ``state`` [B, T, S] where configured) and returns
  ``{'action_logits': float32 [B, T, action_size * vocab_size]}``; under
  ring attention T is this rank's frames, the r-th T of the episode.
  """

  def __init__(self, action_size: int, vocab_size: int,
               tokens_per_frame: int, embed_dim: int, num_layers: int,
               num_heads: int, head_dim: int, mlp_dim: int,
               max_episode_length: int, tokenizer_widths: tuple,
               img_res: Tuple[int, int],
               attention_mode: str = 'auto', tp_axis: Optional[str] = None,
               moe_experts: int = 0, pipe_axis: Optional[str] = None,
               dropout_rate: float = 0.0,
               dtype: torch.dtype = torch.float32,
               use_state_input: bool = False, state_size: int = 7,
               num_task_embeddings: int = 0, group=None):
    super().__init__()
    self.dtype, self.embed_dim = dtype, embed_dim
    self.num_task_embeddings = num_task_embeddings
    self.use_state_input = use_state_input
    self.tokenizer = transformer_lib.ImageTokenizer(
        img_res, num_tokens=tokens_per_frame, embed_dim=embed_dim,
        widths=tokenizer_widths, dtype=dtype)
    tokens = tokens_per_frame
    if num_task_embeddings:
      self.task_embedding = TaskEmbedding(num_task_embeddings, embed_dim,
                                          dtype)
      tokens += 1
    if use_state_input:
      self.state_token = transformer_lib.Dense(state_size, embed_dim, dtype)
      tokens += 1
    self.transformer = transformer_lib.CausalTransformer(
        embed_dim, num_layers, num_heads, head_dim, mlp_dim,
        max_length=max_episode_length * tokens,
        attention_mode=attention_mode, tp_axis=tp_axis,
        moe_experts=moe_experts, pipe_axis=pipe_axis,
        dropout_rate=dropout_rate, dtype=dtype, group=group)
    self.action_head = transformer_lib.Dense(
        embed_dim, action_size * vocab_size, torch.float32)

  def forward(self, features, mode: str = ModeKeys.PREDICT):
    images = torch.as_tensor(features['image']).to(self.dtype)
    b, t = images.shape[0], images.shape[1]
    tokens = multi_batch_apply(self.tokenizer, 2, images)   # [B, T, K, D]
    groups = [tokens]
    if self.num_task_embeddings:
      # Clamped as the JAX network clamps it; pack_features validates.
      task_id = torch.as_tensor(features['task_id']).reshape(b).long()
      task_id = task_id.clamp(0, self.num_task_embeddings - 1)
      groups.append(self.task_embedding(task_id)[:, None, None, :].expand(
          b, t, 1, self.embed_dim))
    if self.use_state_input:
      state = torch.as_tensor(features['state']).to(self.dtype)
      groups.append(self.state_token(state)[:, :, None, :])
    tokens = torch.cat(groups, 2) if len(groups) > 1 else tokens
    k = tokens.shape[2]
    encoded = self.transformer(tokens.reshape(b, t * k, self.embed_dim),
                               train=mode == ModeKeys.TRAIN)
    # The last token of each frame has seen the whole frame and the history.
    frame_out = encoded.reshape(b, t, k, -1)[:, :, -1, :]
    return {'action_logits': self.action_head(frame_out)}


def _flax_default_init(state: Dict[str, torch.Tensor],
                       generator: torch.Generator
                       ) -> Dict[str, torch.Tensor]:
  """Random weights as the flax modules' own initializers draw them:
  lecun normal kernels (a truncated normal of variance 1 / fan_in), zero
  biases, unit layer-norm scales, N(0, 0.02) positions and N(0, 1 /
  features) task embeddings. (``jax.random`` gives other numbers.)"""
  out = {}
  for name, value in state.items():
    leaf = name.rsplit('.', 1)[-1]
    if leaf == 'weight':
      fan_in = value[0].numel()
      new = torch.empty(value.shape)
      nn.init.trunc_normal_(new, 0.0, 1.0, -2.0, 2.0, generator=generator)
      new *= (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    elif leaf == 'pos_embedding':
      new = 0.02 * torch.randn(value.shape, generator=generator)
    elif leaf == 'embedding':
      new = torch.randn(value.shape, generator=generator) / value.shape[1] ** 0.5
    elif leaf == 'scale':
      new = torch.ones(value.shape)
    else:
      new = torch.zeros(value.shape)
    out[name] = new
  return out


class Seq2ActBCModel(AbstractT2RModel):
  """The T2R contract around ``RT1StyleNet``.

  The constructor keeps the JAX model's defaults (``episode_length`` 6,
  8 blocks of 8 heads x 64 at width 512, MLP 2048, 8 tokens a frame,
  128x160 crops of 136x168 frames, 256 bins over [-1, 1], adam at
  ``learning_rate``). ``device_type`` defaults to ``'cpu'`` as in the JAX
  model; only ``'tpu'`` makes the compute dtype bfloat16.
  ``process_group`` (in place of JAX's ``mesh``) goes with
  ``attention_mode='ring'`` and no other mode: its N ranks must divide the
  episode, and the rank's tokens must suit the carry kernel's blocks (the
  first attention raises otherwise).
  """

  label_key = 'action'
  # The keys whose second axis is the episode's frames (after the batch's).
  _FRAME_KEYS = ('image', 'state', 'action')

  def __init__(self,
               episode_length: int = 6,
               action_size: int = 7,
               vocab_size: int = 256,
               img_res: Tuple[int, int] = (128, 160),
               src_img_res: Tuple[int, int] = (136, 168),
               tokens_per_frame: int = 8,
               embed_dim: int = 512,
               num_layers: int = 8,
               num_heads: int = 8,
               head_dim: int = 64,
               mlp_dim: int = 2048,
               tokenizer_widths: Sequence[int] = (32, 64, 128, 256),
               action_min: float = -1.0,
               action_max: float = 1.0,
               attention_mode: str = 'auto',
               process_group=None,
               tp_axis: Optional[str] = None,
               moe_experts: int = 0,
               pipe_axis: Optional[str] = None,
               max_episode_length: Optional[int] = None,
               dropout_rate: float = 0.0,
               use_state_input: bool = False,
               state_size: int = 7,
               num_task_embeddings: int = 0,
               learning_rate: float = 1e-4,
               **kwargs):
    if (attention_mode == 'ring') != (process_group is not None):
      raise ValueError("attention_mode='ring' requires a process_group, and "
                       'a process_group requires ring attention; got {!r} '
                       'and {}.'.format(attention_mode, process_group))
    if process_group is not None:
      world = collectives.world_size(process_group)
      if episode_length % world:
        raise ValueError('Ring attention over {} ranks needs an episode '
                         'length that they divide; got {}.'.format(
                             world, episode_length))
    kwargs.setdefault('device_type', 'cpu')
    kwargs.setdefault(
        'create_optimizer_fn',
        lambda: optimizers.create_adam_optimizer(learning_rate=learning_rate))
    super().__init__(
        preprocessor_cls=functools.partial(Seq2ActPreprocessor,
                                           src_img_res=tuple(src_img_res)),
        process_group=process_group, **kwargs)
    self._episode_length = episode_length
    self._action_size = action_size
    self._vocab_size = vocab_size
    self._img_res = tuple(img_res)
    self._tokens_per_frame = tokens_per_frame
    self._embed_dim = embed_dim
    self._num_layers = num_layers
    self._num_heads = num_heads
    self._head_dim = head_dim
    self._mlp_dim = mlp_dim
    self._tokenizer_widths = tuple(tokenizer_widths)
    self._attention_mode = attention_mode
    self._tp_axis = tp_axis
    self._moe_experts = moe_experts
    self._pipe_axis = pipe_axis
    self._max_episode_length = max_episode_length or episode_length
    self._dropout_rate = dropout_rate
    self._use_state_input = use_state_input
    self._state_size = state_size
    self._num_task_embeddings = num_task_embeddings
    self._action_min, self._action_max = action_min, action_max
    self._bin_centers = decoders.get_discrete_bins(
        vocab_size, np.full((action_size,), action_min, np.float32),
        np.full((action_size,), action_max, np.float32))

  @property
  def episode_length(self) -> int:
    return self._episode_length

  def get_feature_specification(self, mode: str) -> Dict[str, tuple]:
    del mode
    h, w = self._img_res
    spec = {'image': ((self._episode_length, h, w, 3), np.float32)}
    if self._use_state_input:
      spec['state'] = ((self._episode_length, self._state_size), np.float32)
    if self._num_task_embeddings:
      spec['task_id'] = ((1,), np.int32)
    return spec

  def get_label_specification(self, mode: str) -> Dict[str, tuple]:
    del mode
    return {'action': ((self._episode_length, self._action_size),
                       np.float32)}

  def create_network(self) -> nn.Module:
    return RT1StyleNet(
        action_size=self._action_size,
        vocab_size=self._vocab_size,
        tokens_per_frame=self._tokens_per_frame,
        embed_dim=self._embed_dim,
        num_layers=self._num_layers,
        num_heads=self._num_heads,
        head_dim=self._head_dim,
        mlp_dim=self._mlp_dim,
        max_episode_length=self._max_episode_length,
        tokenizer_widths=self._tokenizer_widths,
        img_res=self._img_res,
        attention_mode=self._attention_mode,
        tp_axis=self._tp_axis,
        moe_experts=self._moe_experts,
        pipe_axis=self._pipe_axis,
        dropout_rate=self._dropout_rate,
        dtype=self.compute_dtype,
        use_state_input=self._use_state_input,
        state_size=self._state_size,
        num_task_embeddings=self._num_task_embeddings,
        group=self.process_group)

  def frame_shard(self) -> FrameShard:
    """This rank's frames ``[r T/N, (r + 1) T/N)`` of every episode, of each
    array keyed in ``_FRAME_KEYS`` (the others, ``task_id``, whole): all T
    without a ``process_group``. The trainer draws only these."""
    n = collectives.world_size(self.process_group)
    per_rank = self._episode_length // n
    start = collectives.rank(self.process_group) * per_rank
    return FrameShard(self._FRAME_KEYS, start, start + per_rank)

  def init_variables(self, generator: torch.Generator) -> Variables:
    """Random weights from ``generator`` at the flax initializers' scales
    (see ``_flax_default_init``), on the model's device."""
    state = _flax_default_init(dict(self.create_network().state_dict()),
                               generator)
    return {'params': self.to_device(state)}

  def model_train_fn(self, state, features, labels, inference_outputs,
                     mode: str):
    """(loss, {loss, action_accuracy, action_mae}): the discrete action
    loss, and the share and mean error of the mode actions against the
    labels (a prediction within half a bin, plus 1e-6, is accurate).

    With a ``process_group`` each rank holds some frames of every episode:
    the three are means over all of them (the local sums and counts summed
    over the group), and the loss returned to differentiate is this rank's
    share of the global mean, whose gradients the group sums.
    """
    del state, features, mode
    logits = inference_outputs['action_logits']      # [B, T, A * V]
    actions = torch.as_tensor(labels[self.label_key]).to(torch.float32)
    loss = decoders.get_discrete_action_loss(
        logits, actions, self._bin_centers, self._vocab_size)
    predicted = decoders.get_discrete_actions(
        logits, self._action_size, self._vocab_size, self._bin_centers)
    bin_width = (self._action_max - self._action_min) / self._vocab_size
    error = (predicted - actions).abs()
    within_bin = error <= (bin_width * 0.5 + 1e-6)
    if self.process_group is None:
      return loss, {'loss': loss,
                    'action_accuracy': within_bin.to(torch.float32).mean(),
                    'action_mae': error.mean()}
    count = float(error.numel())
    totals = collectives.all_reduce_sum(torch.stack([
        loss.detach() * count, within_bin.to(torch.float32).sum(),
        error.sum(), torch.tensor(count, device=error.device)]),
                                        self.process_group)
    means = totals[:3] / totals[3]
    return loss * (count / totals[3]), {
        'loss': means[0], 'action_accuracy': means[1],
        'action_mae': means[2]}

  def model_eval_fn(self, state, features, labels, inference_outputs,
                    mode: str) -> Dict[str, torch.Tensor]:
    return self.model_train_fn(state, features, labels, inference_outputs,
                               mode)[1]

  def pack_features(self, state, context, timestep) -> dict:
    """The rolling episode window for robot-time serving.

    ``state['image']`` is one uint8 [H, W, 3] frame at source resolution;
    ``context`` the previous call's return value (None on the first step).
    The newest frame enters at the end of the [1, T, H, W, 3] window; until
    T frames exist the first frame repeats.
    """
    del timestep
    frame = np.asarray(state['image'], np.uint8)[None, None]
    if context is None:
      window = np.repeat(frame, self._episode_length, axis=1)
    else:
      window = np.concatenate([np.asarray(context['image'])[:, 1:], frame],
                              axis=1)
    packed = {'image': window}
    if self._num_task_embeddings:
      if 'task_id' not in state:
        raise ValueError(
            'Task-conditioned model (num_task_embeddings={}) requires a '
            "'task_id' in the observation.".format(
                self._num_task_embeddings))
      task_id = int(np.asarray(state['task_id']).reshape(()))
      if not 0 <= task_id < self._num_task_embeddings:
        raise ValueError('task_id {} out of range [0, {}).'.format(
            task_id, self._num_task_embeddings))
      packed['task_id'] = np.asarray([[task_id]], np.int32)
    return packed

  def create_export_outputs_fn(self, features, inference_outputs,
                               mode: str) -> Dict[str, torch.Tensor]:
    logits = inference_outputs['action_logits']
    action = decoders.get_discrete_actions(
        logits, self._action_size, self._vocab_size, self._bin_centers)
    return {'action': action,                      # [B, T, A]
            'inference_output': action[:, -1, :],  # the newest step's
            'action_logits': logits}
