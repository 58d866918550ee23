"""Seq2Act's variants in the port against the JAX package, on the CPU: the
MoE MLP of ``train_seq2act_moe.gin``, bfloat16 activations
(``device_type = "tpu"``) and dropout, on a 2-block, width-64 model of
4-frame episodes.

Weights are the JAX model's own initial state, converted
(``convert.train_state_from_flax``), but for the MoE routers' kernels,
drawn with numpy at a scale where no two of a token's top 3 router
probabilities tie (the test asserts a gap of 1e-6 between them, on the
inputs the port's routers see): ``jax.lax.top_k`` and ``torch.topk`` break
ties in other orders. Inputs are drawn with numpy from a seed.

Tolerances, each with its reason:

  * MoE, float32: the logits within 1e-4 of their max, the loss (the
    discrete action loss plus ``moe_aux_weight`` times the summed aux
    losses) within 1e-5 relative, the aux losses within 1e-6 relative and
    every gradient within 1e-4 of its largest magnitude: the bounds of
    the dense model's step (``tests/test_torch_seq2act_training.py``),
    XLA and PyTorch summing their products in other orders; the routing
    is the same, so no token moves;
  * bfloat16 (``device_type='tpu'`` on both sides), with and without the
    MoE: the logits within BF16_LOGITS_ATOL (3e-2) of their max and the
    loss within BF16_LOSS_RTOL (3e-3) relative: XLA and PyTorch round
    each bf16 product, convolution and gelu at other points, one bf16 ulp
    (2 ** -8) a rounding through two blocks and the tokenizer, which the
    float32 layer norms and action head do not undo; measured here 8.6e-3
    and 3.4e-4 (dense) and 6.1e-3 and 2.9e-4 (MoE); the aux losses within
    BF16_AUX_RTOL (1e-2) relative: the router is float32 on both sides,
    but its input is the bf16 residual stream, which differs by those
    roundings (measured 1.7e-3);
  * dropout's apply fed the masks JAX drew (recovered from flax's
    ``Dropout`` outputs by ``capture_intermediates``): the training
    forward's logits within 1e-6 of their max of JAX's with those masks;
  * dropout's draw: the kept share of 2 ** 20 draws within 3 sigma of
    1 - rate, and a run resumed from a checkpoint equal to an
    uninterrupted one bit for bit (its masks are drawn from the step).
"""

import functools

import flax
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.trainer import train_eval

import test_torch_seq2act

jax_seq2act = test_torch_seq2act.jax_seq2act

SMALL = dict(
    episode_length=4,
    action_size=3,
    vocab_size=16,
    img_res=(48, 64),
    src_img_res=(52, 70),
    tokens_per_frame=8,
    embed_dim=64,
    num_layers=2,
    num_heads=2,
    head_dim=32,
    mlp_dim=128,
    tokenizer_widths=(8, 8, 16, 16),
    attention_mode='xla',
)
# train_seq2act_moe.gin's bindings.
MOE = dict(moe_experts=8, moe_top_k=2, ep_axis='expert', moe_aux_weight=0.01)
BF16_LOGITS_ATOL = 3e-2   # of max|logits|
BF16_LOSS_RTOL = 3e-3
BF16_AUX_RTOL = 1e-2
# The TokenLearner's softmax cancels the map_out bias: its gradient is 0 in
# exact arithmetic, noise held to 1e-6 of the largest on both sides.
ZERO_GRADIENTS = ('tokenizer.token_learner.map_out.bias',)


def _batch(seed, batch=2):
  rng = np.random.RandomState(seed)
  t, (h, w) = SMALL['episode_length'], SMALL['img_res']
  features = {'image': rng.uniform(0, 1, (batch, t, h, w, 3)).astype(
      np.float32)}
  labels = {'action': rng.uniform(-1, 1, (batch, t, SMALL['action_size']))
            .astype(np.float32)}
  return features, labels


def _torch_tree(tree):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _jax_state(jax_model, features, labels, seed=0):
  state = jax.jit(jax_model.create_train_state)(
      jax.random.PRNGKey(0), SpecStruct(**features), SpecStruct(**labels))
  if not getattr(jax_model, '_moe_experts', 0):
    return state
  params = flax.core.unfreeze(jax.tree_util.tree_map(np.asarray,
                                                     state.params))
  rng = np.random.RandomState(seed)
  d = SMALL['embed_dim']
  for i in range(SMALL['num_layers']):
    router = params['transformer']['block{}'.format(i)]['moe']['router']
    router['kernel'] = (3.0 * rng.randn(d, MOE['moe_experts']) /
                        np.sqrt(d)).astype(np.float32)
  return state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))


def _port(jax_model_kwargs, state):
  model = Seq2ActBCModel(device='cpu', **jax_model_kwargs)
  converted = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, state))
  assert set(converted.params) == set(model.network.state_dict())
  return model, converted


def _close_to_max(got, want, tol, name=''):
  got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape, name
  err = float(np.abs(got - want).max())
  scale = float(np.abs(want).max())
  assert err <= tol * scale, (name, err / scale, tol)
  return err / scale


def _routings(model):
  """Forward hooks that keep each MoE layer's router probabilities and
  routing, computed on the weights of the call (inside it)."""
  seen = []
  for module in model.network.modules():
    if module.__class__.__name__ == 'MoEMlp':
      module.register_forward_hook(
          lambda m, inputs, out: seen.append(m.routing(inputs[0].detach())))
  return seen


def test_moe_model_matches_jax():
  """Logits, the aux losses, the loss with its aux term and every
  gradient, at train_seq2act_moe.gin's bindings in float32."""
  kwargs = dict(SMALL, **MOE)
  features, labels = _batch(1)
  jax_model = jax_seq2act.Seq2ActBCModel(**kwargs)
  state = _jax_state(jax_model, features, labels)
  (loss, (_, outputs, _)), grads = jax.jit(jax.value_and_grad(
      functools.partial(jax_model.loss_fn, mode=JaxModeKeys.TRAIN, rng=None),
      has_aux=True))(state.params, state.model_state, SpecStruct(**features),
                     SpecStruct(**labels))

  model, converted = _port(kwargs, state)
  seen = _routings(model)
  params = {k: v.clone().requires_grad_()
            for k, v in converted.params.items()}
  got_loss, (_, got_outputs, _) = model.loss_fn(
      params, {}, _torch_tree(features), _torch_tree(labels), ModeKeys.TRAIN)
  got_grads = dict(zip(params, torch.autograd.grad(got_loss,
                                                   list(params.values()))))

  # No ties in any router: the top 3 probabilities at least 1e-6 apart.
  assert len(seen) == SMALL['num_layers']
  for probs, _ in seen:
    top = probs.detach().sort(-1, descending=True).values[..., :3]
    assert float(top.diff(dim=-1).max()) < -1e-6
  dropped = [float(routing.dropped_share()) for _, routing in seen]
  assert max(dropped) > 0.0, dropped   # capacity drops some pairs

  _close_to_max(got_outputs['action_logits'], outputs['action_logits'], 1e-4)
  np.testing.assert_allclose(float(got_outputs['moe_aux_loss']),
                             float(outputs['moe_aux_loss']), rtol=1e-6)
  assert float(outputs['moe_aux_loss']) > 1.0    # E * sum(f * p) >= 1
  np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
  want_grads = convert.from_flax({'params': grads})['params']
  assert set(want_grads) == set(got_grads)
  assert {'transformer.block0.moe.w_in', 'transformer.block1.moe.router.weight'
          } <= set(want_grads)
  largest = max(float(g.abs().max()) for g in want_grads.values())
  for name, want in want_grads.items():
    if name in ZERO_GRADIENTS:
      assert max(float(want.abs().max()), float(
          got_grads[name].abs().max())) <= 1e-6 * largest, name
      continue
    _close_to_max(got_grads[name], want.numpy(), 1e-4, name)


@pytest.mark.parametrize('moe_experts', [0, 8])
def test_bfloat16_model_matches_jax(moe_experts):
  """device_type='tpu' on both sides: bf16 activations, float32 params,
  layer norms, router, action head and loss."""
  kwargs = dict(SMALL, device_type='tpu',
                **(MOE if moe_experts else {}))
  features, labels = _batch(2)
  jax_model = jax_seq2act.Seq2ActBCModel(**kwargs)
  state = _jax_state(jax_model, features, labels, seed=3)
  loss, (_, outputs, _) = jax.jit(functools.partial(
      jax_model.loss_fn, mode=JaxModeKeys.TRAIN, rng=None))(
          state.params, state.model_state, SpecStruct(**features),
          SpecStruct(**labels))
  model, converted = _port(kwargs, state)
  assert model.compute_dtype == torch.bfloat16
  assert all(v.dtype == torch.float32 for v in converted.params.values())
  with torch.no_grad():
    got_loss, (_, got_outputs, _) = model.loss_fn(
        converted.params, {}, _torch_tree(features), _torch_tree(labels),
        ModeKeys.TRAIN)
  logits = got_outputs['action_logits']
  assert logits.dtype == torch.float32 and got_loss.dtype == torch.float32
  _close_to_max(logits, outputs['action_logits'], BF16_LOGITS_ATOL)
  np.testing.assert_allclose(float(got_loss), float(loss),
                             rtol=BF16_LOSS_RTOL)
  if moe_experts:
    np.testing.assert_allclose(float(got_outputs['moe_aux_loss']),
                               float(outputs['moe_aux_loss']),
                               rtol=BF16_AUX_RTOL)


class _Replay:
  """A dropout draw that hands out given masks in order."""

  def __init__(self, masks):
    self.masks = list(masks)

  def __call__(self, shape, rate, device):
    mask = self.masks.pop(0)
    assert tuple(mask.shape) == tuple(shape) and rate == 0.1
    return mask.to(device)


def test_dropout_apply_matches_jax_on_jaxs_masks():
  kwargs = dict(SMALL, dropout_rate=0.1)
  features, labels = _batch(4)
  jax_model = jax_seq2act.Seq2ActBCModel(**kwargs)
  state = _jax_state(jax_model, features, labels)
  network = jax_model.create_network()
  outputs, captured = network.apply(
      {'params': state.params}, SpecStruct(**features),
      mode=JaxModeKeys.TRAIN, train=True,
      rngs={'dropout': jax.random.PRNGKey(7)},
      capture_intermediates=lambda module, _: isinstance(module,
                                                         flax_nn.Dropout),
      mutable=['intermediates'])
  blocks = captured['intermediates']['transformer']
  masks = []
  for i in range(SMALL['num_layers']):
    for site in ('Dropout_0', 'Dropout_1'):     # after attention, after MLP
      y = np.asarray(blocks['block{}'.format(i)][site]['__call__'][0])
      masks.append(torch.from_numpy(y != 0))
  kept = float(np.mean([m.float().mean() for m in masks]))
  assert 0.85 < kept < 0.95

  model, converted = _port(kwargs, state)
  replay = _Replay(masks)
  got = torch.func.functional_call(
      model.network, converted.params, (_torch_tree(features),),
      {'mode': ModeKeys.TRAIN, 'dropout': replay})
  assert not replay.masks                      # every mask used
  _close_to_max(got['action_logits'], outputs['action_logits'], 1e-6)
  # The same weights without dropout give other logits.
  plain = torch.func.functional_call(
      model.network, converted.params, (_torch_tree(features),),
      {'mode': ModeKeys.EVAL})
  assert float((plain['action_logits'] - got['action_logits']).abs().max()
               ) > 1e-3


def test_dropout_draw_keeps_its_share_and_resumes_equal(tmp_path):
  rate, n = 0.1, 1 << 20
  draw = transformer.DropoutDraw(torch.Generator().manual_seed(0))
  kept = float(draw((n,), rate, 'cpu').float().mean())
  assert abs(kept - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)

  kwargs = dict(SMALL, dropout_rate=rate)
  data = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                      prefetch=0)

  def run(name, steps, **extra):
    return train_eval.train_eval_model(
        Seq2ActBCModel(device='cpu', **dict(kwargs, **extra)),
        str(tmp_path / name), data, max_train_steps=steps,
        save_checkpoints_steps=2, seed=3)

  result = run('whole', 4)
  whole, trainer = result['state'], result['trainer']
  run('resumed', 2)
  resumed = run('resumed', 4)['state']
  assert resumed.step == whole.step == 4
  for name, value in whole.params.items():
    assert torch.equal(resumed.params[name], value), name
  # The dropout stream is its own: not the crops', and another each step.
  seeds = {trainer.dropout_generator(k).initial_seed() for k in range(4)}
  seeds |= {trainer.crop_generator(k).initial_seed() for k in range(4)}
  assert len(seeds) == 8
  # Without dropout the run ends elsewhere.
  plain = run('plain', 4, dropout_rate=0.0)['state']
  assert any(not torch.equal(plain.params[k], v)
             for k, v in whole.params.items())
