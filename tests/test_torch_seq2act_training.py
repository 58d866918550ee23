"""The port's Seq2Act training path against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and go through both packages;
weights and optimizer state are drawn by the JAX package and converted
(``convert.train_state_from_flax``). The JAX seq2act modules come through
``tests/test_torch_seq2act.py``'s import helper (jax 0.9's batching proxy
gets an ``in`` for the import only).

Tolerances, each with its reason:

  * K5's plain version against ``_flash_bwd_pallas`` in interpret mode,
    and the gradients of the port's ``flash_attention`` against
    ``jax.grad`` of the JAX one: within 2e-5 of each gradient's max in
    float32 (the same arithmetic, the products summed in another order)
    and 2e-2 of it in bfloat16 (one bf16 rounding of the result);
  * the plain forward and backward in float64 against
    ``torch.autograd.gradcheck``'s finite differences: its own defaults;
  * adam against optax over 5 updates: 1e-6 relative (the same float32
    operations; only ``b ** count`` may round otherwise);
  * the TRAIN crop + ``/ 255`` at JAX's offsets: exact (both multiply by
    the float32 reciprocal);
  * the discrete loss: 1e-6 relative (a log-softmax and a mean of float32
    rows in another order); the bins picked, and so the metrics, exact;
  * one train step of the small flash model: the loss within 1e-5
    relative and every gradient within 1e-4 of its largest magnitude (XLA
    and PyTorch sum their products in other orders, a few float32 ulps a
    layer, doubled by the backward), where a gradient that is 0 in exact
    arithmetic (``ZERO_GRADIENTS``) is noise held to 1e-6 of the largest
    gradient on both sides; the parameters after the step within
    2 * lr absolute, as adam's first update is lr * g / (|g| + eps), about
    lr * sign(g), and a gradient near 0 may take the other sign; each
    parameter's update (new minus old) over two steps within 1e-4 * lr of
    JAX's, beyond one float32 rounding of the new parameter, where the
    step's gradient is above 1e-2 of its tensor's largest
    (there the gradients agree to 1e-4 of their own size, and a zero,
    halved or sign-flipped update misses by some lr);
  * a run resumed from a checkpoint against one run of as many steps: the
    same weights, optimizer state and crop offsets, bit for bit (the same
    operations on the same batches and offsets).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.models import optimizers
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.parallel import flash_attention
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.research.vrgripper import decoders
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval

import test_torch_seq2act

jax_seq2act = test_torch_seq2act.jax_seq2act
jax_decoders = test_torch_seq2act.jax_decoders
jax_flash = test_torch_seq2act.jax_flash

GRAD_RTOL = {np.float32: 2e-5, 'bfloat16': 2e-2}

# A small flash model: 4 frames x 8 TokenLearner tokens (of a 3 x 4 stem
# map) = 32 tokens, width 32, two blocks of two heads.
SMALL_FLASH = dict(
    episode_length=4,
    action_size=3,
    vocab_size=16,
    img_res=(48, 64),
    src_img_res=(52, 70),
    tokens_per_frame=8,
    embed_dim=32,
    num_layers=2,
    num_heads=2,
    head_dim=16,
    mlp_dim=64,
    tokenizer_widths=(8, 8, 16, 16),
    attention_mode='flash',
)
LEARNING_RATE = 1e-3


def _rand(rng, shape):
  return rng.randn(*shape).astype(np.float32)


def _to_jax(x, dtype):
  return jnp.asarray(x, jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32)


def _to_torch(x, dtype):
  t = torch.from_numpy(np.array(x, np.float32))
  return t.to(torch.bfloat16) if dtype == 'bfloat16' else t


def _close_to_max(got, want, tol, name=''):
  got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
         else np.asarray(got, np.float32))
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape, name
  scale = float(np.abs(want).max())
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, (name, err, scale)


# -- K5: the flash backward --------------------------------------------------


@pytest.mark.parametrize('causal,dtype,bh,l_q,l_k,block', [
    (True, np.float32, 2, 128, 128, 32),     # a 4 x 4 grid: skip + carry
    (False, np.float32, 2, 128, 128, 32),
    (True, 'bfloat16', 2, 128, 128, 32),
    (False, 'bfloat16', 2, 128, 128, 64),
    (True, np.float32, 1, 200, 200, 40),      # L = 200
    (True, np.float32, 2, 64, 128, 32),       # Lq != Lk, global positions
    (False, np.float32, 2, 96, 64, 32),
])
def test_flash_bwd_plain_matches_pallas_interpret(causal, dtype, bh, l_q, l_k,
                                                  block):
  rng = np.random.RandomState(bh * l_q + l_k)
  d = 64
  q = _rand(rng, (bh, l_q, d))
  k, v = _rand(rng, (bh, l_k, d)), _rand(rng, (bh, l_k, d))
  d_out = _rand(rng, (bh, l_q, d))
  scale = 1.0 / float(np.sqrt(d))
  jq, jk, jv, jdo = (_to_jax(x, dtype) for x in (q, k, v, d_out))
  out, lse = jax_flash._flash_bhld(jq, jk, jv, scale=scale, causal=causal,
                                   block_q=block, block_k=block,
                                   interpret=True)
  want = jax_flash._flash_bwd_pallas(jq, jk, jv, out, lse, jdo, scale=scale,
                                     causal=causal, block_q=block,
                                     block_k=block, interpret=True)
  got = flash_attention.flash_attention_bwd_plain(
      *(_to_torch(x, dtype) for x in (q, k, v, out, lse, d_out)),
      causal=causal, scale=scale)
  for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
    assert g.dtype == (torch.bfloat16 if dtype == 'bfloat16'
                       else torch.float32), name
    _close_to_max(g, w, GRAD_RTOL[dtype], name)


@pytest.mark.parametrize('causal,dtype,b,l,h,blocks', [
    (True, np.float32, 2, 96, 2, dict(block_q=32, block_k=32)),
    (False, np.float32, 1, 64, 3, dict(block_q=64, block_k=32,
                                       block_q_bwd=16, block_k_bwd=32)),
    (True, 'bfloat16', 1, 128, 2, dict(block_q=64, block_k=64)),
])
def test_flash_attention_gradients_match_jax_grad(causal, dtype, b, l, h,
                                                  blocks):
  rng = np.random.RandomState(l + h)
  q, k, v = (_rand(rng, (b, l, h, 64)) for _ in range(3))

  def jax_loss(q, k, v):
    out = jax_flash.flash_attention(q, k, v, causal=causal, interpret=True,
                                    **blocks).astype(jnp.float32)
    return jnp.sum(out * (1 + 0.01 * out))

  want = jax.grad(jax_loss, argnums=(0, 1, 2))(
      *(_to_jax(x, dtype) for x in (q, k, v)))
  tensors = [_to_torch(x, dtype).requires_grad_() for x in (q, k, v)]
  out = flash_attention.flash_attention(*tensors, causal=causal,
                                        **blocks).float()
  (out * (1 + 0.01 * out)).sum().backward()
  for name, t, w in zip(('dq', 'dk', 'dv'), tensors, want):
    _close_to_max(t.grad, w, GRAD_RTOL[dtype], name)


def test_flash_backward_blocks_raise_as_in_jax():
  """The backward's blocks are checked on the forward's ladder."""
  q = torch.zeros(1, 64, 2, 64)
  flash_attention.flash_attention(q, q, q, block_q_bwd=16, block_k_bwd=64)
  with pytest.raises(ValueError, match='multiple of 8'):
    flash_attention.flash_attention(*(torch.zeros(1, 100, 2, 64),) * 3,
                                    block_q_bwd=16)
  assert flash_attention._bwd_default_blocks(4096, 64) == \
      jax_flash._bwd_default_blocks(4096, 64) == (256, 256)
  assert flash_attention._bwd_default_blocks(64, 8192) == \
      jax_flash._bwd_default_blocks(64, 8192) == (512, 1024)


@pytest.mark.parametrize('causal', [True, False])
def test_plain_flash_forward_and_backward_pass_gradcheck(causal):
  """Finite differences in float64: an oracle independent of both
  packages."""
  gen = torch.Generator().manual_seed(0)
  q, k, v = (torch.randn(1, 24, 2, 8, dtype=torch.float64, generator=gen,
                         requires_grad=True) for _ in range(3))
  assert torch.autograd.gradcheck(
      lambda q, k, v: flash_attention.flash_attention(q, k, v,
                                                      causal=causal),
      (q, k, v))


def test_flash_with_lse_differentiates_o_only_and_launches_nothing():
  rng = np.random.RandomState(1)
  q, k, v = (torch.from_numpy(_rand(rng, (2, 64, 16))).requires_grad_()
             for _ in range(3))
  kernels.reset_launches()
  out, lse = flash_attention.flash_attention_with_lse(q, k, v, causal=True)
  assert not lse.requires_grad and out.requires_grad
  out.sum().backward()
  dq, dk, dv = flash_attention.flash_attention_bwd_plain(
      q.detach(), k.detach(), v.detach(), out.detach(), lse,
      torch.ones_like(out), True, 0.25)
  for t, want in ((q, dq), (k, dk), (v, dv)):
    assert torch.equal(t.grad, want)
  assert not any(kernels.LAUNCHES.values())


# -- adam --------------------------------------------------------------------


def test_adam_matches_optax_over_five_updates():
  rng = np.random.RandomState(2)
  params = {'a': _rand(rng, (3, 4)), 'b': _rand(rng, (5,))}
  opt = optax.adam(1e-3, b1=0.8, b2=0.99, eps=1e-7)
  state, want = opt.init(params), dict(params)
  port = optimizers.create_adam_optimizer(1e-3, 0.8, 0.99, 1e-7)
  got = {k: torch.from_numpy(v) for k, v in params.items()}
  port_state = port.init(got)
  assert port_state['count'].dtype == torch.int32
  for _ in range(5):
    grads = {k: _rand(rng, v.shape) for k, v in params.items()}
    updates, state = opt.update(grads, state, want)
    want = optax.apply_updates(want, updates)
    got, port_state = port.update(
        {k: torch.from_numpy(g) for k, g in grads.items()}, port_state, got)
  adam_state = state[0]
  assert int(port_state['count']) == int(adam_state.count) == 5
  for key in params:
    for g, w in ((got[key], want[key]), (port_state['mu'][key],
                                         adam_state.mu[key]),
                 (port_state['nu'][key], adam_state.nu[key])):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                 atol=0)
  # The optimizer returns new tensors: the old state is left as it was.
  before = {k: v.clone() for k, v in got.items()}
  port.update({k: torch.ones_like(v) for k, v in got.items()}, port_state,
              got)
  assert all(torch.equal(before[k], got[k]) for k in got)


# -- the TRAIN crop ----------------------------------------------------------


def _jax_episode_offsets(key, batch, image_hw, target_hw):
  """The offsets JAX's TRAIN preprocessor draws: ``split(rng)[1]``, split
  into y and x keys, then ``randint`` (``_preprocess_fn`` and
  ``random_crop_episodes``)."""
  kcrop = jax.random.split(key)[1]
  ky, kx = jax.random.split(kcrop)
  (h, w), (th, tw) = image_hw, target_hw
  ys = jax.random.randint(ky, (batch,), 0, h - th + 1)
  xs = jax.random.randint(kx, (batch,), 0, w - tw + 1)
  return np.stack([np.asarray(ys), np.asarray(xs)], -1).astype(np.int32)


def test_train_crop_matches_jitted_jax_at_its_offsets():
  rng = np.random.RandomState(3)
  images = rng.randint(0, 256, (3, 4, 136, 168, 3)).astype(np.uint8)
  key = jax.random.PRNGKey(11)
  jax_model = jax_seq2act.Seq2ActBCModel(episode_length=4)
  want = np.asarray(jax.jit(
      lambda im, k: jax_model.preprocessor._preprocess_fn(
          SpecStruct(image=im), None, JaxModeKeys.TRAIN, k)[0]['image'])(
              jnp.asarray(images), key))
  offsets = _jax_episode_offsets(key, 3, (136, 168), (128, 160))
  assert len({tuple(o) for o in offsets}) > 1
  model = Seq2ActBCModel(episode_length=4, device='cpu')
  kernels.reset_launches()
  got, labels = model.preprocessor.preprocess(
      {'image': torch.from_numpy(images)}, None, ModeKeys.TRAIN,
      offsets=torch.from_numpy(offsets))
  assert labels is None and not any(kernels.LAUNCHES.values())
  assert got['image'].dtype == torch.float32
  np.testing.assert_array_equal(got['image'].numpy(), want)
  # One offset an episode: every frame is cut at its episode's offset.
  for b, (y, x) in enumerate(offsets):
    for t in range(4):
      np.testing.assert_array_equal(
          np.round(got['image'][b, t].numpy() * 255),
          images[b, t, y:y + 128, x:x + 160])

  # From a generator: in range, one offset an episode, the same for one
  # seed.
  episodes = torch.from_numpy(images)
  drawn = image_transformations.random_crop_episodes(
      episodes, (128, 160), generator=torch.Generator().manual_seed(0))
  again = image_transformations.random_crop_episodes(
      episodes, (128, 160), generator=torch.Generator().manual_seed(0))
  assert drawn.shape == (3, 4, 128, 160, 3) and torch.equal(drawn, again)
  with pytest.raises(ValueError, match='generator'):
    model.preprocessor.preprocess({'image': episodes}, None, ModeKeys.TRAIN)
  with pytest.raises(ValueError, match='generator'):
    image_transformations.random_crop_episodes(episodes, (128, 160))
  with pytest.raises(ValueError, match=r'\[B, 2\]'):
    image_transformations.random_crop_episodes(
        episodes, (128, 160), offsets=torch.zeros(2, 2, dtype=torch.int32))


# -- the loss and the metrics ------------------------------------------------


def test_discrete_action_loss_and_metrics_match_jax():
  rng = np.random.RandomState(4)
  kwargs = dict(SMALL_FLASH, action_size=3, vocab_size=16)
  model = Seq2ActBCModel(device='cpu', **kwargs)
  jax_model = jax_seq2act.Seq2ActBCModel(**kwargs)
  logits = _rand(rng, (2, 4, 3 * 16)) * 3
  actions = rng.uniform(-1, 1, (2, 4, 3)).astype(np.float32)
  actions[0, 0] = model._bin_centers[5]    # on the predicted bin: accurate
  logits[0, 0, 5::16] = 20.0
  actions[0, 1, 0] = -1.0                  # the range's edges
  actions[0, 1, 1] = 1.0
  want = jax_decoders.get_discrete_action_loss(
      jnp.asarray(logits), jnp.asarray(actions), model._bin_centers, 16)
  got = decoders.get_discrete_action_loss(
      torch.from_numpy(logits), torch.from_numpy(actions),
      model._bin_centers, 16)
  assert got.dtype == torch.float32 and got.dim() == 0
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

  outputs = {'action_logits': torch.from_numpy(logits)}
  labels = {'action': torch.from_numpy(actions)}
  loss, metrics = model.model_train_fn(None, None, labels, outputs,
                                       ModeKeys.TRAIN)
  want_loss, want_metrics = jax_model.model_train_fn(
      None, None, {'action': jnp.asarray(actions)},
      {'action_logits': jnp.asarray(logits)}, JaxModeKeys.TRAIN)
  assert set(metrics) == {'loss', 'action_accuracy', 'action_mae'}
  np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
  assert float(metrics['action_accuracy']) == float(
      want_metrics['action_accuracy'])
  assert float(metrics['action_accuracy']) > 0
  np.testing.assert_allclose(float(metrics['action_mae']),
                             float(want_metrics['action_mae']), rtol=1e-6)
  eval_metrics = model.model_eval_fn(None, None, labels, outputs,
                                     ModeKeys.EVAL)
  assert set(eval_metrics) == {'loss', 'action_accuracy', 'action_mae'}


# -- one train step against JAX's --------------------------------------------


def _small_batch(rng, batch, kwargs):
  t, (h, w) = kwargs['episode_length'], kwargs['img_res']
  features = {'image': rng.uniform(0, 1, (batch, t, h, w, 3)).astype(
      np.float32)}
  labels = {'action': rng.uniform(-1, 1, (batch, t, kwargs['action_size']))
            .astype(np.float32)}
  return features, labels


def _torch_tree(tree):
  return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# The TokenLearner's softmax runs over the tokens, so the map_out bias (one
# constant a map) cancels in it: its gradient is 0 in exact arithmetic and
# rounding noise on both sides, held to 1e-6 of the largest gradient.
ZERO_GRADIENTS = ('tokenizer.token_learner.map_out.bias',)


def test_train_step_matches_jax_train_step():
  """JAX runs jitted: its flax init and Pallas interpreter take some 40 s
  op by op and 10 s compiled."""
  rng = np.random.RandomState(5)
  features, labels = _small_batch(rng, 2, SMALL_FLASH)
  jax_model = jax_seq2act.Seq2ActBCModel(learning_rate=LEARNING_RATE,
                                         **SMALL_FLASH)
  state = jax.jit(jax_model.create_train_state)(
      jax.random.PRNGKey(0), SpecStruct(**features), SpecStruct(**labels))
  before = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, state))
  assert set(before.opt_state) == {'count', 'mu', 'nu'}
  model = Seq2ActBCModel(device='cpu', learning_rate=LEARNING_RATE,
                         **SMALL_FLASH)
  assert set(before.params) == set(model.network.state_dict())

  # The gradients, each against jax.grad's.
  (loss, _), grads = jax.jit(jax.value_and_grad(
      functools.partial(jax_model.loss_fn, mode=JaxModeKeys.TRAIN, rng=None),
      has_aux=True))(state.params, state.model_state, SpecStruct(**features),
                     SpecStruct(**labels))
  params = {k: v.clone().requires_grad_() for k, v in before.params.items()}
  got_loss, _ = model.loss_fn(params, {}, _torch_tree(features),
                              _torch_tree(labels), ModeKeys.TRAIN)
  got_grads = dict(zip(params, torch.autograd.grad(got_loss,
                                                   list(params.values()))))
  np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                             rtol=1e-5)
  want_grads = convert.from_flax({'params': grads})['params']
  assert set(want_grads) == set(got_grads)
  largest = max(float(g.abs().max()) for g in want_grads.values())
  for name, want in want_grads.items():
    if name in ZERO_GRADIENTS:
      assert max(float(want.abs().max()), float(
          got_grads[name].abs().max())) <= 1e-6 * largest, name
      continue
    _close_to_max(got_grads[name], want.numpy(), 1e-4, name)

  # The step: loss, metrics, adam's state and the new parameters.
  new_state, metrics = jax.jit(jax_model.train_step)(
      state, SpecStruct(**features), SpecStruct(**labels),
      jax.random.PRNGKey(1))
  want = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, new_state))
  kernels.reset_launches()
  got, got_metrics = model.train_step(before, _torch_tree(features),
                                      _torch_tree(labels))
  assert not any(kernels.LAUNCHES.values())
  assert got.step == want.step == 1 and int(got.opt_state['count']) == 1
  assert set(got_metrics) == {'loss', 'action_accuracy', 'action_mae'}
  np.testing.assert_allclose(float(got_metrics['loss']),
                             float(metrics['loss']), rtol=1e-5)
  for key in ('action_accuracy', 'action_mae'):
    np.testing.assert_allclose(float(got_metrics[key]), float(metrics[key]),
                               rtol=1e-6, err_msg=key)
  moved = 0.0
  for name, value in want.params.items():
    np.testing.assert_allclose(got.params[name].numpy(), value.numpy(),
                               rtol=0, atol=2 * LEARNING_RATE, err_msg=name)
    if name not in ZERO_GRADIENTS:
      _close_to_max(got.opt_state['mu'][name], want.opt_state['mu'][name],
                    1e-4, name)
    moved = max(moved, float((got.params[name] -
                              before.params[name]).abs().max()))
  assert moved > 0.5 * LEARNING_RATE   # the step moved the weights

  # Each step's update, parameter by parameter, against JAX's over two
  # steps (b1 and b2 show in the second).
  grads_2 = jax.jit(jax.grad(
      lambda p: jax_model.loss_fn(p, new_state.model_state,
                                  SpecStruct(**features),
                                  SpecStruct(**labels), JaxModeKeys.TRAIN,
                                  None)[0]))(new_state.params)
  new_state_2, _ = jax.jit(jax_model.train_step)(
      new_state, SpecStruct(**features), SpecStruct(**labels),
      jax.random.PRNGKey(2))
  want_2 = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, new_state_2))
  got_2, _ = model.train_step(got, _torch_tree(features),
                              _torch_tree(labels))
  check_updates([before.params, got.params, got_2.params],
                [before.params, want.params, want_2.params],
                [want_grads, convert.from_flax({'params': grads_2})['params']],
                LEARNING_RATE)


def check_updates(got, want, grads, lr):
  """Adam's update of every parameter (new minus old), step by step, within
  1e-4 * lr of JAX's where the step's gradient is far above adam's eps.

  ``got`` and ``want`` list the parameters before and after each step,
  ``grads`` JAX's gradients of each step. Each package rounds its new
  parameters to float32, so the two updates may also differ by one unit in
  the last place of the new parameter (1.2e-7 at 1.0, above 1e-4 of a
  1e-3 learning rate): that much is allowed beyond. There an update is lr
  times a
  function of the gradients alone (about lr * sign(g) on the first step),
  so a zero, halved or sign-flipped update shows at once, wherever the two
  packages' gradients agree to 1e-4 of their own size: entries below 1e-2
  of their tensor's largest gradient, where the 1e-4-of-max agreement
  of the gradients leaves their sign or size open, are left out.
  """
  worst, checked = 0.0, 0
  for step, g_step in enumerate(grads):
    for name, g in g_step.items():
      if name in ZERO_GRADIENTS:
        continue
      g = np.abs(np.asarray(g, np.float32))
      mask = g > max(UPDATE_GRAD_FLOOR * float(g.max()), 1e3 * ADAM_EPS)
      got_update = (got[step + 1][name] - got[step][name]).numpy()
      want_update = (want[step + 1][name] - want[step][name]).numpy()
      # Beyond 1e-4 * lr, one float32 rounding of the new parameter itself.
      err = np.abs(got_update - want_update)[mask] - np.spacing(
          np.abs(want[step + 1][name].numpy()))[mask]
      if err.size:
        worst = max(worst, float(err.max()) / lr)
        checked += err.size
      assert err.size == 0 or float(err.max()) <= UPDATE_RTOL * lr, (
          step, name, float(err.max()) / lr)
  assert checked > 0
  return worst, checked


ADAM_EPS = 1e-8
UPDATE_RTOL = 1e-4           # of the learning rate
UPDATE_GRAD_FLOOR = 1e-2     # of each tensor's largest gradient


# -- the trainer -------------------------------------------------------------


def _states_equal(a, b):
  def leaves(tree, prefix=''):
    if isinstance(tree, dict):
      for key, value in tree.items():
        yield from leaves(value, prefix + '/' + key)
    else:
      yield prefix, tree
  la, lb = dict(leaves(vars(a))), dict(leaves(vars(b)))
  assert la.keys() == lb.keys()
  for key, value in la.items():
    if isinstance(value, torch.Tensor):
      assert torch.equal(value, lb[key]), key
    else:
      assert value == lb[key], key


def test_trainer_trains_checkpoints_and_skips_nonfinite_losses(tmp_path):
  model = Seq2ActBCModel(device='cpu', **SMALL_FLASH)
  data = input_generators.DefaultRandomInputGenerator(batch_size=2)
  kernels.reset_launches()
  result = train_eval.train_eval_model(
      model, str(tmp_path / 'run'), data, max_train_steps=3,
      log_every_n_steps=1, save_checkpoints_steps=3)
  state, trainer = result['state'], result['trainer']
  assert state.step == 3 and int(state.opt_state['count']) == 3
  assert not any(kernels.LAUNCHES.values())   # the CPU takes plain versions
  assert set(trainer.last_metrics) == {'loss', 'action_accuracy',
                                       'action_mae', 'nonfinite_loss_skipped'}
  assert np.isfinite(trainer.last_metrics['loss'])
  for key in ('loss', 'action_accuracy', 'action_mae'):
    assert trainer.registry.gauge('train/' + key).value == \
        trainer.last_metrics[key]
  assert checkpointing.all_checkpoint_steps(str(tmp_path / 'run')) == [3]
  _states_equal(checkpointing.CheckpointManager(
      str(tmp_path / 'run')).restore(), state)
  # The TRAIN input is the uint8 source frame; the crop makes the model's.
  data.set_specification_from_model(model, ModeKeys.TRAIN)
  assert data.feature_spec['image'] == ((4, 52, 70, 3), np.uint8)

  # An injected NaN loss: the state stays, the step counter moves on.
  train_fn = model.model_train_fn

  def nan_loss(*args):
    loss, outputs = train_fn(*args)
    loss = loss * float('nan')
    return loss, dict(outputs, loss=loss)

  model.model_train_fn = nan_loss
  skipping = train_eval.Trainer(model, str(tmp_path / 'skip'),
                                log_every_n_steps=1)
  kept = skipping.train(data, 4, state=state)
  assert kept.step == 4 and skipping.last_metrics[
      'nonfinite_loss_skipped'] == 1
  kept.step = state.step
  _states_equal(kept, state)


def test_resumed_run_equals_uninterrupted_run(tmp_path, monkeypatch):
  """2 steps, a checkpoint, and a run that resumes from it for 2 more end
  where 4 steps in one run end, bit for bit, adam's state included: the
  episodes of step k are drawn from seed + k and their crops from
  (seed + 1, k)."""
  data = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                      prefetch=0)
  drawn = []
  draw = image_transformations.random_crop_offsets

  def recording(*args, **kwargs):
    offsets = draw(*args, **kwargs)
    drawn.append(offsets.clone())
    return offsets

  monkeypatch.setattr(image_transformations, 'random_crop_offsets',
                      recording)

  def run(name, steps):
    return train_eval.train_eval_model(
        Seq2ActBCModel(device='cpu', **SMALL_FLASH), str(tmp_path / name),
        data, max_train_steps=steps, save_checkpoints_steps=2,
        seed=3)['state']

  whole = run('whole', 4)
  whole_crops = list(drawn)
  del drawn[:]
  run('resumed', 2)
  resumed = run('resumed', 4)
  assert resumed.step == whole.step == 4
  assert int(resumed.opt_state['count']) == 4
  _states_equal(resumed, whole)
  assert len(drawn) == len(whole_crops) == 4
  for got, want in zip(drawn, whole_crops):
    assert torch.equal(got, want)
  assert not torch.equal(whole_crops[0], whole_crops[1])


def test_command_line_trains_seq2act_on_the_cpu(tmp_path, capsys):
  assert train_eval.main([
      '--model', 'seq2act', '--device', 'cpu', '--episode_length', '2',
      '--attention_mode', 'flash', '--max_train_steps', '1',
      '--batch_size', '1', '--model_dir', str(tmp_path),
      '--log_every_n_steps', '1']) == 0
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['model'] == 'seq2act' and line['step'] == 1
  assert line['checkpoint_step'] == 1 and np.isfinite(line['metrics']['loss'])
  assert set(line['metrics']) >= {'action_accuracy', 'action_mae'}
  restored = checkpointing.CheckpointManager(str(tmp_path)).restore()
  assert restored.avg_params is None   # the gin binds no averaging
  assert set(restored.opt_state) == {'count', 'mu', 'nu'}
  args = train_eval.make_parser().parse_args(['--model_dir', 'x'])
  assert args.model == 'qtopt' and args.device == 'cuda'


def test_dropout_in_training_raises_and_is_the_identity_otherwise():
  """Training with dropout needs the draw of its masks (a generator): it
  raises without one; outside training dropout is the identity."""
  block = transformer.TransformerBlock(32, 2, 16, 48, attention_mode='xla',
                                       dropout_rate=0.1)
  gen = torch.Generator().manual_seed(0)
  with torch.no_grad():
    for param in block.parameters():
      param.copy_(0.1 * torch.randn(param.shape, generator=gen))
  x = torch.randn(1, 8, 32, generator=gen)
  with pytest.raises(ValueError, match='generator'):
    block(x, train=True)
  plain = transformer.TransformerBlock(32, 2, 16, 48, attention_mode='xla')
  plain.load_state_dict(block.state_dict())
  same = block(x, train=False)[0]
  assert torch.isfinite(same).all()
  assert torch.equal(same, plain(x, train=False)[0])
  assert torch.equal(plain(x, train=True)[0], same)
  dropped = block(x, train=True, dropout=transformer.DropoutDraw(gen))[0]
  assert torch.isfinite(dropped).all() and not torch.equal(dropped, same)


def test_flash_dispatchers_raise_on_other_devices():
  x = torch.empty(1, 64, 2, 64, device='meta')
  lse = torch.empty(1, 2, 64, device='meta')
  with pytest.raises(ValueError, match='CUDA or CPU'):
    flash_attention.flash_attention_forward(x, x, x, True, 0.125)
  with pytest.raises(ValueError, match='CUDA or CPU'):
    flash_attention.flash_attention_backward(x, x, x, x, lse, x, True, 0.125)
