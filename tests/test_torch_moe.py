"""The port's MoE MLP (``layers/moe.py``) against the JAX package's
``MoEMlp`` on its dense path (no mesh), on the CPU.

The same numpy-drawn inputs and weights (converted by ``convert.from_flax``,
the names unchanged) go through both. The router's weights are drawn at a
scale where no two of a token's top k + 1 probabilities tie (the test
asserts a gap of 1e-6 between them, some 10 float32 ulps of a
probability, where XLA and PyTorch differ by one or two):
``jax.lax.top_k`` and ``torch.topk`` break ties in other orders, which
would route a tied token elsewhere.

Tolerances, each with its reason:

  * float32 output within 1e-6 of its max and the aux loss within 1e-6
    relative: the same operations, the products and means summed in other
    orders (a few float32 ulps);
  * float32 gradients of x, the router's kernel and bias, ``w_in`` and
    ``w_out`` within 1e-5 of each one's max: the backward of the same
    products, summed over the tokens and slots in other orders;
  * the tokens dropped over capacity: the same (token, expert) pairs,
    exactly, and the output of a token with every choice dropped exactly 0
    on both sides;
  * bfloat16 output within 2e-2 of its max (MOE_BF16_ATOL): both compute
    the expert products in bf16 with float32 sums, XLA and PyTorch round
    their bf16 products and the gelu between them at other points, one
    bf16 ulp (2 ** -8 relative) a rounding; measured 6.2e-3 here. The
    router is float32 on both sides, so the routing and the aux loss
    (1e-6 relative) agree as in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import moe as jax_moe
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.layers import moe

D, H, E, B, L = 16, 32, 8, 2, 96
MOE_BF16_ATOL = 2e-2   # of max|out|


def _draw(seed, k, router_scale=1.0):
  """x [B, L, d] and flax params, each from numpy; the router's weights at
  ``router_scale`` so that the top k + 1 probabilities of every token are
  at least 1e-6 apart (no ties)."""
  rng = np.random.RandomState(seed)
  x = rng.randn(B, L, D).astype(np.float32)
  params = {
      'router': {'kernel': (router_scale * rng.randn(D, E) / np.sqrt(D))
                 .astype(np.float32),
                 'bias': (0.1 * rng.randn(E)).astype(np.float32)},
      'w_in': (rng.randn(E, D, H) / np.sqrt(D)).astype(np.float32),
      'w_out': (rng.randn(E, H, D) / np.sqrt(H)).astype(np.float32),
  }
  logits = x @ params['router']['kernel'] + params['router']['bias']
  probs = np.exp(logits - logits.max(-1, keepdims=True))
  probs /= probs.sum(-1, keepdims=True)
  top = -np.sort(-probs, -1)[..., :k + 1]
  assert np.diff(top, axis=-1).max() < -1e-6, 'a tie in the routing'
  return x, params


def _pair(k, factor, dtype=torch.float32):
  jax_layer = jax_moe.MoEMlp(num_experts=E, expert_dim=H, top_k=k,
                             capacity_factor=factor,
                             dtype=jnp.bfloat16 if dtype == torch.bfloat16
                             else jnp.float32)
  port = moe.MoEMlp(D, E, H, top_k=k, capacity_factor=factor, dtype=dtype)
  return jax_layer, port


def _load(port, params):
  state = convert.from_flax({'params': params})['params']
  assert set(state) == {'router.weight', 'router.bias', 'w_in', 'w_out'}
  port.load_state_dict(state, strict=True)
  return port


def _jax_kept(params, x, k, factor):
  """JAX's kept (token, expert) pairs [B, L, E] from its own dispatch."""
  logits = jnp.asarray(x) @ params['router']['kernel'] + params['router'][
      'bias']
  probs = jax.nn.softmax(logits, -1)
  _, idx = jax.lax.top_k(probs, k)
  slots = jax_moe._capacity(k, L, factor, E)
  dispatch, _ = jax_moe._dispatch_combine(probs, idx, E, k, slots)
  return np.asarray(dispatch.sum(-1)), slots


def _port_kept(routing):
  kept = torch.zeros(B, L, E)
  kept.scatter_add_(-1, routing.expert, routing.kept.float())
  return kept.numpy()


@pytest.mark.parametrize('k,tokens,factor,experts', [
    (2, 40, 1.25, 8), (1, 40, 1.25, 8), (2, 4096, 1.25, 8),
    (2, 4096 * 8, 1.25, 8), (1, 7, 0.5, 8), (2, 100, 0.3, 3),
    (2, 48, 4.0, 8)])
def test_capacity_is_jaxs(k, tokens, factor, experts):
  assert (moe.capacity(k, tokens, factor, experts) ==
          jax_moe._capacity(k, tokens, factor, experts))


@pytest.mark.parametrize('k', [1, 2])
@pytest.mark.parametrize('overflow', [False, True])
def test_moe_matches_jax_in_float32(k, overflow):
  """No drops at capacity_factor E / k (every expert has L slots); at 0.5
  (8 slots an expert for top 1, 16 for top 2: fewer than the pairs) the
  same pairs drop on both sides."""
  factor = 0.5 if overflow else E / k
  x, params = _draw(10 * k + overflow, k, router_scale=3.0)
  jax_layer, port = _pair(k, factor)
  want, want_aux = jax_layer.apply({'params': params}, jnp.asarray(x))
  port = _load(port, params)
  xt = torch.from_numpy(x).requires_grad_()
  got, got_aux = port(xt)
  scale = float(np.abs(want).max())
  assert got.dtype == torch.float32 and got_aux.dtype == torch.float32
  assert float((got.detach() - torch.from_numpy(np.asarray(want))).abs()
               .max()) <= 1e-6 * scale
  np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)

  jax_kept, slots = _jax_kept(params, x, k, factor)
  _, routing = port.routing(xt.detach())
  assert routing.capacity == slots
  np.testing.assert_array_equal(_port_kept(routing), jax_kept)
  dropped = float(routing.dropped_share())
  if overflow:
    assert 0.1 < dropped < 0.9, dropped
    silent = jax_kept.sum(-1) == 0                 # every choice dropped
    assert silent.any()
    assert (got.detach().numpy()[silent] == 0).all()
    assert (np.asarray(want)[silent] == 0).all()
  else:
    assert dropped == 0.0 and slots == L

  # Gradients of a loss through the output and the aux loss.
  rng = np.random.RandomState(3)
  cotangent = rng.randn(B, L, D).astype(np.float32)

  def jax_loss(p, xj):
    out, aux = jax_layer.apply({'params': p}, xj)
    return jnp.sum(out * cotangent) + 0.5 * aux

  want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
  loss = (got * torch.from_numpy(cotangent)).sum() + 0.5 * got_aux
  names = ['router.weight', 'router.bias', 'w_in', 'w_out']
  grads = torch.autograd.grad(loss, [xt] + [dict(port.named_parameters())[n]
                                            for n in names])
  want_grads = convert.from_flax({'params': want_p})['params']
  pairs = [(grads[0], np.asarray(want_x), 'x')] + [
      (g, want_grads[n].numpy(), n) for g, n in zip(grads[1:], names)]
  for got_g, want_g, name in pairs:
    err = float(np.abs(got_g.numpy() - want_g).max())
    assert err <= 1e-5 * float(np.abs(want_g).max()), (name, err)


def test_moe_matches_jax_in_bfloat16():
  """bf16 activations: the routing (float32 on the bf16 input) is the
  same, the output within MOE_BF16_ATOL of its max (see the docstring)."""
  x, params = _draw(7, 2, router_scale=3.0)
  x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
  jax_layer, port = _pair(2, 1.25, torch.bfloat16)
  want, want_aux = jax_layer.apply({'params': params},
                                   jnp.asarray(x, jnp.bfloat16))
  port = _load(port, params)
  with torch.no_grad():
    got, got_aux = port(torch.from_numpy(x).to(torch.bfloat16))
  assert got.dtype == torch.bfloat16 and got_aux.dtype == torch.float32
  want = np.asarray(want.astype(jnp.float32))
  err = float(np.abs(got.float().numpy() - want).max())
  assert err <= MOE_BF16_ATOL * float(np.abs(want).max()), err
  np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
  jax_kept, _ = _jax_kept(params, x, 2, 1.25)
  np.testing.assert_array_equal(
      _port_kept(port.routing(torch.from_numpy(x))[1]), jax_kept)


def test_expert_group_raises_and_ep_axis_alone_is_the_dense_path():
  with pytest.raises(NotImplementedError, match='next slice'):
    moe.MoEMlp(D, E, H, ep_axis='expert', expert_group=object())
  x, params = _draw(4, 2)
  dense = _load(moe.MoEMlp(D, E, H), params)
  named = _load(moe.MoEMlp(D, E, H, ep_axis='expert'), params)
  xt = torch.from_numpy(x)
  assert all(torch.equal(a, b) for a, b in zip(dense(xt), named(xt)))
