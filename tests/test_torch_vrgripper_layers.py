"""The port's mixture density, MAF, TEC and SNAIL layers and the vrgripper
action decoders against the JAX package's, on the CPU.

Each test draws its inputs and the port module's weights from a seed
with numpy, hands JAX's module the same weights as a flax tree (the port
keeps flax's names and ``convert.from_flax`` maps JAX's gradients back
onto them), and holds the port's outputs, and the gradients of a scalar of
them, to JAX's. The random draws of a sample (the mixture's component and normal,
the MAF's base normal) are JAX's, injected.

Tolerances. float32 on both sides: outputs within 1e-5 of each one's
magnitude, gradients within 1e-4 of each tensor's largest (sums in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_flax_tree import random_state, to_flax
from _torch_jax_qtopt import jax_qtopt_fixture
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.layers import maf
from tensor2robot_tpu_torch.layers import mdn
from tensor2robot_tpu_torch.layers import snail
from tensor2robot_tpu_torch.layers import tec
from tensor2robot_tpu_torch.research.vrgripper import decoders

RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope='module')
def ref():
  yield from jax_qtopt_fixture('layers.mdn', 'layers.maf', 'layers.tec',
                               'layers.snail', 'research.vrgripper.decoders')


def close(got, want, rtol=RTOL, what=''):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  assert float(np.abs(got - want).max()) <= rtol * scale + 1e-6, (
      what, float(np.abs(got - want).max()), scale)


def draw(seed, *shape):
  return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def carried(module, variables):
  """``module`` with JAX's ``variables`` converted into it."""
  state = convert.from_flax(jax.tree_util.tree_map(np.asarray,
                                                   variables))['params']
  module.load_state_dict(state, strict=True)
  return module


def compare(jax_module, module, args, scalar, method=None, kwargs=None,
            port_call=None):
  """JAX's and the port's outputs of ``args`` on the same random weights,
  and the gradients of ``scalar(outputs)`` with respect to every
  parameter."""
  kwargs = kwargs or {}
  state = random_state(module)
  module.load_state_dict(state, strict=True)

  def jax_value(params):
    out = jax_module.apply({'params': params}, *args, method=method,
                           **kwargs)
    return scalar(out, jnp), out

  (_, want), want_grads = jax.jit(jax.value_and_grad(
      jax_value, has_aux=True))(to_flax(state)['params'])
  torch_args = [torch.tensor(a) if isinstance(a, np.ndarray) else a
                for a in args]
  got = (port_call or module)(*torch_args)
  names = [n for n, _ in module.named_parameters()]
  grads = dict(zip(names, torch.autograd.grad(
      scalar(got, torch), list(module.parameters()), allow_unused=True)))
  want_grads = convert.from_flax(jax.tree_util.tree_map(
      np.asarray, {'params': want_grads}))['params']
  assert want_grads.keys() == grads.keys()
  for name, value in want_grads.items():
    assert grads[name] is not None, name
    close(grads[name], value.numpy(), GRAD_RTOL, name)
  return got, want


def test_mixture_functions_against_jax(ref):
  """Split, log density, mode and a sample (JAX's draws injected)."""
  params = draw(0, 2, 5, 3 + 2 * 3 * 4)
  params[0, 0, :3] = [1.0, 2.0, 2.0]   # a tie: argmax takes the first
  value = draw(1, 2, 5, 4)
  mean = draw(2, 4)
  got = mdn.get_mixture_distribution(torch.from_numpy(params), 3, 4,
                                     torch.from_numpy(mean))
  want = ref.mdn.get_mixture_distribution(jnp.asarray(params), 3, 4, mean)
  for g, w in zip(got, want):
    close(g, w)
  close(mdn.mixture_log_prob(got, torch.from_numpy(value)),
        ref.mdn.mixture_log_prob(want, value))
  close(mdn.gaussian_mixture_approximate_mode(got),
        ref.mdn.gaussian_mixture_approximate_mode(want))
  key = jax.random.PRNGKey(3)
  k_rng, n_rng = jax.random.split(key)
  component = np.asarray(jax.random.categorical(k_rng, want.alphas, axis=-1))
  noise = np.asarray(jax.random.normal(n_rng, (2, 5, 4)))
  close(mdn.mixture_sample(got, component=torch.tensor(component),
                           noise=torch.tensor(noise)),
        ref.mdn.mixture_sample(want, key))
  sample = mdn.mixture_sample(got, torch.Generator().manual_seed(0))
  assert sample.shape == (2, 5, 4) and bool(torch.isfinite(sample).all())
  close(mdn.mdn_loss(got, torch.from_numpy(value)),
        ref.mdn.mdn_loss(want, value))


@pytest.mark.parametrize('condition_sigmas', [False, True])
def test_mdn_decoder_against_jax(ref, condition_sigmas):
  inputs, target = draw(0, 2, 6, 5), draw(1, 2, 6, 3)
  got, want = compare(
      ref.mdn.MDNDecoder(num_mixture_components=4, output_size=3,
                         condition_sigmas=condition_sigmas),
      mdn.MDNDecoder(5, 4, 3, condition_sigmas), (inputs,),
      lambda out, xp: -(out[1].mus.sum() + out[1].sigmas.sum() +
                        out[1].alphas.sum() * 0.5 + out[0].sum()))
  close(got[0], want[0])
  close(mdn.mdn_loss(got[1], torch.from_numpy(target)),
        ref.mdn.mdn_loss(want[1], target))


def test_maf_distribution_against_jax(ref):
  """3 flows with their permutations: the sequential sample from JAX's
  base noise and the log density of a value, and their gradients."""
  params, value = draw(0, 4, 5), draw(1, 4, 3)
  key = jax.random.PRNGKey(7)
  jax_dist = ref.maf.MAFDistribution(output_size=3, num_flows=3,
                                     hidden_layers=(8, 8))
  dist = maf.MAFDistribution(5, 3, 3, (8, 8))
  noise = torch.tensor(np.asarray(jax.random.normal(key, (4, 3))))
  got, want = compare(
      jax_dist, dist, (params, value), lambda out, xp: (
          out[0] ** 2).sum() + out[1].sum(), kwargs={'rng': key},
      port_call=lambda p, v: dist(p, value=v, noise=noise))
  close(got[0], want[0])
  close(got[1], want[1])
  sample, log_prob = dist(torch.from_numpy(params))
  assert log_prob is None and sample.shape == (4, 3)


def test_maf_bijector_log_det_against_jax(ref):
  """The inverse and its log-det against JAX's, the forward inverting it,
  and the log-det against the numerical Jacobian's."""
  jax_bij = ref.maf.MAFBijector(event_size=3, num_flows=2,
                                hidden_layers=(8, 8))
  variables = jax_bij.init(jax.random.PRNGKey(1), np.zeros((1, 3),
                                                           np.float32),
                           method=jax_bij.forward)
  bij = carried(maf.MAFBijector(3, 2, (8, 8)), variables)
  y = draw(2, 5, 3)
  u, ildj = bij.inverse_and_log_det(torch.from_numpy(y))
  want_u, want_ildj = jax_bij.apply(variables, y,
                                    method=jax_bij.inverse_and_log_det)
  close(u, want_u)
  close(ildj, want_ildj)
  close(bij(u), y, 1e-4)
  jac = torch.autograd.functional.jacobian(
      lambda row: bij.inverse_and_log_det(row[None])[0][0],
      torch.from_numpy(y[0]))
  close(ildj[0], np.log(abs(np.linalg.det(jac.double().numpy()))), 1e-4)
  with pytest.raises(ValueError, match='at least as wide'):
    maf.MAFDistribution(3, 8, hidden_layers=(4,))


def test_tec_layers_against_jax(ref):
  """The temporal reduction (kernel-10 VALID conv, relu, layer norm, the
  MLP), the state MLP, the image embedding with an MLP head, and the
  contrastive losses."""
  temporal = draw(0, 3, 12, 5)
  got, want = compare(ref.tec.ReduceTemporalEmbeddings(output_size=8),
                      tec.ReduceTemporalEmbeddings(5, 12, 8), (temporal,),
                      lambda out, xp: (out ** 2).sum())
  close(got, want)
  got, want = compare(ref.tec.EmbedFullstate(embed_size=6),
                      tec.EmbedFullstate(5, 6), (temporal,),
                      lambda out, xp: (out ** 3).sum())
  close(got, want)
  images = np.random.RandomState(3).uniform(size=(2, 40, 40, 3)).astype(
      np.float32)
  got, want = compare(ref.tec.EmbedConditionImages(fc_layers=(10, 4)),
                      tec.EmbedConditionImages(fc_layers=(10, 4)), (images,),
                      lambda out, xp: (out ** 2).sum())
  close(got, want)
  inf, con = draw(4, 3, 2, 6), draw(5, 3, 1, 6)
  close(tec.compute_embedding_contrastive_loss(torch.from_numpy(inf),
                                               torch.from_numpy(con)),
        ref.tec.compute_embedding_contrastive_loss(inf, con))
  positives = np.array([True, False, True])
  close(tec.compute_embedding_contrastive_loss(
      torch.from_numpy(inf), torch.from_numpy(con),
      torch.from_numpy(positives)),
        ref.tec.compute_embedding_contrastive_loss(inf, con, positives))
  with pytest.raises(ValueError, match='shorter'):
    tec.ReduceTemporalEmbeddings(5, 9, 8)


def test_snail_blocks_against_jax(ref):
  """A TC block (4 dilated causal dense blocks over 12 steps) into an
  attention block; the causal mask, and step t independent of t' > t."""
  x = draw(0, 2, 12, 5)
  jax_tc, jax_attn = ref.snail.TCBlock(12, 4), ref.snail.AttentionBlock(6, 3)
  tc, attn = snail.TCBlock(5, 12, 4), snail.AttentionBlock(5 + 4 * 4, 6, 3)
  got, want = compare(jax_tc, tc, (x,), lambda out, xp: (out ** 2).sum())
  close(got, want)
  mid = np.asarray(want)
  got, want = compare(jax_attn, attn, (mid,),
                      lambda out, xp: (out[0] ** 2).sum())
  close(got[0], want[0])
  close(got[1]['attn_prob'], want[1]['attn_prob'])
  probs = got[1]['attn_prob'].detach().numpy()
  assert np.all(np.triu(probs[0], 1) == 0)
  np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)
  changed = x.copy()
  changed[:, 7:] += 1.0
  base, moved = tc(torch.from_numpy(x)), tc(torch.from_numpy(changed))
  assert torch.equal(base[:, :7], moved[:, :7])
  assert not torch.equal(base[:, 7:], moved[:, 7:])


@pytest.mark.parametrize('kind', ['mse', 'mdn', 'maf', 'discrete'])
def test_decoders_against_jax(ref, kind):
  """Each decoder's action and loss, and the loss's gradients."""
  inputs = draw(0, 2, 5, 6)
  labels = np.random.RandomState(1).uniform(-1, 1, (2, 5, 3)).astype(
      np.float32)
  jax_cls, cls, kwargs = {
      'mse': (ref.decoders.MSEDecoder, decoders.MSEDecoder, {}),
      'mdn': (ref.decoders.MDNActionDecoder, decoders.MDNActionDecoder,
              {'num_mixture_components': 4}),
      'maf': (ref.decoders.MAFDecoder, decoders.MAFDecoder,
              {'hidden_layers': (16, 16), 'num_flows': 2}),
      'discrete': (ref.decoders.DiscreteDecoder, decoders.DiscreteDecoder,
                   {'num_bins': 4, 'output_min': (-1.0,) * 3,
                    'output_max': (1.0,) * 3})}[kind]
  got, want = compare(jax_cls(output_size=3, **kwargs),
                      cls(6, output_size=3, **kwargs), (inputs, labels),
                      lambda out, xp: out['loss'])
  assert set(got) == set(want)
  for key in want:
    close(got[key], want[key], what=key)
