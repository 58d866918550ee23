"""The port's ResNet v2 (``layers/resnet.py``) against the JAX package's,
on the CPU, with JAX's weights carried across by ``convert.from_flax``.

Weights are flax's initializers from a seed; the batch norms' running
statistics are drawn from a numpy seed (flax starts them at 0 and 1, which
would hide a swapped mean and variance in EVAL).

Tolerances. Both sides sum in other orders (XLA against PyTorch's CPU
convolutions): outputs, endpoints and the updated running statistics
within 1e-5 of each one's largest magnitude (and 1e-6 absolute), in
float32 for the blocks; ResNet-50 is compared in float64 on both sides (see its test; the head float32 on
both, as flax's is, its output within 1e-4), its gradients within 1e-5
of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import resnet as jax_resnet
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.layers import basic
from tensor2robot_tpu_torch.layers import resnet

RTOL = 1e-5
GRAD_RTOL = 1e-5
# The float32 head's output in the float64 run: a sum of 2048 float32
# products that cancel to a tenth of their size.
HEAD_RTOL = 1e-4
BATCH = 2


def close(got, want, rtol=RTOL, what=''):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  scale = max(float(np.abs(want).max()), 1e-6)
  err = float(np.abs(got - want).max())
  assert err <= rtol * scale + 1e-6, (what, err, scale)


def random_stats(variables, seed):
  """The variables with the batch stats drawn: mean N(0, 0.5), var in
  [0.5, 1.5]."""
  rng = np.random.RandomState(seed)
  stats = jax.tree_util.tree_map_with_path(
      lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if
                       path[-1].key == 'var' else
                       rng.normal(0, 0.5, x.shape)).astype(np.float32),
      variables['batch_stats'])
  return {'params': variables['params'], 'batch_stats': stats}


def to_port(variables):
  return convert.from_flax(jax.tree_util.tree_map(np.asarray,
                                                  variables))['params']


def image(seed, shape):
  return np.random.RandomState(seed).uniform(0, 1, shape).astype(np.float32)


def flat_stats(tree):
  return {'.'.join(k.key for k in path): np.asarray(v) for path, v in
          jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_apply_film():
  rng = np.random.RandomState(0)
  x = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
  gb = rng.normal(size=(2, 12)).astype(np.float32)
  close(resnet.apply_film(torch.from_numpy(x), torch.from_numpy(gb)),
        jax_resnet.apply_film(jnp.asarray(x), jnp.asarray(gb)))
  assert resnet.apply_film(torch.from_numpy(x), None) is not None


@pytest.mark.parametrize('block', ['BottleneckBlock', 'ResidualBlock'])
@pytest.mark.parametrize('train', [False, True])
def test_block(block, train):
  """A projecting stride-2 block on an even map, with FiLM."""
  filters, in_features = 4, 8
  out = 4 * filters if block == 'BottleneckBlock' else filters
  x = image(1, (2, 10, 10, in_features)) - 0.5
  gb = image(2, (2, 2 * out)) - 0.5
  jax_block = getattr(jax_resnet, block)(filters=filters, strides=2,
                                         projection=True)
  variables = random_stats(dict(jax_block.init(
      jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(gb))), 3)
  if train:
    want, new_state = jax_block.apply(variables, jnp.asarray(x),
                                      jnp.asarray(gb), train=True,
                                      mutable=['batch_stats'])
  else:
    want = jax_block.apply(variables, jnp.asarray(x), jnp.asarray(gb))
  port = getattr(resnet, block)(in_features, filters, 2, projection=True)
  state = to_port(variables)
  got = torch.func.functional_call(
      port, state, (torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(gb)), {'train': train})
  close(got.permute(0, 2, 3, 1), want, what=block)
  if train:
    for name, value in flat_stats(new_state['batch_stats']).items():
      close(state[name], value, what=name)


def test_same_padding_stride2_even():
  """flax SAME at stride 2 on an even size pads (k // 2 - 1, k // 2): the
  7x7 stem (2, 3), a 3x3 conv and the 3x3 pool (0, 1). A symmetric
  (1, 1) pad, torch's ``padding=1``, gives another result."""
  assert basic.same_padding(472, 7, 2) == (2, 3)
  assert basic.same_padding(236, 3, 2) == (0, 1)
  assert basic.same_padding(8, 3, 2) == (0, 1)
  x = image(4, (1, 8, 8, 3))
  kernel = image(5, (3, 3, 3, 2)) - 0.5
  want = jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(kernel), (2, 2), 'SAME',
      dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
  conv = resnet.Conv(3, 2, 3, 2)
  weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
  nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
  got = torch.func.functional_call(conv, {'weight': weight}, (nchw,))
  close(got.permute(0, 2, 3, 1), want)
  symmetric = torch.nn.functional.conv2d(nchw, weight, None, 2, 1)
  assert float((symmetric - got).abs().max()) > 1e-3
  pool_want = jax.lax.reduce_window(
      jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
      'SAME')
  close(resnet._max_pool_same(nchw, 3, 2).permute(0, 2, 3, 1), pool_want)


def _resnet50_run(train, jax_dtype, torch_dtype):
  """(JAX's, the port's) output, endpoints, new statistics and gradients
  (parameters, FiLM parameters, image) of a random projection of the
  output, in the given dtypes."""
  x = image(6, (BATCH, 32, 32, 3))
  model = jax_resnet.ResNet(resnet_size=50, num_classes=5, dtype=jax_dtype)
  variables = random_stats(dict(jax.jit(model.init)(
      jax.random.PRNGKey(1), jnp.asarray(x))), 7)
  film = jax_resnet.LinearFilmGenerator(
      block_sizes=model.block_sizes, filter_sizes=model.filter_sizes,
      enabled_block_layers=[False, True, False, False])
  embedding = image(8, (BATCH, 4)) - 0.5
  film_vars = film.init(jax.random.PRNGKey(2), jnp.asarray(embedding))
  projection = image(9, (BATCH, 5)) - 0.5
  cast = lambda tree: jax.tree_util.tree_map(
      lambda a: jnp.asarray(a, jax_dtype), tree)
  variables, film_vars = cast(variables), cast(film_vars)

  def jax_loss(params, film_params, images):
    gbs = film.apply(film_params, jnp.asarray(embedding, jax_dtype))
    variables_in = {'params': params,
                    'batch_stats': variables['batch_stats']}
    if train:
      (out, endpoints), new = model.apply(
          variables_in, images, film_gamma_betas=gbs, train=True,
          mutable=['batch_stats'])
    else:
      out, endpoints = model.apply(variables_in, images,
                                   film_gamma_betas=gbs)
      new = None
    return jnp.sum(out * projection), (out, endpoints, new)

  (_, (want, want_endpoints, new)), want_grads = jax.jit(jax.value_and_grad(
      jax_loss, argnums=(0, 1, 2), has_aux=True))(
          variables['params'], film_vars, jnp.asarray(x, jax_dtype))

  port = resnet.ResNet(resnet_size=50, num_classes=5, dtype=torch_dtype)
  port_film = resnet.LinearFilmGenerator(
      4, port.block_sizes, port.filter_sizes, [False, True, False, False])
  as_port = lambda tree: {k: v.to(torch_dtype) for k, v in to_port(
      jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                             tree)).items()}
  state = as_port(variables)
  params = {k: v.requires_grad_() for k, v in state.items()
            if k in dict(port.named_parameters())}
  film_params = {k: v.requires_grad_() for k, v in as_port(
      {'params': film_vars['params']}).items()}
  images = torch.from_numpy(x).to(torch_dtype).requires_grad_()
  gbs = torch.func.functional_call(
      port_film, film_params, (torch.from_numpy(embedding).to(torch_dtype),))
  got, endpoints = torch.func.functional_call(
      port, state, (images,), {'film_gamma_betas': gbs, 'train': train})
  (got * torch.from_numpy(projection).to(torch_dtype)).sum().backward()
  got_grads = ({k: v.grad for k, v in params.items()},
               {k: v.grad for k, v in film_params.items()}, images.grad)
  return ((want, want_endpoints, new, want_grads),
          (got, endpoints, state, got_grads))


@pytest.mark.parametrize('train', [False, True])
def test_resnet50_forward_and_gradients(train):
  """ResNet-50 at 32x32, batch 2, with its head and FiLM on layer 2: the
  output, every endpoint, the new running statistics, and the gradients of
  every parameter, of the FiLM generator's and of the image.

  In float64 on both sides (the head float32 on both, as flax's is): in
  float32 a ReLU whose input is within rounding of 0 (one of this net's,
  in block_layer2_1) takes the other gate in the other summation order,
  which moves its layer's gradients by percents, and TRAIN's batch
  statistics over 2 images amplify the orders' roundings through 50
  layers. The blocks' test holds float32."""
  with jax.enable_x64(True):
    (want, want_endpoints, new, want_grads), (got, endpoints, state,
                                              got_grads) = _resnet50_run(
                                                  train, jnp.float64,
                                                  torch.float64)
    want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
    new = jax.tree_util.tree_map(np.asarray, new)
    want = np.asarray(want)
    want_endpoints = {k: np.asarray(v) for k, v in want_endpoints.items()}
  close(got, want, HEAD_RTOL)
  for key, value in want_endpoints.items():
    close(endpoints[key], value,
          HEAD_RTOL if key == 'final_dense' else RTOL, key)
  if train:
    for name, value in flat_stats(new['batch_stats']).items():
      close(state[name], value, what=name)
  grads, film_grads, image_grad = want_grads
  for name, value in convert.from_flax({'params': grads})['params'].items():
    close(got_grads[0][name], value.numpy(), GRAD_RTOL, name)
  for name, value in convert.from_flax(
      {'params': film_grads['params']})['params'].items():
    close(got_grads[1][name], value.numpy(), GRAD_RTOL, name)
  close(got_grads[2], image_grad, GRAD_RTOL, 'image')


def test_resnet_model_functional():
  """``resnet_model`` on a state dict (ResNet-18, float64 as ResNet-50's
  TRAIN test), TRAIN returning the new buffers and leaving the given ones
  as they were."""
  x = image(10, (2, 16, 16, 3)).astype(np.float64)
  with jax.enable_x64(True):
    model = jax_resnet.ResNet(resnet_size=18, num_classes=3,
                              dtype=jnp.float64)
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        random_stats(dict(model.init(jax.random.PRNGKey(3),
                                     jnp.asarray(x))), 11))
    want, _, new = jax.jit(lambda images, v: jax_resnet.resnet_model(
        images, v, train=True, num_classes=3, resnet_size=18,
        dtype=jnp.float64))(jnp.asarray(x), variables)
    want, new = np.asarray(want), jax.tree_util.tree_map(np.asarray, new)
  state = {k: v.double() for k, v in to_port(variables).items()}
  before = {k: v.clone() for k, v in state.items()}
  got, endpoints, new_buffers = resnet.resnet_model(
      torch.from_numpy(x), state, train=True, num_classes=3, resnet_size=18,
      dtype=torch.float64)
  close(got, want, HEAD_RTOL)
  assert set(endpoints) >= {'initial_conv', 'pre_final_pool', 'final_dense'}
  for name, value in flat_stats(new['batch_stats']).items():
    close(new_buffers[name], value, what=name)
    assert torch.equal(state[name], before[name])
