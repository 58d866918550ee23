"""The port's Seq2Act serving path against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed and go through both packages;
weights are drawn by one package and converted for the other
(``convert.from_flax`` one way, ``_to_flax`` below the other).

Tolerances. K4's plain version against the Pallas kernel in interpret mode
(``_flash_bhld``): O within 2e-6 in float32 (``tests/test_flash_attention
.py``'s own bound) and 2e-2 in bfloat16 (one bf16 rounding of values of
order 1, the sums being taken in another order), LSE within 1e-5 (a few
float32 ulps of values near log L). Modules and networks: both sides run
float32 and XLA and PyTorch sum their products in other orders, which
leaves a few ulps per layer: 1e-4 of the largest output magnitude. Served
actions are bin centers picked by an argmax, so they must be equal.
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.export import export_generators as jax_export
from tensor2robot_tpu.layers import transformer as jax_transformer
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.policies import policies as jax_policies
from tensor2robot_tpu.predictors.abstract_predictor import (
    AbstractPredictor as JaxAbstractPredictor,
)
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.layers import moe
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.meta_learning.meta_data import multi_batch_apply
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.observability import TelemetryRegistry
from tensor2robot_tpu_torch.observability import set_registry
from tensor2robot_tpu_torch.parallel import flash_attention
from tensor2robot_tpu_torch.policies import SequentialRegressionPolicy
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.research.vrgripper import decoders
from tensor2robot_tpu_torch.trainer import checkpointing

jax_flash = importlib.import_module('tensor2robot_tpu.parallel.flash_attention')

# The JAX modules that import research/qtopt/networks.py, whose import
# fails under jax 0.9 (ROADMAP queue 3): seq2act_model reaches it through
# meta_learning/__init__.py -> rl -> qtopt.
_QTOPT_DEPENDENT = ('tensor2robot_tpu.meta_learning', 'tensor2robot_tpu.rl',
                    'tensor2robot_tpu.research.qtopt',
                    'tensor2robot_tpu.research.seq2act',
                    'tensor2robot_tpu.research.vrgripper')


def _import_jax_seq2act():
  """The JAX package's seq2act model and decoders.

  For the import only, jax 0.9's batching proxy answers ``in`` from the
  table it fronts. Afterwards the proxy is as it was, and the modules whose
  import needed that leave ``sys.modules`` and their packages, so later
  imports elsewhere see the JAX package as before.
  """
  from jax._src.interpreters import batching

  proxy = batching.PrimitiveBatchersProxy
  shimmed = not hasattr(proxy, '__contains__')
  before = set(sys.modules)
  if shimmed:
    proxy.__contains__ = (
        lambda self, prim: prim in batching.fancy_primitive_batchers)
  try:
    seq2act = importlib.import_module(
        'tensor2robot_tpu.research.seq2act.seq2act_model')
    vrgripper = importlib.import_module(
        'tensor2robot_tpu.research.vrgripper.decoders')
  finally:
    if shimmed:
      del proxy.__contains__
      for name in sorted(set(sys.modules) - before, reverse=True):
        if name.startswith(_QTOPT_DEPENDENT):
          del sys.modules[name]
          parent, _, child = name.rpartition('.')
          if parent in sys.modules:
            vars(sys.modules[parent]).pop(child, None)
  return seq2act, vrgripper


jax_seq2act, jax_decoders = _import_jax_seq2act()

O_ATOL = {np.float32: 2e-6, 'bfloat16': 2e-2}
LSE_ATOL = 1e-5
RTOL_OF_MAX = 1e-4

# A small model whose flash attention runs over more than one block:
# 48 frames x (4 visual + task + state) tokens = 288 tokens, which the
# JAX kernel tiles as 9 q blocks of 32 in float32.
SMALL = dict(
    episode_length=48,
    action_size=3,
    vocab_size=16,
    img_res=(32, 32),
    src_img_res=(36, 40),
    tokens_per_frame=4,
    embed_dim=32,
    num_layers=2,
    num_heads=2,
    head_dim=16,
    mlp_dim=64,
    tokenizer_widths=(8, 16, 16, 32),
    num_task_embeddings=3,
    use_state_input=True,
    state_size=5,
)
# Full width, depth and frame size, two frames, dense attention.
FULL_SHORT = dict(episode_length=2, attention_mode='xla')
# The policy tests' model: 8 frames x 4 tokens.
POLICY = dict(SMALL, episode_length=8, num_task_embeddings=0,
              use_state_input=False, attention_mode='xla')


def _rand(rng, shape, dtype=np.float32):
  return rng.randn(*shape).astype(dtype)


def _to_jax(x, dtype):
  return jnp.asarray(x, jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32)


def _to_torch(x, dtype):
  t = torch.from_numpy(np.asarray(x, np.float32))
  return t.to(torch.bfloat16) if dtype == 'bfloat16' else t


def _close_to_max(got, want, tol=RTOL_OF_MAX):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape
  scale = float(np.abs(want).max())
  err = float(np.abs(got - want).max())
  assert err <= tol * scale, (err, scale)


def _to_flax(state):
  """The inverse of ``convert.from_flax`` for a params state dict."""
  tree = {}
  for name, value in state.items():
    *path, leaf = name.split('.')
    value = value.detach().float().cpu().numpy()
    if leaf == 'weight':
      value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
      leaf = 'kernel'
    node = tree
    for key in path:
      node = node.setdefault(key, {})
    node[leaf] = jnp.asarray(np.ascontiguousarray(value))
  return tree


def _load(module, flax_params):
  """``module`` (CPU, eval) carrying the converted flax params, strictly."""
  state = convert.from_flax({'params': flax_params})['params']
  assert set(state) == set(module.state_dict()), (
      sorted(set(state) ^ set(module.state_dict())))
  module.load_state_dict(state, strict=True)
  return module.eval()


# -- K4: the flash forward ---------------------------------------------------


@pytest.mark.parametrize('causal,dtype,bh,l,d,block_q,block_k,scale', [
    (False, np.float32, 4, 256, 64, 64, 64, None),
    (True, np.float32, 4, 256, 64, 64, 64, None),
    (True, np.float32, 2, 256, 128, 128, 32, None),      # uneven blocks
    (False, np.float32, 2, 128, 64, 64, 64, 0.25),       # custom scale
    (True, 'bfloat16', 4, 256, 64, 64, 64, None),
    (False, 'bfloat16', 2, 128, 128, 64, 64, None),
    (True, np.float32, 2, 200, 64, 8, 8, None),           # L = 200
])
def test_flash_plain_matches_pallas_interpret(causal, dtype, bh, l, d,
                                              block_q, block_k, scale):
  rng = np.random.RandomState(bh * l + d)
  q, k, v = (_rand(rng, (bh, l, d)) for _ in range(3))
  jscale = scale if scale is not None else 1.0 / float(np.sqrt(d))
  want_o, want_lse = jax_flash._flash_bhld(
      *(_to_jax(x, dtype) for x in (q, k, v)), scale=jscale, causal=causal,
      block_q=block_q, block_k=block_k, interpret=True)
  got_o, got_lse = flash_attention.flash_attention_with_lse(
      *(_to_torch(x, dtype) for x in (q, k, v)), causal=causal, scale=scale,
      block_q=block_q, block_k=block_k)
  assert got_o.dtype == (torch.bfloat16 if dtype == 'bfloat16'
                         else torch.float32)
  assert got_lse.dtype == torch.float32 and got_lse.shape == (bh, l)
  np.testing.assert_allclose(got_o.float().numpy(),
                             np.asarray(want_o, np.float32),
                             atol=O_ATOL[dtype], rtol=0)
  np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                             atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_blhd_matches_jax(causal):
  rng = np.random.RandomState(7)
  q, k, v = (_rand(rng, (2, 200, 2, 64)) for _ in range(3))
  want = jax_flash.flash_attention(q, k, v, causal=causal, block_q=128,
                                   block_k=128)
  got = flash_attention.flash_attention(
      *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, block_q=128,
      block_k=128)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                             rtol=0)


def test_flash_misaligned_length_raises_as_in_jax():
  q, k, v = (torch.zeros(1, 100, 2, 64) for _ in range(3))
  with pytest.raises(ValueError, match='multiple of 8'):
    flash_attention.flash_attention(q, k, v)
  with pytest.raises(ValueError, match='multiple of 8'):
    jax_flash.flash_attention(*(np.zeros((1, 100, 2, 64), np.float32),) * 3)
  with pytest.raises(ValueError, match='multiple of 8'):
    flash_attention.flash_attention_with_lse(q[:, :, 0], k[:, :, 0],
                                             v[:, :, 0])


def test_flash_plain_matches_dense_oracle_and_masks_causally():
  rng = np.random.RandomState(3)
  q, k, v = (torch.from_numpy(_rand(rng, (1, 64, 2, 64))) for _ in range(3))
  dense = transformer.scaled_dot_attention(q, k, v, causal=True)
  flash = flash_attention.flash_attention(q, k, v, causal=True)
  np.testing.assert_allclose(flash.numpy(), dense.numpy(), atol=2e-6)
  v2 = v.clone()
  v2[:, 40:] += 1.0   # later keys must not reach earlier queries
  moved = flash_attention.flash_attention(q, k, v2, causal=True)
  assert torch.equal(moved[:, :40], flash[:, :40])


# -- the layer library -------------------------------------------------------


def _module_pair(jax_module, port_module, x, **apply_kwargs):
  variables = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              **apply_kwargs)
  want = jax_module.apply(variables, jnp.asarray(x), **apply_kwargs)
  return _load(port_module, variables['params']), want


def test_token_learner_matches_flax():
  x = _rand(np.random.RandomState(0), (3, 20, 16))
  port, want = _module_pair(jax_transformer.TokenLearner(num_tokens=4),
                            transformer.TokenLearner(16, 4), x)
  _close_to_max(port(torch.from_numpy(x)).detach(), want)


def test_image_tokenizer_matches_flax():
  """TF SAME pads (0 low, 1 high), NHWC flattening, TokenLearner."""
  x = np.random.RandomState(1).rand(2, 32, 48, 3).astype(np.float32)
  port, want = _module_pair(
      jax_transformer.ImageTokenizer(num_tokens=4, embed_dim=24,
                                     widths=(8, 8, 16, 16)),
      transformer.ImageTokenizer((32, 48), 4, 24, (8, 8, 16, 16)), x)
  _close_to_max(port(torch.from_numpy(x)).detach(), want)
  # As many tokens as the stem makes: TokenLearner is skipped.
  port, want = _module_pair(
      jax_transformer.ImageTokenizer(num_tokens=6, embed_dim=24,
                                     widths=(8, 8, 16, 16)),
      transformer.ImageTokenizer((32, 48), 6, 24, (8, 8, 16, 16)), x)
  _close_to_max(port(torch.from_numpy(x)).detach(), want)
  assert port.token_learner is None
  with pytest.raises(ValueError, match='exceeds'):
    transformer.ImageTokenizer((32, 48), 7, 24, (8, 8, 16, 16))
  with pytest.raises(ValueError, match='built for'):
    port(torch.zeros(1, 32, 32, 3))


@pytest.mark.parametrize('mode', ['xla', 'flash'])
def test_multi_head_attention_matches_flax(mode):
  """Head-major qkv columns; 'flash' runs Pallas in interpret mode on the
  JAX side and K4's plain version on the port's."""
  x = _rand(np.random.RandomState(2), (2, 64, 32))
  port, want = _module_pair(
      jax_transformer.MultiHeadAttention(num_heads=2, head_dim=16,
                                         attention_mode=mode),
      transformer.MultiHeadAttention(32, 2, 16, attention_mode=mode), x)
  _close_to_max(port(torch.from_numpy(x)).detach(), want)


def test_transformer_block_and_stack_match_flax():
  x = _rand(np.random.RandomState(3), (2, 24, 32))
  port, want = _module_pair(
      jax_transformer.TransformerBlock(num_heads=2, head_dim=16, mlp_dim=48,
                                       attention_mode='xla'),
      transformer.TransformerBlock(32, 2, 16, 48, attention_mode='xla'), x)
  got, aux = port(torch.from_numpy(x))
  _close_to_max(got.detach(), want[0])
  assert float(aux) == float(want[1]) == 0.0    # no MoE: no aux loss
  port, want = _module_pair(
      jax_transformer.CausalTransformer(num_layers=2, num_heads=2,
                                        head_dim=16, mlp_dim=48,
                                        max_length=40, attention_mode='xla'),
      transformer.CausalTransformer(32, 2, 2, 16, 48, max_length=40,
                                    attention_mode='xla'), x)
  got, aux = port(torch.from_numpy(x))
  _close_to_max(got.detach(), want[0])
  assert float(aux) == float(want[1]) == 0.0
  with pytest.raises(ValueError, match='max_length'):
    port(torch.zeros(1, 41, 32))


def test_layer_norm_is_flax_layer_norm():
  """float32 out of bf16 in, epsilon 1e-6, E[x^2] - E[x]^2."""
  import flax.linen as nn
  x = _rand(np.random.RandomState(4), (4, 8, 32)) * 3 + 1
  port, want = _module_pair(nn.LayerNorm(dtype=jnp.float32),
                            transformer.LayerNorm(32), x)
  got = port(torch.from_numpy(x).to(torch.bfloat16))
  assert got.dtype == torch.float32
  want_bf16 = nn.LayerNorm(dtype=jnp.float32).apply(
      {'params': {'scale': jnp.ones(32), 'bias': jnp.zeros(32)}},
      jnp.asarray(x, jnp.bfloat16))
  _close_to_max(got.detach(), want_bf16)
  _close_to_max(port(torch.from_numpy(x)).detach(), want)


def test_attention_modes_resolve_as_in_jax():
  resolve = transformer.resolve_attention_mode
  cuda, cpu = torch.device('cuda'), torch.device('cpu')
  assert resolve('flash', 64, cpu) == 'flash'
  assert resolve('xla', 4096, cuda) == 'xla'
  assert resolve('auto', 4096, cuda) == 'flash'
  assert resolve('auto', 4096, cpu) == 'xla'
  assert resolve('auto', 1024, cuda) == 'xla'       # short
  assert resolve('auto', 4096 + 64, cuda) == 'xla'  # not 128-aligned
  assert jax_transformer.resolve_attention_mode('auto', 4096) == 'xla'
  q = torch.zeros(1, 16, 2, 8)
  with pytest.raises(ValueError, match='process group'):
    transformer.run_attention(q, q, q, mode='ring', causal=True)
  with pytest.raises(ValueError, match='Unknown'):
    transformer.run_attention(q, q, q, mode='sparse', causal=True)


def test_unported_variants_raise():
  with pytest.raises(NotImplementedError, match='tp_axis'):
    transformer.MultiHeadAttention(32, 2, 16, tp_axis='model')
  with pytest.raises(NotImplementedError, match='next slice'):
    moe.MoEMlp(32, 4, 48, ep_axis='expert', expert_group=object())
  with pytest.raises(NotImplementedError, match='MoE under ring'):
    Seq2ActBCModel(device='cpu', process_group=object(), moe_experts=4,
                   **dict(POLICY, attention_mode='ring'))
  with pytest.raises(NotImplementedError, match='pipe_axis'):
    transformer.CausalTransformer(32, 2, 2, 16, 48, 40, pipe_axis='pipe')
  model = Seq2ActBCModel(device='cpu', **POLICY)
  with pytest.raises(ValueError, match='generator'):
    model.preprocessor.preprocess(
        {'image': torch.zeros(1, 8, 36, 40, 3, dtype=torch.uint8)}, None,
        ModeKeys.TRAIN)
  with pytest.raises(ValueError, match='process_group'):
    Seq2ActBCModel(device='cpu', attention_mode='ring')


def test_multi_batch_apply_merges_and_splits():
  x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
  seen = []

  def fn(a, scale):
    seen.append(tuple(a.shape))
    return {'y': a * scale, 'pair': (a.sum(-1), a[:, :2])}

  out = multi_batch_apply(fn, 2, x, scale=2.0)
  assert seen == [(6, 4)]
  assert torch.equal(out['y'], x * 2)
  assert torch.equal(out['pair'][0], x.sum(-1))
  assert out['pair'][1].shape == (2, 3, 2)
  with pytest.raises(ValueError, match='tensor'):
    multi_batch_apply(fn, 2, 1.0, scale=1.0)


def test_discrete_actions_match_jax():
  rng = np.random.RandomState(5)
  bins = decoders.get_discrete_bins(16, [-1.0, 0.0, -2.0], [1.0, 0.5, 2.0])
  np.testing.assert_array_equal(
      bins, jax_decoders.get_discrete_bins(16, [-1.0, 0.0, -2.0],
                                           [1.0, 0.5, 2.0]))
  logits = _rand(rng, (2, 5, 3 * 16))
  logits[0, 0, :16] = 0.0     # ties: the first maximal bin
  got = decoders.get_discrete_actions(torch.from_numpy(logits), 3, 16, bins)
  want = jax_decoders.get_discrete_actions(jnp.asarray(logits), 3, 16, bins)
  assert got.shape == (2, 5, 3)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the model ---------------------------------------------------------------


def _episodes(rng, batch, model_kwargs):
  t = model_kwargs['episode_length']
  h, w = model_kwargs.get('src_img_res', (136, 168))
  features = {'image': rng.randint(0, 256, (batch, t, h, w, 3),
                                   dtype=np.uint8)}
  if model_kwargs.get('use_state_input'):
    features['state'] = _rand(rng, (batch, t, model_kwargs['state_size']))
  if model_kwargs.get('num_task_embeddings'):
    features['task_id'] = rng.randint(
        0, model_kwargs['num_task_embeddings'], (batch, 1)).astype(np.int32)
  return features


def _jax_variables(jax_model, features):
  """flax default-initialized variables of the JAX model's network."""
  net = jax_model.create_network()
  pre, _ = jax_model.preprocessor.preprocess(
      SpecStruct(**features), None, JaxModeKeys.PREDICT, rng=None)
  return net.init(jax.random.PRNGKey(0), pre, mode=JaxModeKeys.PREDICT)


def _predict_both(model_kwargs, batch=2, seed=0):
  rng = np.random.RandomState(seed)
  features = _episodes(rng, batch, model_kwargs)
  jax_model = jax_seq2act.Seq2ActBCModel(**model_kwargs)
  variables = _jax_variables(jax_model, features)
  want = jax_export.make_serve_fn(jax_model)(
      {'params': variables['params']}, dict(features))
  model = Seq2ActBCModel(device='cpu', **model_kwargs)
  port_variables = convert.from_flax({'params': variables['params']})
  assert set(port_variables['params']) == set(model.network.state_dict())
  from tensor2robot_tpu_torch.export import export_generators
  got = export_generators.make_serve_fn(model)(port_variables, features)
  return got, want


@pytest.mark.parametrize('kwargs', [
    dict(SMALL, attention_mode='flash'),
    FULL_SHORT,
], ids=['small_flash', 'full_width_short_episode'])
def test_predict_step_matches_flax_model(kwargs):
  got, want = _predict_both(kwargs)
  assert set(got) == {'action', 'inference_output', 'action_logits'}
  _close_to_max(got['action_logits'], want['action_logits'])
  np.testing.assert_array_equal(got['action'].numpy(),
                                np.asarray(want['action']))
  np.testing.assert_array_equal(got['inference_output'].numpy(),
                                np.asarray(want['inference_output']))
  a = kwargs.get('action_size', 7)
  assert got['action'].shape == (2, kwargs['episode_length'], a)
  assert got['action_logits'].dtype == torch.float32


def test_preprocessor_matches_jitted_jax_bit_for_bit():
  """K1's multiply by the float32 reciprocal of 255 is what XLA compiles
  the JAX preprocessor's ``/ 255.0`` into under jit."""
  rng = np.random.RandomState(6)
  features = _episodes(rng, 2, dict(FULL_SHORT, episode_length=3))
  jax_model = jax_seq2act.Seq2ActBCModel(episode_length=3)
  want = jax.jit(lambda f: jax_model.preprocessor.preprocess(
      SpecStruct(**f), None, JaxModeKeys.PREDICT, rng=None)[0]['image'])(
          features)
  model = Seq2ActBCModel(episode_length=3, device='cpu')
  got, _ = model.preprocessor.preprocess(
      {'image': torch.from_numpy(features['image'])}, None, ModeKeys.PREDICT)
  assert got['image'].dtype == torch.float32
  assert got['image'].shape == (2, 3, 128, 160, 3)
  np.testing.assert_array_equal(got['image'].numpy(), np.asarray(want))
  # One unbatched episode keeps its shape.
  single, _ = model.preprocessor.preprocess(
      {'image': torch.from_numpy(features['image'][0])}, None,
      ModeKeys.PREDICT)
  assert torch.equal(single['image'], got['image'][0])
  spec = model.preprocessor.get_in_feature_specification(ModeKeys.PREDICT)
  assert spec['image'] == ((3, 136, 168, 3), np.uint8)


def test_specs_and_defaults_follow_jax():
  model = Seq2ActBCModel(**SMALL)
  jax_model = jax_seq2act.Seq2ActBCModel(**SMALL)
  for mode in ModeKeys.ALL:
    jax_spec = jax_model.get_feature_specification(mode)
    assert set(model.get_feature_specification(mode)) == set(jax_spec)
    for key, (shape, dtype) in model.get_feature_specification(mode).items():
      assert shape == tuple(jax_spec[key].shape)
      assert np.dtype(dtype) == np.dtype(jax_spec[key].dtype)
    assert model.get_label_specification(mode)['action'][0] == tuple(
        jax_model.get_label_specification(mode)['action'].shape)
  assert model.device == torch.device('cuda')
  assert model.compute_dtype == torch.float32
  assert Seq2ActBCModel(device_type='tpu').compute_dtype == torch.bfloat16
  net = Seq2ActBCModel(device='cpu').create_network()
  assert net.transformer.max_length == 6 * 8
  assert net.transformer.block0.attn.num_heads == 8


def test_pack_features_rolls_the_window_and_validates_task_ids():
  kwargs = dict(SMALL, episode_length=4)
  model = Seq2ActBCModel(device='cpu', **kwargs)
  jax_model = jax_seq2act.Seq2ActBCModel(**kwargs)
  context = jax_context = None
  for step in range(6):
    state = {'image': np.full((36, 40, 3), step * 30, np.uint8),
             'task_id': 2}
    context = model.pack_features(state, context, step)
    jax_context = jax_model.pack_features(state, jax_context, step)
    assert context.keys() == jax_context.keys()
    for key in context:
      np.testing.assert_array_equal(context[key], jax_context[key])
  assert context['image'].shape == (1, 4, 36, 40, 3)
  assert [int(f[0, 0, 0]) for f in context['image'][0]] == [60, 90, 120, 150]
  assert context['task_id'].tolist() == [[2]]
  frame = np.zeros((36, 40, 3), np.uint8)
  with pytest.raises(ValueError, match='task_id'):
    model.pack_features({'image': frame}, None, 0)
  with pytest.raises(ValueError, match='out of range'):
    model.pack_features({'image': frame, 'task_id': 3}, None, 0)


# -- predictor and policy ----------------------------------------------------


class _JaxFixedPredictor(JaxAbstractPredictor):
  """The JAX package's serving function on given variables."""

  def __init__(self, model, variables):
    self._serve = jax.jit(jax_export.make_serve_fn(model))
    self._variables = variables

  def predict(self, features):
    return {k: np.asarray(v) for k, v in
            self._serve(self._variables, dict(features)).items()}

  def get_feature_specification(self):
    return None

  def restore(self):
    return True

  def close(self):
    pass


def _frames(steps, seed=8):
  rng = np.random.RandomState(seed)
  return [rng.randint(0, 256, (36, 40, 3), dtype=np.uint8)
          for _ in range(steps)]


def _policy_actions(policy, frames):
  policy.reset()
  return [np.asarray(policy.SelectAction({'image': f}, None, step))
          for step, f in enumerate(frames)]


def _jax_policy_actions(variables, frames):
  jax_model = jax_seq2act.Seq2ActBCModel(**POLICY)
  policy = jax_policies.SequentialRegressionPolicy(
      t2r_model=jax_model, predictor=_JaxFixedPredictor(
          jax_model, {'params': _to_flax(variables['params'])}))
  return _policy_actions(policy, frames)


@pytest.fixture
def registry():
  fresh = TelemetryRegistry()
  previous = set_registry(fresh)
  yield fresh
  set_registry(previous)


def test_policy_init_randomly_matches_jax_policy(registry):
  model = Seq2ActBCModel(device='cpu', **POLICY)
  predictor = CheckpointPredictor(model)
  policy = SequentialRegressionPolicy(model, predictor=predictor)
  policy.init_randomly()
  assert predictor.is_loaded and predictor.model_version == 0
  frames = _frames(5)
  got = _policy_actions(policy, frames)
  want = _jax_policy_actions(predictor.variables, frames)
  for g, w in zip(got, want):
    assert g.shape == (3,) and np.all(np.abs(g) <= 1.0)
    np.testing.assert_array_equal(g, w)
  # Not every step the same action: the window moves the output.
  assert len({tuple(a) for a in got}) > 1
  scalars = registry.scalars()
  assert scalars['policy/select_action_ms/SequentialRegressionPolicy/count'
                 ] == 5
  assert scalars['inference/latency_ms/CheckpointPredictor/count'] == 5


def test_policy_restores_port_checkpoints_and_swaps_versions(tmp_path,
                                                             registry):
  model = Seq2ActBCModel(device='cpu', **POLICY)
  manager = checkpointing.CheckpointManager(str(tmp_path))
  first = model.init_variables(torch.Generator().manual_seed(1))['params']
  manager.save(TrainState(step=3, params=first, model_state={},
                          opt_state=None))
  predictor = CheckpointPredictor(model, str(tmp_path), timeout=5.0)
  policy = SequentialRegressionPolicy(model, predictor=predictor)
  assert policy.restore() and predictor.model_version == 3
  frames = _frames(4, seed=9)
  got = _policy_actions(policy, frames)
  want = _jax_policy_actions({'params': first}, frames)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)

  # A newer checkpoint is picked up; the served outputs and their version
  # come from one snapshot.
  second = model.init_variables(torch.Generator().manual_seed(2))['params']
  manager.save(TrainState(step=7, params=second, model_state={},
                          opt_state=None))
  window = model.pack_features({'image': frames[0]}, None, 0)
  before, version = predictor.predict_versioned(window)
  assert version == 3
  assert predictor.restore() and predictor.model_version == 7
  after, version = predictor.predict_versioned(window)
  assert version == 7
  assert not np.array_equal(before['action_logits'], after['action_logits'])
  assert predictor.restore()   # nothing newer: keeps serving step 7
  assert predictor.global_step == 7
  scalars = registry.scalars()
  assert scalars['inference/restores/CheckpointPredictor/success'] == 3

  # A damaged newest checkpoint is skipped for the intact one.
  with open(os.path.join(str(tmp_path), 'checkpoint_9.pt'), 'wb') as f:
    f.write(b'not a checkpoint')
  fresh = CheckpointPredictor(model, str(tmp_path), timeout=5.0)
  assert fresh.restore() and fresh.model_version == 7


def test_restore_times_out_without_checkpoints(tmp_path, registry):
  model = Seq2ActBCModel(device='cpu', **POLICY)
  predictor = CheckpointPredictor(model, str(tmp_path / 'empty'),
                                  timeout=0.0)
  assert predictor.restore() is False
  assert not predictor.is_loaded
  assert registry.scalars()[
      'inference/restores/CheckpointPredictor/timeout'] == 1
  with pytest.raises(ValueError, match='restored'):
    predictor.predict({'image': np.zeros((1, 8, 36, 40, 3), np.uint8)})
  assert registry.scalars()['inference/errors/CheckpointPredictor'] == 1
  with pytest.raises(ValueError, match='checkpoint_dir'):
    CheckpointPredictor(model).restore()
