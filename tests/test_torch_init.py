"""The port's initial weights against the JAX package's ``init``.

Every model that the port's registry names (and the pusher's critic, the
MoE variant of Seq2Act, TEC with FiLM and a MAF decoder, and
``ImagesToFeaturesHighResNet``, which draw their own) is built at small
widths on both sides. The JAX side is flax's ``init`` traced abstractly
with every initializer it calls recorded, then those initializers
evaluated on their shapes (one compiled program for all models; the same
initializer on the same shape is drawn once); the port's is
``init_variables``. Tensor by tensor, under the names ``convert.from_flax``
gives JAX's tree:

  * a constant draw (biases, scales, batch norm statistics, the MDN's
    stddev inputs) is equal exactly;
  * a tensor of at least 64 elements has a std within 5 standard errors of
    JAX's (each sample's std has standard error about std / sqrt(2 n));
  * the support agrees, for a tensor of at least 1024 elements (where an
    untruncated normal's largest value lies well past 2 std): where one
    side's draw is bounded as a uniform (xavier) or as a normal truncated
    at 2 std, the other side's largest value lies within that bound.
"""

import math

import numpy as np
import pytest
import torch

from _torch_jax_qtopt import jax_qtopt_fixture

jax = pytest.importorskip('jax')

from tensor2robot_tpu_torch import convert  # noqa: E402

SMALL_SEQ2ACT = dict(
    episode_length=4, action_size=3, vocab_size=16, img_res=(32, 32),
    src_img_res=(36, 40), tokens_per_frame=4, embed_dim=32, num_layers=2,
    num_heads=2, head_dim=16, mlp_dim=64, tokenizer_widths=(8, 16, 16, 32),
    num_task_embeddings=3, use_state_input=True, state_size=5,
    attention_mode='xla')
T = 12   # >= TEC's temporal reduction kernel (10)
# max |x| / std of a unit normal truncated to [-2, 2], and of a uniform.
TRUNCATED_RATIO = 2.0 / 0.87962566103423978
UNIFORM_RATIO = math.sqrt(3.0)


def _cases(ref):
  """(name, JAX model, port model) of every case."""
  from tensor2robot_tpu_torch import meta_learning
  from tensor2robot_tpu_torch.research import grasp2vec
  from tensor2robot_tpu_torch.research import pose_env
  from tensor2robot_tpu_torch.research import pusher_env
  from tensor2robot_tpu_torch.research import vrgripper
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.research.seq2act import seq2act_model

  critic = 'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom'
  narrow = {'network_kwargs': {'num_convs': (1, 1, 1)}}
  g2v = dict(scene_size=(56, 56), goal_size=(56, 56), resnet_size=18)
  maf = dict(episode_length=T, use_film=True,
             action_decoder_kwargs={'hidden_layers': (16, 16)})
  jv, pv = ref.vrgripper, vrgripper
  return [
      (critic, getattr(ref.t2r_models, critic)(**narrow),
       getattr(t2r_models, critic)(device='cpu', **narrow)),
      ('Seq2ActBCModel', ref.seq2act_model.Seq2ActBCModel(**SMALL_SEQ2ACT),
       seq2act_model.Seq2ActBCModel(device='cpu', **SMALL_SEQ2ACT)),
      ('Seq2ActBCModel_moe', ref.seq2act_model.Seq2ActBCModel(
          moe_experts=4, moe_top_k=2, **SMALL_SEQ2ACT),
       seq2act_model.Seq2ActBCModel(device='cpu', moe_experts=4,
                                    moe_top_k=2, **SMALL_SEQ2ACT)),
      ('Grasp2VecModel', ref.grasp2vec_model.Grasp2VecModel(**g2v),
       grasp2vec.Grasp2VecModel(device='cpu', **g2v)),
      ('PoseEnvRegressionModel',
       ref.pose_env_models.PoseEnvRegressionModel(),
       pose_env.PoseEnvRegressionModel(device='cpu')),
      ('PoseEnvContinuousMCModel',
       ref.pose_env_models.PoseEnvContinuousMCModel(),
       pose_env.PoseEnvContinuousMCModel(device='cpu')),
      ('PoseEnvRegressionModelMAML',
       ref.pose_env_maml_models.PoseEnvRegressionModelMAML(
           base_model=ref.pose_env_models.PoseEnvRegressionModel()),
       pose_env.PoseEnvRegressionModelMAML(
           base_model=pose_env.PoseEnvRegressionModel(device='cpu'))),
      ('MAMLRegressionModel', ref.meta_learning.MAMLRegressionModel(
          base_model=jv.VRGripperRegressionModel(episode_length=4)),
       meta_learning.MAMLRegressionModel(
           base_model=pv.VRGripperRegressionModel(device='cpu',
                                                  episode_length=4))),
      ('VRGripperRegressionModel', jv.VRGripperRegressionModel(
          episode_length=4, num_mixture_components=3),
       pv.VRGripperRegressionModel(device='cpu', episode_length=4,
                                   num_mixture_components=3)),
      ('VRGripperDomainAdaptiveModel',
       jv.VRGripperDomainAdaptiveModel(episode_length=19),
       pv.VRGripperDomainAdaptiveModel(device='cpu', episode_length=19)),
      ('VRGripperEnvRegressionModelMAML',
       jv.VRGripperEnvRegressionModelMAML(
           base_model=jv.VRGripperRegressionModel(episode_length=4)),
       pv.VRGripperEnvRegressionModelMAML(
           base_model=pv.VRGripperRegressionModel(device='cpu',
                                                  episode_length=4))),
      ('VRGripperEnvTecModel', jv.VRGripperEnvTecModel(episode_length=T),
       pv.VRGripperEnvTecModel(device='cpu', episode_length=T)),
      ('VRGripperEnvTecModel_film_maf',
       jv.VRGripperEnvTecModel(action_decoder_cls=jv.MAFDecoder, **maf),
       pv.VRGripperEnvTecModel(device='cpu', action_decoder_cls=pv.MAFDecoder,
                               **maf)),
      ('VRGripperEnvSequentialModel',
       jv.VRGripperEnvSequentialModel(episode_length=T),
       pv.VRGripperEnvSequentialModel(device='cpu', episode_length=T)),
      ('VRGripperEnvSimpleTrialModel',
       jv.VRGripperEnvSimpleTrialModel(episode_length=T),
       pv.VRGripperEnvSimpleTrialModel(device='cpu', episode_length=T)),
      ('VRGripperEnvVisionTrialModel',
       jv.VRGripperEnvVisionTrialModel(episode_length=T),
       pv.VRGripperEnvVisionTrialModel(device='cpu', episode_length=T)),
      ('PusherCriticModel', ref.pusher_env.PusherCriticModel(),
       pusher_env.PusherCriticModel(device='cpu')),
  ]


CASE_NAMES = [
    'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom',
    'Seq2ActBCModel', 'Seq2ActBCModel_moe', 'Grasp2VecModel',
    'PoseEnvRegressionModel', 'PoseEnvContinuousMCModel',
    'PoseEnvRegressionModelMAML', 'MAMLRegressionModel',
    'VRGripperRegressionModel', 'VRGripperDomainAdaptiveModel',
    'VRGripperEnvRegressionModelMAML', 'VRGripperEnvTecModel',
    'VRGripperEnvTecModel_film_maf', 'VRGripperEnvSequentialModel',
    'VRGripperEnvSimpleTrialModel', 'VRGripperEnvVisionTrialModel',
    'PusherCriticModel', 'ImagesToFeaturesHighResNet']


def _record_inits(init):
  """``(collection, path, initializer, args, kwargs)`` of every variable
  that ``init`` (a flax init) creates, traced abstractly (no forward pass
  is compiled or run)."""
  from flax.core import scope as flax_scope

  records = []
  param, variable = flax_scope.Scope.param, flax_scope.Scope.variable

  def recording_param(self, name, init_fn, *args, unbox=True, **kwargs):
    def recorded(rng, *a, **k):
      records.append(('params', tuple(self.path) + (name,), init_fn, a, k))
      return init_fn(rng, *a, **k)
    return param(self, name, recorded, *args, unbox=unbox, **kwargs)

  def recording_variable(self, col, name, init_fn=None, *args, unbox=True,
                         **kwargs):
    if init_fn is not None and col != 'params':
      inner = init_fn

      def init_fn(*a, **k):
        records.append((col, tuple(self.path) + (name,), inner, a, k))
        return inner(*a, **k)
    return variable(self, col, name, init_fn, *args, unbox=unbox, **kwargs)

  flax_scope.Scope.param = recording_param
  flax_scope.Scope.variable = recording_variable
  try:
    jax.eval_shape(init)
  finally:
    flax_scope.Scope.param, flax_scope.Scope.variable = param, variable
  return records


def _signature(record):
  collection, _, init_fn, args, kwargs = record
  cells = tuple(repr(c.cell_contents) for c in init_fn.__closure__ or ())
  return (collection, init_fn.__code__, cells, repr(args),
          repr(sorted(kwargs.items())))


def _evaluate(records):
  """The records' values: each distinct initializer call once, all in one
  compiled program (the unsafe_rbg generator compiles fastest: only the
  distributions are compared)."""
  unique = {}
  for record in records:
    unique.setdefault(_signature(record), record)
  keys = list(unique)

  def draw(key):
    out = []
    for i, signature in enumerate(keys):
      collection, _, init_fn, args, kwargs = unique[signature]
      out.append(init_fn(jax.random.fold_in(key, i), *args, **kwargs)
                 if collection == 'params' else init_fn(*args, **kwargs))
    return out

  values = dict(zip(keys, jax.jit(draw)(jax.random.key(0,
                                                       impl='unsafe_rbg'))))
  return [np.asarray(values[_signature(r)]) for r in records]


def _tree(records, values):
  tree = {}
  for (collection, path, *_), value in zip(records, values):
    node = tree.setdefault(collection, {})
    for part in path[:-1]:
      node = node.setdefault(part, {})
    node[path[-1]] = value
  return tree


@pytest.fixture(scope='module')
def drawn():
  """{case name: (JAX's initial state dict, the port's)}."""
  from tensor2robot_tpu.specs import generators
  from tensor2robot_tpu_torch.layers import vision_layers
  from tensor2robot_tpu_torch.models import abstract_model

  for ref in jax_qtopt_fixture(
      'research.qtopt.t2r_models', 'research.seq2act.seq2act_model',
      'research.grasp2vec.grasp2vec_model',
      'research.pose_env.pose_env_models',
      'research.pose_env.pose_env_maml_models', 'research.vrgripper',
      'research.pusher_env', 'meta_learning', 'layers.vision_layers'):
    records, ports = [], {}
    for name, jax_model, model in _cases(ref):
      pre = jax_model.preprocessor
      features = generators.make_random_numpy(
          pre.get_out_feature_specification('train'), batch_size=2)
      label_spec = pre.get_out_label_specification('train')
      labels = (generators.make_random_numpy(label_spec, batch_size=2)
                if label_spec else None)
      records.append(_record_inits(
          lambda m=jax_model, f=features, l=labels: m.init_variables(
              jax.random.PRNGKey(0), f, l, 'train')))
      ports[name] = model.init_variables(
          torch.Generator().manual_seed(0))['params']
    net = ref.vision_layers.ImagesToFeaturesHighResNet(num_blocks=3)
    records.append(_record_inits(lambda: net.init(
        jax.random.PRNGKey(0), np.zeros((2, 128, 128, 3), np.float32))))
    high_res = vision_layers.ImagesToFeaturesHighResNet(num_blocks=3)
    generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
      for module in high_res.modules():
        abstract_model._init_module(module, generator)
    ports['ImagesToFeaturesHighResNet'] = dict(high_res.state_dict())
    values = _evaluate([r for rs in records for r in rs])
    out, start = {}, 0
    for name, rs in zip(CASE_NAMES, records):
      tree = _tree(rs, values[start:start + len(rs)])
      start += len(rs)
      out[name] = (convert.from_flax(tree)['params'], ports[name])
    yield out


def _bound(x: np.ndarray):
  """The support that a bounded-looking sample implies (as a uniform, or a
  normal truncated at 2 std), with 3 standard errors of its std as slack;
  None for an unbounded-looking one."""
  std = x.std()
  ratio = np.abs(x).max() / std
  slack = 1.0 + 3.0 / math.sqrt(2 * x.size)
  for bounded in (UNIFORM_RATIO, TRUNCATED_RATIO):
    if ratio <= bounded * slack:
      return bounded * std * slack
  return None


@pytest.mark.parametrize('name', CASE_NAMES)
def test_initial_weights_draw_jax_initializers(drawn, name):
  want, got = drawn[name]
  assert set(got) == set(want), (sorted(set(want) ^ set(got))[:6])
  for key in sorted(want):
    w = want[key].double().numpy().ravel()
    p = got[key].detach().double().numpy().ravel()
    assert w.shape == p.shape, key
    if np.all(w == w[0]):
      np.testing.assert_array_equal(p, w, err_msg=key)
      continue
    assert not np.all(p == p[0]), key
    if w.size < 64:
      continue
    assert abs(p.std() - w.std()) <= 5 * w.std() / math.sqrt(w.size), (
        key, p.std(), w.std())
    if w.size < 1024:
      continue
    for sample, other in ((w, p), (p, w)):
      bound = _bound(sample)
      if bound is not None:
        assert np.abs(other).max() <= bound, (key, np.abs(other).max(),
                                              bound)


def test_pose_env_and_vrgripper_scales(drawn):
  """The fault that a generic 0.01 draw made: the pose critic's fc0 at
  lecun's std (1 / sqrt(64 * 64 * 32), about 0.0028), and the vrgripper
  towers xavier-uniform with 0.01 biases."""
  _, pose = drawn['PoseEnvContinuousMCModel']
  fc0 = pose['fc0.weight']
  assert abs(float(fc0.std()) - 1 / math.sqrt(64 * 64 * 32)) < 1e-4
  _, vision = drawn['VRGripperEnvVisionTrialModel']
  for key, value in vision.items():
    if 'ImagesToFeaturesNet' in key and key.endswith('conv3.weight'):
      fan_in, fan_out = value[0].numel(), value.shape[0] * value[0, 0].numel()
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      assert float(value.abs().max()) <= limit
      assert float(value.abs().max()) > 0.9 * limit
    if 'ImagesToFeaturesNet' in key and key.endswith('conv3.bias'):
      assert torch.equal(value, torch.full_like(value, 0.01))
