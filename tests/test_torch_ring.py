"""The port's ring attention and ring training against the JAX package, on
the CPU.

Four ranks run as four processes (``torch.multiprocessing``, spawn) in a
gloo group that meets through a ``file://`` init method in the test's
temporary directory, so no port is needed; ``_torch_ring_worker.run`` is a
rank's work. The ranks start once for the module and each writes what it
found; the tests hold that against JAX's ``ring_self_attention`` and ring
``train_step`` on a 4-device mesh of conftest's 8 CPU devices. Inputs are
drawn with numpy from a seed; the train step starts from JAX's state,
converted (``convert.train_state_from_flax``).

Tolerances, each with its reason:

  * K6's plain version against the Pallas ``flash_attention_carry`` in
    interpret mode: 1e-6 of each output's max (the same float32 arithmetic,
    the Pallas kernel folding 32-key blocks in turn, the plain version all
    keys at once);
  * ring attention's outputs and dq, dk, dv against JAX's ring on the mesh,
    with and without ``use_pallas``: 1e-5 absolute, JAX's own bound against
    its oracle (``tests/test_parallel.py``);
  * one ring train step of the small model: the loss within 1e-5 relative,
    every gradient within 1e-4 of its largest magnitude (XLA and PyTorch sum
    in other orders, a few float32 ulps a layer, doubled by the backward),
    the bins picked, and so ``action_accuracy``, exact; the parameters after
    adam within 2 * lr of JAX's (adam's first update is about lr * sign(g),
    and a gradient near 0 may take the other sign), each step's update over
    two steps within 1e-4 * lr of JAX's (beyond one float32 rounding of the
    new parameter) where the gradient is above 1e-2 of its tensor's largest
    (``check_updates`` in
    ``test_torch_seq2act_training.py``), and equal on every rank;
  * a ring of one rank against flash attention: the logits within 1e-6 and
    the gradients within 1e-5 of their max (the same operations but for the
    backward's order of sums).
"""

import functools
import importlib
import json
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.parallel import ring_attention as jax_ring
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.layers import transformer
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import flash_attention
from tensor2robot_tpu_torch.parallel import mesh
from tensor2robot_tpu_torch.parallel import ring_attention
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval

import _torch_ring_worker
import test_torch_seq2act
from test_torch_seq2act_training import check_updates

jax_seq2act = test_torch_seq2act.jax_seq2act
jax_flash = importlib.import_module('tensor2robot_tpu.parallel.flash_attention')

WORLD = 4
SPAWN_TIMEOUT_S = 180
LEARNING_RATE = 1e-3
# tests/test_seq2act.py's ring model: 8 frames x 4 tokens = 32 tokens, 8 a
# rank; two blocks of two heads of 8 at width 32.
RING = dict(
    episode_length=8,
    action_size=2,
    vocab_size=16,
    img_res=(32, 32),
    src_img_res=(36, 36),
    tokens_per_frame=4,
    embed_dim=32,
    num_layers=2,
    num_heads=2,
    head_dim=8,
    mlp_dim=64,
    tokenizer_widths=(8, 16, 16, 32),
)
# The attention inputs: [B, L, H, D] as tests/test_parallel.py draws them.
QKV_SHAPE = (2, 64, 2, 16)


def _close_to_max(got, want, tol, name=''):
  got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                   np.float32)
  want = np.asarray(want, np.float32)
  assert got.shape == want.shape, name
  err = float(np.abs(got - want).max())
  assert err <= tol * float(np.abs(want).max()), (name, err)


def _batch(rng, batch, config):
  t, (h, w) = config['episode_length'], config['img_res']
  features = {'image': rng.uniform(0, 1, (batch, t, h, w, 3)).astype(
      np.float32)}
  labels = {'action': rng.uniform(-1, 1, (batch, t, config['action_size']))
            .astype(np.float32)}
  return features, labels


def _spawn(fn, args, nprocs):
  """Starts ``nprocs`` ranks of ``fn``; joins them within SPAWN_TIMEOUT_S or
  kills them and fails."""
  context = torch_mp.start_processes(fn, args=args, nprocs=nprocs,
                                     join=False, start_method='spawn')
  deadline = time.monotonic() + SPAWN_TIMEOUT_S
  try:
    # join() returns as each rank ends, True once all have; it raises if a
    # rank failed.
    done = False
    while not done and time.monotonic() < deadline:
      done = context.join(timeout=max(deadline - time.monotonic(), 0.1))
  finally:
    for process in context.processes:
      if process.is_alive():
        process.kill()
  assert done, 'a rank did not finish within {} s'.format(SPAWN_TIMEOUT_S)
  assert all(p.exitcode == 0 for p in context.processes)


@pytest.fixture(scope='module')
def jax_mesh():
  return jax.sharding.Mesh(np.array(jax.devices()[:WORLD]), ('data',))


@pytest.fixture(scope='module')
def ring_setup(tmp_path_factory, jax_mesh):
  """JAX's initial state and the inputs, then the four ranks' results."""
  out_dir = tmp_path_factory.mktemp('ring')
  rng = np.random.RandomState(7)
  qkv = rng.randn(3, *QKV_SHAPE).astype(np.float32)
  features, labels = _batch(rng, 2, RING)
  jax_model = jax_seq2act.Seq2ActBCModel(
      attention_mode='ring', mesh=jax_mesh, learning_rate=LEARNING_RATE,
      **RING)
  state = jax.jit(jax_model.create_train_state)(
      jax.random.PRNGKey(0), SpecStruct(**features), SpecStruct(**labels))
  before = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, state))
  torch.save({'qkv': torch.from_numpy(qkv), 'features': features,
              'labels': labels, 'state': vars(before), 'config': RING,
              'learning_rate': LEARNING_RATE}, str(out_dir / 'plan.pt'))
  _spawn(_torch_ring_worker.run,
         (WORLD, str(out_dir / 'init'), str(out_dir)), WORLD)
  ranks = [torch.load(str(out_dir / 'rank{}.pt'.format(r)),
                      weights_only=False) for r in range(WORLD)]
  return dict(ranks=ranks, qkv=qkv, features=features, labels=labels,
              jax_model=jax_model, state=state, before=before)


# -- K6's plain version against the Pallas carry kernel --------------------


def _carry_case(causal, q_offset, k_offset, carried, l_k=64):
  """A case of the test below; its id names l_k where it is not 64."""
  name = '-'.join(str(x) for x in (causal, q_offset, k_offset, carried))
  return pytest.param(causal, q_offset, k_offset, carried, l_k,
                      id=name if l_k == 64 else '{}-{}'.format(name, l_k))


@pytest.mark.parametrize('causal,q_offset,k_offset,carried,l_k', [
    _carry_case(True, 0, 0, False),   # the diagonal hop, from the initial state
    _carry_case(True, 64, 64, True),  # the diagonal hop, carried
    _carry_case(True, 64, 0, True),   # a full hop below the diagonal
    _carry_case(True, 0, 64, True),   # a hop the mask hides entirely
    _carry_case(True, 32, 0, False),  # a hop that crosses the diagonal
    _carry_case(False, 0, 64, False),   # no mask: every key counts
    _carry_case(False, 64, 0, True),
    # The diagonal crossed at an offset that is not a multiple of 16.
    _carry_case(True, 40, 30, True),
    # A hop hidden from the first 20 queries only.
    _carry_case(True, 0, 20, True),
    # Lq != Lk: more keys than queries, then fewer.
    _carry_case(True, 48, 8, True, l_k=96),
    _carry_case(True, 64, 0, False, l_k=32),
])
def test_carry_plain_matches_pallas_interpret(causal, q_offset, k_offset,
                                              carried, l_k):
  rng = np.random.RandomState(q_offset + 2 * k_offset + int(carried))
  bh, l, d = 2, 64, 16
  q, k, v, k0, v0 = (rng.randn(bh, length, d).astype(np.float32)
                     for length in (l, l_k, l_k, l, l))
  o = jnp.zeros((bh, l, d), jnp.float32)
  m = jnp.full((bh, l), flash_attention.NEG_INF, jnp.float32)
  lsum = jnp.zeros((bh, l), jnp.float32)
  carry = functools.partial(jax_flash.flash_attention_carry, block_q=32,
                            block_k=32, interpret=True, scale=0.25)
  if carried:   # the state after an earlier full hop
    o, m, lsum = carry(q, k0, v0, o, m, lsum, q_offset, q_offset - l, causal)
  want = carry(q, k, v, o, m, lsum, q_offset, k_offset, causal)

  def blhd(x):   # [BH, L, D] -> [BH, L, 1, D]
    return torch.from_numpy(np.asarray(x))[:, :, None, :]

  state = (torch.from_numpy(np.array(o))[:, None],
           torch.from_numpy(np.array(m))[:, None],
           torch.from_numpy(np.array(lsum))[:, None])
  kernels.reset_launches()
  got = flash_attention.flash_attention_carry(
      blhd(q), blhd(k), blhd(v), *state, q_offset, k_offset, causal, 0.25)
  assert not any(kernels.LAUNCHES.values())
  assert all(g is s for g, s in zip(got, state))   # updated in place
  for name, g, w in zip('oml', got, want):
    _close_to_max(g[:, 0], w, 1e-6, name)
  if causal and k_offset > q_offset + l - 1:   # the hidden hop changes nothing
    for g, s in zip(got, (o, m, lsum)):
      np.testing.assert_array_equal(g[:, 0].numpy(), np.asarray(s))


def test_carry_checks_its_operands():
  q = torch.zeros(1, 136, 2, 64)
  state = (torch.zeros(1, 2, 136, 64), torch.zeros(1, 2, 136),
           torch.zeros(1, 2, 136))
  with pytest.raises(ValueError, match='multiples of the block'):
    flash_attention.flash_attention_carry(q, q, q, *state, 0, 0, True, 0.1)
  q = torch.zeros(1, 64, 2, 64)
  with pytest.raises(ValueError, match=r'o \[B, H, Lq, D\]'):
    flash_attention.flash_attention_carry(q, q, q, *state, 0, 0, True, 0.1)
  meta = torch.empty(1, 64, 2, 64, device='meta')
  meta_state = (torch.empty(1, 2, 64, 64, device='meta'),
                torch.empty(1, 2, 64, device='meta'),
                torch.empty(1, 2, 64, device='meta'))
  with pytest.raises(ValueError, match='CUDA or CPU'):
    flash_attention.flash_attention_carry(meta, meta, meta, *meta_state, 0,
                                          0, True, 0.1)
  # JAX's wrapper raises for the same lengths.
  with pytest.raises(ValueError, match='multiples of the block'):
    jax_flash.flash_attention_carry(
        jnp.zeros((1, 136, 8)), jnp.zeros((1, 136, 8)),
        jnp.zeros((1, 136, 8)), jnp.zeros((1, 136, 8)), jnp.zeros((1, 136)),
        jnp.zeros((1, 136)), 0, 0, True, 0.1, interpret=True)


# -- four gloo ranks against JAX's ring on a 4-device mesh -------------------


def test_collectives_over_four_ranks(ring_setup):
  for found in ring_setup['ranks']:
    r = found['rank']
    assert found['world_size'] == WORLD and found['device'] == 'cpu'
    received, tens = found['ring_permute']
    assert torch.equal(received, torch.full((2,), float((r - 1) % WORLD)))
    assert torch.equal(tens, received * 10)
    assert torch.equal(found['sum'], torch.full((2,), 6.0))
  one = [torch.ones(3)]
  assert collectives.ring_permute(one, None)[0] is one[0]
  assert collectives.world_size(None) == 1 and collectives.rank(None) == 0


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('use_pallas', [False, True])
def test_ring_attention_matches_jax(ring_setup, jax_mesh, causal,
                                    use_pallas):
  q, k, v = (jnp.asarray(x) for x in ring_setup['qkv'])

  def loss(q, k, v):
    out = jax_ring.ring_self_attention(q, k, v, jax_mesh, causal=causal,
                                       use_pallas=use_pallas)
    return jnp.sum(jnp.sin(out)), out

  (_, want_out), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
  got = [torch.cat([found['attention', causal][i]
                    for found in ring_setup['ranks']], 1)
         for i in range(4)]
  for name, g, w in zip(('out', 'dq', 'dk', 'dv'), got, (want_out,) + want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                               err_msg=name)


def test_ring_train_step_matches_jax(ring_setup):
  jax_model, state = ring_setup['jax_model'], ring_setup['state']
  features = SpecStruct(**ring_setup['features'])
  labels = SpecStruct(**ring_setup['labels'])
  (loss, _), grads = jax.jit(jax.value_and_grad(
      functools.partial(jax_model.loss_fn, mode=JaxModeKeys.TRAIN, rng=None),
      has_aux=True))(state.params, state.model_state, features, labels)
  new_state, metrics = jax.jit(jax_model.train_step)(
      state, features, labels, jax.random.PRNGKey(1))
  want_grads = convert.from_flax({'params': grads})['params']
  ranks = ring_setup['ranks']
  for found in ranks:
    assert found['frames'] == RING['episode_length'] // WORLD
    assert not any(found['launches'].values())
    np.testing.assert_allclose(found['metrics']['loss'], float(loss),
                               rtol=1e-5)
    assert found['step_metrics'] == found['metrics']
    assert found['metrics']['action_accuracy'] == float(
        metrics['action_accuracy'])
    np.testing.assert_allclose(found['metrics']['action_mae'],
                               float(metrics['action_mae']), rtol=1e-6)
    assert set(found['grads']) == set(want_grads)
    for name, want in want_grads.items():
      _close_to_max(found['grads'][name], want.numpy(), 1e-4, name)
  want_params = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, new_state)).params
  moved = 0.0
  for name, value in want_params.items():
    np.testing.assert_allclose(ranks[0]['params'][name].numpy(),
                               value.numpy(), rtol=0, atol=2 * LEARNING_RATE,
                               err_msg=name)
    moved = max(moved, float((ranks[0]['params'][name] -
                              ring_setup['before'].params[name]).abs().max()))
  assert moved > 0.5 * LEARNING_RATE
  # Each step's update against JAX's over two steps on the same batch.
  grads_2 = jax.jit(jax.grad(
      lambda p: jax_model.loss_fn(p, new_state.model_state, features, labels,
                                  JaxModeKeys.TRAIN, None)[0]))(
                                      new_state.params)
  new_state_2, _ = jax.jit(jax_model.train_step)(
      new_state, features, labels, jax.random.PRNGKey(2))
  want_params_2 = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, new_state_2)).params
  check_updates(
      [ring_setup['before'].params, ranks[0]['params'],
       ranks[0]['params_2']],
      [ring_setup['before'].params, want_params, want_params_2],
      [want_grads, convert.from_flax({'params': grads_2})['params']],
      LEARNING_RATE)
  # The summed gradients leave the weights equal on every rank.
  for found in ranks[1:]:
    for key in ('params', 'params_2'):
      for name, value in ranks[0][key].items():
        assert torch.equal(found[key][name], value), (key, name)


def test_ring_refuses_what_it_cannot_shard(ring_setup):
  for found in ring_setup['ranks']:
    uneven, long_shard, attention = found['errors']
    assert 'episode length that they divide' in uneven
    assert 'multiples of the block' in long_shard
    assert 'multiples of the block' in attention


# -- one rank ----------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
  sequence = mesh.init_sequence_group(
      'cpu', init_method='file://' + str(tmp_path / 'init'), rank=0,
      world_size=1)
  try:
    yield sequence
  finally:
    dist.destroy_process_group()


def test_one_rank_ring_equals_flash(one_rank):
  assert (one_rank.rank, one_rank.world_size) == (0, 1)
  assert one_rank.device == torch.device('cpu')
  rng = np.random.RandomState(8)
  features, labels = _batch(rng, 2, RING)
  features = {k: torch.from_numpy(v) for k, v in features.items()}
  labels = {k: torch.from_numpy(v) for k, v in labels.items()}
  ring = Seq2ActBCModel(device='cpu', attention_mode='ring',
                        process_group=one_rank.group, **RING)
  flash = Seq2ActBCModel(device='cpu', attention_mode='flash', **RING)
  state = flash.create_train_state(torch.Generator().manual_seed(0))
  assert ring.shard_batch(features) is features or torch.equal(
      ring.shard_batch(features)['image'], features['image'])
  logits = [m.inference_network_fn(state.variables(), features,
                                    ModeKeys.EVAL)['action_logits']
            for m in (ring, flash)]
  _close_to_max(logits[0], logits[1].numpy(), 1e-6)
  (ring_loss, ring_metrics, _, ring_grads), (flash_loss, flash_metrics, _,
                                             flash_grads) = (
                                                 m.gradients(state, features,
                                                             labels)
                                                 for m in (ring, flash))
  np.testing.assert_allclose(float(ring_loss.detach()),
                             float(flash_loss.detach()), rtol=1e-6)
  for key in ('loss', 'action_accuracy', 'action_mae'):
    np.testing.assert_allclose(float(ring_metrics[key]),
                               float(flash_metrics[key]), rtol=1e-6)
  for name, want in flash_grads.items():
    _close_to_max(ring_grads[name], want.numpy(), 1e-5, name)


class _RecordingGenerator(input_generators.DefaultRandomInputGenerator):
  """Random batches, made on demand, the seed of each recorded."""

  def __init__(self):
    super().__init__(batch_size=1, prefetch=0)
    self.seeds = []

  def _generate_batch(self, seed, frames=None):
    self.seeds.append(seed)
    return super()._generate_batch(seed, frames)


def test_ring_segments_and_resumed_runs_draw_new_batches(one_rank,
                                                         tmp_path):
  """Under a group the train batch of global step k is drawn from seed + k:
  the segments between evals and a resumed run go on with new batches, and
  the evals draw from seeds of their own."""
  model = Seq2ActBCModel(device='cpu', attention_mode='ring',
                         process_group=one_rank.group, **RING)
  train, evaluate = _RecordingGenerator(), _RecordingGenerator()
  result = train_eval.train_eval_model(
      model, str(tmp_path), train, evaluate, max_train_steps=2,
      eval_steps=1, eval_throttle_steps=1, seed=5)
  assert result['state'].step == 2 and result['eval_metrics']
  assert train.seeds == [5, 6]
  first_eval = 5 + train_eval.EVAL_SEED_OFFSET
  assert evaluate.seeds[0] == first_eval and len(evaluate.seeds) > 1
  assert evaluate.seeds[len(evaluate.seeds) // 2] == first_eval
  assert min(evaluate.seeds) > max(train.seeds) + 977
  train_eval.train_eval_model(model, str(tmp_path), train,
                              max_train_steps=3, seed=5)
  assert train.seeds == [5, 6, 7]


@pytest.mark.parametrize('world', [2, 4])
def test_ranks_draw_only_their_frames(world, monkeypatch, tmp_path):
  """Under a group of N, each rank's train batch of step k holds only its
  T/N frames of ``image``, ``state`` and ``action``, and the ranks' draws
  concatenate to what one rank draws alone at steps 0 and 1; ``task_id``
  and the crop offsets are drawn alike on every rank."""
  config = dict(RING, use_state_input=True, num_task_embeddings=3)
  frames = config['episode_length']
  group = object()   # a stand-in: only its rank and size are asked for
  monkeypatch.setattr(collectives, 'world_size',
                      lambda g: 1 if g is None else world)

  def draw(model, step):
    data = input_generators.DefaultRandomInputGenerator(batch_size=2,
                                                        prefetch=0)
    data.set_specification_from_model(model, ModeKeys.TRAIN)
    trainer = train_eval.Trainer(model, str(tmp_path), seed=3)
    iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, step)
    features, labels = next(iterator)
    iterator.close()
    offsets = image_transformations.random_crop_offsets(
        2, RING['src_img_res'], RING['img_res'], trainer.crop_generator(step))
    return {**features, **labels}, offsets

  one = Seq2ActBCModel(device='cpu', attention_mode='flash', **config)
  first = None
  for step in (0, 1):
    want, want_offsets = draw(one, step)
    assert set(want) == {'image', 'state', 'task_id', 'action'}
    shares = []
    for r in range(world):
      monkeypatch.setattr(collectives, 'rank',
                          lambda g, r=r: 0 if g is None else r)
      ring = Seq2ActBCModel(device='cpu', attention_mode='ring',
                            process_group=group, **config)
      assert ring.frame_shard() == (('image', 'state', 'action'),
                                    r * frames // world,
                                    (r + 1) * frames // world)
      shares.append(draw(ring, step))
    for key, value in want.items():
      if key == 'task_id':
        for share, _ in shares:
          np.testing.assert_array_equal(share[key], value)
      else:
        assert all(share[key].shape[1] == frames // world
                   for share, _ in shares), key
        np.testing.assert_array_equal(
            np.concatenate([share[key] for share, _ in shares], 1), value)
    for _, offsets in shares:
      assert torch.equal(offsets, want_offsets)
    if first is None:
      first = want
    else:   # step 1 draws anew
      assert not np.array_equal(first['image'], want['image'])


def test_ring_without_a_group_raises():
  q = torch.zeros(1, 16, 2, 8)
  with pytest.raises(ValueError, match='process group'):
    transformer.run_attention(q, q, q, mode='ring', causal=True)
  with pytest.raises(ValueError, match='process group'):
    ring_attention.ring_self_attention(q, q, q, None)
  with pytest.raises(ValueError, match='process_group'):
    Seq2ActBCModel(device='cpu', attention_mode='ring', **RING)
  with pytest.raises(ValueError, match='process_group'):
    Seq2ActBCModel(device='cpu', process_group=object(), **RING)
  with pytest.raises(ValueError, match='MASTER_PORT'):
    mesh.init_sequence_group('cpu', rank=0, world_size=1)
  with pytest.raises(ValueError, match='CUDA or CPU'):
    mesh.init_sequence_group('meta')


def _free_port():
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def test_command_line_trains_with_ring_attention(tmp_path, capsys,
                                                 monkeypatch):
  """``--attention_mode ring`` as torchrun starts one rank: the group from
  its environment, one JSON line with the world size."""
  for name, value in (('RANK', '0'), ('WORLD_SIZE', '1'), ('LOCAL_RANK', '0'),
                      ('MASTER_ADDR', '127.0.0.1'),
                      ('MASTER_PORT', str(_free_port()))):
    monkeypatch.setenv(name, value)
  assert train_eval.main([
      '--model', 'seq2act', '--device', 'cpu', '--episode_length', '2',
      '--attention_mode', 'ring', '--max_train_steps', '1',
      '--batch_size', '1', '--model_dir', str(tmp_path),
      '--log_every_n_steps', '1']) == 0
  assert not dist.is_initialized()
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['world_size'] == 1 and line['step'] == 1
  assert line['checkpoint_step'] == 1 and np.isfinite(line['metrics']['loss'])
  restored = checkpointing.CheckpointManager(str(tmp_path)).restore()
  flash = Seq2ActBCModel(device='cpu', episode_length=2,
                         attention_mode='flash')
  assert set(restored.params) == set(flash.network.state_dict())
  with pytest.raises(ValueError, match='seq2act'):
    train_eval.main(['--attention_mode', 'ring', '--device', 'cpu',
                     '--model_dir', str(tmp_path / 'qtopt')])
