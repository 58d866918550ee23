"""Seq2Act's episodes from records: the port against the JAX package, on
the CPU.

Episodes are written by the JAX package's ``build_example_for_specs``
under the JAX model's on-disk names (``image0``: a list of JPEG frames,
``state``, ``task_id``, ``action``) and read by both packages' record
generators, both decoding with the same library here (libjpeg in the
native loaders, OpenCV in the Python parsers). Frame t of episode e holds
e and t in dims 0 and 1 of its action, each scaled into [-1, 1], so a
batch tells which frames of which episodes it holds. A tiny binding:
8-frame episodes of 24x32 frames (cropped to 20x28), 2 blocks of width
32.

Tolerances, each with its reason:

  * the batches of the two packages' generators, of a rank's shard
    against the whole episodes' frames, and of the ranks' shards put
    together: exact (the same records through the same decoder; pixels and
    ints bit-equal, floats equal);
  * a ring step from records over 2 gloo ranks against a flash step on the
    same episodes and crops: the loss within 1e-5 relative and every
    gradient within 1e-4 of the largest gradient (the ring train step's
    bounds in ``tests/test_torch_ring.py``: the two sum in other orders, a
    few float32 ulps a layer, doubled by the backward);
  * the port's first train step from records and converted weights against
    the JAX model's loss on the JAX generator's batch of the same records
    at the same crop offsets: 1e-5 relative (the Seq2Act training tests'
    bound on the loss: XLA and PyTorch sum in other orders).
"""

import functools
import json
import os
import socket
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as torch_mp

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.data import parser as jax_parser
from tensor2robot_tpu.modes import ModeKeys as JaxModeKeys
from tensor2robot_tpu.specs.struct import SpecStruct
from tensor2robot_tpu_torch import convert
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.data import parser
from tensor2robot_tpu_torch.data.input_generators import FrameShard
from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.preprocessors import image_transformations
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.trainer import checkpointing
from tensor2robot_tpu_torch.trainer import train_eval

import _torch_ring_worker
import test_torch_seq2act

jax_seq2act = test_torch_seq2act.jax_seq2act

# 8 frames of 4 tokens (2 TokenLearner tokens of the 2x2 stem map, the task
# and the state): 32 tokens, 16 a rank at 2 ranks.
TINY = dict(
    episode_length=8,
    action_size=3,
    vocab_size=16,
    img_res=(20, 28),
    src_img_res=(24, 32),
    tokens_per_frame=2,
    embed_dim=32,
    num_layers=2,
    num_heads=2,
    head_dim=16,
    mlp_dim=64,
    tokenizer_widths=(8, 8, 16, 16),
    use_state_input=True,
    state_size=4,
    num_task_embeddings=3,
    attention_mode='flash',
)
FRAME_KEYS = ('image', 'state', 'action')
FILES, PER_FILE, BATCH = 4, 4, 4
EPISODES = FILES * PER_FILE
LEARNING_RATE = 1e-3
SPAWN_TIMEOUT_S = 180


def _frame(rng, episode, t, hw):
  h, w = hw
  yy, xx = np.mgrid[0:h, 0:w]
  image = np.stack([xx * 5 + 9 * episode, yy * 7 + 3 * t,
                    (xx + yy) * 2 + 5 * episode], -1) % 256
  return np.clip(image + rng.randint(-20, 21, image.shape), 0,
                 255).astype(np.uint8)


def _jpeg(image):
  ok, encoded = cv2.imencode('.jpg', image[..., ::-1],
                             [cv2.IMWRITE_JPEG_QUALITY, 95])
  assert ok
  return encoded.tobytes()


def episode_values(spec, episode, episodes, junk_outside=None):
  """One episode of ``spec`` (flat in-specs, features and labels): JPEG
  frames, random states, a task id and actions that name the episode and
  frame. ``junk_outside`` (start, stop): frames outside it are bytes that
  are not a JPEG."""
  rng = np.random.RandomState(episode)
  t, h, w, _ = spec['image'].shape
  frames = [_jpeg(_frame(rng, episode, i, (h, w))) for i in range(t)]
  if junk_outside is not None:
    start, stop = junk_outside
    frames = [f if start <= i < stop else b'not a jpeg %d' % i
              for i, f in enumerate(frames)]
  values = {'image': frames}
  action = rng.uniform(-1, 1, spec['action'].shape).astype(np.float32)
  action[:, 0] = -1 + 2 * episode / (episodes - 1)
  action[:, 1] = -1 + 2 * np.arange(t) / (t - 1)
  values['action'] = action
  if 'state' in spec:
    values['state'] = rng.uniform(-1, 1, spec['state'].shape).astype(
        np.float32)
  if 'task_id' in spec:
    values['task_id'] = np.asarray([episode % 3], np.int32)
  return values


def write_episodes(directory, spec, build, junk_outside=None,
                   files=FILES, per_file=PER_FILE):
  """``files`` x ``per_file`` episodes, serialized by ``build(spec,
  values)``; returns their file pattern."""
  os.makedirs(directory, exist_ok=True)
  episodes = files * per_file
  for f in range(files):
    with TFRecordReplayWriter() as writer:
      writer.open(os.path.join(directory, 'train-{}.tfrecord'.format(f)))
      writer.write([build(spec, episode_values(spec, f * per_file + i,
                                               episodes, junk_outside))
                    for i in range(per_file)])
  return os.path.join(directory, 'train-*')


def named(labels):
  """Which (episode, frame) each action row names: int [B, T, 2]."""
  action = labels['action']
  episode = np.rint((action[..., 0] + 1) / 2 * (EPISODES - 1))
  frame = np.rint((action[..., 1] + 1) / 2 * (TINY['episode_length'] - 1))
  return np.stack([episode, frame], -1).astype(np.int64)


def _jax_in_specs(mode=JaxModeKeys.TRAIN):
  model = jax_seq2act.Seq2ActBCModel(**TINY)
  return (model.preprocessor.get_in_feature_specification(mode),
          model.preprocessor.get_in_label_specification(mode))


@pytest.fixture(scope='module')
def episodes(tmp_path_factory):
  """The tiny binding's episodes, written by the JAX package's writer, and
  the same episodes with junk bytes for every frame outside 2..5."""
  root = tmp_path_factory.mktemp('episodes')
  features, labels = _jax_in_specs()
  spec = dict(features)
  spec.update(labels)
  return {'clean': write_episodes(str(root / 'clean'), spec,
                                  jax_parser.build_example_for_specs),
          'junk': write_episodes(str(root / 'junk'), spec,
                                 jax_parser.build_example_for_specs,
                                 junk_outside=(2, 6)),
          'root': root}


def _equal(got, want):
  want = {k: want[k] for k in want}
  assert sorted(got) == sorted(want)
  for key in want:
    g, w = np.asarray(got[key]), np.asarray(want[key])
    assert g.dtype == w.dtype and g.shape == w.shape, key
    np.testing.assert_array_equal(g, w, err_msg=key)


def _generator(pattern, **kwargs):
  data = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=BATCH, prefetch=0, **kwargs)
  data.set_specification_from_model(
      Seq2ActBCModel(device='cpu', **TINY), ModeKeys.TRAIN)
  return data


def _batches(data, frames=None, epochs=1, seed=5, mode=ModeKeys.TRAIN):
  return list(data.create_dataset_iterator(mode, num_epochs=epochs,
                                           seed=seed, frames=frames))


# -- specs -------------------------------------------------------------------


@pytest.mark.parametrize('mode', [ModeKeys.TRAIN, ModeKeys.EVAL,
                                  ModeKeys.PREDICT])
def test_in_specs_carry_the_jax_names_and_formats(mode):
  model = Seq2ActBCModel(device='cpu', **TINY)
  features, labels = _jax_in_specs(mode)
  for got, want in ((model.preprocessor.get_in_feature_specification(mode),
                     features),
                    (model.preprocessor.get_in_label_specification(mode),
                     labels)):
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
      assert spec.shape == tuple(want[key].shape), key
      assert spec.dtype == np.dtype(want[key].dtype), key
      for field, value in spec.fields().items():
        assert getattr(want[key], field) == value, (key, field)
  image = model.preprocessor.get_in_feature_specification(mode)['image']
  assert (image.name, image.data_format) == ('image0', 'jpeg')
  # The model's own specs are named too, and still unpack as pairs.
  shape, dtype = model.get_label_specification(mode)['action']
  assert (shape, dtype) == ((8, 3), np.float32)
  assert model.get_label_specification(mode)['action'].name == 'action'


def test_frame_shard_spec_keeps_the_on_disk_fields():
  spec = Seq2ActBCModel(device='cpu', **TINY).preprocessor \
      .get_in_feature_specification(ModeKeys.TRAIN)
  cut = FrameShard(FRAME_KEYS, 2, 6).spec(spec)
  assert cut['image'].shape == (4, 24, 32, 3)
  assert cut['image'].fields() == spec['image'].fields()
  assert cut['state'].shape == (4, 4) and cut['state'].name == 'state'
  assert cut['task_id'] is spec['task_id']


# -- the batches -------------------------------------------------------------


@pytest.mark.parametrize('use_native', [True, False],
                         ids=['native', 'python'])
def test_record_batches_equal_the_jax_generators(episodes, use_native):
  data = _generator(episodes['clean'], use_native=use_native)
  ref = jax_generators.DefaultRecordInputGenerator(
      file_patterns=episodes['clean'], batch_size=BATCH, prefetch=0,
      use_native=use_native)
  ref.set_specification_from_model(jax_seq2act.Seq2ActBCModel(**TINY),
                                    JaxModeKeys.TRAIN)
  got = _batches(data)
  want = list(ref.create_dataset_iterator(JaxModeKeys.TRAIN, num_epochs=1,
                                          seed=5))
  assert data.reader == ('native' if use_native else 'python')
  assert len(got) == len(want) == EPISODES // BATCH
  for (gf, gl), (wf, wl) in zip(got, want):
    _equal(gf, wf)
    _equal(gl, wl)
  names = np.concatenate([named(batch[1])[:, 0, 0] for batch in got])
  assert sorted(names) == list(range(EPISODES))   # one epoch, shuffled
  assert not np.array_equal(names, np.arange(EPISODES))


def test_a_shard_decodes_only_its_frames(episodes):
  """Frames outside 2..5 of the junk episodes are not JPEGs: a loader of
  frames 2..5 reads them, a loader of whole episodes fails on them."""
  shard = FrameShard(FRAME_KEYS, 2, 6)
  got = _batches(_generator(episodes['junk'], use_native=True), shard)
  whole = _batches(_generator(episodes['clean'], use_native=True))
  assert len(got) == len(whole) == EPISODES // BATCH
  for (gf, gl), (wf, wl) in zip(got, whole):
    _equal(gf, shard.cut(wf))
    _equal(gl, shard.cut(wl))
    assert gf['image'].shape[1] == 4
    np.testing.assert_array_equal(named(gl)[..., 1],
                                  np.broadcast_to(np.arange(2, 6), (BATCH, 4)))
  with pytest.raises(RuntimeError, match='jpeg'):
    _batches(_generator(episodes['junk'], use_native=True))


@pytest.mark.parametrize('world,threads', [
    (1, 1), (1, 4), (2, 1), (2, 4), (4, 1), (4, 4), (2, 'python'),
    (4, 'python')])
def test_the_ranks_shards_make_the_whole_episodes(episodes, world, threads):
  """Every rank reads its T/N frames of the same episodes, step by step,
  over two shuffled epochs, whatever the loader's thread count: the shards
  put together along the frames are the whole episodes' batch."""
  kwargs = ({'use_native': False} if threads == 'python' else
            {'use_native': True, 'num_native_threads': threads})
  whole = _batches(_generator(episodes['clean'], **kwargs), epochs=2)
  per_rank = TINY['episode_length'] // world
  shares = [_batches(_generator(episodes['clean'], **kwargs),
                     FrameShard(FRAME_KEYS, r * per_rank,
                                (r + 1) * per_rank), epochs=2)
            for r in range(world)]
  assert all(len(share) == len(whole) == 2 * EPISODES // BATCH
             for share in shares)
  for step, (wf, wl) in enumerate(whole):
    parts = [share[step] for share in shares]
    for key in wf:
      if key in FRAME_KEYS:
        np.testing.assert_array_equal(
            np.concatenate([f[key] for f, _ in parts], 1), wf[key])
      else:
        for f, _ in parts:
          np.testing.assert_array_equal(f[key], wf[key])
    np.testing.assert_array_equal(
        np.concatenate([l['action'] for _, l in parts], 1), wl['action'])
    for r, (_, l) in enumerate(parts):
      names = named(l)
      np.testing.assert_array_equal(names[..., 0], named(wl)[
          :, r * per_rank:(r + 1) * per_rank, 0])
      np.testing.assert_array_equal(names[0, :, 1], np.arange(
          r * per_rank, (r + 1) * per_rank))


def test_native_plan_cuts_only_fixed_frame_lists():
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

  spec = Seq2ActBCModel(device='cpu', **TINY).preprocessor \
      .get_in_feature_specification(ModeKeys.TRAIN)
  plan = native_loader.plan_for_specs(spec, {}, frames=FrameShard(
      FRAME_KEYS, 4, 8))
  fields = {f.key: f for f in plan.fields}
  assert fields['features/image'].items == (4, 8)
  assert fields['features/image'].shape == (4, 24, 32, 3)
  assert fields['features/state'].items == (16, 32)   # 4 floats a frame
  assert fields['features/task_id'].items is None
  assert plan.feature_spec['image'].shape == (4, 24, 32, 3)
  varlen = {'v': TensorSpec((8,), np.float32, name='v',
                            varlen_default_value=0.0)}
  shard = FrameShard(('v',), 0, 4)
  assert native_loader.plan_for_specs(varlen, {}, frames=shard) is None
  assert native_loader.plan_for_specs(varlen, {}) is not None
  past = FrameShard(FRAME_KEYS, 4, 12)   # more frames than the episode's
  assert native_loader.plan_for_specs(spec, {}, frames=past) is None


@pytest.mark.parametrize('ranks,cores,want', [
    (1, 32, 16), (1, 8, 8), (4, 32, 8), (4, 8, 2), (64, 32, 1)])
def test_default_loader_threads_share_the_cores_among_ranks(
    monkeypatch, tmp_path, ranks, cores, want):
  """The trainer gives each rank's record loaders its share of the host's
  cores, up to 16; the loader alone keeps all of them, up to 16."""
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.specs.tensor_spec import TensorSpec

  monkeypatch.setattr(os, 'cpu_count', lambda: cores)
  assert train_eval.loader_threads(ranks) == want
  args = train_eval.make_parser().parse_args(
      ['--model', 'seq2act', '--model_dir', 'unused', '--train_data', 'a*',
       '--eval_data', 'b*', '--eval_steps', '1'])
  for data in train_eval.make_input_generators(args, ranks):
    assert data._num_native_threads == want
  plan = native_loader.plan_for_specs(
      {'v': TensorSpec((2,), np.float32, name='v')}, {})
  empty = tmp_path / 'empty.tfrecord'
  empty.write_bytes(b'')
  stream = native_loader.NativeBatchedStream(plan, [str(empty)],
                                             batch_size=1)
  try:
    assert stream.num_threads == min(16, cores)
  finally:
    stream.close()


# -- training from records ---------------------------------------------------


@pytest.fixture(scope='module')
def full_width_episodes(tmp_path_factory):
  """2-frame episodes at the full binding's 136x168, by the port's writer,
  for the command line (which builds the full-width model)."""
  model = Seq2ActBCModel(device='cpu', episode_length=2)
  spec = dict(model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN))
  spec.update(model.preprocessor.get_in_label_specification(ModeKeys.TRAIN))
  return write_episodes(str(tmp_path_factory.mktemp('full')), spec,
                        parser.build_example_for_specs, files=1, per_file=4)


def _command_line(pattern, model_dir, mode):
  return ['--model', 'seq2act', '--device', 'cpu', '--episode_length', '2',
          '--attention_mode', mode, '--batch_size', '1',
          '--max_train_steps', '2', '--log_every_n_steps', '1',
          '--train_data', pattern, '--eval_data', pattern, '--eval_steps',
          '1', '--eval_throttle_steps', '2', '--model_dir', model_dir]


def test_command_line_trains_seq2act_from_records_with_flash(
    full_width_episodes, tmp_path, capsys):
  assert train_eval.main(_command_line(full_width_episodes, str(tmp_path),
                                       'flash')) == 0
  line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert line['data'] == 'native' and line['model'] == 'seq2act'
  assert line['step'] == line['checkpoint_step'] == 2
  assert np.isfinite(line['metrics']['loss'])
  assert set(line['eval_metrics']) == {'loss', 'action_accuracy',
                                       'action_mae'}
  assert checkpointing.all_checkpoint_steps(str(tmp_path)) == [2]


def _free_port():
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def _close_to_max(got, want, tol, name):
  got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
  assert got.shape == want.shape, name
  err = float(np.abs(got - want).max())
  assert err <= tol, (name, err, tol)


@pytest.fixture(scope='module')
def ring_from_records(episodes, full_width_episodes):
  """Two gloo ranks (``_torch_ring_worker.run_records``): each rank's share
  of the first train batch, the ring's gradients on it, and the command
  line with ring attention over the two."""
  out_dir = episodes['root'] / 'ring'
  out_dir.mkdir()
  config = dict(TINY, attention_mode='ring')
  state = Seq2ActBCModel(device='cpu', **TINY).create_train_state(
      torch.Generator().manual_seed(0))
  offsets = torch.tensor([[1, 3], [4, 0], [0, 4], [2, 2]], dtype=torch.int32)
  torch.save({'config': config, 'pattern': episodes['clean'],
              'batch_size': BATCH, 'seed': 3, 'state': vars(state),
              'offsets': offsets, 'port': _free_port(),
              'main_argv': _command_line(full_width_episodes,
                                         str(out_dir / 'model'), 'ring')},
             str(out_dir / 'records_plan.pt'))
  context = torch_mp.start_processes(
      _torch_ring_worker.run_records,
      args=(2, str(out_dir / 'init'), str(out_dir)), nprocs=2, join=False,
      start_method='spawn')
  deadline = time.monotonic() + SPAWN_TIMEOUT_S
  try:
    done = False
    while not done and time.monotonic() < deadline:
      done = context.join(timeout=max(deadline - time.monotonic(), 0.1))
  finally:
    for process in context.processes:
      if process.is_alive():
        process.kill()
  assert done, 'a rank did not finish within {} s'.format(SPAWN_TIMEOUT_S)
  ranks = [torch.load(str(out_dir / 'records_rank{}.pt'.format(r)),
                      weights_only=False) for r in range(2)]
  return dict(ranks=ranks, state=state, offsets=offsets, out_dir=out_dir)


def test_a_ring_step_from_records_equals_a_flash_step(episodes,
                                                      ring_from_records):
  ranks = ring_from_records['ranks']
  flash = Seq2ActBCModel(device='cpu', **TINY)
  data = _generator(episodes['clean'], use_native=True)
  trainer = train_eval.Trainer(flash, str(ring_from_records['out_dir']),
                               seed=3)
  iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, 0)
  features, labels = next(iterator)
  iterator.close()
  for r, found in enumerate(ranks):
    assert found['reader'] == 'native'
    _equal(found['features'], FrameShard(FRAME_KEYS, 4 * r, 4 * r + 4).cut(
        features))
    _equal(found['labels'], FrameShard(FRAME_KEYS, 4 * r, 4 * r + 4).cut(
        labels))
  raw = trainer.put_batch(features)
  cropped, _ = flash.preprocessor.preprocess(
      raw, None, ModeKeys.TRAIN, offsets=ring_from_records['offsets'])
  _, metrics, _, grads = flash.gradients(ring_from_records['state'], cropped,
                                         trainer.put_batch(labels))
  largest = max(float(g.abs().max()) for g in grads.values())
  for found in ranks:
    np.testing.assert_allclose(found['metrics']['loss'],
                               float(metrics['loss']), rtol=1e-5)
    assert found['metrics']['action_accuracy'] == float(
        metrics['action_accuracy'])
    assert set(found['grads']) == set(grads)
    for name, want in grads.items():
      _close_to_max(found['grads'][name], want, 1e-4 * largest, name)


def test_command_line_trains_seq2act_from_records_with_ring(
    ring_from_records):
  ranks = ring_from_records['ranks']
  assert [found['main_rc'] for found in ranks] == [0, 0]
  assert ranks[1]['main_out'].strip() == ''   # rank 0 prints the line
  line = json.loads(ranks[0]['main_out'].strip().splitlines()[-1])
  assert line['data'] == 'native' and line['world_size'] == 2
  assert line['step'] == line['checkpoint_step'] == 2
  assert np.isfinite(line['metrics']['loss']) and line['eval_metrics']
  restored = checkpointing.CheckpointManager(
      str(ring_from_records['out_dir'] / 'model')).restore()
  assert restored.step == 2


def test_training_from_records_matches_jax_on_the_same_episodes(
    episodes, tmp_path, monkeypatch):
  """The whole slice: JAX-written episodes, the port's generator, 2 steps
  of the port's trainer from converted weights; the first step's loss
  against the JAX model's on the JAX generator's batch of the same records
  at the same crop offsets."""
  jax_model = jax_seq2act.Seq2ActBCModel(learning_rate=LEARNING_RATE, **TINY)
  ref = jax_generators.DefaultRecordInputGenerator(
      file_patterns=episodes['clean'], batch_size=BATCH, prefetch=0,
      use_native=True)
  ref.set_specification_from_model(jax_model, JaxModeKeys.TRAIN)
  seed = 7
  ref_features, ref_labels = next(ref.create_dataset_iterator(
      JaxModeKeys.TRAIN, seed=seed))
  h, w = TINY['img_res']
  to_float = jax.jit(lambda x: jnp.asarray(x, jnp.float32) / 255.0)
  init_features = SpecStruct(
      image=np.zeros((BATCH, 8, h, w, 3), np.float32),
      state=np.asarray(ref_features['state']),
      task_id=np.asarray(ref_features['task_id']))
  jax_state = jax.jit(jax_model.create_train_state)(
      jax.random.PRNGKey(0), init_features,
      SpecStruct(action=np.asarray(ref_labels['action'])))
  initial = convert.train_state_from_flax(
      jax.tree_util.tree_map(np.asarray, jax_state))
  model = Seq2ActBCModel(device='cpu', learning_rate=LEARNING_RATE, **TINY)
  checkpointing.CheckpointManager(str(tmp_path)).save(initial)

  offsets, losses = [], []
  draw = image_transformations.random_crop_offsets

  def recording_offsets(*args, **kwargs):
    offsets.append(draw(*args, **kwargs))
    return offsets[-1]

  monkeypatch.setattr(image_transformations, 'random_crop_offsets',
                      recording_offsets)
  step_fn = model.train_step

  def recording_step(state, features, labels):
    new_state, metrics = step_fn(state, features, labels)
    losses.append(float(metrics['loss']))
    return new_state, metrics

  model.train_step = recording_step
  result = train_eval.train_eval_model(
      model, str(tmp_path), _generator(episodes['clean'], use_native=True),
      max_train_steps=2, save_checkpoints_steps=2, seed=seed)
  assert result['state'].step == 2 and len(losses) == 2
  assert np.isfinite(losses).all()

  ys, xs = offsets[0][:, 0].numpy(), offsets[0][:, 1].numpy()
  images = np.asarray(ref_features['image'])
  cropped = np.stack([images[b, :, y:y + h, x:x + w]
                      for b, (y, x) in enumerate(zip(ys, xs))])
  features = SpecStruct(image=to_float(cropped),
                        state=np.asarray(ref_features['state']),
                        task_id=np.asarray(ref_features['task_id']))
  loss, _ = jax.jit(functools.partial(
      jax_model.loss_fn, mode=JaxModeKeys.TRAIN, rng=None))(
          jax_state.params, jax_state.model_state, features,
          SpecStruct(action=np.asarray(ref_labels['action'])))
  np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
