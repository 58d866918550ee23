"""One rank of ``tests/test_torch_ring.py``'s gloo group (no JAX here).

``run`` is started by ``torch.multiprocessing`` (spawn) once a rank. It
joins a CPU group through a ``file://`` init method, reads the inputs that
the test wrote with ``torch.save`` (``plan.pt``), computes its rank's share
of every case and writes what it found to ``rank<r>.pt``:

  * ``ring_permute``: what each rank receives from the one before it, and
    the sum of the ranks' numbers;
  * ring attention of the global q, k, v ([B, L, H, D]) for causal and
    not: this rank's output shard and its dq, dk, dv through
    ``sin(out).sum()``;
  * one Seq2Act train step with ring attention from the converted state:
    the loss, the metrics, the gradients (summed over the group) and the
    parameters after adam, and after a second step on the same batch;
  * the messages of the ValueErrors that a bad configuration raises;
  * the kernels' launch counts (none: every tensor is on the CPU).

``run_gin`` is a rank of ``tests/test_torch_config.py``'s ring under a
gin (``gin_plan.pt``): ``train_eval.main`` as torchrun starts it, first
with the flags (``--attention_mode ring``), then with the gin binding
``Seq2ActBCModel.attention_mode = "ring"``, each over a group of its own,
with rank 0's printed lines (``gin_rank<r>.pt``).

``run_records`` is a rank of ``tests/test_torch_seq2act_records.py``'s
ring from records (``records_plan.pt``): its share of the first train
batch that the trainer's record iterator reads, the ring's loss and
gradients on it from the given state and crop offsets, and then
``train_eval.main`` with ring attention over the group, as torchrun starts
it, with rank 0's printed lines (``records_rank<r>.pt``).
"""

import contextlib
import io
import os

import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.data import input_generators
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.modes import ModeKeys
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh
from tensor2robot_tpu_torch.parallel import ring_attention
from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
from tensor2robot_tpu_torch.trainer import train_eval


def _errors(group, config):
  messages = []
  uneven = dict(config, episode_length=6)            # 4 ranks do not divide 6
  try:
    Seq2ActBCModel(device='cpu', attention_mode='ring', process_group=group,
                   **uneven)
  except ValueError as error:
    messages.append(str(error))
  # 34 frames of 4 tokens a rank: 136 tokens, which no block of 128 divides;
  # the first block's attention refuses them.
  long_shard = dict(config, episode_length=4 * 34)
  model = Seq2ActBCModel(device='cpu', attention_mode='ring',
                         process_group=group, **long_shard)
  state = model.create_train_state(torch.Generator().manual_seed(0))
  image = torch.zeros((1, 34) + tuple(config['img_res']) + (3,))
  try:
    model.inference_network_fn(state.variables(), {'image': image},
                               ModeKeys.EVAL)
  except ValueError as error:
    messages.append(str(error))
  try:
    x = torch.zeros(1, 136, 1, 8)
    ring_attention.ring_self_attention(x, x, x, group)
  except ValueError as error:
    messages.append(str(error))
  return messages


def run(rank, world, init_file, out_dir):
  torch.set_num_threads(1)
  sequence = mesh.init_sequence_group(
      'cpu', init_method='file://' + init_file, rank=rank, world_size=world)
  group = sequence.group
  plan = torch.load(os.path.join(out_dir, 'plan.pt'), weights_only=False)
  kernels.reset_launches()
  found = {'rank': sequence.rank, 'world_size': sequence.world_size,
           'device': str(sequence.device)}

  token = torch.full((2,), float(rank))
  found['ring_permute'] = collectives.ring_permute([token, token * 10],
                                                   group)
  found['sum'] = collectives.all_reduce_sum(token.clone(), group)

  qkv = plan['qkv']                                    # [3, B, L, H, D]
  shard = qkv.shape[2] // world
  for causal in (False, True):
    q, k, v = (x[:, rank * shard:(rank + 1) * shard].clone().requires_grad_()
               for x in qkv)
    out = ring_attention.ring_self_attention(q, k, v, group, causal=causal)
    torch.sin(out).sum().backward()
    found['attention', causal] = (out.detach(), q.grad, k.grad, v.grad)

  model = Seq2ActBCModel(device='cpu', attention_mode='ring',
                         process_group=group,
                         learning_rate=plan['learning_rate'],
                         **plan['config'])
  state = TrainState(**plan['state'])
  features = {k: torch.from_numpy(v)
              for k, v in model.shard_batch(plan['features']).items()}
  labels = {k: torch.from_numpy(v)
            for k, v in model.shard_batch(plan['labels']).items()}
  found['frames'] = features['image'].shape[1]
  _, metrics, _, grads = model.gradients(state, features, labels)
  found['metrics'] = {k: float(v) for k, v in metrics.items()}
  found['grads'] = grads
  new_state, step_metrics = model.train_step(state, features, labels)
  found['step_metrics'] = {k: float(v) for k, v in step_metrics.items()}
  found['params'] = new_state.params
  found['params_2'] = model.train_step(new_state, features, labels)[0].params
  found['errors'] = _errors(group, plan['config'])
  found['launches'] = dict(kernels.LAUNCHES)
  torch.save(found, os.path.join(out_dir, 'rank{}.pt'.format(rank)))
  dist.barrier()
  dist.destroy_process_group()


def run_records(rank, world, init_file, out_dir):
  torch.set_num_threads(1)
  plan = torch.load(os.path.join(out_dir, 'records_plan.pt'),
                    weights_only=False)
  sequence = mesh.init_sequence_group(
      'cpu', init_method='file://' + init_file, rank=rank, world_size=world)
  model = Seq2ActBCModel(device='cpu', process_group=sequence.group,
                         **plan['config'])
  data = input_generators.DefaultRecordInputGenerator(
      file_patterns=plan['pattern'], batch_size=plan['batch_size'],
      use_native=True, prefetch=0)
  data.set_specification_from_model(model, ModeKeys.TRAIN)
  trainer = train_eval.Trainer(model, os.path.join(out_dir, 'unused'),
                               seed=plan['seed'])
  iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, 0)
  features, labels = next(iterator)
  iterator.close()
  found = {'features': features, 'labels': labels, 'reader': data.reader}
  raw, labels = trainer.put_batch(features), trainer.put_batch(labels)
  features, _ = model.preprocessor.preprocess(raw, None, ModeKeys.TRAIN,
                                              offsets=plan['offsets'])
  _, metrics, _, grads = model.gradients(TrainState(**plan['state']),
                                         features, labels)
  found['metrics'] = {k: float(v) for k, v in metrics.items()}
  found['grads'] = grads
  dist.barrier()
  dist.destroy_process_group()
  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                    MASTER_PORT=str(plan['port']))
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    found['main_rc'] = train_eval.main(plan['main_argv'])
  found['main_out'] = out.getvalue()
  torch.save(found, os.path.join(out_dir, 'records_rank{}.pt'.format(rank)))


def run_gin(rank, world, out_dir):
  torch.set_num_threads(1)
  plan = torch.load(os.path.join(out_dir, 'gin_plan.pt'), weights_only=False)
  found = {}
  for name in ('flags', 'gin'):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(plan[name + '_port']))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      found[name + '_rc'] = train_eval.main(plan[name + '_argv'])
    found[name + '_out'] = out.getvalue()
    found[name + '_group_left'] = dist.is_initialized()
  torch.save(found, os.path.join(out_dir, 'gin_rank{}.pt'.format(rank)))
