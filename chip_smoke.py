#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (tensor2robot_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, and prints no result, without a card or without the
repository around it. Phases, each printing one line or more:

  1. Device: the card's name and power limit; builds the CUDA kernels from
     ``tensor2robot_tpu_torch/csrc`` (one nvcc per source, in parallel).
  2. Kernel parity: each kernel's wrapper against its plain PyTorch
     version on the card, at the shapes the serving path gives it, bit for
     bit, and timed beside its memory bound and, where one PyTorch call
     computes the same function, that call.
  3. Slice: the full-width Grasping44 CEM policy (num_convs (6, 6, 3),
     512x640 frames cropped to 472, CEM 64 x 3 with 10 elites) behind a
     PolicyServer with max_batch_size 8, answering requests from 4
     threads. The kernels' launch counters are zeroed just before and
     read just after; every kernel must have launched as often as the
     batches imply. Then one request at a time, one batch rerun through
     the plain versions, and a profile of full batches.
  4. A JSON line of the kernels, the card's name and power limit, and
     the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and float32 (non-tensor
# core) operations/s, the rates at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

MAX_BATCH = 8
CEM_SAMPLES, CEM_ITERS, NUM_ELITES = 64, 3, 10
NUM_CONVS = (6, 6, 3)
THREADS, ROUNDS, PER_ROUND = 4, 3, 4   # 48 requests, 16 in flight
# The served pools: (name, input NHWC shape, window, calls per batch).
SERVED_POOLS = (
    ('stem 236->79', (MAX_BATCH, 236, 236, 64), 3, 1),
    ('pool2 79->27', (MAX_BATCH, 79, 79, 64), 3, 1),
    ('pool3 27->14', (MAX_BATCH * CEM_SAMPLES, 27, 27, 64), 2,
     CEM_ITERS + 1),
)


def check(condition, message):
  if not condition:
    raise AssertionError(message)


def smi_line():
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()


def median_ms(fn, iters=30, warmup=5):
  """Median device time of one call, from CUDA events around each call."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  events = [(torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
  for start, end in events:
    start.record()
    fn()
    end.record()
  torch.cuda.synchronize()
  return statistics.median(start.elapsed_time(end) for start, end in events)


def bound_ms(nbytes, ops):
  """The least time for the work: the larger of bytes over the memory
  rate and operations over the float32 rate; and which one bounds it."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = ops / FP32_OPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def max_abs_err(a, b):
  return float((a.float() - b.float()).abs().max())


def phase_device():
  from tensor2robot_tpu_torch import kernels
  print('device: {}'.format(smi_line()))
  seconds = kernels.build()
  print('build: {} kernels in {:.1f}s (nvcc {})'.format(
      len(kernels.KERNELS), seconds, ' '.join(kernels.NVCC_FLAGS)))
  for name in kernels.KERNELS:
    log = kernels.BUILD_DIR / '{}.log'.format(name)
    if log.exists():
      for line in log.read_text().splitlines():
        if 'registers' in line or 'spill' in line:
          print('  ptxas {}: {}'.format(name, line.strip()))


def phase_crop(device, gen):
  from tensor2robot_tpu_torch.preprocessors import image_transformations
  from tensor2robot_tpu_torch.preprocessors import pallas_crop

  b, (h, w, c), (th, tw) = MAX_BATCH, (512, 640, 3), (472, 472)
  images = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8,
                         device=device, generator=gen)
  center = image_transformations.center_crop_offsets(b, (h, w), (th, tw),
                                                     device=device)
  ragged = torch.tensor([[0, 0], [40, 168], [-5, 700], [100, -3],
                         [10**6, 10**6], [7, 99], [39, 1], [20, 84]],
                        dtype=torch.int32, device=device)[:b]
  err = 0.0
  for offsets in (center, ragged):
    for dtype in (torch.float32, torch.bfloat16):
      got = pallas_crop.crop_convert(images, offsets, (th, tw), dtype)
      want = pallas_crop.crop_convert_plain(images, offsets, (th, tw),
                                            dtype)
      torch.cuda.synchronize()
      check(got.dtype == dtype and got.shape == want.shape,
            'crop_convert shape/dtype')
      check(torch.equal(got, want),
            'crop_convert differs from its plain version ({}, {})'.format(
                dtype, offsets.tolist()))
      err = max(err, max_abs_err(got, want))
  ms = median_ms(lambda: pallas_crop.crop_convert(images, center, (th, tw)))
  plain = median_ms(
      lambda: pallas_crop.crop_convert_plain(images, center, (th, tw)))
  elements = b * th * tw * c
  # The crop window is what the function must read: 1 byte in, 4 out.
  bound, by = bound_ms(elements * 5 + center.numel() * 4, elements)
  print('crop_convert [8,512,640,3] u8 -> [8,472,472,3] f32: bit-exact '
        '(center and clamped offsets, f32 and bf16); {:.4f} ms, plain '
        '{:.4f} ms, bound {:.4f} ms ({})'.format(ms, plain, bound, by))
  return {'name': 'crop_convert', 'route': 'cuda',
          'source': 'tensor2robot_tpu_torch/csrc/crop_convert.cu',
          'replaces': 'tensor2robot_tpu/preprocessors/pallas_crop.py:117',
          'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
          'bound_ms': bound, 'bound_by': by, 'library_ms': None,
          'shapes': '1 x [8,512,640,3] u8 -> [8,472,472,3] f32 per batch'}


def phase_pool(device, gen):
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.layers import pooling

  err = 0.0
  cases = [(name, shape, k, 'SAME') for name, shape, k, _ in SERVED_POOLS]
  cases.append(('valid 29x31', (MAX_BATCH, 29, 31, 64), 3, 'VALID'))
  for name, shape, k, padding in cases:
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(shape, device=device, generator=gen).to(dtype)
      got, idx = pooling.max_pool(x, (k, k), (k, k), padding, True)
      want, want_idx = pooling.max_pool_plain(x, (k, k), (k, k), padding,
                                              True)
      no_index = pooling.max_pool(x, (k, k), (k, k), padding)
      torch.cuda.synchronize()
      check(torch.equal(got, want) and torch.equal(no_index, want),
            'max_pool values differ from plain ({}, {})'.format(name, dtype))
      check(torch.equal(idx, want_idx),
            'max_pool index differs from plain ({}, {})'.format(name, dtype))
      err = max(err, max_abs_err(got, want))
  print('max_pool: bit-exact values and int8 index at {} geometries in '
        'f32 and bf16'.format(len(cases)))

  totals = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0}
  bound_by = set()
  for name, shape, k, calls in SERVED_POOLS:
    x = torch.randn(shape, device=device, generator=gen)
    (ho, wo), (pad_top, _), _ = pooling.pool_geometry(shape, (k, k), (k, k),
                                                      'SAME')
    nchw = x.permute(0, 3, 1, 2)   # channels_last NCHW view of the NHWC map

    def library(nchw=nchw, k=k, pad=pad_top):
      return F.max_pool2d(nchw, k, k, padding=pad, ceil_mode=True)

    check(torch.equal(library().permute(0, 2, 3, 1),
                      pooling.max_pool(x, (k, k), (k, k), 'SAME')),
          'F.max_pool2d computes another function at {}'.format(name))
    ms = median_ms(lambda: pooling.max_pool(x, (k, k), (k, k), 'SAME'))
    plain = median_ms(
        lambda: pooling.max_pool_plain(x, (k, k), (k, k), 'SAME'))
    lib = median_ms(library)
    out_elems = shape[0] * ho * wo * shape[3]
    bound, by = bound_ms((x.numel() + out_elems) * 4, x.numel())
    bound_by.add(by)
    print('max_pool {} {} f32: {:.4f} ms, plain {:.4f} ms, F.max_pool2d '
          '{:.4f} ms, bound {:.4f} ms ({}); {} call(s) per batch'.format(
              name, list(shape), ms, plain, lib, bound, by, calls))
    for key, value in (('ms', ms), ('plain_ms', plain), ('bound_ms', bound),
                       ('library_ms', lib)):
      totals[key] += calls * value
  return dict(name='max_pool', route='cuda',
              source='tensor2robot_tpu_torch/csrc/max_pool.cu',
              replaces='tensor2robot_tpu/layers/pallas_pooling.py:205',
              max_abs_err=err, bound_by='/'.join(sorted(bound_by)),
              shapes='per batch: stem + pool2 + {} x pool3, f32'.format(
                  CEM_ITERS + 1), **totals)


def spread_weights(variables, gen):
  """Redraws the random weights at unit-preserving scale.

  The reference initializer (truncated normal, std 0.01) shrinks the
  activations through 19 layers until every candidate scores about 0.5;
  fan-in scaling and random batch norm statistics keep them at unit scale,
  so the Q-values spread and the CEM has something to choose.
  """
  out = {}
  for name, value in variables['params'].items():
    leaf = name.rsplit('.', 1)[-1]
    shape, dev = value.shape, value.device
    if leaf == 'weight':
      fan_in = value[0].numel()
      new = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
    elif leaf == 'var':
      new = torch.rand(shape, generator=gen) + 0.5
    elif leaf == 'scale':
      new = 1.0 + 0.1 * torch.randn(shape, generator=gen)
    else:  # bias, mean
      new = 0.1 * torch.randn(shape, generator=gen)
    new = new.to(dev)
    if value.dim() == 4:
      new = new.contiguous(memory_format=torch.channels_last)
    out[name] = new
  return {'params': out, 'avg_params': dict(out)}


def phase_slice(device):
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.layers import pooling
  from tensor2robot_tpu_torch.preprocessors import pallas_crop
  from tensor2robot_tpu_torch.serving import serve
  from tensor2robot_tpu_torch.serving.server import PolicyServer
  from tensor2robot_tpu_torch.serving.server import ServingConfig

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model, variables, batch_select = serve.build_policy(
      device=device, num_convs=NUM_CONVS, cem_samples=CEM_SAMPLES,
      cem_iters=CEM_ITERS, num_elites=NUM_ELITES, seed=0)
  variables = spread_weights(variables, torch.Generator().manual_seed(1))
  spec = model.serving_feature_spec()
  rng = np.random.RandomState(0)
  states = [serve.synthetic_state(spec, rng) for _ in range(MAX_BATCH)]
  stacked = {k: np.stack([s[k] for s in states]) for k in spec}
  batch_select(variables, stacked, 0)   # first launches, cuDNN set-up
  torch.cuda.synchronize()

  server = PolicyServer(batch_select, variables,
                        ServingConfig(max_batch_size=MAX_BATCH,
                                      max_wait_ms=5.0, max_queue_depth=64,
                                      slo_ms=33.0),
                        feature_spec=spec)
  results, errors = [], []

  def client(index):
    for _ in range(ROUNDS):
      futures = [server.submit(states[(index + j) % MAX_BATCH])
                 for j in range(PER_ROUND)]
      for future in futures:
        try:
          results.append(future.result(timeout=120))
        except Exception as e:  # noqa: BLE001 — counted, then fails below
          errors.append(repr(e))

  server.start()
  threads = [threading.Thread(target=client, args=(i,))
             for i in range(THREADS)]
  kernels.reset_launches()
  start = time.monotonic()
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=600)
  elapsed = time.monotonic() - start
  launches = dict(kernels.LAUNCHES)
  stats = server.stats()
  # A lone robot: one request at a time, each batch padded to 8 rows.
  lone = [server.select_action(states[i], timeout_s=120).latency_ms
          for i in range(MAX_BATCH)]
  server.close()

  requests = THREADS * ROUNDS * PER_ROUND
  check(not any(t.is_alive() for t in threads), 'clients did not finish')
  check(not errors, 'requests failed: {}'.format(errors[:3]))
  check(len(results) == requests, 'answered {} of {} requests'.format(
      len(results), requests))
  check(stats['errors_total'] == 0, 'serving/errors is {}'.format(
      stats['errors_total']))
  for result in results:
    action, q = result.outputs['action'], result.outputs['q']
    check(action.shape == (8,) and np.isfinite(action).all(),
          'bad action {}'.format(action))
    check(np.isfinite(q) and 0.0 <= q <= 1.0, 'bad q {}'.format(q))
  batches = int(stats['batches_total'])
  # Per batch: one crop; the image tower's two pools; the head's pool once
  # for each CEM iteration and once more to score the chosen action.
  want = {'crop_convert': batches,
          'max_pool': batches * (2 + CEM_ITERS + 1)}
  check(launches == want, 'launch counts {} != expected {} for {} '
        'batches'.format(launches, want, batches))
  latencies = np.array([r.latency_ms for r in results])
  p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
  qs = np.array([float(r.outputs['q']) for r in results])
  print('slice: {} requests from {} threads in {} batches, 0 errors; '
        'launches {}; p50 {:.2f} ms, p99 {:.2f} ms, {:.2f} actions/s; q in '
        '[{:.4f}, {:.4f}]; {}'.format(
            requests, THREADS, batches, launches, p50, p99,
            requests / elapsed, qs.min(), qs.max(), smi_line()))
  print('slice, one request at a time: p50 {:.2f} ms, max {:.2f} ms over '
        '{} requests'.format(np.percentile(lone, 50), max(lone), len(lone)))

  # One batch through the kernels and through the plain versions. The
  # kernels are bit-exact with their plain versions, so the two runs can
  # differ only where cuDNN sums in another order between calls: a
  # tolerance of 1e-4 on q (a probability) and on the action covers that.
  got = batch_select(variables, stacked, 7)
  with mock.patch.object(pooling, 'max_pool', pooling.max_pool_plain), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    want = batch_select(variables, stacked, 7)
  torch.cuda.synchronize()
  q_err = max_abs_err(got['q'], want['q'])
  a_err = max_abs_err(got['action'], want['action'])
  check(q_err <= 1e-4 and a_err <= 1e-4,
        'kernel path vs plain path: q err {}, action err {}'.format(
            q_err, a_err))
  print('slice vs plain versions, one batch: max |dq| {:.3g}, max '
        '|daction| {:.3g} (tolerance 1e-4)'.format(q_err, a_err))
  phase_profile(batch_select, variables, stacked)
  return launches


def phase_profile(batch_select, variables, stacked, batches=3):
  """Where a served batch's time goes: device time by kernel, from
  torch.profiler over a few full batches, and the device's busy share."""
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.monotonic()
    for seed in range(batches):
      batch_select(variables, stacked, seed)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) * 1e3
  rows = []
  for event in prof.key_averages():
    # Kernels only: the host-side aten ops carry their kernels' device
    # time too, and would count it twice.
    if event.device_type != torch.autograd.DeviceType.CUDA:
      continue
    device_us = event.self_device_time_total
    if device_us > 0:
      rows.append((device_us / 1e3 / batches, event.count // batches,
                   event.key))
  if not rows:
    print('profile: the profiler saw no device time; not measured')
    return
  rows.sort(reverse=True)
  busy_ms = sum(ms for ms, _, _ in rows)
  print('profile: {:.2f} ms wall per batch of {}, kernels busy {:.2f} ms '
        '({:.1%})'.format(wall_ms / batches, MAX_BATCH, busy_ms,
                          busy_ms / (wall_ms / batches)))
  for ms, count, name in rows[:12]:
    print('  {:8.3f} ms {:5.1%} x{:<4d} {}'.format(ms, ms / busy_ms, count,
                                                   name[:90]))


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; nothing measured.', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  device = torch.device('cuda')
  gen = torch.Generator(device=device).manual_seed(0)
  phase_device()
  crop = phase_crop(device, gen)
  pool = phase_pool(device, gen)
  launches = phase_slice(device)
  for entry in (crop, pool):
    entry['launches'] = launches[entry['name']]
    check(entry['launches'] > 0, '{} never launched on the main path'
          .format(entry['name']))
  print(json.dumps({'kernels': [crop, pool]}))
  print(smi_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
