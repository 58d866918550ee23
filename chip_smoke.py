#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (tensor2robot_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, and prints no result, without a card or without the
repository around it. Phases, each printing one line or more:

  1. Device: the card's name and power limit; builds the CUDA kernels from
     ``tensor2robot_tpu_torch/csrc`` (one nvcc per source, in parallel).
  2. Kernel parity: each kernel's wrapper against its plain PyTorch
     version on the card, at the shapes the serving and training paths
     give it, timed (median of 30 CUDA-event-timed calls) beside its bound
     and, where one PyTorch call computes the same function, that call.
     K1, K2f and K2b must agree bit for bit; K3 (the 5x5 weight gradient)
     within 1e-4 of max|plain|, the float32 sums being taken in another
     order; K4 (the flash attention forward) at the served shape (8 heads
     x 4096 x 64, causal, read by strides out of the qkv projection, f32
     and bf16) and at odd shapes, O within 1e-5 (f32) or 2e-2 (bf16) and
     LSE within 1e-5, timed beside scaled_dot_product_attention.
  3. Serving: the full-width Grasping44 CEM policy (num_convs (6, 6, 3),
     512x640 frames cropped to 472, CEM 64 x 3 with 10 elites) behind a
     PolicyServer with max_batch_size 8, answering requests from 4
     threads. The kernels' launch counters are zeroed just before and
     read just after; every kernel must have launched as often as the
     batches imply. Then one request at a time, one batch rerun through
     the plain versions, and a profile of full batches.
  4. Training: ``train_eval_model`` trains the full-width critic for
     TRAIN_STEPS steps at batch 32 on random uint8 frames, resuming from
     a step-0 checkpoint of random weights at fan-in scale in a temporary
     model_dir, with the counters zeroed just before and read just after:
     1 K1, 3 K2f, 3 K2b and 6 K3 launches a step. The loss must be finite
     and the checkpoint must restore equal to the final state. Then one
     step through the kernels and through the plain versions (loss and
     every gradient must agree), a profile of train steps, and one batch
     served on the trained variables, whose q must be the trained
     avg_params' forward and not the untrained weights'.
  5. Seq2Act serving: the long-context RT-1-style policy at full width
     (512-frame episodes, 4,096 tokens, 8 blocks, attention_mode 'flash',
     float32 with TF32 off) restored by CheckpointPredictor from a
     checkpoint of random weights and stepped by
     SequentialRegressionPolicy, with the counters zeroed just before and
     read just after: 1 K1 and 8 K4 launches a predict. Actions must be
     finite bin centers in [-1, 1]; one forward through the kernels must
     match the plain versions' (logits within 1e-4 of their max). Then a
     profile of two SelectAction calls.
  6. A JSON line of the kernels, the card's name and power limit, and
     the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
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
TRAIN_BATCH, TRAIN_STEPS = 32, 8        # train_qtopt.gin's batch size
# The training pools, each run once a step: (name, input NHWC, window).
TRAIN_POOLS = (
    ('stem 236->79', (TRAIN_BATCH, 236, 236, 64), 3),
    ('pool2 79->27', (TRAIN_BATCH, 79, 79, 64), 3),
    ('pool3 27->14', (TRAIN_BATCH, 27, 27, 64), 2),
)
BODY_CONV = (TRAIN_BATCH, 79, 79, 64)  # conv2..conv7's map
BODY_CONVS = NUM_CONVS[0]
WGRAD_RTOL = 1e-4   # of max|plain|: float32 sums in another order
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


def phase_pool_backward(device, gen):
  from tensor2robot_tpu_torch.layers import pooling

  cases = [(name, shape, k, 'SAME') for name, shape, k in TRAIN_POOLS]
  cases.append(('valid 29x31', (8, 29, 31, 64), 3, 'VALID'))
  for name, shape, k, padding in cases:
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(shape, device=device, generator=gen).to(dtype)
      _, idx = pooling.max_pool_forward(x, (k, k), (k, k), padding, True)
      dy = torch.randn(idx.shape, device=device, generator=gen).to(dtype)
      got = pooling.max_pool_backward(dy, idx, shape, (k, k), padding)
      want = pooling.max_pool_backward_plain(dy, idx, shape, (k, k), padding)
      torch.cuda.synchronize()
      check(got.dtype == dtype and torch.equal(got, want),
            'max_pool_backward differs from plain ({}, {})'.format(name,
                                                                  dtype))
  print('max_pool_backward: bit-exact at {} geometries in f32 and bf16'
        .format(len(cases)))

  def library_for(x, dy, k, pad):
    """The library's backward of the same pool (aten's, on channels_last
    NCHW views, with the indices of its own forward)."""
    nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, indices = torch.nn.functional.max_pool2d(
        nchw, k, k, padding=pad, ceil_mode=True, return_indices=True)
    return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dy_nchw, nchw, [k, k], [k, k], [pad, pad], [1, 1], True, indices)

  totals = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'library_ms': 0.0}
  bound_by = set()
  for name, shape, k in TRAIN_POOLS:
    (ho, wo), (pad, _), _ = pooling.pool_geometry(shape, (k, k), (k, k),
                                                  'SAME')
    # The library picks the row-major first of tied maxima, K2b the
    # stage-wise first: compare them on one frame of distinct values.
    one = (1,) + shape[1:]
    x = torch.randperm(int(np.prod(one)), device=device,
                       generator=gen).to(torch.float32).reshape(one)
    _, idx = pooling.max_pool_forward(x, (k, k), (k, k), 'SAME', True)
    dy = torch.randn(idx.shape, device=device, generator=gen)
    check(torch.equal(library_for(x, dy, k, pad)().permute(0, 2, 3, 1),
                      pooling.max_pool_backward(dy, idx, one, (k, k),
                                                'SAME')),
          'the library pool backward computes another function at {}'
          .format(name))
    x = torch.randn(shape, device=device, generator=gen)
    _, idx = pooling.max_pool_forward(x, (k, k), (k, k), 'SAME', True)
    dy = torch.randn(idx.shape, device=device, generator=gen)
    library = library_for(x, dy, k, pad)
    ms = median_ms(
        lambda: pooling.max_pool_backward(dy, idx, shape, (k, k), 'SAME'))
    plain = median_ms(lambda: pooling.max_pool_backward_plain(
        dy, idx, shape, (k, k), 'SAME'))
    lib = median_ms(library)
    # dx written, dy and the int8 index read once; one compare per dx.
    bound, by = bound_ms(x.numel() * 4 + dy.numel() * 5, x.numel())
    bound_by.add(by)
    print('max_pool_backward {} {} f32: {:.4f} ms, plain {:.4f} ms, aten '
          'max_pool2d_with_indices_backward {:.4f} ms, bound {:.4f} ms ({}); '
          '1 call per train step'.format(name, list(shape), ms, plain, lib,
                                         bound, by))
    for key, value in (('ms', ms), ('plain_ms', plain), ('bound_ms', bound),
                       ('library_ms', lib)):
      totals[key] += value
  return dict(name='max_pool_backward', route='cuda',
              source='tensor2robot_tpu_torch/csrc/max_pool_backward.cu',
              replaces='tensor2robot_tpu/layers/pallas_pooling.py:232',
              max_abs_err=0.0, bound_by='/'.join(sorted(bound_by)),
              shapes='per train step: stem + pool2 + pool3 at batch {}, f32'
              .format(TRAIN_BATCH), **totals)


def phase_wgrad(device, gen):
  from tensor2robot_tpu_torch.layers import wgrad

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  err = 0.0
  for shape in (BODY_CONV, (4, 19, 23, 64)):
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(shape, device=device, generator=gen).to(dtype)
      dy = torch.randn(shape, device=device, generator=gen).to(dtype)
      got = wgrad.conv5x5_wgrad(x, dy)
      want = wgrad.conv5x5_wgrad_plain(x, dy)
      torch.cuda.synchronize()
      e = max_abs_err(got, want)
      limit = WGRAD_RTOL * float(want.abs().max())
      check(got.dtype == torch.float32 and got.shape == want.shape and
            e <= limit, 'conv5x5_wgrad {} {}: max err {} > {}'.format(
                list(shape), dtype, e, limit))
      check(torch.equal(wgrad.conv5x5_wgrad(x, dy), got),
            'conv5x5_wgrad is not the same from run to run')
      err = max(err, e)
      print('conv5x5_wgrad {} {}: max |err| {:.3g} = {:.3g} of max|plain| '
            '(tolerance {:g}); the same bits run to run'.format(
                list(shape), str(dtype).split('.')[-1], e,
                e / float(want.abs().max()), WGRAD_RTOL))

  b, h, w, c = BODY_CONV
  x = torch.randn(BODY_CONV, device=device, generator=gen)
  dy = torch.randn(BODY_CONV, device=device, generator=gen)
  nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)

  def library():
    return torch.nn.grad.conv2d_weight(nchw, (c, c, 5, 5), dy_nchw, 1, 2)

  # The same function up to the order and the method of its sums (cuDNN
  # picks its algorithm; the error is printed): a wrong layout would differ
  # by the size of the result.
  ours = wgrad.conv5x5_wgrad(x, dy)
  lib_err = {}
  for deterministic in (False, True):
    torch.backends.cudnn.deterministic = deterministic
    want = library()
    lib_err[deterministic] = (max_abs_err(want.permute(2, 3, 1, 0), ours) /
                              float(want.abs().max()))
  torch.backends.cudnn.deterministic = False
  print('cuDNN conv2d_weight vs K3: {:.3g} of its max ({:.3g} with '
        'cudnn.deterministic)'.format(lib_err[False], lib_err[True]))
  lib_err = lib_err[False]
  check(lib_err <= 0.1, 'conv2d_weight computes another function ({:.3g} '
        'of its max)'.format(lib_err))
  ms = median_ms(lambda: wgrad.conv5x5_wgrad(x, dy))
  plain = median_ms(lambda: wgrad.conv5x5_wgrad_plain(x, dy))
  lib = median_ms(library)
  # Only the (offset, position) pairs whose shifted x lies inside the image
  # multiply real data; the rest multiply the SAME pad's zeros. Offset a
  # covers h - |a - 2| rows, offset b w - |b - 2| columns.
  rows = sum(max(h - abs(a - 2), 0) for a in range(5))
  cols = sum(max(w - abs(a - 2), 0) for a in range(5))
  flops = 2 * c * c * b * rows * cols
  bound, by = bound_ms((x.numel() + dy.numel()) * 4 + 25 * c * c * 4, flops)
  print('conv5x5_wgrad {} f32: {:.4f} ms ({:.1f} TFLOP/s), plain {:.4f} ms, '
        'cuDNN conv2d_weight (TF32 off) {:.4f} ms (differs from K3 by '
        '{:.3g} of its max), bound {:.4f} ms ({}); {} calls per train step'
        .format(list(BODY_CONV), ms, flops / ms / 1e9, plain, lib, lib_err,
                bound, by, BODY_CONVS))
  return dict(name='conv5x5_wgrad', route='cuda',
              source='tensor2robot_tpu_torch/csrc/conv5x5_wgrad.cu',
              replaces='tensor2robot_tpu/layers/pallas_wgrad.py:112',
              max_abs_err=err, ms=BODY_CONVS * ms,
              plain_ms=BODY_CONVS * plain, bound_ms=BODY_CONVS * bound,
              bound_by=by, library_ms=BODY_CONVS * lib,
              shapes='per train step: {} x {} f32'.format(
                  BODY_CONVS, list(BODY_CONV)))


def spread_weights(state, gen):
  """A network state dict's random weights, redrawn at unit-preserving
  scale.

  The reference initializer (truncated normal, std 0.01) shrinks the
  activations through 19 layers until every candidate scores about 0.5;
  fan-in scaling and random batch norm statistics keep them at unit scale,
  so the Q-values spread and the CEM has something to choose.
  """
  out = {}
  for name, value in state.items():
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
  return out


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
  params = spread_weights(variables['params'],
                          torch.Generator().manual_seed(1))
  variables = {'params': params, 'avg_params': dict(params)}
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
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': batches,
               'max_pool': batches * (2 + CEM_ITERS + 1)})
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


def _states_equal(a, b):
  def leaves(tree, prefix=''):
    if isinstance(tree, dict):
      for key, value in tree.items():
        yield from leaves(value, prefix + '/' + key)
    else:
      yield prefix, tree
  la, lb = dict(leaves(vars(a))), dict(leaves(vars(b)))
  return la.keys() == lb.keys() and all(
      torch.equal(v, lb[k]) if isinstance(v, torch.Tensor) else v == lb[k]
      for k, v in la.items())


def _gradients(model, state, features, labels):
  from tensor2robot_tpu_torch.modes import ModeKeys

  params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
  loss, _ = model.loss_fn(params, state.model_state, features, labels,
                          ModeKeys.TRAIN)
  grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
  return loss.detach(), {k: g for k, g in zip(params, grads)
                         if g is not None}


def phase_train(device):
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.layers import pooling
  from tensor2robot_tpu_torch.layers import wgrad
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.preprocessors import pallas_crop
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device=device, network_kwargs={'num_convs': NUM_CONVS})
  data = input_generators.DefaultRandomInputGenerator(batch_size=TRAIN_BATCH)
  # Training resumes from a step-0 checkpoint of weights at fan-in scale:
  # from the reference initializer's, 8 steps leave the running batch norm
  # statistics near (0, 1) while the activations are tiny, so the eval
  # forward would score every candidate 0.5 and the served batch below
  # could not tell trained weights from any others.
  initial = model.create_train_state(torch.Generator().manual_seed(0))
  spread = spread_weights({**initial.params, **initial.model_state},
                          torch.Generator().manual_seed(2))
  initial.params = {k: spread[k] for k in initial.params}
  initial.model_state = {k: spread[k] for k in initial.model_state}
  initial.avg_params = {k: v.clone() for k, v in initial.params.items()}
  with tempfile.TemporaryDirectory() as model_dir:
    checkpointing.CheckpointManager(model_dir).save(initial)
    kernels.reset_launches()
    start = time.monotonic()
    result = train_eval.train_eval_model(
        model, model_dir, data, max_train_steps=TRAIN_STEPS,
        log_every_n_steps=1, save_checkpoints_steps=TRAIN_STEPS)
    elapsed = time.monotonic() - start
    launches = dict(kernels.LAUNCHES)
    state, trainer = result['state'], result['trainer']
    restored = checkpointing.CheckpointManager(model_dir).restore(
        device=device)
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': TRAIN_STEPS, 'max_pool': 3 * TRAIN_STEPS,
               'max_pool_backward': 3 * TRAIN_STEPS,
               'conv5x5_wgrad': BODY_CONVS * TRAIN_STEPS})
  check(launches == want, 'train launch counts {} != expected {} for {} '
        'steps'.format(launches, want, TRAIN_STEPS))
  loss = trainer.last_metrics['loss']
  check(state.step == TRAIN_STEPS and np.isfinite(loss),
        'training ended at step {} with loss {}'.format(state.step, loss))
  check(_states_equal(restored, state),
        'the checkpoint does not restore the final state')
  # One log window per step; each ends with the step's metrics on the
  # host, so it times the whole step. The first pays for cuDNN's set-up.
  steps = trainer.windows[1:]
  step_ms = statistics.median(w[1] * 1e3 for w in steps)
  compute_ms = statistics.median((w[1] - w[2]) * 1e3 for w in steps)
  print('train: {} steps of batch {} in {:.1f}s, launches {}; loss {:.4f} '
        '(grasp {:.4f}, l2 {:.6f}); median step {:.2f} ms ({:.1f} examples/s)'
        ', of which {:.2f} ms after the batch was ready; checkpoint restores '
        'equal; {}'.format(
            TRAIN_STEPS, TRAIN_BATCH, elapsed, launches, loss,
            trainer.last_metrics['grasp_loss'],
            trainer.last_metrics['l2_loss'], step_ms,
            TRAIN_BATCH * 1e3 / step_ms, compute_ms, smi_line()))

  # One step through the kernels and through the plain versions, on the
  # same batch and crop offsets. K1 and K2b are bit-exact with their plain
  # versions and K3 sums in another order, so the weight gradients of the
  # body convs differ by float32 rounding; cuDNN's own kernels may too, as
  # they sum in an order that can change between calls.
  numpy_features, numpy_labels = next(data.create_dataset_iterator(
      ModeKeys.TRAIN, seed=0, prefetch=0))
  raw, labels = trainer.put_batch(numpy_features), trainer.put_batch(
      numpy_labels)
  offsets = torch.tensor([[0, 0], [40, 168]] * (TRAIN_BATCH // 2),
                         dtype=torch.int32, device=device)

  def one_step():
    features, _ = model.preprocessor.preprocess(raw, None, ModeKeys.TRAIN,
                                                offsets=offsets)
    return features['state/image'], _gradients(model, state, features,
                                               labels)

  image, (got_loss, got) = one_step()
  with mock.patch.object(pooling, 'max_pool_forward',
                         pooling.max_pool_plain), \
      mock.patch.object(pooling, 'max_pool_backward',
                        pooling.max_pool_backward_plain), \
      mock.patch.object(wgrad, 'conv5x5_wgrad', wgrad.conv5x5_wgrad_plain), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    before = dict(kernels.LAUNCHES)
    plain_image, (want_loss, want) = one_step()
    check(kernels.LAUNCHES == before, 'the plain step launched a kernel')
  torch.cuda.synchronize()
  check(torch.equal(image, plain_image), 'the TRAIN crop differs from plain')
  check(got.keys() == want.keys(), 'gradient names differ')
  loss_err = abs(float(got_loss) - float(want_loss))
  check(loss_err <= 1e-5 * abs(float(want_loss)),
        'loss: kernels {} vs plain {}'.format(float(got_loss),
                                              float(want_loss)))
  # The biases of the per-block grasp denses are 0 in exact arithmetic:
  # the train-mode bngrasp subtracts the batch mean of their sum. Both
  # sides are rounding noise there (run F read some 8e-8 of the network's
  # largest gradient), held to 1e-6 of that gradient.
  largest = max(float(g.abs().max()) for g in want.values())
  zero = {'{}.{}.bias'.format(t2r_models._NETWORK, name) for name, _, _
          in getattr(model.network, t2r_models._NETWORK)._blocks}
  check(zero <= want.keys(), 'no gradient of {}'.format(zero - want.keys()))
  worst_zero = max((max_abs_err(got[k], want[k]) / largest, k) for k in zero)
  check(worst_zero[0] <= 1e-6, 'gradients that are 0 in exact arithmetic: '
        'kernels vs plain differ by {:.3g} of the largest gradient at {}'
        .format(*worst_zero))
  # Every other gradient within 1e-4 of its scale: its largest magnitude,
  # taken no lower than 1e-3 of the network's largest gradient. cuDNN's
  # input gradients sum in an order that can change between calls, which
  # leaves an error of the order of 1e-7 of the largest gradient on every
  # gradient downstream, however small that gradient is itself.
  floor = 1e-3 * largest
  errors = sorted(((max_abs_err(got[k], want[k]) /
                    max(float(want[k].abs().max()), floor), k)
                   for k in want if k not in zero), reverse=True)
  check(errors[0][0] <= 1e-4, 'gradients: kernels vs plain differ by {:.3g} '
        'of their scale at {}'.format(*errors[0]))
  print('train step, kernels vs plain versions: |dloss| {:.3g} (tolerance '
        '1e-5 relative); worst gradients {} of their scale (tolerance 1e-4);'
        ' the zero-in-exact-arithmetic grasp biases differ by at most {:.3g} '
        'of the largest gradient at {} (tolerance 1e-6); crop bit-exact'
        .format(loss_err, ', '.join('{:.3g} at {}'.format(*e)
                                    for e in errors[:3]), *worst_zero))

  phase_train_profile(trainer, model, state, raw, labels)
  phase_train_serve(model, initial, state)
  return launches


def phase_train_serve(model, initial, state):
  """The trained variables are the serving dict: a served batch scores its
  chosen actions as a forward of the trained ``avg_params`` and batch norm
  statistics does, and otherwise than the untrained weights."""
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.qtopt import networks
  from tensor2robot_tpu_torch.serving import serve

  batch_select = model.make_batched_select_action(CEM_SAMPLES, CEM_ITERS,
                                                  NUM_ELITES)
  spec = model.serving_feature_spec()
  rng = np.random.RandomState(1)
  requests = [serve.synthetic_state(spec, rng) for _ in range(MAX_BATCH)]
  states = {k: np.stack([r[k] for r in requests]) for k in spec}
  served = batch_select(state.variables(), states, 0)
  check(served['action'].shape == (MAX_BATCH, 8) and
        bool(torch.isfinite(served['action']).all()) and
        bool(torch.isfinite(served['q']).all()),
        'the trained weights serve non-finite actions')

  # The served action and 15 random ones per state, scored by the network
  # on explicitly named weights, without the serving code.
  device = model.device
  candidates = torch.cat([served['action'][:, None], torch.rand(
      (MAX_BATCH, 15, 8), generator=torch.Generator().manual_seed(3)).to(
          device) * 2 - 1], dim=1)
  scalars = {k: torch.as_tensor(states[k], dtype=torch.float32).to(device)
             .reshape(MAX_BATCH, 1, 1).expand(MAX_BATCH, 16, 1)
             for k in ('gripper_closed', 'height_to_bottom')}
  grasp = torch.cat([candidates, scalars['gripper_closed'],
                     scalars['height_to_bottom']], dim=-1).reshape(-1, 10)
  features = {'state/image': model.preprocessor.preprocess_images(
      torch.as_tensor(states['image']).to(device))}
  for key, (offset, size) in zip(networks.E2E_GRASP_PARAM_KEYS,
                                 networks.E2E_GRASP_PARAM_NAMES.values()):
    features['action/' + key] = grasp[:, offset:offset + size]

  def score(weights, buffers):
    with torch.inference_mode():
      outputs = torch.func.functional_call(
          model.network, {**weights, **buffers}, (features,),
          {'mode': ModeKeys.PREDICT}, strict=True)
    return (outputs['q_predicted'].reshape(MAX_BATCH, 16),
            outputs['q_logits'].reshape(MAX_BATCH, 16))

  q_avg, logits_avg = score(state.avg_params, state.model_state)
  _, logits_params = score(state.params, state.model_state)
  _, logits_untrained = score(initial.avg_params, initial.model_state)
  torch.cuda.synchronize()
  q_err = max_abs_err(served['q'], q_avg[:, 0])
  spread = float(logits_avg.max() - logits_avg.min())
  moved = max_abs_err(logits_avg, logits_untrained)
  check(q_err <= 1e-4, 'served q differs from the trained avg_params\' '
        'forward by {:.3g}'.format(q_err))
  check(spread >= 0.1, 'the trained eval forward scores every candidate '
        'alike (logits spread {:.3g})'.format(spread))
  check(moved >= 1e-3, 'the trained weights score as the untrained ones '
        '(max |dlogit| {:.3g})'.format(moved))
  print('train -> serve: the trained variables answer a batch of {}; served '
        'q (in [{:.4f}, {:.4f}]) equals the trained avg_params\' forward '
        'within {:.3g} (tolerance 1e-4); over 16 candidates a state the '
        'logits spread {:.3g} (at least 0.1) and differ from the untrained '
        'weights\' by up to {:.3g} (at least 1e-3) and from params\' by up '
        'to {:.3g}'.format(
            MAX_BATCH, float(served['q'].min()), float(served['q'].max()),
            q_err, spread, moved, max_abs_err(logits_avg, logits_params)))


def phase_train_profile(trainer, model, state, raw, labels, steps=3):
  """Where a train step's time goes: device time by kernel over a few
  steps (crop + forward + backward + optimizer + EMA) and the device's
  busy share of the wall time."""
  from torch.profiler import ProfilerActivity, profile
  from tensor2robot_tpu_torch.modes import ModeKeys

  def step(current):
    features, batch_labels = model.preprocessor.preprocess(
        raw, labels, ModeKeys.TRAIN, generator=trainer.crop_generator)
    current, metrics = model.train_step(current, features, batch_labels)
    float(metrics['loss'])
    return current

  state = step(state)   # warm
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.monotonic()
    for _ in range(steps):
      state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) * 1e3 / steps
  rows = [(e.self_device_time_total / 1e3 / steps, e.count // steps, e.key)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and
          e.self_device_time_total > 0]
  if not rows:
    print('train profile: the profiler saw no device time; not measured')
    return
  rows.sort(reverse=True)
  busy_ms = sum(ms for ms, _, _ in rows)
  print('train profile: {:.2f} ms wall per step of {}, kernels busy {:.2f} '
        'ms ({:.1%})'.format(wall_ms, TRAIN_BATCH, busy_ms,
                             busy_ms / wall_ms))
  for ms, count, name in rows[:16]:
    print('  {:8.3f} ms {:5.1%} x{:<4d} {}'.format(ms, ms / busy_ms, count,
                                                   name[:90]))


# The served attention: episode_length 512 x 8 tokens, 8 heads of 64.
SEQ2ACT_EPISODE, SEQ2ACT_STEPS = 512, 4
FLASH_HEADS, FLASH_LEN, FLASH_DIM = 8, 4096, 64
FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-5
LOGITS_RTOL = 1e-4   # of max|logits|: float32 sums in another order


def flash_plain_blhd(q, k, v, causal=False):
  """K4's plain version with ``flash_attention``'s signature, as the main
  path calls it."""
  from tensor2robot_tpu_torch.parallel import flash_attention

  return flash_attention.flash_attention_plain_blhd(
      q, k, v, causal, 1.0 / float(np.sqrt(q.shape[-1])))[0]


def phase_flash(device, gen):
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.parallel import flash_attention

  torch.backends.cuda.matmul.allow_tf32 = False
  h, l, d = FLASH_HEADS, FLASH_LEN, FLASH_DIM
  err = 0.0
  cases = [(1, l, h, d, True, 'served')]
  # Odd shapes: ragged 64-row tiles, head dim 128, several batches.
  cases += [(2, 200, 3, 128, True, 'odd'), (3, 72, 2, 64, False, 'odd')]
  for b, length, heads, dim, causal, name in cases:
    for dtype in (torch.float32, torch.bfloat16):
      qkv = torch.randn((b, length, heads, 3, dim), device=device,
                        generator=gen).to(dtype)
      q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
      got = flash_attention.flash_attention(q, k, v, causal=causal)
      want = flash_plain_blhd(q, k, v, causal)
      bhld = [x.permute(0, 2, 1, 3).reshape(b * heads, length, dim)
              for x in (q, k, v)]
      got_o, got_lse = flash_attention.flash_attention_with_lse(
          *bhld, causal=causal)
      want_o, want_lse = flash_attention.flash_attention_plain(
          *bhld, causal, 1.0 / float(np.sqrt(dim)))
      torch.cuda.synchronize()
      e = max(max_abs_err(got, want), max_abs_err(got_o, want_o))
      e_lse = max_abs_err(got_lse, want_lse)
      check(got.dtype == dtype and got.shape == want.shape and
            got_lse.dtype == torch.float32 and
            e <= FLASH_ATOL[dtype] and e_lse <= LSE_ATOL,
            'flash_attention {} {}: max |dO| {} (tolerance {}), max |dLSE| '
            '{} (tolerance {})'.format([b, length, heads, dim], dtype, e,
                                       FLASH_ATOL[dtype], e_lse, LSE_ATOL))
      if name == 'served' and dtype == torch.float32:
        err = e
      print('flash_attention {} {} {} {}: max |dO| {:.3g} (tolerance {:g}), '
            'max |dLSE| {:.3g} (tolerance {:g})'.format(
                name, [b, length, heads, dim], 'causal' if causal else
                'full', str(dtype).split('.')[-1], e, FLASH_ATOL[dtype],
                e_lse, LSE_ATOL))

  # The served call: q, k, v strided views of one float32 qkv projection.
  qkv = torch.randn((1, l, h, 3, d), device=device, generator=gen)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  bhl = [x.transpose(1, 2) for x in (q, k, v)]   # [B, H, L, D] views

  def library():
    return F.scaled_dot_product_attention(*bhl, is_causal=True)

  lib_err = max_abs_err(library().transpose(1, 2),
                        flash_attention.flash_attention(q, k, v, causal=True))
  check(lib_err <= 1e-2, 'scaled_dot_product_attention computes another '
        'function ({:.3g})'.format(lib_err))
  ms = median_ms(lambda: flash_attention.flash_attention(q, k, v,
                                                         causal=True))
  plain = median_ms(lambda: flash_plain_blhd(q, k, v, True))
  lib = median_ms(library)
  # The products with unmasked pairs (q_pos >= k_pos): two of D
  # multiply-adds each, for s and for p @ v.
  pairs = h * l * (l + 1) // 2
  flops = 4 * d * pairs
  bound, by = bound_ms(4 * q.numel() * 4 + h * l * 4, flops)
  print('flash_attention served [1,{},{},{}] causal f32: {:.4f} ms ({:.1f} '
        'TFLOP/s), plain {:.4f} ms, scaled_dot_product_attention {:.4f} ms '
        '(differs by {:.3g}), bound {:.4f} ms ({}); {} calls per '
        'predict'.format(l, h, d, ms, flops / ms / 1e9, plain, lib, lib_err,
                         bound, by, 8))
  return dict(name='flash_attention_fwd', route='cuda',
              source='tensor2robot_tpu_torch/csrc/flash_attention_fwd.cu',
              replaces='tensor2robot_tpu/parallel/flash_attention.py:202',
              max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
              bound_by=by, library_ms=lib,
              shapes='per launch: [1,{},{},{}] causal f32, q/k/v strided '
              'views of the qkv projection'.format(l, h, d))


def phase_seq2act(device):
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.models.abstract_model import TrainState
  from tensor2robot_tpu_torch.parallel import flash_attention
  from tensor2robot_tpu_torch.policies import SequentialRegressionPolicy
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.preprocessors import pallas_crop
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.research.vrgripper import decoders
  from tensor2robot_tpu_torch.trainer import checkpointing

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                         attention_mode='flash', device=device)
  rng = np.random.RandomState(5)
  frames = [rng.randint(0, 256, (136, 168, 3), dtype=np.uint8)
            for _ in range(SEQ2ACT_STEPS + 1)]
  with tempfile.TemporaryDirectory() as model_dir:
    # Random weights at the flax initializers' fan-in scale, seed 4.
    params = model.init_variables(torch.Generator().manual_seed(4))['params']
    checkpointing.CheckpointManager(model_dir).save(TrainState(
        step=1, params=params, model_state={}, opt_state=None))
    predictor = CheckpointPredictor(model, model_dir, timeout=60.0)
    policy = SequentialRegressionPolicy(model, predictor=predictor)
    check(policy.restore() and predictor.model_version == 1,
          'CheckpointPredictor did not restore the checkpoint')
  policy.reset()
  first = policy.SelectAction({'image': frames[0]}, None, 0)  # warm
  torch.cuda.synchronize()
  actions, wall_ms = [first], []
  kernels.reset_launches()
  for step, frame in enumerate(frames[1:], 1):
    start = time.monotonic()
    actions.append(policy.SelectAction({'image': frame}, None, step))
    wall_ms.append((time.monotonic() - start) * 1e3)
  launches = dict(kernels.LAUNCHES)
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': SEQ2ACT_STEPS,
               'flash_attention_fwd': 8 * SEQ2ACT_STEPS})
  check(launches == want, 'seq2act launch counts {} != expected {} for {} '
        'predicts'.format(launches, want, SEQ2ACT_STEPS))
  centers = set(decoders.get_discrete_bins(256, -1.0, 1.0).tolist())
  for action in actions:
    check(action.shape == (7,) and np.isfinite(action).all() and
          np.abs(action).max() <= 1.0 and set(action.tolist()) <= centers,
          'bad seq2act action {}'.format(action))
  print('seq2act: {} SelectAction calls over a {}-frame window ({} tokens), '
        'launches {}; wall per call median {:.2f} ms (min {:.2f}, max '
        '{:.2f}); {} distinct actions; {}'.format(
            SEQ2ACT_STEPS, SEQ2ACT_EPISODE, 8 * SEQ2ACT_EPISODE, launches,
            statistics.median(wall_ms), min(wall_ms), max(wall_ms),
            len({tuple(a) for a in actions}), smi_line()))

  # One forward through the kernels and through the plain versions, on the
  # window of the frames above.
  serve = export_generators.make_serve_fn(model)
  window = None
  for frame in frames:
    window = model.pack_features({'image': frame}, window, 0)
  got = serve(predictor.variables, window)
  with mock.patch.object(flash_attention, 'flash_attention',
                         flash_plain_blhd), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    before = dict(kernels.LAUNCHES)
    want_out = serve(predictor.variables, window)
    check(kernels.LAUNCHES == before, 'the plain forward launched a kernel')
  torch.cuda.synchronize()
  scale = float(want_out['action_logits'].abs().max())
  e = max_abs_err(got['action_logits'], want_out['action_logits'])
  same = float((got['action'] == want_out['action']).float().mean())
  check(e <= LOGITS_RTOL * scale, 'seq2act kernels vs plain: max |dlogit| '
        '{} > {} of max {}'.format(e, LOGITS_RTOL, scale))
  print('seq2act vs plain versions, one forward: max |dlogit| {:.3g} = '
        '{:.3g} of max|logits| {:.3g} (tolerance {:g}); {:.1%} of the '
        '{} step actions equal'.format(e, e / scale, scale, LOGITS_RTOL,
                                       same, got['action'].numel()))
  phase_seq2act_profile(policy, frames)
  return launches


def phase_seq2act_profile(policy, frames, calls=2):
  """Where a SelectAction's time goes: device time by kernel and the
  device's busy share of the wall time."""
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.monotonic()
    for step in range(calls):
      policy.SelectAction({'image': frames[step]}, None, step)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) * 1e3 / calls
  rows = [(e.self_device_time_total / 1e3 / calls, e.count // calls, e.key)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and
          e.self_device_time_total > 0]
  if not rows:
    print('seq2act profile: the profiler saw no device time; not measured')
    return
  rows.sort(reverse=True)
  busy_ms = sum(ms for ms, _, _ in rows)
  print('seq2act profile: {:.2f} ms wall per SelectAction, kernels busy '
        '{:.2f} ms ({:.1%})'.format(wall_ms, busy_ms, busy_ms / wall_ms))
  for ms, count, name in rows[:16]:
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
  pool_backward = phase_pool_backward(device, gen)
  wgrad_entry = phase_wgrad(device, gen)
  flash = phase_flash(device, gen)
  served = phase_slice(device)
  trained = phase_train(device)
  seq2act = phase_seq2act(device)
  # K1 and K2f report their serving launches, K2b and K3 their training
  # ones, K4 its seq2act ones; every path's counts are listed too.
  entries = ((crop, served), (pool, served), (pool_backward, trained),
             (wgrad_entry, trained), (flash, seq2act))
  for entry, main_path in entries:
    entry['launches'] = main_path[entry['name']]
    entry['launches_by_path'] = {'serve': served[entry['name']],
                                 'train': trained[entry['name']],
                                 'seq2act': seq2act[entry['name']]}
    check(entry['launches'] > 0, '{} never launched on the main path'
          .format(entry['name']))
  print(json.dumps({'kernels': [entry for entry, _ in entries]}))
  print(smi_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
