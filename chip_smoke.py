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
     K1, K2f and K2b must agree bit for bit (K2f and K2b also in their
     one-element instances, at 5 channels, and K2b at a dy one element
     off 16 bytes; both are timed behind a device sleep, so that the
     events time the device and not the host queueing a short call: K2f
     at the served pools and with its index at the critic's training
     pools, K2b at those training pools); K3
     (the 5x5 weight gradient, float32-grade 3xTF32 products on the tensor
     cores) within 1e-4 of max|plain|, the float32 sums being taken in
     another order; K4 (the flash attention forward, 3xTF32 on the tensor
     cores) at the served shape (8 heads
     x 4096 x 64, causal, read by strides out of the qkv projection, f32
     and bf16) and at odd shapes, O within 1e-5 (f32) or 2e-2 (bf16) and
     LSE within 1e-5, timed beside scaled_dot_product_attention (whose
     kernels the profiler names) at the served shape and at the training
     shape (batch 8); K5a and
     K5b (the flash attention backward: dk and dv, dq) at the training
     shape (batch 8) in f32 and bf16 and at an odd shape, dq, dk and dv
     within 1e-4 (f32) or 2e-2 (bf16) of each one's max|plain| and the
     same bits run to run, timed each alone beside the plain backward
     (median of 10) and the backward of scaled_dot_product_attention. K3,
     K4, K5a and K5b (3xTF32 on the tensor cores) print two bounds, the
     CUDA cores' float32 rate's and three TF32 passes at the tensor cores'
     rate (the one in the JSON line's bound_ms), and the HMMA count of
     their SASS (cuobjdump), which must not be 0.
  3. Serving: the full-width Grasping44 CEM policy (num_convs (6, 6, 3),
     512x640 frames cropped to 472, CEM 64 x 3 with 10 elites) behind a
     PolicyServer with max_batch_size 8, answering requests from 4
     threads. The kernels' launch counters are zeroed just before and
     read just after; every kernel must have launched as often as the
     batches imply. Then one request at a time, one batch rerun through
     the plain versions, the served critic's q and logits for 16 actions a
     state against the same weights and states on the CPU (CPU
     convolutions and plain versions; 1e-4 of their max), and a profile of
     full batches.
  4. Training: ``train_eval_model`` trains the full-width critic for
     TRAIN_STEPS steps at batch 32 on random uint8 frames, resuming from
     a step-0 checkpoint of random weights at fan-in scale in a temporary
     model_dir, with the counters zeroed just before and read just after:
     1 K1, 3 K2f, 3 K2b and 6 K3 launches a step. The loss must be finite
     and the checkpoint must restore equal to the final state. Then one
     step through the kernels and through the plain versions (loss and
     every gradient must agree); the same step on the CPU (CPU
     convolutions and plain versions) replaying the card's max-pool window
     indices and ReLU gates, the loss within 1e-4 relative and every
     gradient within 1e-4 of the largest; what summing the weight gradients
     of the non-K3 convs in float64 costs; a profile of train steps, and
     one batch served on the trained variables, whose q must be the
     trained avg_params' forward and not the untrained weights'.
  5. Seq2Act serving: the long-context RT-1-style policy at full width
     (512-frame episodes, 4,096 tokens, 8 blocks, attention_mode 'flash',
     float32 with TF32 off) restored by CheckpointPredictor from a
     checkpoint of random weights and stepped by
     SequentialRegressionPolicy, with the counters zeroed just before and
     read just after: 1 K1 and 8 K4 launches a predict. Actions must be
     finite bin centers in [-1, 1]; one forward through the kernels must
     match the plain versions' (logits within 1e-4 of their max), and the
     same forward on the CPU (CPU convolutions and plain versions) too.
     Then a profile of two SelectAction calls.
  6. Seq2Act training: ``train_eval_model`` trains the same full-width
     512-frame binding for SEQ2ACT_TRAIN_STEPS steps at batch 8 with adam
     (lr 1e-4) from random weights at the flax initializers' scale (seed
     0) on random uint8 episodes, float32 with TF32 off, with the counters
     zeroed just before and read just after: 1 K1 and 8 each of K4, K5a
     and K5b launches a step. Every step's loss must be finite and the
     checkpoint must restore equal. Then one step on one episode through
     the kernels and through the plain versions (loss within 1e-5
     relative, every gradient within 1e-4 of its scale), a profile of two
     steps on a resident batch, and a SequentialRegressionPolicy over a
     CheckpointPredictor restored from the trained checkpoint, whose
     logits must be the trained params' predict_step (1e-4) and not the
     untrained weights'.
  7. Ring attention's kernel: K6 (the carried flash update, the ring's
     hop) against its plain version at the 4-rank hop shape [8, 1024, 8,
     64] (diagonal, full and hidden hops from a carried state, f32 and
     bf16) and at an odd shape (Lq 100 != Lk 72, head dim 128), o, m and l
     within 1e-5 of their max, a hidden hop leaving the state as it was;
     the four-shard hop schedule of a [8, 4096, 8, 64] causal sequence
     replayed on one card, O and LSE within 1e-5 of max of K4's over the
     whole sequence; K6 timed at the main path's launch shape beside its
     plain version and at the 4-rank diagonal and full hops.
  8. Seq2Act ring training: ``min(4, cards)`` NCCL ranks, one process a
     card, each train the full-width 512-frame binding with
     ``attention_mode='ring'`` for RING_STEPS steps through
     ``train_eval_model`` (batch 8 at one rank, the gin's 32 at four), with
     the counters zeroed just before and read just after: 1 K1 and 8 x N
     K6 launches a step a rank, no K4 or K5. Every loss finite, the weights
     equal on every rank (per-tensor checksums, their minimum and maximum
     over the ranks), rank 0's checkpoint restores equal; two resident
     steps timed on every rank from a barrier, and two profiled on the
     last rank (the one with the most unmasked hops); one ring step against one flash step from the same
     state on the same 8 episodes and crops (loss within 1e-5 relative,
     every gradient within 1e-4 of its scale); the trained checkpoint
     served by the flash SequentialRegressionPolicy gives the trained
     params' logits (1e-4).
  9. A JSON line of the kernels, the card's name and power limit, and
     the last line ``{"ok": true, "device": {...}}``. K2f's and K2b's ms,
     plain_ms and library_ms are device time, each call queued behind a
     device sleep; their ms_with_host, and every other kernel's ms, is one
     call between two events as the host queues it.

Any failed check raises, so the script exits non-zero.
"""

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32 (non-tensor core)
# operations/s and dense TF32 tensor-core operations/s, the rates at the
# full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

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


def median_ms(fn, iters=30, warmup=5, host_ahead=False):
  """Median device time of one call, from CUDA events around each call.

  A call that the device finishes sooner than the host queues it times the
  host. With ``host_ahead`` each call waits behind a millisecond of device
  sleep, by which time the host has queued it and its end event: the
  events then time the device alone."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  events = [(torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
  for start, end in events:
    if host_ahead:
      torch.cuda._sleep(2_000_000)   # some 1 ms of clock cycles
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


def tensor_core_bound_ms(flops):
  """The least time for float32-grade products on the tensor cores: three
  TF32 passes (3xTF32, csrc/tf32_mma.cuh) of every product."""
  return 3 * flops / TF32_OPS_PER_S * 1e3


SASS_OPCODE = re.compile(r'\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)')
# Integer and address arithmetic, beside the products (HMMA) and the
# shared-memory loads (LDS) that the flash kernels' loops issue.
SASS_INTEGER = ('IMAD', 'IADD3', 'LOP3', 'LEA', 'SHF', 'VIADD')


def sass_opcodes(name):
  """Opcode counts over a built kernel's SASS, all its instances."""
  from tensor2robot_tpu_torch import kernels
  tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                      'cuobjdump')
  sass = subprocess.run([tool, '--dump-sass', str(kernels.library_path(name))],
                        check=True, capture_output=True, text=True).stdout
  counts = collections.Counter()
  for line in sass.splitlines():
    match = SASS_OPCODE.match(line)
    if match:
      counts[match.group(1)] += 1
  return counts


def sass_hmma(name):
  """The tensor-core (HMMA) instructions in a built kernel's SASS."""
  return sass_opcodes(name)['HMMA']


def sass_mix(name):
  """HMMA, LDS and integer-arithmetic counts of a kernel's SASS."""
  counts = sass_opcodes(name)
  return {'HMMA': counts['HMMA'], 'LDS': counts['LDS'],
          'integer': sum(counts[op] for op in SASS_INTEGER)}


def device_kernels(fn):
  """The names of the device kernels one call of ``fn`` runs, from
  torch.profiler: which of its backends a library call took."""
  from torch.profiler import ProfilerActivity, profile as torch_profile

  fn()
  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  return sorted({e.key[:120] for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA})


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
  # C = 5 takes the kernel's one-channel instance, the others 16 bytes.
  cases.append(('5 channels', (MAX_BATCH, 25, 25, 5), 3, 'SAME'))
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

  totals = {'ms': 0.0, 'ms_with_host': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
            'library_ms': 0.0}
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

    def kernel(x=x, k=k):
      return pooling.max_pool(x, (k, k), (k, k), 'SAME')

    # A pool can take the device less time than the host takes to queue it:
    # the device's times, and the kernel's one call between events beside.
    ms = median_ms(kernel, host_ahead=True)
    ms_with_host = median_ms(kernel)
    plain = median_ms(
        lambda: pooling.max_pool_plain(x, (k, k), (k, k), 'SAME'),
        host_ahead=True)
    lib = median_ms(library, host_ahead=True)
    out_elems = shape[0] * ho * wo * shape[3]
    bound, by = bound_ms((x.numel() + out_elems) * 4, x.numel())
    bound_by.add(by)
    print('max_pool {} {} f32: {:.4f} ms ({:.4f} ms one call with the '
          'host), plain {:.4f} ms, F.max_pool2d {:.4f} ms, bound {:.4f} ms '
          '({}); {} call(s) per batch'.format(
              name, list(shape), ms, ms_with_host, plain, lib, bound, by,
              calls))
    for key, value in (('ms', ms), ('ms_with_host', ms_with_host),
                       ('plain_ms', plain), ('bound_ms', bound),
                       ('library_ms', lib)):
      totals[key] += calls * value

  # The critic's training step runs each training pool once, with the int8
  # index that its backward (K2b) reads.
  train = {'ms': 0.0, 'bound_ms': 0.0}
  for name, shape, k in TRAIN_POOLS:
    x = torch.randn(shape, device=device, generator=gen)
    (ho, wo), _, _ = pooling.pool_geometry(shape, (k, k), (k, k), 'SAME')
    ms = median_ms(lambda: pooling.max_pool_forward(x, (k, k), (k, k),
                                                    'SAME', True),
                   host_ahead=True)
    out_elems = shape[0] * ho * wo * shape[3]
    bound, by = bound_ms(x.numel() * 4 + out_elems * (4 + 1), x.numel())
    print('max_pool with index {} {} f32: {:.4f} ms, bound {:.4f} ms ({}); '
          'once a critic step'.format(name, list(shape), ms, bound, by))
    train['ms'] += ms
    train['bound_ms'] += bound
  print('max_pool per served batch {:.4f} ms ({:.4f} one call at a time '
        'with the host; bound {:.4f}, F.max_pool2d {:.4f}); with the index '
        'per critic step {:.4f} ms (bound {:.4f}); {}'.format(
            totals['ms'], totals['ms_with_host'], totals['bound_ms'],
            totals['library_ms'], train['ms'], train['bound_ms'],
            smi_line()))
  return dict(name='max_pool', route='cuda',
              source='tensor2robot_tpu_torch/csrc/max_pool.cu',
              replaces='tensor2robot_tpu/layers/pallas_pooling.py:205',
              max_abs_err=err, bound_by='/'.join(sorted(bound_by)),
              shapes='per batch: stem + pool2 + {} x pool3, f32'.format(
                  CEM_ITERS + 1),
              train_step_ms=train['ms'],
              train_step_bound_ms=train['bound_ms'],
              train_step_shapes='with the int8 index: {}, f32, once each a '
                                'critic step'.format(
                                    ' + '.join(n for n, _, _ in TRAIN_POOLS)),
              **totals)


def phase_pool_backward(device, gen):
  from tensor2robot_tpu_torch.layers import pooling

  cases = [(name, shape, k, 'SAME', 0) for name, shape, k in TRAIN_POOLS]
  cases.append(('valid 29x31', (8, 29, 31, 64), 3, 'VALID', 0))
  # The one-element instance: 5 channels, and a dy one element past a
  # 16-byte boundary; the others move 16 bytes of dy a cell.
  cases.append(('5 channels', (8, 25, 25, 5), 3, 'SAME', 0))
  cases.append(('dy off 16 bytes', (8, 79, 79, 64), 3, 'SAME', 1))
  for name, shape, k, padding, offset in cases:
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(shape, device=device, generator=gen).to(dtype)
      _, idx = pooling.max_pool_forward(x, (k, k), (k, k), padding, True)
      dy = torch.randn(idx.numel() + offset, device=device,
                       generator=gen).to(dtype)[offset:].view(idx.shape)
      got = pooling.max_pool_backward(dy, idx, shape, (k, k), padding)
      want = pooling.max_pool_backward_plain(dy, idx, shape, (k, k), padding)
      torch.cuda.synchronize()
      check(got.dtype == dtype and torch.equal(got, want),
            'max_pool_backward differs from plain ({}, {})'.format(name,
                                                                  dtype))
  print('max_pool_backward: bit-exact at {} geometries in f32 and bf16, '
        'in its 16-byte and one-element instances'.format(len(cases)))

  def library_for(x, dy, k, pad):
    """The library's backward of the same pool (aten's, on channels_last
    NCHW views, with the indices of its own forward)."""
    nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, indices = torch.nn.functional.max_pool2d(
        nchw, k, k, padding=pad, ceil_mode=True, return_indices=True)
    return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dy_nchw, nchw, [k, k], [k, k], [pad, pad], [1, 1], True, indices)

  totals = {'ms': 0.0, 'ms_with_host': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
            'library_ms': 0.0}
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

    def kernel(dy=dy, idx=idx, shape=shape, k=k):
      return pooling.max_pool_backward(dy, idx, shape, (k, k), 'SAME')

    # As K2f's: the device's times behind a device sleep, and the kernel's
    # one call between events, the host's queueing included, beside them.
    ms = median_ms(kernel, host_ahead=True)
    ms_with_host = median_ms(kernel)
    plain = median_ms(lambda: pooling.max_pool_backward_plain(
        dy, idx, shape, (k, k), 'SAME'), host_ahead=True)
    lib = median_ms(library, host_ahead=True)
    # dx written, dy and the int8 index read once; one compare per dx.
    bound, by = bound_ms(x.numel() * 4 + dy.numel() * 5, x.numel())
    bound_by.add(by)
    print('max_pool_backward {} {} f32: {:.4f} ms ({:.4f} ms one call with '
          'the host), plain {:.4f} ms, aten max_pool2d_with_indices_backward '
          '{:.4f} ms, bound {:.4f} ms ({}); 1 call per train step'.format(
              name, list(shape), ms, ms_with_host, plain, lib, bound, by))
    for key, value in (('ms', ms), ('ms_with_host', ms_with_host),
                       ('plain_ms', plain), ('bound_ms', bound),
                       ('library_ms', lib)):
      totals[key] += value
  print('max_pool_backward per critic step {:.4f} ms of device time ({:.1%} '
        'of its {:.4f} ms bound), {:.4f} ms one call at a time with the host; '
        'aten {:.4f} ms; {}'.format(
            totals['ms'], totals['bound_ms'] / totals['ms'],
            totals['bound_ms'], totals['ms_with_host'],
            totals['library_ms'], smi_line()))
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
  fp32_bound, by = bound_ms((x.numel() + dy.numel()) * 4 + 25 * c * c * 4,
                            flops)
  bound = tensor_core_bound_ms(flops)
  hmma = sass_hmma('conv5x5_wgrad')
  check(hmma > 0, 'the SASS of conv5x5_wgrad holds no HMMA')
  print('conv5x5_wgrad {} f32: {:.4f} ms ({:.1f} TFLOP/s), plain {:.4f} ms, '
        'cuDNN conv2d_weight (TF32 off) {:.4f} ms (differs from K3 by '
        '{:.3g} of its max); bound {:.4f} ms on the CUDA cores\' float32 '
        'rate ({}), {:.4f} ms for 3xTF32 on the tensor cores; {} HMMA in its '
        'SASS; {} calls per train step; {}'.format(
            list(BODY_CONV), ms, flops / ms / 1e9, plain, lib, lib_err,
            fp32_bound, by, bound, hmma, BODY_CONVS, smi_line()))
  return dict(name='conv5x5_wgrad', route='cuda',
              source='tensor2robot_tpu_torch/csrc/conv5x5_wgrad.cu',
              replaces='tensor2robot_tpu/layers/pallas_wgrad.py:112',
              max_abs_err=err, ms=BODY_CONVS * ms,
              plain_ms=BODY_CONVS * plain, bound_ms=BODY_CONVS * bound,
              bound_by='operations', fp32_bound_ms=BODY_CONVS * fp32_bound,
              library_ms=BODY_CONVS * lib, sass_hmma=hmma,
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
  card_vs_cpu_served_q(model, variables['avg_params'], stacked, got['action'])
  profile('profile', lambda i: batch_select(variables, stacked, i), 3,
          'batch of {}'.format(MAX_BATCH), top=12)
  return launches


def profile(label, run, calls, unit, top=16):
  """Where the time of ``calls`` runs of ``run(i)`` goes: device time by
  kernel from torch.profiler, the wall time per run (ending in a
  synchronize) and the device's busy share of it. Returns the wall ms per
  run."""
  from torch.profiler import ProfilerActivity, profile as torch_profile

  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    start = time.monotonic()
    for i in range(calls):
      run(i)
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - start) * 1e3 / calls
  # Kernels only: the host-side aten ops carry their kernels' device time
  # too, and would count it twice (as would the 'nccl:' annotations of the
  # collectives' kernels).
  rows = [(e.self_device_time_total / 1e3 / calls, e.count // calls, e.key)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and
          e.self_device_time_total > 0 and not e.key.startswith('nccl:')]
  if not rows:
    print('{}: the profiler saw no device time; not measured'.format(label))
    return wall_ms
  rows.sort(reverse=True)
  # NCCL's kernels run on their own stream, beside the compute, and wait
  # there for the peer ranks: counted apart.
  comm_ms = sum(ms for ms, _, name in rows if name.startswith('nccl'))
  busy_ms = sum(ms for ms, _, _ in rows) - comm_ms
  print('{}: {:.2f} ms wall per {}, kernels busy {:.2f} ms ({:.1%}){}'.format(
      label, wall_ms, unit, busy_ms, busy_ms / wall_ms,
      ', NCCL kernels (waits for the peers included) {:.2f} ms'.format(
          comm_ms) if comm_ms else ''))
  for ms, count, name in rows[:top]:
    print('  {:8.3f} ms {:5.1%} x{:<4d} {}'.format(ms, ms / busy_ms, count,
                                                   name[:90]))
  return wall_ms


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
  print('train step, kernels vs plain versions: {}; crop bit-exact'.format(
      compare_critic_steps('kernels vs plain', model, got_loss, want_loss,
                           got, want)))
  card_vs_cpu_critic_step(model, state, raw, labels, offsets)
  time_float64_weight_grads(device)

  train_profile('train profile', trainer, model, state, raw, labels, 3,
                TRAIN_BATCH)
  phase_train_serve(model, initial, state)
  return launches


def compare_critic_steps(label, model, got_loss, want_loss, got, want):
  """Two critic steps' losses and gradients: the loss within 1e-5
  relative; the gradients that are 0 in exact arithmetic within 1e-6 of the
  largest; every other within 1e-4 of its scale. Returns what it found, as
  text."""
  from tensor2robot_tpu_torch.research.qtopt import t2r_models

  check(got.keys() == want.keys(), 'gradient names differ')
  loss_err = abs(float(got_loss) - float(want_loss))
  check(loss_err <= 1e-5 * abs(float(want_loss)),
        'loss, {}: {} vs {}'.format(label, float(got_loss),
                                    float(want_loss)))
  # The biases of the per-block grasp denses are 0 in exact arithmetic:
  # the train-mode bngrasp subtracts the batch mean of their sum. Both
  # sides are rounding noise there (run F of PR 5 read some 8e-8 of the
  # network's largest gradient), held to 1e-6 of that gradient.
  largest = max(float(g.abs().max()) for g in want.values())
  zero = {'{}.{}.bias'.format(t2r_models._NETWORK, name) for name, _, _
          in getattr(model.network, t2r_models._NETWORK)._blocks}
  check(zero <= want.keys(), 'no gradient of {}'.format(zero - want.keys()))
  worst_zero = max((max_abs_err(got[k], want[k]) / largest, k) for k in zero)
  check(worst_zero[0] <= 1e-6, 'gradients that are 0 in exact arithmetic: '
        '{} differ by {:.3g} of the largest gradient at {}'.format(
            label, *worst_zero))
  # Every other gradient within 1e-4 of its scale: its largest magnitude,
  # taken no lower than 1e-3 of the network's largest gradient. cuDNN's
  # input gradients sum in an order that can change between calls, which
  # leaves an error of the order of 1e-7 of the largest gradient on every
  # gradient downstream, however small that gradient is itself.
  floor = 1e-3 * largest
  errors = sorted(((max_abs_err(got[k], want[k]) /
                    max(float(want[k].abs().max()), floor), k)
                   for k in want if k not in zero), reverse=True)
  check(errors[0][0] <= 1e-4, 'gradients, {}: differ by {:.3g} of their '
        'scale at {}'.format(label, *errors[0]))
  return ('|dloss| {:.3g} (tolerance 1e-5 relative); worst gradients {} of '
          'their scale (tolerance 1e-4); the zero-in-exact-arithmetic grasp '
          'biases differ by at most {:.3g} of the largest gradient at {} '
          '(tolerance 1e-6)'.format(
              loss_err, ', '.join('{:.3g} at {}'.format(*e)
                                  for e in errors[:3]), *worst_zero))


def compare_across_devices(label, got_loss, want_loss, got, want):
  """A step's loss and gradients on the card against the CPU's: the loss
  within 1e-4 relative and every gradient within 1e-4 of the step's largest
  gradient. Returns what it found, as text."""
  check(got.keys() == want.keys(), 'gradient names differ')
  loss_err = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
  check(loss_err <= 1e-4, 'loss, {}: {} vs {}'.format(
      label, float(got_loss), float(want_loss)))
  largest = max(float(g.abs().max()) for g in want.values())
  worst = max((max_abs_err(got[k], want[k]) / largest, k) for k in want)
  check(worst[0] <= 1e-4, 'gradients, {}: differ by {:.3g} of the largest '
        'gradient at {}'.format(label, *worst))
  own = max((max_abs_err(got[k], want[k]) /
             max(float(want[k].abs().max()), 1e-3 * largest), k)
            for k in want)
  return ('loss within {:.3g} relative (tolerance 1e-4); gradients within '
          '{:.3g} of the largest at {} (tolerance 1e-4); of their own scale '
          'at most {:.3g} at {}'.format(loss_err, *worst, *own))


def to_cpu(tree):
  if isinstance(tree, dict):
    return {k: to_cpu(v) for k, v in tree.items()}
  return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def cpu_critic():
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device='cpu', network_kwargs={'num_convs': NUM_CONVS})


def critic_q(model, weights, states, candidates):
  """q and logits [B, n] of the critic for n candidate actions [B, n, 8]
  of B served states, through ``model.network`` on explicitly named
  weights (batch norm statistics included), on the model's device, without
  the serving code."""
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.qtopt import networks

  device = model.device
  b, n = candidates.shape[:2]
  scalars = {k: torch.as_tensor(states[k], dtype=torch.float32).to(device)
             .reshape(b, 1, 1).expand(b, n, 1)
             for k in ('gripper_closed', 'height_to_bottom')}
  grasp = torch.cat([candidates.to(device), scalars['gripper_closed'],
                     scalars['height_to_bottom']], dim=-1).reshape(-1, 10)
  features = {'state/image': model.preprocessor.preprocess_images(
      torch.as_tensor(states['image']).to(device))}
  for key, (offset, size) in zip(networks.E2E_GRASP_PARAM_KEYS,
                                 networks.E2E_GRASP_PARAM_NAMES.values()):
    features['action/' + key] = grasp[:, offset:offset + size]
  with torch.inference_mode():
    outputs = torch.func.functional_call(
        model.network, weights, (features,), {'mode': ModeKeys.PREDICT},
        strict=True)
  return (outputs['q_predicted'].reshape(b, n),
          outputs['q_logits'].reshape(b, n))


def card_vs_cpu_served_q(model, weights, states, actions):
  """The served critic's q on the card (cuDNN convolutions, TF32 off, and
  the kernels) against the same weights and inputs on the CPU (CPU
  convolutions and the plain versions): the served actions and 15 random
  ones a state, q and logits within 1e-4 of their max."""
  b = actions.shape[0]
  candidates = torch.cat([actions.cpu()[:, None], torch.rand(
      (b, 15, 8), generator=torch.Generator().manual_seed(9)) * 2 - 1], 1)
  q, logits = critic_q(model, weights, states, candidates)
  start = time.monotonic()
  want_q, want_logits = critic_q(cpu_critic(), to_cpu(weights), states,
                                 candidates)
  seconds = time.monotonic() - start
  errors = [max_abs_err(got.cpu(), want) / float(want.abs().max())
            for got, want in ((q, want_q), (logits, want_logits))]
  check(max(errors) <= 1e-4, 'served critic, card vs CPU: q {:.3g}, logits '
        '{:.3g} of their max (tolerance 1e-4)'.format(*errors))
  print('served critic, card vs CPU ({} states x 16 actions, the same '
        'weights): q within {:.3g}, logits within {:.3g} of their max '
        '(tolerance 1e-4); the CPU took {:.1f} s'.format(b, *errors, seconds))


def card_vs_cpu_critic_step(model, state, raw, labels, offsets):
  """One critic train step's loss and gradients on the card (cuDNN
  convolutions, TF32 off, and the kernels) against the same on the CPU
  (CPU convolutions and the plain versions), from the same state on the
  same batch of TRAIN_BATCH at the same crop offsets.

  A max pool's window index and a ReLU's gate are discrete: where two cells
  of a window, or a pre-activation and 0, are within float32 rounding of
  each other, the card and the CPU may choose differently, and the
  gradient then flows through another cell, however exact both sides'
  arithmetic. So the CPU step replays the card's choices (its window
  indices and ReLU gates, in call order); the choices the CPU would have
  made otherwise are counted.

  """
  from tensor2robot_tpu_torch.layers import pooling
  from tensor2robot_tpu_torch.models.abstract_model import TrainState
  from tensor2robot_tpu_torch.modes import ModeKeys

  functional = torch.nn.functional
  pool_forward, relu = pooling.max_pool_forward, functional.relu
  cpu = cpu_critic()
  cpu_state = TrainState(step=state.step, params=to_cpu(state.params),
                         model_state=to_cpu(state.model_state),
                         opt_state=None)
  card_features, _ = model.preprocessor.preprocess(
      raw, None, ModeKeys.TRAIN, offsets=offsets)
  cpu_features, _ = cpu.preprocessor.preprocess(
      to_cpu(raw), None, ModeKeys.TRAIN, offsets=offsets.cpu())

  def compare():
    choices = {'pool': [], 'relu': []}

    def record_pool(x, window, strides, padding='VALID', return_index=False):
      out = pool_forward(x, window, strides, padding, return_index)
      if return_index:
        choices['pool'].append(out[1].cpu())
      return out

    def record_relu(x, inplace=False):
      choices['relu'].append((x > 0).cpu())
      return relu(x, inplace)

    with mock.patch.object(pooling, 'max_pool_forward', record_pool), \
        mock.patch.object(functional, 'relu', record_relu):
      got_loss, got = _gradients(model, state, card_features, labels)
    pools, gates = iter(choices['pool']), iter(choices['relu'])
    other = {'pool': 0, 'relu': 0}

    def replay_pool(x, window, strides, padding='VALID', return_index=False):
      idx = next(pools)
      other['pool'] += int((pooling.max_pool_plain(
          x, window, strides, padding, True)[1] != idx).sum())
      chosen = pooling.max_pool_backward_plain(
          torch.ones(idx.shape, dtype=x.dtype), idx, x.shape, window,
          padding) > 0
      out = pooling.max_pool_plain(
          torch.where(chosen, x, torch.full((), -float('inf'))), window,
          strides, padding)
      return (out, idx) if return_index else out

    def replay_relu(x, inplace=False):
      gate = next(gates)
      other['relu'] += int((gate != (x > 0)).sum())
      return x * gate.to(x.dtype)

    start = time.monotonic()
    with mock.patch.object(pooling, 'max_pool_forward', replay_pool), \
        mock.patch.object(functional, 'relu', replay_relu):
      want_loss, want = _gradients(cpu, cpu_state, cpu_features,
                                   to_cpu(labels))
    seconds = time.monotonic() - start
    check(next(pools, None) is None and next(gates, None) is None,
          'the CPU step made fewer pools or ReLUs than the card\'s')
    return ('the CPU replays the card\'s {} window indices and {} ReLU gates, '
            'of which it would have chosen {} and {} otherwise; {}; the CPU '
            'took {:.1f} s'.format(
                sum(int(i.numel()) for i in choices['pool']),
                sum(int(g.numel()) for g in choices['relu']), other['pool'],
                other['relu'], compare_across_devices(
                    'card vs CPU', got_loss, want_loss, to_cpu(got), want),
                seconds))

  print('train step, card vs CPU ({} examples, the same state and crops): '
        '{}'.format(TRAIN_BATCH, compare()))


# The critic's training convs whose weight gradient is not K3's, at batch
# 32: (name, NCHW input, OIHW weight, stride, padding, count a step).
FLOAT64_WGRAD_CONVS = (
    ('stem 6x6/2', (TRAIN_BATCH, 3, 472, 472), (64, 3, 6, 6), 2, 2, 1),
    ('3x3 SAME 27', (TRAIN_BATCH, 64, 27, 27), (64, 64, 3, 3), 1, 1, 6),
    ('3x3 VALID 14', (TRAIN_BATCH, 64, 14, 14), (64, 64, 3, 3), 1, 0, 1),
    ('3x3 VALID 12', (TRAIN_BATCH, 64, 12, 12), (64, 64, 3, 3), 1, 0, 1),
    ('3x3 VALID 10', (TRAIN_BATCH, 64, 10, 10), (64, 64, 3, 3), 1, 0, 1),
)


def time_float64_weight_grads(device):
  """What summing the critic's other weight gradients in float64
  (``networks._ConvFloat64WeightGrad``, cuDNN's float64 algorithms) costs a
  train step, against cuDNN's float32 ones (TF32 off)."""
  gen = torch.Generator(device=device).manual_seed(11)
  totals = {torch.float32: 0.0, torch.float64: 0.0}
  for _, shape, w_shape, stride, padding, count in FLOAT64_WGRAD_CONVS:
    x = torch.randn(shape, device=device, generator=gen).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(w_shape, device=device, generator=gen)
    dy = torch.randn(torch.nn.functional.conv2d(x, w, None, stride,
                                                padding).shape,
                     device=device, generator=gen).contiguous(
                         memory_format=torch.channels_last)
    for dtype in totals:
      totals[dtype] += count * median_ms(
          lambda dtype=dtype, x=x, dy=dy, w=w, s=stride, p=padding:
          torch.nn.grad.conv2d_weight(x.to(dtype), w.shape, dy.to(dtype), s,
                                      p).float(), iters=10)
  print('the critic\'s weight gradients other than K3\'s ({} convs a step) '
        'summed in float64: {:.3f} ms a step, against cuDNN\'s float32 ones\' '
        '{:.3f} ms (TF32 off): {:+.3f} ms a step; {}'.format(
            sum(c[-1] for c in FLOAT64_WGRAD_CONVS), totals[torch.float64],
            totals[torch.float32],
            totals[torch.float64] - totals[torch.float32], smi_line()))


def phase_train_serve(model, initial, state):
  """The trained variables are the serving dict: a served batch scores its
  chosen actions as a forward of the trained ``avg_params`` and batch norm
  statistics does, and otherwise than the untrained weights."""
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
  candidates = torch.cat([served['action'].cpu()[:, None], torch.rand(
      (MAX_BATCH, 15, 8), generator=torch.Generator().manual_seed(3)) * 2 - 1],
                         dim=1)

  def score(weights, buffers):
    return critic_q(model, {**weights, **buffers}, states, candidates)

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


def train_profile(label, trainer, model, state, raw, labels, steps, batch):
  """``profile`` of train steps (crop + forward + backward + optimizer)
  on a resident batch, after one warm step; prints examples/s."""
  from tensor2robot_tpu_torch.modes import ModeKeys

  current = [state]

  def step(_):
    features, batch_labels = model.preprocessor.preprocess(
        raw, labels, ModeKeys.TRAIN,
        generator=trainer.crop_generator(current[0].step))
    current[0], metrics = model.train_step(current[0], features,
                                           batch_labels)
    float(metrics['loss'])

  step(0)   # warm
  wall_ms = profile(label, step, steps, 'step of {}'.format(batch))
  print('{}: {:.2f} examples/s on a resident batch'.format(
      label, batch * 1e3 / wall_ms))


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
  lib_kernels = device_kernels(library)
  # The products with unmasked pairs (q_pos >= k_pos): two of D
  # multiply-adds each, for s and for p @ v.
  pairs = h * l * (l + 1) // 2
  flops = 4 * d * pairs
  fp32_bound, _ = bound_ms(4 * q.numel() * 4 + h * l * 4, flops)
  bound = tensor_core_bound_ms(flops)
  mix = sass_mix('flash_attention_fwd')
  hmma = mix['HMMA']
  check(hmma > 0, 'the SASS of flash_attention_fwd holds no HMMA')
  print('flash_attention served [1,{},{},{}] causal f32: {:.4f} ms ({:.1f} '
        'TFLOP/s), plain {:.4f} ms, scaled_dot_product_attention {:.4f} ms '
        '(differs by {:.3g}; its kernels: {}); bound {:.4f} ms on the CUDA '
        'cores\' float32 rate, {:.4f} ms for 3xTF32 on the tensor cores; its '
        'SASS: {} HMMA, {} LDS, {} integer ({}); {} calls per predict'.format(
            l, h, d, ms, flops / ms / 1e9, plain, lib, lib_err,
            ', '.join(lib_kernels), fp32_bound, bound, hmma, mix['LDS'],
            mix['integer'], ' '.join(SASS_INTEGER), 8))

  # The training shape: batch 8, 8 calls a Seq2Act step.
  b = SEQ2ACT_TRAIN_BATCH
  qkv = torch.randn((b, l, h, 3, d), device=device, generator=gen)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  bhl = [x.transpose(1, 2) for x in (q, k, v)]
  train_ms = median_ms(lambda: flash_attention.flash_attention(
      q, k, v, causal=True))
  train_lib = median_ms(
      lambda: F.scaled_dot_product_attention(*bhl, is_causal=True))
  train_bound = tensor_core_bound_ms(b * flops)
  print('flash_attention training [{},{},{},{}] causal f32: {:.4f} ms ({:.1f} '
        'TFLOP/s; bound {:.4f} ms for 3xTF32), scaled_dot_product_attention '
        '{:.4f} ms; {} calls per Seq2Act step; {}'.format(
            b, l, h, d, train_ms, b * flops / train_ms / 1e9, train_bound,
            train_lib, 8, smi_line()))
  del qkv, q, k, v, bhl
  return dict(name='flash_attention_fwd', route='cuda',
              source='tensor2robot_tpu_torch/csrc/flash_attention_fwd.cu',
              replaces='tensor2robot_tpu/parallel/flash_attention.py:202',
              max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
              bound_by='operations', fp32_bound_ms=fp32_bound,
              tensor_core_bound_ms=bound, library_ms=lib,
              library_kernels=lib_kernels, sass_hmma=hmma, sass_mix=mix,
              train_ms=train_ms, train_library_ms=train_lib,
              train_bound_ms=train_bound,
              shapes='per launch: [1,{},{},{}] causal f32, q/k/v strided '
              'views of the qkv projection'.format(l, h, d),
              train_shapes='per launch: [{},{},{},{}] causal f32, the same '
              'views'.format(b, l, h, d))


BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of max|plain|


def phase_flash_backward(device, gen):
  """K5a and K5b against the dense plain backward, at the training shape
  (batch 8 of 8 heads x 4096 x 64, causal: q, k, v strided views of the
  qkv projection) in f32 and bf16 and at an odd shape (D 128, Lq 200 !=
  Lk 136, neither a multiple of 64, not causal), then timed."""
  import torch.nn.functional as F
  from tensor2robot_tpu_torch.parallel import flash_attention as fa

  torch.backends.cuda.matmul.allow_tf32 = False
  h, l, d = FLASH_HEADS, FLASH_LEN, FLASH_DIM
  b = SEQ2ACT_TRAIN_BATCH
  cases = [(b, l, l, h, d, True, 'training', torch.float32),
           (b, l, l, h, d, True, 'training', torch.bfloat16),
           (2, 200, 136, 3, 128, False, 'odd', torch.float32),
           (2, 200, 136, 3, 128, False, 'odd', torch.bfloat16)]
  err = {'dq': 0.0, 'dk': 0.0, 'dv': 0.0}
  for batch, l_q, l_k, heads, dim, causal, name, dtype in cases:
    scale = 1.0 / float(np.sqrt(dim))
    qkv = torch.randn((batch, l_k, heads, 3, dim), device=device,
                      generator=gen).to(dtype)
    q = (qkv[..., 0, :] if l_q == l_k else torch.randn(
        (batch, l_q, heads, dim), device=device, generator=gen).to(dtype))
    k, v = qkv[..., 1, :], qkv[..., 2, :]
    out, lse = fa.flash_attention_forward(q, k, v, causal, scale)
    d_out = torch.randn(out.shape, device=device, generator=gen).to(dtype)
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal,
                                      scale)
    again = fa.flash_attention_backward(q, k, v, out, lse, d_out, causal,
                                        scale)
    want = fa.flash_attention_bwd_plain_blhd(q, k, v, out, lse, d_out,
                                             causal, scale)
    torch.cuda.synchronize()
    line = []
    for key, g, w, g2 in zip(('dq', 'dk', 'dv'), got, want, again):
      check(bool(torch.isfinite(w).all()), 'the plain backward\'s {} is not '
            'finite'.format(key))
      e = max_abs_err(g, w)
      limit = BWD_RTOL[dtype] * float(w.float().abs().max())
      check(g.dtype == dtype and g.shape == w.shape and e <= limit,
            'flash backward {} {} {}: max |d{}| {} > {}'.format(
                name, [batch, l_q, l_k, heads, dim], dtype, key, e, limit))
      check(torch.equal(g, g2), 'flash backward {} is not the same from run '
            'to run'.format(key))
      if name == 'training' and dtype == torch.float32:
        err[key] = e
      line.append('{} {:.3g} of max'.format(key, e / float(
          w.float().abs().max())))
    print('flash backward {} [{},{}/{},{},{}] {} {}: {} (tolerance {:g}); '
          'the same bits run to run'.format(
              name, batch, l_q, l_k, heads, dim,
              'causal' if causal else 'full', str(dtype).split('.')[-1],
              ', '.join(line), BWD_RTOL[dtype]))
    del got, again, want

  # The training call, each kernel alone, float32.
  scale = 1.0 / float(np.sqrt(d))
  qkv = torch.randn((b, l, h, 3, d), device=device, generator=gen)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  out, lse = fa.flash_attention_forward(q, k, v, True, scale)
  d_out = torch.randn(out.shape, device=device, generator=gen)
  delta = fa.flash_attention_delta(out, d_out)
  kv_ms = median_ms(lambda: fa.flash_attention_bwd_kv(
      q, k, v, d_out, lse, delta, True, scale))
  q_ms = median_ms(lambda: fa.flash_attention_bwd_q(
      q, k, v, d_out, lse, delta, True, scale))
  delta_ms = median_ms(lambda: fa.flash_attention_delta(out, d_out))
  # K5b in bf16 runs one tensor-core pass where float32 runs three.
  qkv16, o16 = qkv.to(torch.bfloat16), d_out.to(torch.bfloat16)
  q_bf16_ms = median_ms(lambda: fa.flash_attention_bwd_q(
      qkv16[..., 0, :], qkv16[..., 1, :], qkv16[..., 2, :], o16, lse, delta,
      True, scale))
  del qkv16, o16
  # The plain backward holds five dense [B*H, L, L] float32 tensors (22 GB).
  plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain_blhd(
      q, k, v, out, lse, d_out, True, scale), iters=10, warmup=2)

  # The library: the backward alone of scaled_dot_product_attention on a
  # saved forward, dq, dk and dv together from [B, H, L, D] views.
  leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
  lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
  lib_do = d_out.transpose(1, 2)

  def library():
    return torch.autograd.grad(lib_out, leaves, lib_do, retain_graph=True)

  ours = fa.flash_attention_backward(q, k, v, out, lse, d_out, True, scale)
  lib_err = max(max_abs_err(g.transpose(1, 2), o) / float(o.abs().max())
                for g, o in zip(library(), ours))
  check(lib_err <= 1e-3, 'the library attention backward computes another '
        'function ({:.3g} of max)'.format(lib_err))
  lib_ms = median_ms(library)
  del lib_out, leaves, ours

  pairs = b * h * l * (l + 1) // 2
  elem = q.numel() * 4                       # one [B, L, H, D] f32 tensor
  rows = b * h * l * 4                       # one [B, H, L] f32 vector
  kv_fp32_bound, _ = bound_ms(6 * elem + 2 * rows, 4 * 2 * d * pairs)
  kv_bound, kv_by = tensor_core_bound_ms(4 * 2 * d * pairs), 'operations'
  q_fp32_bound, _ = bound_ms(5 * elem + 2 * rows, 3 * 2 * d * pairs)
  q_bound, q_by = tensor_core_bound_ms(3 * 2 * d * pairs), 'operations'
  kv_mix = sass_mix('flash_attention_bwd_kv')
  q_mix = sass_mix('flash_attention_bwd_q')
  kv_hmma, q_hmma = kv_mix['HMMA'], q_mix['HMMA']
  check(kv_hmma > 0, 'the SASS of flash_attention_bwd_kv holds no HMMA')
  check(q_hmma > 0, 'the SASS of flash_attention_bwd_q holds no HMMA')
  print('flash backward training [{},{},{},{}] causal f32: K5a (dk, dv) '
        '{:.4f} ms ({:.1f} TFLOP/s; bound {:.4f} ms on the CUDA cores\' '
        'float32 rate, {:.4f} ms for 3xTF32 on the tensor cores; {} HMMA in '
        'its SASS), K5b (dq) {:.4f} ms ({:.1f} TFLOP/s; bound {:.4f} ms on '
        'the CUDA cores\' float32 rate, {:.4f} ms for 3xTF32 on the tensor '
        'cores; {} HMMA in its SASS; {:.4f} ms in bf16, one pass), delta '
        'pass {:.4f} ms; plain backward '
        '{:.4f} ms; scaled_dot_product_attention backward (dq, dk, dv) '
        '{:.4f} ms against K5a + K5b + delta {:.4f} ms (differs by {:.3g} of '
        'max); their SASS, HMMA/LDS/integer: K5a {kv[HMMA]}/{kv[LDS]}/'
        '{kv[integer]}, K5b {q[HMMA]}/{q[LDS]}/{q[integer]}; {}'.format(
            b, l, h, d, kv_ms, 8 * d * pairs / kv_ms / 1e9, kv_fp32_bound,
            kv_bound, kv_hmma, q_ms, 6 * d * pairs / q_ms / 1e9, q_fp32_bound,
            q_bound, q_hmma, q_bf16_ms, delta_ms, plain_ms, lib_ms,
            kv_ms + q_ms + delta_ms, lib_err, smi_line(), kv=kv_mix, q=q_mix))
  shapes = 'per launch: [{},{},{},{}] causal f32, q/k/v strided views of ' \
           'the qkv projection'.format(b, l, h, d)
  library_note = ('scaled_dot_product_attention backward, dq, dk and dv '
                  'together: set against K5a + K5b + the delta pass')
  return (dict(name='flash_attention_bwd_kv', route='cuda',
               source='tensor2robot_tpu_torch/csrc/flash_attention_bwd_kv.cu',
               replaces='tensor2robot_tpu/parallel/flash_attention.py:501',
               max_abs_err=max(err['dk'], err['dv']), ms=kv_ms,
               plain_ms=plain_ms, bound_ms=kv_bound, bound_by=kv_by,
               fp32_bound_ms=kv_fp32_bound, library_ms=lib_ms,
               library_note=library_note, sass_hmma=kv_hmma,
               sass_mix=kv_mix, shapes=shapes),
          dict(name='flash_attention_bwd_q', route='cuda',
               source='tensor2robot_tpu_torch/csrc/flash_attention_bwd_q.cu',
               replaces='tensor2robot_tpu/parallel/flash_attention.py:530',
               max_abs_err=err['dq'], ms=q_ms, plain_ms=plain_ms,
               bound_ms=q_bound, bound_by=q_by, fp32_bound_ms=q_fp32_bound,
               library_ms=lib_ms, library_note=library_note,
               sass_hmma=q_hmma, sass_mix=q_mix, bf16_ms=q_bf16_ms,
               delta_ms=delta_ms,
               shapes=shapes))


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
  card_vs_cpu_seq2act(predictor.variables, window, got['action_logits'])
  profile('seq2act profile', lambda i: policy.SelectAction(
      {'image': frames[i]}, None, i), 2, 'SelectAction')
  return launches


def card_vs_cpu_seq2act(variables, window, logits):
  """The served Seq2Act logits on the card (cuDNN tokenizer convolutions,
  cuBLAS, TF32 off, and the kernels) against the same weights and window on
  the CPU (CPU convolutions and the plain versions), within 1e-4 of their
  max."""
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel

  cpu = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE, attention_mode='flash',
                       device='cpu')
  start = time.monotonic()
  want = export_generators.make_serve_fn(cpu)(to_cpu(variables), window)[
      'action_logits']
  seconds = time.monotonic() - start
  scale = float(want.abs().max())
  e = max_abs_err(logits.cpu(), want)
  check(e <= LOGITS_RTOL * scale, 'seq2act logits, card vs CPU: {:.3g} of '
        'their max (tolerance {:g})'.format(e / scale, LOGITS_RTOL))
  print('seq2act logits, card vs CPU ({}-frame window, the same weights): '
        'within {:.3g} of their max (tolerance {:g}); the CPU took {:.1f} s'
        .format(SEQ2ACT_EPISODE, e / scale, LOGITS_RTOL, seconds))


# Seq2Act training: the long-context binding at full width, batch 8 (the
# backward's activations take some 42 GB at 8, so the gin's 32 would not
# fit the card's 80 GB).
SEQ2ACT_TRAIN_BATCH, SEQ2ACT_TRAIN_STEPS = 8, 4
# The TokenLearner's softmax runs over the tokens, so the map_out bias (one
# constant a map) cancels in it: a gradient that is 0 in exact arithmetic.
SEQ2ACT_ZERO_GRADIENTS = ('tokenizer.token_learner.map_out.bias',)


def phase_seq2act_train(device):
  """Trains the full-width 512-frame Seq2Act policy through
  ``train_eval_model``; checks launches, losses and the checkpoint; holds
  one step against the plain versions; profiles; serves the result."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                         attention_mode='flash', learning_rate=1e-4,
                         device=device)
  data = input_generators.DefaultRandomInputGenerator(
      batch_size=SEQ2ACT_TRAIN_BATCH)
  steps, batch = SEQ2ACT_TRAIN_STEPS, SEQ2ACT_TRAIN_BATCH
  with tempfile.TemporaryDirectory() as model_dir:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = time.monotonic()
    # nan_policy 'raise' checks the loss on the host after every step.
    result = train_eval.train_eval_model(
        model, model_dir, data, max_train_steps=steps, log_every_n_steps=1,
        save_checkpoints_steps=steps, nan_policy='raise', seed=0)
    elapsed = time.monotonic() - start
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, trainer = result['state'], result['trainer']
    restored = checkpointing.CheckpointManager(model_dir).restore(
        device=device)
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update({'crop_convert': steps,
                 'flash_attention_fwd': 8 * steps,
                 'flash_attention_bwd_kv': 8 * steps,
                 'flash_attention_bwd_q': 8 * steps})
    check(launches == want, 'seq2act train launch counts {} != expected {} '
          'for {} steps'.format(launches, want, steps))
    loss = trainer.last_metrics['loss']
    check(state.step == steps and np.isfinite(loss),
          'seq2act training ended at step {} with loss {}'.format(state.step,
                                                                  loss))
    check(_states_equal(restored, state),
          'the seq2act checkpoint does not restore the final state')
    del restored
    # One log window a step, each ending with the metrics on the host. The
    # first pays for cuDNN's set-up.
    windows = trainer.windows[1:]
    step_ms = statistics.median(w[1] * 1e3 for w in windows)
    data_ms = statistics.median(w[2] * 1e3 for w in windows)
    print('seq2act train: {} steps of batch {} x {} frames ({} tokens) in '
          '{:.1f}s, launches {}; loss {:.4f}, action_accuracy {:.4f}, '
          'action_mae {:.4f}; median step {:.1f} ms ({:.2f} examples/s), of '
          'which {:.1f} ms waiting for the batch; peak memory {:.2f} GB '
          '(max_memory_allocated); checkpoint restores equal; {}'.format(
              steps, batch, SEQ2ACT_EPISODE, 8 * SEQ2ACT_EPISODE, elapsed,
              launches, loss, trainer.last_metrics['action_accuracy'],
              trainer.last_metrics['action_mae'], step_ms,
              batch * 1e3 / step_ms, data_ms, peak_gb, smi_line()))

    numpy_features, numpy_labels = next(data.create_dataset_iterator(
        ModeKeys.TRAIN, seed=1, prefetch=0))
    raw, labels = trainer.put_batch(numpy_features), trainer.put_batch(
        numpy_labels)
    phase_seq2act_train_vs_plain(model, state, raw, labels)
    train_profile('seq2act train profile', trainer, model, state, raw,
                  labels, 2, batch)
    del raw, labels
    phase_seq2act_train_serve(model, model_dir, state)
  return launches


def phase_seq2act_train_vs_plain(model, state, raw, labels):
  """One step on one episode through the kernels and through the plain
  versions (K1's, K4's and K5's): the loss and every gradient. Batch 1, so
  that the plain attention's dense [8, 4096, 4096] scores fit."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.parallel import flash_attention
  from tensor2robot_tpu_torch.preprocessors import pallas_crop

  one = {k: v[:1] for k, v in raw.items()}
  one_labels = {k: v[:1] for k, v in labels.items()}
  offsets = torch.tensor([[3, 5]], dtype=torch.int32, device=model.device)

  def one_step():
    features, _ = model.preprocessor.preprocess(one, None, ModeKeys.TRAIN,
                                                offsets=offsets)
    return _gradients(model, state, features, one_labels)

  before = dict(kernels.LAUNCHES)
  got_loss, got = one_step()
  check(all(kernels.LAUNCHES[k] > before[k] for k in (
      'crop_convert', 'flash_attention_fwd', 'flash_attention_bwd_kv',
      'flash_attention_bwd_q')), 'the kernel step did not launch the kernels')
  with mock.patch.object(flash_attention, 'flash_attention_forward',
                         flash_attention.flash_attention_plain_blhd), \
      mock.patch.object(flash_attention, 'flash_attention_backward',
                        flash_attention.flash_attention_bwd_plain_blhd), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    before = dict(kernels.LAUNCHES)
    want_loss, want = one_step()
    check(kernels.LAUNCHES == before, 'the plain step launched a kernel')
  torch.cuda.synchronize()
  check(got.keys() == want.keys() == set(state.params), 'gradient names '
        'differ')
  print('seq2act train step, kernels vs plain versions (1 episode): {}'
        .format(compare_steps('kernels vs plain', got_loss, want_loss, got,
                              want)))


def compare_steps(label, got_loss, want_loss, got, want):
  """Two Seq2Act steps' losses and gradients: the loss within 1e-5
  relative; the gradients that are 0 in exact arithmetic within 1e-6 of
  the largest; every other within 1e-4 of its scale, its largest
  magnitude, no lower than 1e-3 of the network's largest gradient (cuDNN's
  input gradients may sum in another order between calls). Returns what
  it found, as text."""
  got_loss, want_loss = float(got_loss), float(want_loss)
  loss_err = abs(got_loss - want_loss)
  check(loss_err <= 1e-5 * abs(want_loss), 'seq2act loss, {}: {} vs '
        '{}'.format(label, got_loss, want_loss))
  largest = max(float(g.abs().max()) for g in want.values())
  worst_zero = max((max(float(got[k].abs().max()),
                        float(want[k].abs().max())) / largest, k)
                   for k in SEQ2ACT_ZERO_GRADIENTS)
  check(worst_zero[0] <= 1e-6, 'gradients that are 0 in exact arithmetic '
        'reach {:.3g} of the largest gradient at {}'.format(*worst_zero))
  floor = 1e-3 * largest
  errors = sorted(((max_abs_err(got[k], want[k]) /
                    max(float(want[k].abs().max()), floor), k)
                   for k in want if k not in SEQ2ACT_ZERO_GRADIENTS),
                  reverse=True)
  check(errors[0][0] <= 1e-4, 'seq2act gradients, {}: differ by {:.3g} of '
        'their scale at {}'.format(label, *errors[0]))
  return ('|dloss| {:.3g} (tolerance 1e-5 relative); worst gradients {} of '
          'their scale (tolerance 1e-4); the zero-in-exact-arithmetic '
          'map_out bias at {:.3g} of the largest gradient (tolerance '
          '1e-6)'.format(loss_err, ', '.join('{:.3g} at {}'.format(*e)
                                             for e in errors[:3]),
                         worst_zero[0]))


def phase_seq2act_train_serve(model, model_dir, state):
  """The trained checkpoint serves: a SequentialRegressionPolicy over a
  CheckpointPredictor restored from it answers with finite bin centers,
  and its logits are the trained params' predict_step, not the untrained
  weights'."""
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.policies import SequentialRegressionPolicy
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.research.vrgripper import decoders

  predictor = CheckpointPredictor(model, model_dir, timeout=60.0)
  policy = SequentialRegressionPolicy(model, predictor=predictor)
  check(policy.restore() and predictor.model_version == state.step,
        'CheckpointPredictor did not restore the trained checkpoint')
  rng = np.random.RandomState(7)
  frames = [rng.randint(0, 256, (136, 168, 3), dtype=np.uint8)
            for _ in range(2)]
  policy.reset()
  actions = [policy.SelectAction({'image': f}, None, i)
             for i, f in enumerate(frames)]
  centers = set(decoders.get_discrete_bins(256, -1.0, 1.0).tolist())
  for action in actions:
    check(action.shape == (7,) and np.isfinite(action).all() and
          set(action.tolist()) <= centers,
          'bad trained seq2act action {}'.format(action))
  window = None
  for frame in frames:
    window = model.pack_features({'image': frame}, window, 0)
  served = torch.as_tensor(predictor.predict(window)['action_logits'])
  serve = export_generators.make_serve_fn(model)
  trained = serve(state.variables(), window)['action_logits'].cpu()
  untrained_state = model.create_train_state(
      torch.Generator().manual_seed(0))
  untrained = serve(untrained_state.variables(), window)[
      'action_logits'].cpu()
  scale = float(trained.abs().max())
  err = max_abs_err(served, trained)
  moved = max_abs_err(trained, untrained)
  check(err <= 1e-4 * scale, 'served logits differ from the trained '
        'params\' predict_step by {:.3g} of max {:.3g}'.format(err, scale))
  check(moved >= 1e-3 * scale, 'the trained logits are the untrained '
        'weights\' (max |dlogit| {:.3g})'.format(moved))
  print('seq2act train -> serve: the trained checkpoint (step {}) answers '
        '{} SelectAction calls with bin centers; served logits equal the '
        'trained params\' predict_step within {:.3g} of max {:.3g} '
        '(tolerance 1e-4) and differ from the untrained weights\' by up to '
        '{:.3g}'.format(state.step, len(actions), err / scale, scale, moved))


# Ring attention: the hop of 4 ranks over batch 8 of the 512-frame binding
# (a [8, 1024, 8, 64] shard), and the ring's training run.
RING_HOP = (8, 1024, 8, 64)
CARRY_RTOL = 1e-5   # of max|plain|: float32 sums in another order
RING_STEPS = 4
RING_TIMEOUT_S = 900


def causal_pairs(b, h, l_q, l_k, q_offset, k_offset):
  """The (q, k) pairs a causal hop does not mask: q_offset + i >= k_offset
  + j."""
  rows = np.clip(q_offset + np.arange(l_q) - k_offset + 1, 0, l_k)
  return b * h * int(rows.sum())


def carry_state(b, h, l_q, d, device):
  from tensor2robot_tpu_torch.parallel import flash_attention
  return (torch.zeros((b, h, l_q, d), device=device),
          torch.full((b, h, l_q), flash_attention.NEG_INF, device=device),
          torch.zeros((b, h, l_q), device=device))


def carry_errors(q, k, v, state, q_offset, k_offset, causal):
  """K6 and its plain version from copies of one state: the largest error
  of o, m and l relative to each one's max, and o's absolute error."""
  from tensor2robot_tpu_torch.parallel import flash_attention as fa

  scale = 1.0 / float(np.sqrt(q.shape[-1]))
  got = [x.clone() for x in state]
  want = [x.clone() for x in state]
  fa.flash_attention_carry(q, k, v, *got, q_offset, k_offset, causal, scale)
  fa.flash_attention_carry_plain(q, k, v, *want, q_offset, k_offset, causal,
                                 scale)
  torch.cuda.synchronize()
  if causal and k_offset > q_offset + q.shape[1] - 1:
    check(all(torch.equal(g, x) for g, x in zip(got, state)),
          'K6 changed the state of a hop the mask hides')
  rel = max(max_abs_err(g, w) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want))
  return rel, max_abs_err(got[0], want[0])


def phase_ring_kernel(device, gen, world):
  """K6 against its plain version at the 4-rank hop shape (diagonal, full
  and hidden hops from a carried state, f32 and bf16) and at an odd shape;
  a replay of the four-shard hop schedule on one card against K4's O and
  LSE over the whole sequence; then timed at the main path's launch shape
  and at the 4-rank hop."""
  from tensor2robot_tpu_torch.parallel import flash_attention as fa

  torch.backends.cuda.matmul.allow_tf32 = False
  b, l, h, d = RING_HOP
  worst = 0.0
  for dtype in (torch.float32, torch.bfloat16):
    qkv = torch.randn((b, 2 * l, h, 3, d), device=device,
                      generator=gen).to(dtype)
    q = qkv[:, l:, :, 0]                     # rank 1's queries
    # Rank 1's own block, rank 0's, and a block at positions past both.
    blocks = (('diagonal', l, qkv[:, l:]), ('full', 0, qkv[:, :l]),
              ('hidden', 2 * l, torch.randn((b, l, h, 3, d), device=device,
                                            generator=gen).to(dtype)))
    for name, k_offset, block in blocks:
      state = carry_state(b, h, l, d, device)
      # The state after rank 1's hop of rank 0's block.
      fa.flash_attention_carry_plain(q, qkv[:, :l, :, 1], qkv[:, :l, :, 2],
                                     *state, l, 0, True, d ** -0.5)
      rel, _ = carry_errors(q, block[:, :, :, 1], block[:, :, :, 2], state,
                            l, k_offset, True)
      check(rel <= CARRY_RTOL, 'K6 {} hop {}: {:.3g} of max (tolerance '
            '{:g})'.format(name, dtype, rel, CARRY_RTOL))
      print('flash_attention_carry {} hop [{},{},{},{}] causal {}: o, m, l '
            'within {:.3g} of their max (tolerance {:g})'.format(
                name, b, l, h, d, str(dtype).split('.')[-1], rel,
                CARRY_RTOL))
      worst = max(worst, rel)
  for dtype in (torch.float32, torch.bfloat16):
    # Odd: Lq 100 != Lk 72 (ragged 64-row tiles), head dim 128, offsets that
    # cross the diagonal.
    q = torch.randn((2, 100, 3, 128), device=device, generator=gen).to(dtype)
    kv = torch.randn((2, 72, 3, 2, 128), device=device,
                     generator=gen).to(dtype)
    rel, _ = carry_errors(q, kv[..., 0, :], kv[..., 1, :],
                          carry_state(2, 3, 100, 128, device), 40, 30, True)
    check(rel <= CARRY_RTOL, 'K6 odd shape {}: {:.3g} of max'.format(dtype,
                                                                      rel))
    print('flash_attention_carry odd [2,100/72,3,128] causal at offsets 40/30 '
          '{}: within {:.3g} of max (tolerance {:g})'.format(
              str(dtype).split('.')[-1], rel, CARRY_RTOL))

  # The four-shard schedule of a [8, 4096, 8, 64] causal sequence, replayed
  # on one card: shard r takes blocks r, r - 1, ... in ring order.
  n, full = 4, 4 * l
  qkv = torch.randn((b, full, h, 3, d), device=device, generator=gen)
  q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
  want_o, want_lse = fa.flash_attention_forward(q, k, v, True, d ** -0.5)
  outs, lses = [], []
  for r in range(n):
    o, m, lsum = carry_state(b, h, l, d, device)
    for i in range(n):
      src = (r - i) % n
      fa.flash_attention_carry(q[:, r * l:(r + 1) * l],
                               k[:, src * l:(src + 1) * l],
                               v[:, src * l:(src + 1) * l], o, m, lsum,
                               r * l, src * l, True, d ** -0.5)
    lses.append(m + torch.log(lsum.clamp_min(1e-30)))
    outs.append((o / lsum.clamp_min(1e-20)[..., None]).permute(0, 2, 1, 3))
  torch.cuda.synchronize()
  o_err = max_abs_err(torch.cat(outs, 1), want_o) / float(want_o.abs().max())
  lse_err = (max_abs_err(torch.cat(lses, 2), want_lse) /
             float(want_lse.abs().max()))
  check(o_err <= CARRY_RTOL and lse_err <= CARRY_RTOL,
        'the four-shard replay differs from K4: O {:.3g}, LSE {:.3g} of max'
        .format(o_err, lse_err))
  print('flash_attention_carry four-shard replay of [{},{},{},{}] causal '
        '(16 hops) vs K4 on the whole sequence: O within {:.3g}, LSE within '
        '{:.3g} of max (tolerance {:g})'.format(b, full, h, d, o_err,
                                                lse_err, CARRY_RTOL))
  del qkv, q, k, v, want_o, want_lse, outs, lses

  def timed(shape, q_offset, k_offset, plain=False):
    tb, tl, th, td = shape
    tq = torch.randn((tb, tl, th, 3, td), device=device, generator=gen)
    state = carry_state(tb, th, tl, td, device)
    args = (tq[..., 0, :], tq[..., 1, :], tq[..., 2, :], *state, q_offset,
            k_offset, True, td ** -0.5)
    ms = median_ms(lambda: fa.flash_attention_carry(*args))
    plain_ms = (median_ms(lambda: fa.flash_attention_carry_plain(*args),
                          iters=10, warmup=2) if plain else None)
    pairs = causal_pairs(tb, th, tl, tl, q_offset, k_offset)
    # q, k, v read once; o, m, l read and written.
    nbytes = 3 * tb * tl * th * td * 4 + 2 * (tb * th * tl * (td + 2) * 4)
    bound, by = bound_ms(nbytes, 4 * td * pairs)
    return ms, plain_ms, bound, by, pairs

  batch = 8 if world == 1 else 32
  main_shape = (batch, 4 * l // world, h, d)
  # The main path's launches: at one rank the diagonal hop over the whole
  # sequence; at four, full hops (and diagonal and hidden ones).
  main_offsets = (0, 0) if world == 1 else (main_shape[1], 0)
  ms, plain, bound, by, pairs = timed(main_shape, *main_offsets, plain=True)
  err = carry_errors(*(torch.randn(main_shape, device=device, generator=gen)
                       for _ in range(3)),
                     carry_state(batch, h, main_shape[1], d, device),
                     *main_offsets, True)
  check(err[0] <= CARRY_RTOL, 'K6 at the main path\'s shape: {:.3g} of max'
        .format(err[0]))
  diag = timed(RING_HOP, l, l)
  full_hop = timed(RING_HOP, 2 * l, 0)
  print('flash_attention_carry per launch at the main path\'s shape {} '
        'causal f32 at offsets {}: {:.4f} ms ({:.1f} TFLOP/s), plain {:.4f} ms, '
        'bound {:.4f} ms ({}); no single PyTorch call takes a carried (o, m, '
        'l); at the 4-rank hop [{},{},{},{}]: diagonal {:.4f} ms (bound '
        '{:.4f}), full {:.4f} ms (bound {:.4f}); {}'.format(
            list(main_shape), main_offsets, ms, 4 * d * pairs / ms / 1e9,
            plain, bound, by, b, l, h, d, diag[0], diag[2], full_hop[0],
            full_hop[2], smi_line()))
  return dict(name='flash_attention_carry', route='cuda',
              source='tensor2robot_tpu_torch/csrc/flash_attention_carry.cu',
              replaces='tensor2robot_tpu/parallel/flash_attention.py:342',
              max_abs_err=err[1], ms=ms, plain_ms=plain, bound_ms=bound,
              bound_by=by, library_ms=None,
              library_note='no single PyTorch call takes a carried (o, m, l)',
              shapes='per launch: {} causal f32 at offsets {}'.format(
                  list(main_shape), main_offsets),
              hop_ms={'diagonal': diag[0], 'full': full_hop[0]},
              hop_bound_ms={'diagonal': diag[2], 'full': full_hop[2]},
              max_rel_err=max(worst, err[0]))


def phase_ring_train(world):
  """Spawns ``world`` NCCL ranks (``ring_rank``), one a card; each trains
  the full-width 512-frame binding with ring attention. Returns rank 0's
  report."""
  import torch.multiprocessing as torch_mp

  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  with tempfile.TemporaryDirectory() as out_dir:
    context = torch_mp.start_processes(
        ring_rank, args=(world, out_dir), nprocs=world, join=False,
        start_method='spawn')
    deadline = time.monotonic() + RING_TIMEOUT_S
    done = False
    try:
      while not done and time.monotonic() < deadline:
        done = context.join(timeout=max(deadline - time.monotonic(), 0.1))
    finally:
      for process in context.processes:
        if process.is_alive():
          process.kill()
    check(done, 'a ring rank did not finish within {} s'.format(
        RING_TIMEOUT_S))
    reports = [json.loads(open(os.path.join(
        out_dir, 'rank{}.json'.format(r))).read()) for r in range(world)]
  batch = reports[0]['batch']
  print('seq2act ring train: world {}; by rank: peak memory {} GB, the '
        'loop\'s median step {} ms, a resident step {} ms ({:.2f} episodes/s '
        'on rank 0)'.format(
            world, [round(r['peak_gb'], 2) for r in reports],
            [round(r['step_ms'], 1) for r in reports],
            [round(r['resident_ms'], 2) for r in reports],
            batch * 1e3 / reports[0]['resident_ms']))
  return reports[0]


def ring_rank(rank, world, out_dir):
  """One rank of ``phase_ring_train``: trains RING_STEPS steps through
  ``train_eval_model`` and checks the launches, the losses, the weights on
  every rank and the checkpoint; one ring step against one flash step;
  a profile; the trained checkpoint served by the flash policy."""
  import torch.distributed as dist
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.parallel import mesh
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  sequence = mesh.init_sequence_group(
      'cuda', init_method='file://' + os.path.join(out_dir, 'init'),
      rank=rank, world_size=world, local_rank=rank)
  device, group = sequence.device, sequence.group
  batch = 8 if world == 1 else 32
  model = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                         attention_mode='ring', process_group=group,
                         learning_rate=1e-4, device=device)
  data = input_generators.DefaultRandomInputGenerator(batch_size=batch)
  model_dir = os.path.join(out_dir, 'model')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  start = time.monotonic()
  result = train_eval.train_eval_model(
      model, model_dir, data, max_train_steps=RING_STEPS, log_every_n_steps=1,
      save_checkpoints_steps=RING_STEPS, nan_policy='raise', seed=0)
  elapsed = time.monotonic() - start
  launches = dict(kernels.LAUNCHES)
  peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
  state, trainer = result['state'], result['trainer']
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': RING_STEPS,
               'flash_attention_carry': 8 * world * RING_STEPS})
  check(launches == want, 'rank {}: ring train launch counts {} != expected '
        '{}'.format(rank, launches, want))
  loss = trainer.last_metrics['loss']
  check(state.step == RING_STEPS and np.isfinite(loss),
        'ring training ended at step {} with loss {}'.format(state.step, loss))
  # Equal weights on every rank: per-tensor sums and sums of squares, their
  # minimum and maximum over the ranks.
  sums = torch.stack([torch.stack([p.double().sum(), p.double().square()
                                   .sum()]) for p in state.params.values()])
  low, high = sums.clone(), sums.clone()
  dist.all_reduce(low, dist.ReduceOp.MIN)
  dist.all_reduce(high, dist.ReduceOp.MAX)
  check(torch.equal(low, high), 'the ranks\' weights differ after training')
  dist.barrier()
  if rank == 0:
    restored = checkpointing.CheckpointManager(model_dir).restore(
        device=device)
    check(_states_equal(restored, state),
          'the ring checkpoint does not restore the final state')
    del restored
  windows = trainer.windows[1:]
  step_ms = statistics.median(w[1] * 1e3 for w in windows)
  data_ms = statistics.median(w[2] * 1e3 for w in windows)
  report = dict(rank=rank, world=world, batch=batch, launches=launches,
                peak_gb=peak_gb, step_ms=step_ms, data_ms=data_ms, loss=loss,
                metrics=trainer.last_metrics, seconds=elapsed)
  if rank == 0:
    print('seq2act ring train: world {}, {} steps of batch {} x {} frames '
          '({} tokens, {} a rank) in {:.1f}s, launches a rank {}; loss {:.4f}, '
          'action_accuracy {:.4f}, action_mae {:.4f}; median step {:.1f} ms '
          '({:.2f} episodes/s), of which {:.1f} ms waiting for the batch; peak '
          'memory {:.2f} GB on rank 0 (max_memory_allocated); weights equal '
          'on every rank; checkpoint restores equal; {}'.format(
              world, RING_STEPS, batch, SEQ2ACT_EPISODE, 8 * SEQ2ACT_EPISODE,
              8 * SEQ2ACT_EPISODE // world, elapsed, launches, loss,
              trainer.last_metrics['action_accuracy'],
              trainer.last_metrics['action_mae'], step_ms,
              batch * 1e3 / step_ms, data_ms, peak_gb, smi_line()))

  # The whole batch, for the comparison with a flash step below; this
  # rank's frames of it for the resident-batch step.
  numpy_features, numpy_labels = next(data.create_dataset_iterator(
      ModeKeys.TRAIN, seed=1, prefetch=0))
  raw = trainer.put_batch(model.shard_batch(numpy_features))
  labels = trainer.put_batch(model.shard_batch(numpy_labels))

  # The resident-batch step: timed on every rank from a barrier, then
  # profiled on the last rank while the others step with it.
  current = [state]

  def step(_):
    features, batch_labels = model.preprocessor.preprocess(
        raw, labels, ModeKeys.TRAIN,
        generator=trainer.crop_generator(current[0].step))
    current[0], metrics = model.train_step(current[0], features,
                                           batch_labels)
    float(metrics['loss'])

  step(0)   # warm
  dist.barrier()
  start = time.monotonic()
  for i in range(2):
    step(i)
  torch.cuda.synchronize()
  report['resident_ms'] = (time.monotonic() - start) * 1e3 / 2
  if rank == world - 1:
    # The last rank sees every other rank's block unmasked: the most work.
    profile('seq2act ring train profile (rank {})'.format(rank), step, 2,
            'step of {}'.format(batch))
  else:
    for i in range(2):
      step(i)
  del current, raw, labels
  ring_vs_flash(model, state, numpy_features, numpy_labels, rank, device)
  dist.barrier()
  if rank == 0:
    flash = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                           attention_mode='flash', device=device)
    phase_seq2act_train_serve(flash, model_dir, state)
  dist.barrier()
  with open(os.path.join(out_dir, 'rank{}.json'.format(rank)), 'w') as f:
    json.dump(report, f)
  dist.destroy_process_group()


# One ring step against one flash step: batch 8, the flash training phase's
# batch, which one card holds.
RING_VS_FLASH_BATCH = 8


def ring_vs_flash(model, state, numpy_features, numpy_labels, rank, device):
  """One ring step (gradients summed over the group) and, on rank 0, one
  flash step from the same state on the same RING_VS_FLASH_BATCH episodes
  and crop offsets: the loss within 1e-5 relative, every gradient within
  1e-4 of its scale."""
  import torch.distributed as dist
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel

  b = RING_VS_FLASH_BATCH
  offsets = torch.tensor([[3, 5]] * b, dtype=torch.int32, device=device)

  def batch_of(arrays, shard):
    arrays = {k: v[:b] for k, v in arrays.items()}
    arrays = model.shard_batch(arrays) if shard else arrays
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}

  features, _ = model.preprocessor.preprocess(
      batch_of(numpy_features, True), None, ModeKeys.TRAIN, offsets=offsets)
  before = dict(kernels.LAUNCHES)
  _, ring_out, _, ring_grads = model.gradients(
      state, features, batch_of(numpy_labels, True))
  check(kernels.LAUNCHES['flash_attention_carry'] > before[
      'flash_attention_carry'], 'the ring step launched no K6')
  ring_loss = ring_out['loss']
  del features
  dist.barrier()
  if rank == 0:
    flash = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                           attention_mode='flash', device=device)
    features, _ = flash.preprocessor.preprocess(
        batch_of(numpy_features, False), None, ModeKeys.TRAIN,
        offsets=offsets)
    flash_loss, _, _, flash_grads = flash.gradients(
        state, features, batch_of(numpy_labels, False))
    del features
    torch.cuda.synchronize()
    print('seq2act ring step vs flash step (batch {}, the same state, '
          'episodes and crops): {}'.format(b, compare_steps(
              'ring vs flash', ring_loss, flash_loss, ring_grads,
              flash_grads)))
    del flash_grads
  del ring_grads
  torch.cuda.empty_cache()


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; nothing measured.', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  device = torch.device('cuda')
  gen = torch.Generator(device=device).manual_seed(0)
  world = min(4, torch.cuda.device_count())
  phase_device()
  crop = phase_crop(device, gen)
  pool = phase_pool(device, gen)
  pool_backward = phase_pool_backward(device, gen)
  wgrad_entry = phase_wgrad(device, gen)
  flash = phase_flash(device, gen)
  flash_kv, flash_q = phase_flash_backward(device, gen)
  paths = {'serve': phase_slice(device), 'train': phase_train(device),
           'seq2act': phase_seq2act(device),
           'seq2act_train': phase_seq2act_train(device)}
  # K1 and K2f report their serving launches, K2b and K3 their training
  # ones, K4 its seq2act ones, K5a and K5b their seq2act training ones, K6
  # its ring training ones; every path's counts are listed too.
  entries = [(crop, 'serve'), (pool, 'serve'), (pool_backward, 'train'),
             (wgrad_entry, 'train'), (flash, 'seq2act'),
             (flash_kv, 'seq2act_train'), (flash_q, 'seq2act_train')]
  carry = phase_ring_kernel(device, gen, world)
  ring = phase_ring_train(world)
  # The ring path's counts are rank 0's (every rank checked its own).
  paths['seq2act_ring_train'] = ring['launches']
  carry['world_size'] = world
  carry['ring_step_ms'] = ring['step_ms']
  carry['ring_resident_ms'] = ring['resident_ms']
  carry['ring_peak_gb'] = ring['peak_gb']
  entries.append((carry, 'seq2act_ring_train'))
  for entry, main_path in entries:
    entry['launches'] = paths[main_path][entry['name']]
    entry['launches_by_path'] = {path: launches[entry['name']]
                                 for path, launches in paths.items()}
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
