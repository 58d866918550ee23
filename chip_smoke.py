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
     off 16 bytes; all three are timed behind a device sleep, so that the
     events time the device and not the host queueing a short call: K1 at
     the served batch, K2f at the served pools and with its index at the
     critic's training pools, K2b at those training pools); K3
     (the 5x5 weight gradient, float32-grade 3xTF32 products on the tensor
     cores) within 1e-4 of max|plain|, the float32 sums being taken in
     another order; K4 (the flash attention forward, 3xTF32 on the tensor
     cores) at the served shape (8 heads
     x 4096 x 64, causal, read by strides out of the qkv projection, f32
     and bf16) and at odd shapes, O within 1e-5 (f32) or 2e-2 (bf16) and
     LSE within 1e-5, timed beside scaled_dot_product_attention (whose
     kernels the profiler names) at the served shape and at the training
     shape (batch 8), each also in bf16 beside scaled_dot_product_attention
     in bf16 (bound: bytes, or the products at the dense bf16 peak, 989
     TFLOP/s); K5a and
     K5b (the flash attention backward: dk and dv, dq) at the training
     shape (batch 8) in f32 and bf16 and at an odd shape, dq, dk and dv
     within 1e-4 (f32) or 2e-2 (bf16) of each one's max|plain| and the
     same bits run to run, timed each alone beside the plain backward
     (median of 10) and the backward of scaled_dot_product_attention, and
     in bf16 beside its bf16 backward. K3,
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
  4b. Records: the operator's workflow at full width. The JPEG probe
     (PIL, cv2, jpeglib.h, libjpeg and libnvjpeg in ldconfig, nvjpeg.h)
     and the loader's decoder: libjpeg where its header is, else nvJPEG.
     RECORDS critic examples (512x640x3 JPEG frames, encoded by cv2 or
     PIL) in RECORD_FILES files, written by the port's writer under the
     critic's on-disk names; the native loader's records/s and MB/s at
     batch 32 with its thread count; its pixels against libjpeg's (OpenCV)
     on the same records within JPEG_PIXEL_ATOL for nvJPEG (0 for
     libjpeg), every other field bit-equal. ``train_eval.main
     --train_data`` trains the flagship critic TRAIN_STEPS steps at batch
     32 from them through the native loader, from a step-0 checkpoint of
     fan-in-scale weights, with the counters zeroed just before and read
     just after (phase 4's counts); the loop's median step and data wait
     and a profiled resident step, beside phase 4's. Then ``serve.py
     --checkpoint_dir`` (``serve.start``, polling every POLL_SECS) answers
     THREADS closed-loop clients for SERVE_SECONDS while a newer
     checkpoint (one more step) is committed: no request may fail, the
     poll must swap it in, and its first answer must come within
     SWAP_POLLS polls of the commit (the latency printed); the counters,
     zeroed before the server starts, must show 1 K1 and 6 K2f for every
     batch (the warm batch included). A batch on the new step must score its actions as the newer
     checkpoint's avg_params do without the serving code (1e-4 of max).
  4c. The split decode (train_qtopt_sparse.gin's wire) on phase 4b's
     records, nothing new encoded: the loader stops after the entropy stage
     (the port's own baseline Huffman decoder, on the host: no card bound)
     and ships the quantized DCT coefficients. A 'coef' batch finished on
     the card against OpenCV's (PIL's where it is absent) decode of the
     same bytes within JPEG_PIXEL_ATOL (max, mean and the share within 1
     printed); 'coef_sparse' and 'coef_packed' batches unpacked on the card
     by the feed bit-equal to the 'coef' batch; the card's finish within 1
     level of the CPU's (the share equal printed); the bytes a batch ships
     in each wire against its pixels'. The loader alone in 'coef_sparse'
     at 4b's threads (records/s, worker ms a record, bytes a batch) beside
     4b's. ``train_eval.main --device_decode sparse`` trains TRAIN_STEPS
     steps at batch 32 from 4b's step-0 weights at each of
     COEF_FEED_DEPTHS, with the counters zeroed just before and read just
     after (phase 4's counts), every loss finite (``--nan_policy raise``),
     the checkpoint restoring the final state and one batch shape after the
     unpack. The loader alone under the profiler: coef_sparse makes no
     copy and runs no kernel on the card (the pixel loader's, nvJPEG's on
     the card's host, printed beside). Then a profiled resident step on a
     coefficient batch (unpack and finish included), the unpack's and the
     finish's device time, and the loop profiled with the live loader
     through the feed, its copies a step beside the resident step's.
  4d. The gins, on phase 4b's records (nothing new written): ``train_eval
     --gin_configs`` on the port's ``train_qtopt.gin`` with bindings for
     the records, GIN_STEPS steps (cut: the steps), a checkpoint and an
     eval of GIN_EVAL_STEPS batches every GIN_SAVE_STEPS, every
     photometric distortion on, ``nan_policy`` raise (every loss finite),
     the counters zeroed just before and read just after (phase 4's
     counts a step, and 1 K1 and 3 K2f an eval batch); the default
     exporters leave ``best_exporter`` and ``latest_exporter`` versions;
     the loop's median step and data wait beside 4b's. A distorted step
     through the kernels against its plain rerun (the image bit-equal);
     the card's distortions against the CPU's on the same parameters
     (within DISTORTION_ATOL); the distortions' device time and kernels a
     batch, and the resident step with and without them. Without
     distortions, the gin's state after 2 steps against ``train_eval
     --model qtopt``'s with the same flags and seed, bit for bit (cuDNN
     deterministic in both). rmsprop with an exponential decay for
     GIN_SHORT_STEPS steps (every loss finite), while a second process
     runs ``train_eval`` with no train generator over its checkpoints:
     its metrics must equal the trainer's own eval at each step it
     evaluated (the last included), and the lag from each checkpoint's
     commit to its result is printed. A NaN label under ``nan_policy``
     rollback: one rollback to the last checkpoint, counted. Then
     ``serve.py --export_dir`` on ``latest_exporter`` under THREADS
     clients for SERVE_SECONDS while a newer export lands (0 failed, the
     swap within SWAP_POLLS polls, phase 4b's serving counts; the export's
     write time printed), and ExportedModelPredictor's actions against
     CheckpointPredictor's on the same step and CEM seed (1e-4).
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
  6b. Seq2Act records: SEQ2ACT_EPISODES episodes of the same binding (512
     frames of 136x168x3 JPEG by cv2 or PIL, under the JAX model's names:
     ``image0``, ``action``; an action's dims 0 and 1 name its episode and
     frame) in SEQ2ACT_EPISODE_FILES files, written by the port's writer;
     the native loader alone (records/s, frames/s, MB/s, its threads and
     worker ms a frame, the CUDA device it decoded on, which must be the
     caller's under nvJPEG); its frames against libjpeg's (OpenCV) within
     JPEG_PIXEL_ATOL for nvJPEG (0 for libjpeg), every other field
     bit-equal. ``train_eval.main --model seq2act --train_data`` trains
     SEQ2ACT_RECORDS_STEPS steps at batch 8 with flash attention from
     them, with the counters zeroed just before and read just after: 1 K1
     and 8 each of K4, K5a and K5b a step; finite losses, a checkpoint that
     restores the final state. Then one step on a batch of the records
     through the kernels and through the plain versions (as in phase 6),
     a profiled resident step, and the loop's median step and data wait
     and its loader's numbers beside phase 6's.
  6c. Seq2Act in bf16: the port's ``train_seq2act_bc.gin`` as written
     (``device_type = "tpu"``) with the long-context binding (512 frames,
     flash), configured as ``train_eval --gin_configs`` configures it, at
     batch 8 on random episodes for SEQ2ACT_BF16_STEPS steps, the counters
     zeroed just before and read just after: 1 K1 and 8 each of K4, K5a and
     K5b a step, every q that reaches them bf16; every loss finite; params
     and adam state float32; the checkpoint restores equal. One step on one
     episode through the kernels and through the plain versions within
     BF16_STEP_BOUNDS by group of parameters, a profiled resident step and
     the peak memory; then SequentialRegressionPolicy over the trained
     checkpoint: 1 K1 and 8 K4 (bf16) a predict, finite float32 bin
     centers, the logits within BF16_LOGITS_RTOL of the plain versions'
     and equal to the trained params' predict_step, the wall ms a call
     against the 33 ms tick, and a profile.
  6d. The MoE gin: ``train_eval --gin_configs`` on the port's
     ``train_seq2act_moe.gin`` as written (6-frame episodes, batch 32, bf16,
     8 experts, top 2) from MOE_EPISODES records of 6 frames written by the
     port's writer, MOE_STEPS steps with ``TRAIN_DATA`` bound: 1 K1 a step
     (48 tokens: 'auto' attention is dense, as in JAX), the loop's step and
     data wait, the peak memory; on a batch of them the aux loss, the share
     of (token, choice) pairs dropped over capacity and the MoE layers'
     device ms a step. A DROPOUT_STEPS run with ``dropout_rate = 0.1`` and
     its rerun from the same seed, equal bit for bit. Then the same gin
     with the long-context binding at batch 8 from phase 6b's episodes:
     1 K1 and 8 each of K4, K5a, K5b (bf16) a step, the peak memory within
     the card, the same MoE numbers and a profiled resident step.
  7. Ring attention's kernel: K6 (the carried flash update, the ring's
     hop) against its plain version at the 4-rank hop shape [8, 1024, 8,
     64] (diagonal, full and hidden hops from a carried state, f32 and
     bf16), at an odd shape (Lq 100 != Lk 72, head dim 128) and at a hop
     hidden from its first 20 queries only (offsets 128/148: the first
     warp takes no key tile, and its rows must stay bit-equal), o, m and l
     within 1e-5 of their max, a hidden hop leaving the state as it was;
     the same bits run to run; a view whose rows are not 16-byte aligned
     refused with ValueError; the four-shard hop schedule of a [8, 4096,
     8, 64] causal sequence replayed on one card, O and LSE within 1e-5 of
     max of K4's over the whole sequence; K6 (3xTF32 on the tensor cores,
     K4's tile loop) timed at the main path's launch shape beside its
     plain version and at the 4-rank diagonal and full hops, each beside
     both bounds, and its SASS's HMMA (which must not be 0), LDS and
     integer counts.
  8. Seq2Act ring training: ``min(4, cards)`` NCCL ranks, one process a
     card, each train the full-width 512-frame binding with
     ``attention_mode='ring'`` for RING_STEPS steps through
     ``train_eval_model`` (batch 8 at one rank, the gin's 32 at four) from
     phase 6b's episodes, each rank's loader decoding only its 512/N
     frames, with the counters zeroed just before and read just after: 1
     K1 and 8 x N K6 launches a step a rank, no K4 or K5. Every loss
     finite, the weights equal on every rank (per-tensor checksums, their
     minimum and maximum over the ranks), rank 0's checkpoint restores
     equal; each rank's loader given its card's index (and decoding there
     under nvJPEG), its batches holding frames [r 512/N, (r + 1) 512/N) and
     the same episodes as every other rank's at every step (an all-gather
     of the episodes their actions name); two resident
     steps timed on every rank from a barrier, and two profiled on the
     last rank (the one with the most unmasked hops); one ring step against one flash step from the same
     state on the same 8 episodes and crops (loss within 1e-5 relative,
     every gradient within 1e-4 of its scale); the trained checkpoint
     served by the flash SequentialRegressionPolicy gives the trained
     params' logits (1e-4). Then each rank runs ``train_eval
     --gin_configs`` on ``train_seq2act_bc.gin`` with ``attention_mode =
     "ring"`` bound, as torchrun starts it (main_gin builds the NCCL group
     and destroys it), RING_GIN_STEPS steps in float32 at the same shape
     and from the same episodes: 8 x N K6 a step a rank, and rank 0's loss
     within RING_GIN_RTOL of the first run's at that step.
  9. A JSON line of phases 6c's, 6d's and the ring gin's numbers
     (``seq2act_variants``), a JSON line of the kernels (K4, K5a and K5b
     with their bf16 times, bounds at the bf16 peak and the library's bf16
     times), the card's name and power limit, and the last line ``{"ok":
     true, "device": {...}}``. K1's, K2f's and
     K2b's ms, plain_ms and library_ms are device time, each call queued
     behind a device sleep; their ms_with_host, and every other kernel's
     ms, is one call between two events as the host queues it.

Any failed check raises, so the script exits non-zero.
"""

import argparse
import collections
import contextlib
import functools
import io
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
BF16_OPS_PER_S = 989e12   # dense bf16 tensor-core peak

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
# The records phase: critic examples on disk in train_qtopt.gin's layout,
# the files they are in, the server's checkpoint poll and the serving
# clients' seconds.
RECORDS, RECORD_FILES = 256, 4
POLL_SECS, SWAP_POLLS, SERVE_SECONDS = 1.0, 5, 10.0
# nvJPEG's pixels against libjpeg's on the same records: the loader
# upsamples and converts nvJPEG's planes as libjpeg does, so only the IDCT
# differs, by up to 1 in Y, Cb and Cr, which the colour conversion takes to
# up to 3 in R, G or B (1 + 1.772 for B); 4 leaves one for rounding.
JPEG_PIXEL_ATOL = 4
# The random generator's loops (phases 4 and 6), beside the records' (phases
# 4b and 6b).
RANDOM_LOOP = {}
RANDOM_SEQ2ACT_LOOP = {}
# Phase 4b's loader and loop, beside phase 4c's and 4d's.
RECORDS_LOOP = {}
# Phase 4d's gin loop.
GIN_LOOP = {}
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


def bf16_bound_ms(nbytes, flops):
  """The least time for bf16 work: the larger of bytes over the memory
  rate and the products over the dense bf16 tensor-core peak; and which
  one bounds it."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / BF16_OPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


SASS_OPCODE = re.compile(r'\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)'
                         r'((?:\.[A-Z0-9_]+)*)')
SASS_FUNCTION = re.compile(r'\s*Function : (\S+)')
# Opcodes also counted by their full form: the tensor-core products by
# shape and types ('HMMA.16816.F32.BF16', 'HMMA.1688.F32.TF32'), ldmatrix
# by its layout ('LDSM.16.M88.4', transposed 'LDSM.16.MT88.4').
SASS_FORMS = ('HMMA', 'LDSM')
# Integer and address arithmetic, beside the products (HMMA) and the
# shared-memory loads (LDS) that the flash kernels' loops issue.
SASS_INTEGER = ('IMAD', 'IADD3', 'LOP3', 'LEA', 'SHF', 'VIADD')


def sass_opcodes(name, library=None, function=None):
  """Opcode counts over a built kernel's SASS (of the library at
  ``library`` if given): all its functions, or only those whose mangled
  name holds ``function``. SASS_FORMS are also counted by full form."""
  from tensor2robot_tpu_torch import kernels
  tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin',
                      'cuobjdump')
  library = library or kernels.library_path(name)
  sass = subprocess.run([tool, '--dump-sass', str(library)],
                        check=True, capture_output=True, text=True).stdout
  counts = collections.Counter()
  current = ''
  for line in sass.splitlines():
    header = SASS_FUNCTION.match(line)
    if header:
      current = header.group(1)
      continue
    if function is not None and function not in current:
      continue
    match = SASS_OPCODE.match(line)
    if match:
      counts[match.group(1)] += 1
      if match.group(1) in SASS_FORMS:
        counts[match.group(1) + match.group(2)] += 1
  return counts


def sass_hmma(name):
  """The tensor-core (HMMA) instructions in a built kernel's SASS."""
  return sass_opcodes(name)['HMMA']


def sass_mix(name, library=None, function=None):
  """HMMA, LDS, LDSM and integer-arithmetic counts of a kernel's SASS (of
  its functions whose name holds ``function``, if given), and the HMMA and
  LDSM counts by full form."""
  counts = sass_opcodes(name, library, function)
  if function is not None:
    check(sum(counts.values()) > 0, 'no function {} in the SASS of {}'.format(
        function, name))
  return {'HMMA': counts['HMMA'], 'LDS': counts['LDS'],
          'LDSM': counts['LDSM'],
          'integer': sum(counts[op] for op in SASS_INTEGER),
          'forms': {op: n for op, n in sorted(counts.items())
                    if op.startswith(tuple(f + '.' for f in SASS_FORMS))}}


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
      function = ''
      for line in log.read_text().splitlines():
        entry = PTXAS_ENTRY.search(line)
        if entry:
          function = kernel_label(entry.group(1))
        if 'registers' in line or 'spill' in line:
          print('  ptxas {} {}: {}'.format(name, function, line.strip()))


PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def kernel_label(mangled):
  """A short label of a mangled kernel name: its identifier, the type of a
  float or bf16 instance and its integer template arguments, as in
  'flash_bwd_kv_bf16_kernel<64>' or 'flash_fwd_kernel<bf16,64,0>'."""
  i = 0
  while i < len(mangled):
    digits = re.match(r'\d+', mangled[i:])
    if not digits:
      i += 1
      continue
    start = i + digits.end()
    ident = mangled[start:start + int(digits.group())]
    i = start + len(ident)
    if ident.endswith('kernel'):
      rest = mangled[i:]
      args = ['bf16' if rest.startswith('I13__nv_bfloat16') else
              'float' if rest.startswith('If') else None]
      args += re.findall(r'L[ib](\d+)E', rest[:48])
      return '{}<{}>'.format(ident, ','.join(a for a in args if a))
  return mangled[:60]


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
  def kernel():
    return pallas_crop.crop_convert(images, center, (th, tw))

  # One crop takes the device less time than the host takes to queue it:
  # the device's time, and one call between events with the host beside.
  ms = median_ms(kernel, host_ahead=True)
  ms_with_host = median_ms(kernel)
  plain = median_ms(
      lambda: pallas_crop.crop_convert_plain(images, center, (th, tw)),
      host_ahead=True)
  elements = b * th * tw * c
  # The crop window is what the function must read: 1 byte in, 4 out.
  bound, by = bound_ms(elements * 5 + center.numel() * 4, elements)
  print('crop_convert [8,512,640,3] u8 -> [8,472,472,3] f32: bit-exact '
        '(center and clamped offsets, f32 and bf16); {:.4f} ms of device '
        'time ({:.1f}% of the bound; {:.4f} ms one call with the host), '
        'plain {:.4f} ms, bound {:.4f} ms ({}); {}'.format(
            ms, 100 * bound / ms, ms_with_host, plain, bound, by,
            smi_line()))
  return {'name': 'crop_convert', 'route': 'cuda',
          'source': 'tensor2robot_tpu_torch/csrc/crop_convert.cu',
          'replaces': 'tensor2robot_tpu/preprocessors/pallas_crop.py:117',
          'max_abs_err': err, 'ms': ms, 'ms_with_host': ms_with_host,
          'plain_ms': plain, 'bound_ms': bound, 'bound_by': by,
          'library_ms': None,
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


def profile(label, run, calls, unit, top=16, out=None):
  """Where the time of ``calls`` runs of ``run(i)`` goes: device time by
  kernel from torch.profiler, the wall time per run (ending in a
  synchronize) and the device's busy share of it. Returns the wall ms per
  run; ``out``, a dict, also gets the busy ms per run, the device ms per
  run of each kernel by name ('kernel_ms') and the copies per run by kind
  ('HtoD', 'DtoH', 'DtoD')."""
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
  if out is not None:
    out['copies'] = {kind: sum(e.count for e in prof.key_averages()
                               if e.key.startswith('Memcpy ' + kind)) / calls
                     for kind in ('HtoD', 'DtoH', 'DtoD')}
  if not rows:
    print('{}: the profiler saw no device time; not measured'.format(label))
    return wall_ms
  rows.sort(reverse=True)
  if out is not None:
    out['kernel_ms'] = {name: ms for ms, _, name in rows}
  # NCCL's kernels run on their own stream, beside the compute, and wait
  # there for the peer ranks: counted apart.
  comm_ms = sum(ms for ms, _, name in rows if name.startswith('nccl'))
  busy_ms = sum(ms for ms, _, _ in rows) - comm_ms
  if out is not None:
    out['busy_ms'] = busy_ms
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
  from tensor2robot_tpu_torch.modes import ModeKeys
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
  RANDOM_LOOP.update(step_ms=step_ms, data_wait_ms=statistics.median(
      w[2] * 1e3 for w in steps))
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
  with plain_kernels():
    plain_image, (want_loss, want) = one_step()
  torch.cuda.synchronize()
  check(torch.equal(image, plain_image), 'the TRAIN crop differs from plain')
  print('train step, kernels vs plain versions: {}; crop bit-exact'.format(
      compare_critic_steps('kernels vs plain', model, got_loss, want_loss,
                           got, want)))
  card_vs_cpu_critic_step(model, state, raw, labels, offsets)
  time_float64_weight_grads(device)

  RANDOM_LOOP['resident_ms'] = train_profile(
      'train profile', trainer, model, state, raw, labels, 3, TRAIN_BATCH)
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


def train_profile(label, trainer, model, state, raw, labels, steps, batch,
                  out=None):
  """``profile`` of train steps (crop + forward + backward + optimizer)
  on a resident batch, after one warm step; prints examples/s. ``out``:
  as ``profile``'s."""
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
  wall_ms = profile(label, step, steps, 'step of {}'.format(batch), out=out)
  print('{}: {:.2f} examples/s on a resident batch'.format(
      label, batch * 1e3 / wall_ms))
  return wall_ms


# The flash kernels' rows in a profile, by a piece of their function names
# (K4's, K5a's and K5b's bf16 and float32 instances alike).
FLASH_PROFILE_NAMES = (('K4', 'flash_fwd'), ('K5a', 'flash_bwd_kv'),
                       ('K5b', 'flash_bwd_q'))


def flash_step_ms(label, out, resident_ms, peak_gb):
  """Prints a train profile's (``out`` of ``train_profile``) flash kernels'
  device ms a step beside its resident step, busy time and peak memory and
  the card; returns the kernels' ms by id."""
  kernel_ms = out.get('kernel_ms')
  if kernel_ms is None:
    print('{}: the profiler saw no kernels; not measured'.format(label))
    return None
  ms = {k: sum(t for name, t in kernel_ms.items() if piece in name)
        for k, piece in FLASH_PROFILE_NAMES}
  busy = out.get('busy_ms')
  print('{}: resident step {:.2f} ms, kernels busy {} ms; of it K5a {:.2f} '
        'ms a step, K5b {:.2f}, K4 {:.2f}; peak memory {:.2f} GB; {}'.format(
            label, resident_ms, 'not measured' if busy is None else
            '{:.2f}'.format(busy), ms['K5a'], ms['K5b'], ms['K4'], peak_gb,
            smi_line()))
  return ms


def jpeg_probe():
  """What this host offers to encode and decode JPEG."""
  import importlib

  from tensor2robot_tpu_torch.data import native_loader

  found = {}
  for module in ('PIL', 'cv2'):
    try:
      importlib.import_module(module)
      found[module] = True
    except ImportError:
      found[module] = False
  found['jpeglib.h'] = any(os.path.exists(path)
                           for path in native_loader.JPEGLIB_HEADERS)
  libraries = subprocess.run(['ldconfig', '-p'], capture_output=True,
                             text=True).stdout
  found['libjpeg in ldconfig'] = 'libjpeg.so' in libraries
  found['libnvjpeg in ldconfig'] = 'libnvjpeg.so' in libraries
  found['nvjpeg.h'] = os.path.exists(os.path.join(
      os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'include',
      'nvjpeg.h'))
  return found


def encode_jpeg(image, encoder):
  """An RGB uint8 frame as JPEG bytes (quality 95, 4:2:0), by ``encoder``:
  'cv2' or 'PIL'."""
  if encoder == 'cv2':
    import cv2
    ok, encoded = cv2.imencode('.jpg', image[..., ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, 95])
    check(ok, 'cv2 could not encode a frame')
    return encoded.tobytes()
  import io
  from PIL import Image
  out = io.BytesIO()
  Image.fromarray(image).save(out, format='JPEG', quality=95)
  return out.getvalue()


def camera_frame(rng, index):
  """A 512x640 RGB frame with a camera's kind of content: smooth ramps,
  shifted a frame, and sensor noise."""
  yy, xx = np.mgrid[0:512, 0:640]
  image = np.stack([xx + 7 * index, yy + 3 * index, (xx + yy) // 2], -1)
  return np.clip(image % 256 + rng.randint(-6, 7, image.shape), 0,
                 255).astype(np.uint8)


def write_critic_records(directory, feature_spec, label_spec, encoder):
  """RECORDS critic examples in RECORD_FILES files, by the port's writer,
  under the critic's on-disk names; returns (files, bytes of frames)."""
  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter

  spec = {**{'features/' + k: v for k, v in feature_spec.items()},
          **{'labels/' + k: v for k, v in label_spec.items()}}
  rng = np.random.RandomState(0)
  files, frame_bytes = [], 0
  for f in range(RECORD_FILES):
    files.append(os.path.join(directory, 'train-{:05d}-of-{:05d}.tfrecord'
                              .format(f, RECORD_FILES)))
    with TFRecordReplayWriter() as writer:
      writer.open(files[-1])
      for i in range(RECORDS // RECORD_FILES):
        example = {}
        for key, (shape, dtype) in spec.items():
          if key == 'features/state/image':
            example[key] = encode_jpeg(camera_frame(rng, f * 64 + i),
                                       encoder)
            frame_bytes += len(example[key])
          elif key == 'labels/reward':
            example[key] = np.asarray([rng.rand() < 0.3], np.float32)
          else:
            example[key] = rng.uniform(-1, 1, shape).astype(dtype)
        writer.write_numpy(spec, example)
  return files, frame_bytes


def phase_records(device, data_dir):
  """The operator's workflow at full width: critic records on disk (in
  ``data_dir``, which phase 4c reads again), the native loader,
  train_eval --train_data, the checkpoint served by serve.py
  --checkpoint_dir, and a newer checkpoint hot-swapped in while requests go
  on. Returns the launch counts of its train and serve paths."""
  import contextlib
  import io

  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.data import parser
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  probe = jpeg_probe()
  encoder = 'cv2' if probe['cv2'] else 'PIL' if probe['PIL'] else None
  check(encoder is not None, 'no JPEG encoder (cv2 or PIL) on this host')
  decoder = native_loader.jpeg_decoder()
  print('records: JPEG probe {}; frames encoded with {}, the loader decodes '
        'with {}; {}'.format(json.dumps(probe), encoder, decoder,
                             smi_line()))
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device=device, network_kwargs={'num_convs': NUM_CONVS})
  feature_spec = model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)
  label_spec = model.preprocessor.get_in_label_specification(ModeKeys.TRAIN)
  with tempfile.TemporaryDirectory() as tmp:
    model_dir = os.path.join(tmp, 'model')
    start = time.monotonic()
    files, frame_bytes = write_critic_records(data_dir, feature_spec,
                                              label_spec, encoder)
    record_bytes = sum(os.path.getsize(f) for f in files)
    print('records: wrote {} critic examples (512x640x3 JPEG frames by {}, '
          '{:.1f} KB a frame; {:.1f} MB in {} files) in {:.1f} s'.format(
              RECORDS, encoder, frame_bytes / RECORDS / 1024,
              record_bytes / 1e6, RECORD_FILES, time.monotonic() - start))

    # The loader alone: three shuffled epochs at the train batch, after
    # one batch that makes the decoder's process-wide state.
    plan = native_loader.plan_for_specs(feature_spec, label_spec)
    check(plan is not None, 'the native loader does not plan the critic')

    def stream_of(epochs):
      return native_loader.NativeBatchedStream(
          plan, files, batch_size=TRAIN_BATCH, shuffle=True, seed=0,
          num_epochs=epochs)

    start = time.monotonic()
    library = native_loader.build_native()
    build_s = time.monotonic() - start
    start = time.monotonic()
    stream = stream_of(1)
    next(iter(stream))
    stream.close()
    first_ms = (time.monotonic() - start) * 1e3
    stream = stream_of(3)
    start = time.monotonic()
    batch_bytes = []
    for features, labels in stream:
      batch_bytes.append(sum(v.nbytes for part in (features, labels)
                             for v in part.values()))
    batches = len(batch_bytes)
    seconds = time.monotonic() - start
    stats = stream.stats()
    stream.close()
    RECORDS_LOOP.update(
        decoder=decoder, threads=stream.num_threads,
        records_per_s=batches * TRAIN_BATCH / seconds,
        worker_ms=stats['worker_busy_us'] / 1e3 / stats['rows_parsed'],
        batch_bytes=statistics.mean(batch_bytes))
    check(batches == 3 * RECORDS // TRAIN_BATCH, 'the loader gave {} '
          'batches'.format(batches))
    print('records: the native loader ({}, {} threads) reads {} batches of '
          '{} at 512x640 in {:.3f} s: {:.1f} records/s, {:.1f} MB/s of '
          'records, {:.2f} ms of a worker a record; its workers were busy '
          '{:.3f} s, idle {:.3f} s; the loader built in {:.1f} s ({}), the '
          'first batch of the process {:.1f} ms; {}'.format(
              decoder, stream.num_threads, batches, TRAIN_BATCH, seconds,
              batches * TRAIN_BATCH / seconds,
              stats['bytes_read'] / seconds / 1e6,
              stats['worker_busy_us'] / 1e3 / stats['rows_parsed'],
              stats['worker_busy_us'] / 1e6, stats['worker_idle_us'] / 1e6,
              build_s, os.path.basename(library), first_ms, smi_line()))

    # The decoder's pixels against libjpeg's (OpenCV's) on the same records:
    # the first file's first batch, read in order.
    stream = native_loader.NativeBatchedStream(plan, files[:1],
                                               batch_size=TRAIN_BATCH,
                                               num_epochs=1)
    got, got_labels = next(iter(stream))
    stream.close()
    if probe['cv2']:
      want, want_labels = parser.ExampleParser(
          feature_spec, label_spec).parse_batch(
              tfrecord.read_all_records(files[0])[:TRAIN_BATCH])
      for key in want:
        if key != 'state/image':
          check(np.array_equal(got[key], want[key]), '{} differs from the '
                'Python parser\'s'.format(key))
      check(all(np.array_equal(got_labels[k], want_labels[k])
                for k in want_labels), 'labels differ from the parser\'s')
      diff = np.abs(got['state/image'].astype(np.int16) -
                    want['state/image'].astype(np.int16))
      atol = JPEG_PIXEL_ATOL if decoder == 'nvjpeg' else 0
      check(int(diff.max()) <= atol, '{} pixels differ from libjpeg\'s by '
            '{} (tolerance {})'.format(decoder, int(diff.max()), atol))
      print('records: {} pixels against libjpeg\'s (OpenCV) on {} frames: '
            'max |diff| {} (tolerance {}), mean {:.4f}, {:.2%} of values '
            'differ, {:.4%} by more than 2; every other field bit-equal'
            .format(decoder, TRAIN_BATCH, int(diff.max()), atol,
                    float(diff.mean()), float((diff > 0).mean()),
                    float((diff > 2).mean())))

    # Train through the command line from a step-0 checkpoint of weights at
    # fan-in scale (as phase 4 does, so that served weights tell apart).
    initial = model.create_train_state(torch.Generator().manual_seed(0))
    spread = spread_weights({**initial.params, **initial.model_state},
                            torch.Generator().manual_seed(2))
    initial.params = {k: spread[k] for k in initial.params}
    initial.model_state = {k: spread[k] for k in initial.model_state}
    initial.avg_params = {k: v.clone() for k, v in initial.params.items()}
    checkpointing.CheckpointManager(model_dir).save(initial)
    out = io.StringIO()
    kernels.reset_launches()
    start = time.monotonic()
    with contextlib.redirect_stdout(out):
      rc = train_eval.main([
          '--device', device.type, '--num_convs',
          ','.join(str(n) for n in NUM_CONVS),
          '--model_dir', model_dir, '--train_data',
          os.path.join(data_dir, 'train-*'),
          '--batch_size', str(TRAIN_BATCH), '--max_train_steps',
          str(TRAIN_STEPS), '--log_every_n_steps', '1',
          '--save_checkpoints_steps', str(TRAIN_STEPS)])
    elapsed = time.monotonic() - start
    train_launches = dict(kernels.LAUNCHES)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update({
        'crop_convert': TRAIN_STEPS, 'max_pool': 3 * TRAIN_STEPS,
        'max_pool_backward': 3 * TRAIN_STEPS,
        'conv5x5_wgrad': BODY_CONVS * TRAIN_STEPS})
    check(train_launches == want_launches, 'records train launch counts {} '
          '!= expected {}'.format(train_launches, want_launches))
    check(rc == 0 and line['data'] == 'native' and
          line['step'] == TRAIN_STEPS and
          np.isfinite(line['metrics']['loss']),
          'train_eval --train_data: {}'.format(line))
    state = checkpointing.CheckpointManager(model_dir).restore(
        TRAIN_STEPS, device)

    # The resident step, on one batch of the records.
    generator = input_generators.DefaultRecordInputGenerator(
        file_patterns=os.path.join(data_dir, 'train-*'),
        batch_size=TRAIN_BATCH, use_native=True)
    generator.set_specification_from_model(model, ModeKeys.TRAIN)
    trainer = train_eval.Trainer(model, tmp)
    numpy_features, numpy_labels = next(generator.create_dataset_iterator(
        ModeKeys.TRAIN, seed=0, prefetch=0))
    raw, labels = (trainer.put_batch(numpy_features),
                   trainer.put_batch(numpy_labels))
    resident_ms = train_profile('records train profile', trainer, model,
                                state, raw, labels, 3, TRAIN_BATCH)
    RECORDS_LOOP.update(step_ms=line['step_ms'],
                        data_wait_ms=line['data_wait_ms'],
                        resident_ms=resident_ms)
    print('records train: train_eval --train_data trained {} steps of batch '
          '{} from the records through the native loader in {:.1f} s, '
          'launches {}; loss {:.4f}. The loop\'s median step {:.2f} ms, of '
          'which {:.2f} ms waiting for data; a resident step {:.2f} ms. The '
          'random generator\'s loop (phase 4): step {:.2f} ms, data wait '
          '{:.2f} ms, resident step {:.2f} ms; {}'.format(
              TRAIN_STEPS, TRAIN_BATCH, elapsed, train_launches,
              line['metrics']['loss'], line['step_ms'], line['data_wait_ms'],
              resident_ms, RANDOM_LOOP['step_ms'],
              RANDOM_LOOP['data_wait_ms'], RANDOM_LOOP['resident_ms'],
              smi_line()))

    # The newer checkpoint: one more step from the trained state, saved
    # while the server answers requests.
    newer, _ = model.train_step(state, *model.preprocessor.preprocess(
        raw, labels, ModeKeys.TRAIN,
        generator=trainer.crop_generator(state.step)))
    torch.cuda.synchronize()
    check(newer.step == TRAIN_STEPS + 1, 'the newer state is at step {}'
          .format(newer.step))
    def commit():
      checkpointing.CheckpointManager(model_dir).save(newer)
      return newer.step

    serve_launches, served, _ = serve_swap(
        device, 'records serve', ['--checkpoint_dir', model_dir],
        TRAIN_STEPS, commit)

  # The served q of the newest weights, against the network's forward on
  # the newer checkpoint's weights without the serving code.
  states, results = served
  actions = torch.stack([torch.as_tensor(r.outputs['action'])
                         for r in results])
  q = torch.tensor([float(r.outputs['q']) for r in results])
  want_q, _ = critic_q(model, {**newer.avg_params, **newer.model_state},
                       states, actions[:, None])
  torch.cuda.synchronize()
  q_err = max_abs_err(q, want_q[:, 0].cpu()) / float(want_q.abs().max())
  check(q_err <= 1e-4, 'served q differs from the newest checkpoint\'s '
        'forward by {:.3g} of its max'.format(q_err))
  print('records serve: the {} answers on the newest step equal its '
        'avg_params\' forward within {:.3g} of max (tolerance 1e-4)'.format(
            len(results), q_err))
  return {'records_train': train_launches, 'records_serve': serve_launches}


def serve_swap(device, label, source, first_version, commit):
  """serve.py on ``source`` (``--checkpoint_dir <dir>`` or ``--export_dir
  <dir>``), polling every POLL_SECS, under THREADS closed-loop clients for
  SERVE_SECONDS; ``commit()`` lands a newer version a third of the way in
  and returns it. Returns the launch counts of serving, (states, results)
  of one batch on the new version, and the new version."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.serving import serve

  args = serve.make_parser().parse_args([
      '--device', device.type, '--num_convs',
      ','.join(str(n) for n in NUM_CONVS)] + list(source) + [
      '--poll_secs', str(POLL_SECS),
      '--restore_timeout', '60', '--max_batch_size', str(MAX_BATCH),
      '--cem_samples', str(CEM_SAMPLES), '--cem_iters', str(CEM_ITERS),
      '--num_elites', str(NUM_ELITES)])
  kernels.reset_launches()
  serving = serve.start(args)
  first = serving.service.params_version
  # The process's registry counts every server's batches: this one's are
  # those after its start.
  batches_before = serving.service.stats()['batches_total']
  load = {}
  client = threading.Thread(target=lambda: load.update(
      serve.run_synthetic_load(serving.service, serving.feature_spec,
                               THREADS, SERVE_SECONDS)))
  try:
    client.start()
    time.sleep(SERVE_SECONDS / 3)
    version = commit()
    committed = time.monotonic()
    client.join()
    # One batch of MAX_BATCH requests on the new version, for the checks.
    rng = np.random.RandomState(7)
    states = [serve.synthetic_state(serving.feature_spec, rng)
              for _ in range(MAX_BATCH)]
    futures = [serving.service.submit(s) for s in states]
    results = [f.result(timeout=60) for f in futures]
    batches = serving.service.stats()['batches_total'] - batches_before
  finally:
    serving.stop()
  launches = dict(kernels.LAUNCHES)
  new = str(version)
  check(first == first_version, '{}: serve.py started on version {}, not '
        '{}'.format(label, first, first_version))
  check(load['failed'] == 0 and load['completed'] > 0,
        '{}: serving under the swap: {}'.format(label, load))
  check(set(load['versions_served']) == {str(first), new},
        '{}: versions served {}'.format(label, load['versions_served']))
  check([v for v, _ in serving.swaps] == [version],
        '{}: swaps {}'.format(label, serving.swaps))
  latency = load['first_answer_monotonic'][new] - committed
  check(latency <= SWAP_POLLS * POLL_SECS, '{}: the first answer on version '
        '{} came {:.2f} s after its commit ({} polls of {} s allowed)'.format(
            label, new, latency, SWAP_POLLS, POLL_SECS))
  check(all(r.version == version for r in results),
        '{}: the check\'s batch was not served on the new version'.format(
            label))
  # One warm batch before the server started, then every served batch.
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': 1 + int(batches),
               'max_pool': sum(pool[-1] for pool in SERVED_POOLS) *
                           (1 + int(batches))})
  check(launches == want, '{}: serve launch counts {} != expected {}'.format(
      label, launches, want))
  print('{}: serve.py {} served version {} to {} clients, {} answers ({} on '
        '{}, {} on {}), {} failed, p99 over the run {:.2f} ms; the poll ({} '
        's) swapped in version {} and its first answer came {:.3f} s after '
        'its commit (swap at +{:.3f} s); launches {}; {}'.format(
            label, source[0], first, THREADS, load['completed'],
            load['versions_served'][str(first)], first,
            load['versions_served'][new], new, load['failed'],
            serving.service.stats()['latency_ms'].get('p99', 0.0), POLL_SECS,
            new, latency, serving.swaps[0][1] - committed, launches,
            smi_line()))
  stacked = {k: np.stack([s[k] for s in states]) for k in states[0]}
  return launches, (stacked, results), version


# The split decode (phase 4c): train_qtopt_sparse.gin's wire, on phase 4b's
# records; its loops' feed depths.
COEF_FEED_DEPTHS = (1, 2)


def phase_records_coef(device, data_dir):
  """The split decode at full width on phase 4b's records (no new ones):
  the loader's entropy stage on the host (the port's Huffman decoder), the
  coefficients shipped sparse, the decode finished on the card. Returns
  the launch counts of its last training loop."""
  import contextlib
  import glob
  import io

  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import device_feed
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.data import jpeg_device
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.data import wire
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.observability import get_registry
  from tensor2robot_tpu_torch.preprocessors import device_decode
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  model = device_decode.wrap_model_with_device_decode(
      t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
          device=device, network_kwargs={'num_convs': NUM_CONVS}),
      wire_format='sparse')
  wrapper = model.preprocessor
  raw_spec = wrapper.raw_in_feature_specification(ModeKeys.TRAIN)
  label_spec = wrapper.get_in_label_specification(ModeKeys.TRAIN)
  image = raw_spec['state/image']
  height, width = image.shape[:2]
  files = sorted(glob.glob(os.path.join(data_dir, 'train-*')))
  pattern = os.path.join(data_dir, 'train-*')
  pixel_bytes = TRAIN_BATCH * height * width * 3
  print('coef: the split decode on phase 4b\'s {} records; {}'.format(
      RECORDS, smi_line()))

  # Each wire's batch of the first file's first records, read in order.
  batches, stats = {}, {}
  for mode in native_loader.COEF_MODES:
    stream = native_loader.NativeBatchedStream(
        native_loader.plan_for_specs(raw_spec, label_spec, image_mode=mode),
        files[:1], batch_size=TRAIN_BATCH, num_epochs=1)
    batches[mode] = next(iter(stream))[0]
    stats[mode] = stream.stats()
    stream.close()
    check(stats[mode]['decode_device'] == -1, 'the {} loader bound card '
          '{}'.format(mode, stats[mode]['decode_device']))
  dense = batches['coef']
  planes = ('y', 'cb', 'cr', 'qt')

  # Pixels: the finish on the card against a host decode of the same bytes.
  frames = jpeg_device.decode_jpeg_coefficients(
      *(torch.from_numpy(dense['state/image/' + k]).to(device)
        for k in planes)).cpu()
  jpegs = [wire.parse_example(record)[image.name][1][0] for record in
           tfrecord.read_all_records(files[0])[:TRAIN_BATCH]]
  try:
    import cv2
    host = np.stack([cv2.imdecode(np.frombuffer(j, np.uint8),
                                  cv2.IMREAD_COLOR)[..., ::-1] for j in jpegs])
    host_decoder = 'OpenCV'
  except ImportError:
    from PIL import Image
    host = np.stack([np.asarray(Image.open(io.BytesIO(j)).convert('RGB'))
                     for j in jpegs])
    host_decoder = 'PIL'
  diff = np.abs(frames.numpy().astype(np.int16) - host.astype(np.int16))
  check(int(diff.max()) <= JPEG_PIXEL_ATOL, 'the card\'s finish differs '
        'from {}\'s decode by {} (tolerance {})'.format(
            host_decoder, int(diff.max()), JPEG_PIXEL_ATOL))
  print('coef pixels: the card\'s finish of {} frames against {}\'s decode '
        'of the same bytes: max |diff| {} (tolerance {}), mean {:.4f}, '
        '{:.4%} within 1'.format(TRAIN_BATCH, host_decoder, int(diff.max()),
                                 JPEG_PIXEL_ATOL, float(diff.mean()),
                                 float((diff <= 1).mean())))

  # The wires: unpacked on the card, the dense batch bit for bit; the
  # card's finish against the CPU's.
  feed = device_feed.SparseCoefFeed(wrapper.image_shapes(ModeKeys.TRAIN),
                                    device)
  for mode in ('coef_sparse', 'coef_packed'):
    features, _ = feed.put_batch((batches[mode], None))
    for k in planes:
      got = features['state/image/' + k]
      check(got.device.type == 'cuda' and torch.equal(
          got.cpu(), torch.from_numpy(dense['state/image/' + k])),
            '{} unpacked on the card differs from coef in {}'.format(mode, k))
  cpu_frames = jpeg_device.decode_jpeg_coefficients(
      *(torch.from_numpy(dense['state/image/' + k]) for k in planes))
  card_cpu = (frames.int() - cpu_frames.int()).abs()
  check(int(card_cpu.max()) <= 1, 'the card\'s finish differs from the '
        'CPU\'s by {}'.format(int(card_cpu.max())))
  wire_bytes = {mode: sum(v.nbytes for k, v in batch.items()
                          if k.startswith('state/image/'))
                for mode, batch in batches.items()}
  print('coef wires: coef_sparse and coef_packed unpacked on the card equal '
        'the coef batch bit for bit; the card\'s finish against the CPU\'s: '
        'max |diff| {} (tolerance 1), {:.4%} equal. A batch of {} frames '
        'ships {} bytes of pixels, {} of coef, {} of coef_sparse ({:.2f}x '
        'fewer), {} of coef_packed ({:.2f}x fewer)'.format(
            int(card_cpu.max()), float((card_cpu == 0).float().mean()),
            TRAIN_BATCH, pixel_bytes, wire_bytes['coef'],
            wire_bytes['coef_sparse'],
            pixel_bytes / wire_bytes['coef_sparse'],
            wire_bytes['coef_packed'],
            pixel_bytes / wire_bytes['coef_packed']))

  # What each loader does on the card while it reads two batches alone:
  # nvJPEG's copies and kernels (4b's pixels), and none for coef_sparse.
  plan = native_loader.plan_for_specs(raw_spec, label_spec,
                                      image_mode='coef_sparse')
  activity = {}
  for name, each in (('pixels', native_loader.plan_for_specs(
      raw_spec, label_spec)), ('coef_sparse', plan)):
    stream = native_loader.NativeBatchedStream(
        each, files[:1], batch_size=TRAIN_BATCH, num_epochs=1,
        num_threads=RECORDS_LOOP['threads'])
    activity[name] = device_activity(lambda: list(stream))
    stream.close()
  check(activity['coef_sparse'] == ({'HtoD': 0, 'DtoH': 0, 'DtoD': 0}, 0),
        'the coef_sparse loader worked on the card: {}'.format(
            activity['coef_sparse']))
  print('coef loader on the card, two batches alone: the pixel loader ({}) '
        'copies {} and runs {} kernels; coef_sparse copies {} and runs {} '
        'kernels'.format(RECORDS_LOOP['decoder'], *activity['pixels'],
                         *activity['coef_sparse']))

  # The loader alone in coef_sparse: three shuffled epochs at 4b's threads,
  # after a first batch.
  stream = native_loader.NativeBatchedStream(
      plan, files, batch_size=TRAIN_BATCH, shuffle=True, seed=0,
      num_epochs=1, num_threads=RECORDS_LOOP['threads'])
  next(iter(stream))
  stream.close()
  stream = native_loader.NativeBatchedStream(
      plan, files, batch_size=TRAIN_BATCH, shuffle=True, seed=0,
      num_epochs=3, num_threads=RECORDS_LOOP['threads'])
  start = time.monotonic()
  image_bytes, batch_bytes = [], []
  for features, labels in stream:
    image_bytes.append(sum(v.nbytes for k, v in features.items()
                           if k.startswith('state/image/')))
    batch_bytes.append(sum(v.nbytes for part in (features, labels)
                           for v in part.values()))
  seconds = time.monotonic() - start
  loader = stream.stats()
  stream.close()
  check(len(batch_bytes) == 3 * RECORDS // TRAIN_BATCH and
        loader['decode_device'] == -1, 'the coef_sparse loader gave {} '
        'batches on device {}'.format(len(batch_bytes),
                                      loader['decode_device']))
  records_per_s = len(batch_bytes) * TRAIN_BATCH / seconds
  worker_ms = loader['worker_busy_us'] / 1e3 / loader['rows_parsed']
  print('coef loader: coef_sparse ({} threads, no card) reads {} batches of '
        '{} in {:.3f} s: {:.1f} records/s, {:.3f} ms of a worker a record; '
        'a batch ships {:.0f} bytes of frames ({:.2f}x fewer than the {} of '
        'pixels), {:.0f} in all. Phase 4b ({}, {} threads): {:.1f} '
        'records/s, {:.3f} ms of a worker a record, {:.0f} bytes a batch; '
        '{}'.format(
            RECORDS_LOOP['threads'], len(batch_bytes), TRAIN_BATCH, seconds,
            records_per_s, worker_ms, statistics.mean(image_bytes),
            pixel_bytes / statistics.mean(image_bytes), pixel_bytes,
            statistics.mean(batch_bytes), RECORDS_LOOP['decoder'],
            RECORDS_LOOP['threads'], RECORDS_LOOP['records_per_s'],
            RECORDS_LOOP['worker_ms'], RECORDS_LOOP['batch_bytes'],
            smi_line()))

  # The loop: train_eval.main --device_decode sparse at each feed depth,
  # from phase 4b's step-0 weights, capturing the final state.
  initial = model.create_train_state(torch.Generator().manual_seed(0))
  spread = spread_weights({**initial.params, **initial.model_state},
                          torch.Generator().manual_seed(2))
  initial.params = {k: spread[k] for k in initial.params}
  initial.model_state = {k: spread[k] for k in initial.model_state}
  initial.avg_params = {k: v.clone() for k, v in initial.params.items()}
  real_train_eval_model = train_eval.train_eval_model
  want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
  want_launches.update({
      'crop_convert': TRAIN_STEPS, 'max_pool': 3 * TRAIN_STEPS,
      'max_pool_backward': 3 * TRAIN_STEPS,
      'conv5x5_wgrad': BODY_CONVS * TRAIN_STEPS})
  loops = {}
  for depth in COEF_FEED_DEPTHS:
    captured = {}

    def capture(*args, **kwargs):
      captured.update(real_train_eval_model(*args, **kwargs))
      return captured

    with tempfile.TemporaryDirectory() as model_dir:
      checkpointing.CheckpointManager(model_dir).save(initial)
      out = io.StringIO()
      kernels.reset_launches()
      start = time.monotonic()
      with contextlib.redirect_stdout(out), mock.patch.object(
          train_eval, 'train_eval_model', capture):
        rc = train_eval.main([
            '--device', device.type, '--num_convs',
            ','.join(str(n) for n in NUM_CONVS), '--model_dir', model_dir,
            '--train_data', pattern, '--device_decode', 'sparse',
            '--feed_depth', str(depth), '--batch_size', str(TRAIN_BATCH),
            '--max_train_steps', str(TRAIN_STEPS), '--log_every_n_steps',
            '1', '--save_checkpoints_steps', str(TRAIN_STEPS),
            '--nan_policy', 'raise'])
      elapsed = time.monotonic() - start
      launches = dict(kernels.LAUNCHES)
      line = json.loads(out.getvalue().strip().splitlines()[-1])
      check(launches == want_launches, 'coef train launch counts {} != '
            'expected {}'.format(launches, want_launches))
      check(rc == 0 and line['data'] == 'native' and
            line['step'] == TRAIN_STEPS and line['device_decode'] == 'sparse'
            and np.isfinite(line['metrics']['loss']),
            'train_eval --device_decode sparse: {}'.format(line))
      state, trainer = captured['state'], captured['trainer']
      restored = checkpointing.CheckpointManager(model_dir).restore(
          device=device)
      check(_states_equal(restored, state), 'the coef checkpoint does not '
            'restore the final state')
      del restored
      gauge = get_registry().gauge(device_feed.FEED_SHAPES_GAUGE).value
      check(gauge == 1, 'the train batches took {} shapes after the '
            'unpack'.format(gauge))
    loops[depth] = dict(line=line, elapsed=elapsed, launches=launches)
    print('coef train: train_eval --device_decode sparse --feed_depth {} '
          'trained {} steps of batch {} in {:.1f} s, launches {}; every '
          'loss finite, the last {:.4f}; checkpoint restores equal; one '
          'batch shape after the unpack. The loop\'s median step {:.2f} '
          'ms, of which {:.2f} ms waiting for data; a batch\'s copies '
          '{:.2f} ms on the card; {}'.format(
              depth, TRAIN_STEPS, TRAIN_BATCH, elapsed, launches,
              line['metrics']['loss'], line['step_ms'],
              line['data_wait_ms'], line['transfer_ms'], smi_line()))

  # The resident step on a coefficient batch: the unpack, the finish, the
  # crop and the train step, the streams already on the card.
  trainer = train_eval.Trainer(model, os.path.join(data_dir, 'unused'))
  generator = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=TRAIN_BATCH)
  generator.set_specification_from_model(model, ModeKeys.TRAIN)
  iterator = trainer.dataset_iterator(generator, ModeKeys.TRAIN, 0)
  numpy_features, numpy_labels = next(iterator)
  iterator.close()
  streams = {k: torch.from_numpy(v).to(device)
             for k, v in numpy_features.items()}
  labels = {k: torch.from_numpy(v).to(device) for k, v in numpy_labels.items()}
  shapes = wrapper.image_shapes(ModeKeys.TRAIN)
  current = [state]

  def resident_step(_):
    features = jpeg_device.unpack_sparse_features(dict(streams), shapes)
    features, step_labels = model.preprocessor.preprocess(
        features, labels, ModeKeys.TRAIN,
        generator=trainer.crop_generator(current[0].step))
    current[0], metrics = model.train_step(current[0], features, step_labels)
    float(metrics['loss'])

  resident_step(0)   # warm
  resident = {}
  resident_ms = profile('coef resident profile', resident_step, 3,
                        'step of {} (unpack and finish included)'.format(
                            TRAIN_BATCH), out=resident)
  sd, sv = streams['state/image/sd'], streams['state/image/sv']
  unpack, finish = {}, {}
  profile('coef unpack profile', lambda _: jpeg_device.unpack_sparse_features(
      dict(streams), shapes), 3, 'unpack of {}'.format(TRAIN_BATCH), top=4,
          out=unpack)
  card_dense = jpeg_device.unpack_sparse_coefficients(sd, sv, height, width)
  qt = streams['state/image/qt']
  profile('coef finish profile', lambda _: jpeg_device.decode_jpeg_coefficients(
      *card_dense, qt), 3, 'finish of {}'.format(TRAIN_BATCH), top=4,
          out=finish)

  # The loop under the profiler: each step takes its batch from the live
  # loader through the feed (depth 1, so that a step's copies are its own).
  iterator = trainer.device_batches(trainer.dataset_iterator(
      generator, ModeKeys.TRAIN, current[0].step))
  arrays = len(numpy_features) + len(numpy_labels)

  def loop_step(_):
    current[0], metrics = trainer._step(current[0], next(iterator))
    float(metrics['loss'])

  loop_step(0)   # warm: the loader's first batch
  looped = {}
  loop_ms = profile('coef loop profile', loop_step, 3,
                    'step of {} from the loader'.format(TRAIN_BATCH),
                    out=looped)
  iterator.close()
  copies = ('copies a step: the loop {}, the resident step {} (the feed '
            'copies the batch\'s {} arrays)'.format(
                looped.get('copies'), resident.get('copies'), arrays))
  print('coef: a resident step on a coefficient batch {:.2f} ms (busy {}), '
        'the unpack {} ms and the finish {} ms of device time a batch; the '
        'loop profiled {:.2f} ms a step (busy {}); {}. Loops (step, data '
        'wait): feed_depth 1 {:.2f} ms, {:.2f} ms; feed_depth 2 {:.2f} ms, '
        '{:.2f} ms. Phase 4b (nvJPEG pixels): step {:.2f} ms, data wait '
        '{:.2f} ms, resident {:.2f} ms; {}'.format(
            resident_ms, _share(resident, resident_ms),
            _ms(unpack), _ms(finish), loop_ms, _share(looped, loop_ms),
            copies, loops[1]['line']['step_ms'],
            loops[1]['line']['data_wait_ms'], loops[2]['line']['step_ms'],
            loops[2]['line']['data_wait_ms'], RECORDS_LOOP['step_ms'],
            RECORDS_LOOP['data_wait_ms'], RECORDS_LOOP['resident_ms'],
            smi_line()))
  del current, streams, labels, card_dense
  torch.cuda.empty_cache()
  return loops[COEF_FEED_DEPTHS[-1]]['launches']


# The gins (phase 4d): the port's train_qtopt.gin through train_eval's gin
# entry on phase 4b's records (no new ones). GIN_STEPS train steps (cut:
# the steps), a checkpoint every GIN_SAVE_STEPS, an eval of GIN_EVAL_STEPS
# batches every GIN_SAVE_STEPS; every photometric distortion on; the
# rmsprop rerun's and the rollback run's steps; the continuous eval's
# seconds without a new checkpoint before it ends.
GIN_FILE = os.path.join('tensor2robot_tpu_torch', 'research', 'qtopt',
                        'configs', 'train_qtopt.gin')
GIN_STEPS, GIN_SAVE_STEPS, GIN_EVAL_STEPS = 8, 4, 2
GIN_DISTORTIONS = {'random_brightness': True, 'random_saturation': True,
                   'random_hue': True, 'random_contrast': True,
                   'random_noise_level': 0.05, 'random_channel_swap': True}
GIN_SHORT_STEPS, GIN_EVAL_TIMEOUT_S = 4, 10
# The card's distortions against the CPU's on the same parameters: all
# elementwise float32 but the contrast's per-image mean, whose sum runs in
# another order on the card (a few ulps of values in [0, 1]).
DISTORTION_ATOL = 1e-5
_CRITIC = 'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom'


def gin_bindings(data_dir, steps, save_steps, eval_every=0, distort=False,
                 *extra):
  """The phase's bindings on top of train_qtopt.gin."""
  bindings = [
      "TRAIN_DATA = '{}'".format(os.path.join(data_dir, 'train-*')),
      'TRAIN_BATCH_SIZE = {}'.format(TRAIN_BATCH),
      '{}.network_kwargs = {{"num_convs": {}}}'.format(_CRITIC,
                                                      tuple(NUM_CONVS)),
      'train_eval_model.max_train_steps = {}'.format(steps),
      'train_eval_model.save_checkpoints_steps = {}'.format(save_steps),
      'train_eval_model.log_every_n_steps = 1']
  if eval_every:
    bindings += [
        'train_eval_model.input_generator_eval = '
        '@eval_input_generator/DefaultRecordInputGenerator()',
        'eval_input_generator/DefaultRecordInputGenerator.file_patterns = '
        '%TRAIN_DATA',
        'eval_input_generator/DefaultRecordInputGenerator.batch_size = '
        '%TRAIN_BATCH_SIZE',
        'train_eval_model.eval_throttle_steps = {}'.format(eval_every),
        'train_eval_model.eval_steps = {}'.format(GIN_EVAL_STEPS)]
  if distort:
    bindings += [
        '{}.preprocessor_cls = @DefaultGrasping44ImagePreprocessor'.format(
            _CRITIC),
        'DefaultGrasping44ImagePreprocessor.distortion_kwargs = {!r}'.format(
            GIN_DISTORTIONS)]
  return bindings + list(extra)


def gin_argv(model_dir, bindings):
  argv = ['--device', 'cuda', '--model_dir', model_dir, '--gin_configs',
          GIN_FILE]
  for binding in bindings:
    argv += ['--gin_bindings', binding]
  return argv


def run_gin(label, model_dir, bindings):
  """``train_eval.main`` on the gin and ``bindings``, the counters zeroed
  just before and read just after: (its JSON line, the launches, seconds)."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.trainer import train_eval

  out = io.StringIO()
  kernels.reset_launches()
  start = time.monotonic()
  with contextlib.redirect_stdout(out):
    rc = train_eval.main(gin_argv(model_dir, bindings))
  elapsed = time.monotonic() - start
  launches = dict(kernels.LAUNCHES)
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  check(rc == 0, '{}: train_eval --gin_configs returned {}'.format(label, rc))
  return line, launches, elapsed


def gin_launches(steps, eval_batches):
  """Phase 4's counts a train step, and an eval batch's forward (1 K1 and
  3 K2f)."""
  from tensor2robot_tpu_torch import kernels

  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': steps + eval_batches,
               'max_pool': 3 * (steps + eval_batches),
               'max_pool_backward': 3 * steps,
               'conv5x5_wgrad': BODY_CONVS * steps})
  return want


def phase_gins(device, data_dir):
  """train_qtopt.gin drives the port end to end at full width on phase
  4b's records: distortions, rmsprop, a rollback, the exporters,
  serve.py --export_dir with a hot swap, and a continuous eval in a
  second process. Returns the launch counts of its gin_train and
  export_serve paths."""
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.export import exporters
  from tensor2robot_tpu_torch.hooks import TrainHook
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.observability import get_registry
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.predictors import ExportedModelPredictor
  from tensor2robot_tpu_torch.preprocessors import image_transformations
  from tensor2robot_tpu_torch.preprocessors import pallas_crop
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  phase_start = time.monotonic()
  print('gins: {} on phase 4b\'s records; {}'.format(GIN_FILE, smi_line()))
  with tempfile.TemporaryDirectory() as tmp:
    # 1. The gin with every distortion, evals and the exporters.
    gin_dir = os.path.join(tmp, 'gin')
    line, launches, elapsed = run_gin('gin', gin_dir, gin_bindings(
        data_dir, GIN_STEPS, GIN_SAVE_STEPS, GIN_SAVE_STEPS, True,
        "train_eval_model.nan_policy = 'raise'"))
    evals = GIN_STEPS // GIN_SAVE_STEPS
    want = gin_launches(GIN_STEPS, evals * GIN_EVAL_STEPS)
    check(launches == want, 'gin launch counts {} != expected {} ({} steps, '
          '{} eval batches)'.format(launches, want, GIN_STEPS,
                                    evals * GIN_EVAL_STEPS))
    check(line['step'] == GIN_STEPS and line['data'] == 'native' and
          np.isfinite(line['metrics']['loss']) and
          len(line['eval_history']) == evals and
          all(np.isfinite(e['metrics']['loss'])
              for e in line['eval_history']), 'gin run: {}'.format(line))
    latest_root = os.path.join(gin_dir, 'export', 'latest_exporter')
    best_root = os.path.join(gin_dir, 'export', 'best_exporter')
    latest = export_generators.list_exported_versions(latest_root)
    best = export_generators.list_exported_versions(best_root)
    check(len(latest) == evals and best, 'exports: latest {}, best {}'.format(
        latest, best))
    GIN_LOOP.update(step_ms=line['step_ms'], data_wait_ms=line['data_wait_ms'])
    print('gins: train_eval --gin_configs trained {} steps of batch {} with '
          'every photometric distortion ({}) under nan_policy raise (every '
          'loss finite) in {:.1f} s, launches {} ({} steps and {} eval '
          'batches: phase 4\'s counts a step); loss {:.4f}; evals {}; the '
          'loop\'s median step {:.2f} ms, of which {:.2f} ms waiting for '
          'data (phase 4b: {:.2f} ms, {:.2f} ms); exports: latest_exporter '
          '{}, best_exporter {}; {}'.format(
              GIN_STEPS, TRAIN_BATCH, GIN_DISTORTIONS, elapsed, launches,
              GIN_STEPS, evals * GIN_EVAL_STEPS, line['metrics']['loss'],
              [(e['step'], round(e['metrics']['loss'], 6))
               for e in line['eval_history']], line['step_ms'],
              line['data_wait_ms'], RECORDS_LOOP['step_ms'],
              RECORDS_LOOP['data_wait_ms'], latest, best, smi_line()))

    # 2. A distorted step against its plain rerun, the card's distortions
    # against the CPU's, and the resident step with and without them.
    plain_model = t2r_models.\
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            device=device, network_kwargs={'num_convs': NUM_CONVS})
    distorted = t2r_models.\
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            device=device, network_kwargs={'num_convs': NUM_CONVS},
            preprocessor_cls=functools.partial(
                t2r_models.DefaultGrasping44ImagePreprocessor,
                distortion_kwargs=GIN_DISTORTIONS))
    state = checkpointing.CheckpointManager(gin_dir).restore(GIN_STEPS,
                                                             device)
    generator = input_generators.DefaultRecordInputGenerator(
        file_patterns=os.path.join(data_dir, 'train-*'),
        batch_size=TRAIN_BATCH, use_native=True)
    generator.set_specification_from_model(plain_model, ModeKeys.TRAIN)
    trainer = train_eval.Trainer(plain_model, os.path.join(tmp, 'unused'),
                                 write_metrics=False)
    numpy_features, numpy_labels = next(generator.create_dataset_iterator(
        ModeKeys.TRAIN, seed=0, prefetch=0))
    raw, labels = (trainer.put_batch(numpy_features),
                   trainer.put_batch(numpy_labels))
    offsets = torch.tensor([[0, 0], [40, 168]] * (TRAIN_BATCH // 2),
                           dtype=torch.int32, device=device)
    draws = torch.Generator(device=device)

    def distorted_step():
      draws.manual_seed(11)
      features, _ = distorted.preprocessor.preprocess(
          raw, None, ModeKeys.TRAIN, generator=draws, offsets=offsets)
      return features['state/image'], _gradients(distorted, state, features,
                                                 labels)

    image, (got_loss, got) = distorted_step()
    with plain_kernels():
      plain_image, (want_loss, want) = distorted_step()
    torch.cuda.synchronize()
    check(torch.equal(image, plain_image),
          'the distorted TRAIN image differs from its plain rerun\'s')
    print('gins: a distorted step, kernels vs plain versions: {}; the '
          'distorted image bit-equal'.format(compare_critic_steps(
              'distorted, kernels vs plain', distorted, got_loss, want_loss,
              got, want)))
    cropped = pallas_crop.crop_convert(raw['state/image'], offsets,
                                       t2r_models.TARGET_SHAPE,
                                       torch.float32, 255.0)
    draws.manual_seed(12)
    parameters = image_transformations.draw_photometric_parameters(
        draws, [cropped], **GIN_DISTORTIONS)
    card = image_transformations.apply_photometric_image_distortions(
        [cropped], parameters, **GIN_DISTORTIONS)[0]
    cpu = image_transformations.apply_photometric_image_distortions(
        [cropped.cpu()], [{k: v.cpu() for k, v in parameters[0].items()}],
        **GIN_DISTORTIONS)[0]
    err = max_abs_err(card.cpu(), cpu)
    check(err <= DISTORTION_ATOL, 'the card\'s distortions differ from the '
          'CPU\'s by {:.3g} (tolerance {})'.format(err, DISTORTION_ATOL))

    def distort(_):
      draws.manual_seed(13)
      image_transformations.apply_photometric_image_distortions(
          [cropped], generator=draws, **GIN_DISTORTIONS)

    alone = {}
    distort_wall = profile('gins distortions alone', distort, 5,
                           'batch of {}'.format(TRAIN_BATCH), top=6,
                           out=alone)
    _, distort_kernels = device_activity(lambda: distort(0))
    resident = {}
    for label, model in (('off', plain_model), ('on', distorted)):
      out = {}
      current = [state]

      def step(_, model=model, current=current):
        features, batch_labels = model.preprocessor.preprocess(
            raw, labels, ModeKeys.TRAIN,
            generator=trainer.crop_generator(current[0].step))
        current[0], metrics = model.train_step(current[0], features,
                                               batch_labels)
        float(metrics['loss'])

      step(0)
      wall = profile('gins resident step, distortions ' + label, step, 3,
                     'step of {}'.format(TRAIN_BATCH), top=6, out=out)
      resident[label] = (wall, out)
    print('gins: the card\'s distortions equal the CPU\'s on the same '
          'parameters within {:.3g} (tolerance {}); the distortions alone '
          '{} ms of device time a batch of {} ({} kernels, wall {:.2f} ms); '
          'the resident step {:.2f} ms with them (busy {}), {:.2f} ms '
          'without (busy {}); {}'.format(
              err, DISTORTION_ATOL, _ms(alone), TRAIN_BATCH, distort_kernels,
              distort_wall, resident['on'][0],
              _share(resident['on'][1], resident['on'][0]),
              resident['off'][0],
              _share(resident['off'][1], resident['off'][0]), smi_line()))

    # 3. Distortions off: the gin's final weights against the flags', bit
    # for bit (cuDNN held to its deterministic algorithms in both runs).
    torch.backends.cudnn.deterministic = True
    try:
      run_gin('gin, no distortions', os.path.join(tmp, 'gin_plain'),
              gin_bindings(data_dir, 2, 2))
      with contextlib.redirect_stdout(io.StringIO()):
        rc = train_eval.main([
            '--device', device.type, '--model_dir',
            os.path.join(tmp, 'flags'),
            '--num_convs', ','.join(str(n) for n in NUM_CONVS),
            '--train_data', os.path.join(data_dir, 'train-*'),
            '--batch_size', str(TRAIN_BATCH), '--max_train_steps', '2',
            '--save_checkpoints_steps', '2', '--log_every_n_steps', '1'])
    finally:
      torch.backends.cudnn.deterministic = False
    check(rc == 0, 'train_eval --model qtopt returned {}'.format(rc))
    from_gin = checkpointing.CheckpointManager(
        os.path.join(tmp, 'gin_plain')).restore(2)
    from_flags = checkpointing.CheckpointManager(
        os.path.join(tmp, 'flags')).restore(2)
    check(_states_equal(from_gin, from_flags), 'the gin\'s final state '
          'differs from train_eval --model qtopt\'s with the same flags')
    print('gins: without distortions the gin\'s state after 2 steps equals '
          'train_eval --model qtopt\'s with the same flags and seed, bit for '
          'bit (cuDNN deterministic in both)')

    # 4. rmsprop with an exponential decay, and a continuous eval of its
    # checkpoints in a second process.
    rms_dir = os.path.join(tmp, 'rmsprop')
    eval_bindings = gin_bindings(
        data_dir, GIN_SHORT_STEPS, 2, 2, False,
        'train_eval_model.input_generator_train = None',
        'train_eval_model.create_exporters_fn = None',
        'train_eval_model.eval_timeout_secs = {}'.format(GIN_EVAL_TIMEOUT_S))
    evaluator = subprocess.Popen(
        [sys.executable, '-m', 'tensor2robot_tpu_torch.trainer.train_eval'] +
        gin_argv(rms_dir, eval_bindings),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
      # The evaluator writes its config snapshot just before it polls: the
      # trainer starts then, so that the lags time the polls and not the
      # second process's start.
      deadline = time.monotonic() + 120
      while not os.path.exists(os.path.join(rms_dir, 'config_snapshot.gin')):
        check(evaluator.poll() is None and time.monotonic() < deadline,
              'the continuous eval did not start: {}'.format(
                  evaluator.poll()))
        time.sleep(0.1)
      rms_line, _, rms_s = run_gin('rmsprop', rms_dir, gin_bindings(
          data_dir, GIN_SHORT_STEPS, 2, 2, False,
          "train_eval_model.nan_policy = 'raise'",
          '{}.optimizer_override = @create_rms_prop_optimizer'.format(
              _CRITIC),
          'create_rms_prop_optimizer.learning_rate = '
          '@create_exponential_decay_learning_rate()',
          'create_rms_prop_optimizer.momentum = 0.9',
          'create_exponential_decay_learning_rate.initial_learning_rate = '
          '1e-4',
          'create_exponential_decay_learning_rate.decay_steps = 2',
          'create_exponential_decay_learning_rate.decay_rate = 0.5',
          'create_exponential_decay_learning_rate.staircase = False'))
      mtimes = {step: os.path.getmtime(os.path.join(
          rms_dir, 'checkpoint_{}.pt'.format(step)))
                for step in checkpointing.all_checkpoint_steps(rms_dir)}
      stdout, stderr = evaluator.communicate(timeout=240)
    finally:
      if evaluator.poll() is None:
        evaluator.kill()
        evaluator.wait()
    check(rms_line['step'] == GIN_SHORT_STEPS and
          np.isfinite(rms_line['metrics']['loss']),
          'rmsprop run: {}'.format(rms_line))
    check(evaluator.returncode == 0, 'the continuous eval failed: {}'.format(
        stderr[-2000:]))
    continuous = json.loads(stdout.strip().splitlines()[-1])
    trainer_evals = {e['step']: e for e in rms_line['eval_history']}
    lags, diffs = [], []
    for entry in continuous['eval_history']:
      own = trainer_evals.get(entry['step'])
      check(own is not None, 'the continuous eval evaluated step {}, which '
            'the trainer did not'.format(entry['step']))
      diff = abs(entry['metrics']['loss'] - own['metrics']['loss'])
      check(diff <= 1e-5 * abs(own['metrics']['loss']), 'continuous eval '
            'at step {}: {} vs the trainer\'s {}'.format(
                entry['step'], entry['metrics'], own['metrics']))
      diffs.append(diff)
      lags.append(entry['wall_time'] - mtimes[entry['step']])
    check(continuous['eval_history'] and
          continuous['eval_history'][-1]['step'] == GIN_SHORT_STEPS,
          'the continuous eval did not reach step {}: {}'.format(
              GIN_SHORT_STEPS, continuous['eval_history']))
    print('gins: rmsprop (momentum 0.9, exponential decay 1e-4 x 0.5^(t/2)) '
          '{} steps in {:.1f} s, every loss finite, loss {:.4f}; a second '
          'process\'s continuous eval (no train generator) evaluated steps '
          '{} with the trainer\'s own metrics (|diff| at most {:.3g}, '
          'tolerance 1e-5 relative), each {} s after the checkpoint\'s '
          'commit; {}'.format(
              GIN_SHORT_STEPS, rms_s, rms_line['metrics']['loss'],
              [e['step'] for e in continuous['eval_history']], max(diffs),
              ['{:.3f}'.format(lag) for lag in lags], smi_line()))

    # 5. A NaN label under nan_policy 'rollback'.
    batches, seen = [], []

    class Poisoned(input_generators.DefaultRecordInputGenerator):
      """The records, with a NaN grasp label in the third batch."""

      def create_dataset_iterator(self, mode, **kwargs):
        inner = super().create_dataset_iterator(mode, **kwargs)
        try:
          for features, batch_labels in inner:
            batches.append(1)
            if len(batches) == 3:
              batch_labels = dict(batch_labels)
              batch_labels['reward'] = batch_labels['reward'].copy()
              batch_labels['reward'][0] = np.nan
            yield features, batch_labels
        finally:
          inner.close()

    class Steps(TrainHook):
      def after_step(self, trainer, state, step, metrics):
        seen.append(step)

    class StepsBuilder:
      def create_hooks(self, t2r_model, trainer):
        return [Steps()]

    counter = get_registry().counter('reliability/nan_rollbacks')
    before = counter.value
    result = train_eval.train_eval_model(
        t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            device=device, network_kwargs={'num_convs': NUM_CONVS}),
        os.path.join(tmp, 'rollback'),
        Poisoned(file_patterns=os.path.join(data_dir, 'train-*'),
                 batch_size=TRAIN_BATCH),
        max_train_steps=GIN_SHORT_STEPS, save_checkpoints_steps=2,
        log_every_n_steps=1, nan_policy='rollback',
        train_hook_builders=[StepsBuilder()])
    rollbacks = int(counter.value - before)
    check(rollbacks == 1 and len(batches) == GIN_SHORT_STEPS + 1 and
          seen == list(range(1, GIN_SHORT_STEPS + 1)) and
          result['state'].step == GIN_SHORT_STEPS,
          'rollback: {} rollbacks, {} batches, steps {}'.format(
              rollbacks, len(batches), seen))
    print('gins: nan_policy rollback: the NaN label of batch 3 rolled step 3 '
          'back to checkpoint 2 ({} rollback counted), and the run went on '
          'to step {} over {} batches (steps after each: {})'.format(
              rollbacks, result['state'].step, len(batches), seen))

    # 6. serve.py --export_dir while a newer export lands; its actions
    # against CheckpointPredictor's on the same step.
    newer, _ = plain_model.train_step(state, *plain_model.preprocessor
                                      .preprocess(raw, labels,
                                                  ModeKeys.TRAIN,
                                                  offsets=offsets))
    torch.cuda.synchronize()
    owner = argparse.Namespace(model=plain_model, model_dir=gin_dir)
    write_ms = []

    def commit():
      torch.cuda.synchronize()
      start = time.monotonic()
      path = exporters.LatestModelExporter().export(owner, newer, {})
      write_ms.append((time.monotonic() - start) * 1e3)
      return int(os.path.basename(path))

    serve_launches, (states, results), new_version = serve_swap(
        device, 'gins serve', ['--export_dir', latest_root], latest[-1],
        commit)
    check(all(r.version == new_version for r in results),
          'the compare batch was not served on the new export')
    checkpoint_dir = os.path.join(tmp, 'newer')
    checkpointing.CheckpointManager(checkpoint_dir).save(newer)
    from_checkpoint = CheckpointPredictor(plain_model, checkpoint_dir)
    from_export = ExportedModelPredictor(latest_root, plain_model)
    check(from_checkpoint.restore() and from_export.restore() and
          from_export.model_version == new_version and
          from_export.global_step == newer.step,
          'the predictors did not load step {}'.format(newer.step))
    select = plain_model.make_batched_select_action(
        cem_samples=CEM_SAMPLES, cem_iters=CEM_ITERS, num_elites=NUM_ELITES)
    got = select(from_export.variables, states, 5)
    want = select(from_checkpoint.variables, states, 5)
    action_err = max_abs_err(got['action'], want['action'])
    served = torch.stack([torch.as_tensor(r.outputs['action'])
                          for r in results])
    check(action_err <= 1e-4, 'ExportedModelPredictor\'s actions differ '
          'from CheckpointPredictor\'s by {:.3g}'.format(action_err))
    print('gins serve: ExportedModelPredictor\'s actions on step {} equal '
          'CheckpointPredictor\'s on the same states and CEM seed within '
          '{:.3g} (tolerance 1e-4); {} served actions on the new export; the '
          'export wrote in {:.1f} ms (LatestModelExporter: variables, '
          'assets and a warmup request, committed by one rename); {}'.format(
              newer.step, action_err, served.shape[0], write_ms[0],
              smi_line()))
  torch.cuda.empty_cache()
  print('gins: phase 4d took {:.1f} s'.format(time.monotonic() - phase_start))
  return {'gin_train': launches, 'export_serve': serve_launches}


@contextlib.contextmanager
def plain_kernels():
  """Every kernel's wrapper replaced by its plain version; no launch
  allowed meanwhile."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.layers import pooling
  from tensor2robot_tpu_torch.layers import wgrad
  from tensor2robot_tpu_torch.preprocessors import pallas_crop

  before = dict(kernels.LAUNCHES)
  with mock.patch.object(pooling, 'max_pool_forward',
                         pooling.max_pool_plain), \
      mock.patch.object(pooling, 'max_pool_backward',
                        pooling.max_pool_backward_plain), \
      mock.patch.object(wgrad, 'conv5x5_wgrad', wgrad.conv5x5_wgrad_plain), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    yield
  check(kernels.LAUNCHES == before, 'the plain rerun launched a kernel')


def device_activity(run):
  """(copies by kind, kernels) on the card while ``run()`` runs, from
  torch.profiler: CUPTI records the whole process's device work, the
  threads of C++ libraries included."""
  from torch.profiler import ProfilerActivity, profile as torch_profile

  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    run()
    torch.cuda.synchronize()
  events = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
  copies = {kind: sum(e.count for e in events
                      if e.key.startswith('Memcpy ' + kind))
            for kind in ('HtoD', 'DtoH', 'DtoD')}
  kernels = sum(e.count for e in events
                if not e.key.startswith(('Memcpy', 'Memset')))
  return copies, kernels


def _ms(out):
  return '{:.3f}'.format(out['busy_ms']) if 'busy_ms' in out else \
      'not measured'


def _share(out, wall_ms):
  return '{:.3f} ms, {:.1%}'.format(out['busy_ms'], out['busy_ms'] / wall_ms) \
      if 'busy_ms' in out else 'not measured'


# The served attention: episode_length 512 x 8 tokens, 8 heads of 64.
SEQ2ACT_EPISODE, SEQ2ACT_STEPS = 512, 4
FLASH_HEADS, FLASH_LEN, FLASH_DIM = 8, 4096, 64
FLASH_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-5
LOGITS_RTOL = 1e-4   # of max|logits|: float32 sums in another order
# The functions of K4's and K6's libraries: the float32 tile loop
# (csrc/flash_fwd.cuh) and the bf16 kernel (csrc/flash_fwd_bf16.cuh), by a
# piece of their mangled names.
FWD_FUNCTION = 'flash_fwd_kernel'
FWD_BF16_FUNCTION = 'flash_fwd_bf16_kernel'


def bf16_sass(name, function):
  """The SASS mix of a bf16 flash function, which must hold only bf16
  m16n8k16 products (HMMA.16816.F32.BF16), none TF32, and ldmatrix
  (LDSM); printed."""
  mix = sass_mix(name, function=function)
  bf16_hmma = mix['forms'].get('HMMA.16816.F32.BF16', 0)
  check(bf16_hmma > 0 and bf16_hmma == mix['HMMA'] and mix['LDSM'] > 0,
        'the SASS of {} holds other products than bf16 m16n8k16, or no '
        'ldmatrix: {}'.format(function, mix))
  print('bf16 SASS of {} ({}): {} HMMA ({}), {} LDSM ({}), {} LDS, {} '
        'integer; no TF32 HMMA'.format(
            function, name, mix['HMMA'], ', '.join(
                '{} {}'.format(n, f) for f, n in mix['forms'].items()
                if f.startswith('HMMA')), mix['LDSM'], ', '.join(
                '{} {}'.format(n, f) for f, n in mix['forms'].items()
                if f.startswith('LDSM')), mix['LDS'], mix['integer']))
  return mix


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
  mix = sass_mix('flash_attention_fwd', function=FWD_FUNCTION)
  hmma = mix['HMMA']
  check(hmma > 0, 'the SASS of flash_attention_fwd holds no HMMA')
  bf16_mix = bf16_sass('flash_attention_fwd', FWD_BF16_FUNCTION)
  print('flash_attention served [1,{},{},{}] causal f32: {:.4f} ms ({:.1f} '
        'TFLOP/s), plain {:.4f} ms, scaled_dot_product_attention {:.4f} ms '
        '(differs by {:.3g}; its kernels: {}); bound {:.4f} ms on the CUDA '
        'cores\' float32 rate, {:.4f} ms for 3xTF32 on the tensor cores; its '
        'float32 function\'s SASS: {} HMMA, {} LDS, {} integer ({}); {} calls '
        'per predict'.format(
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

  # bf16 (device_type 'tpu'): the served and the training call on the bf16
  # kernel (csrc/flash_fwd_bf16.cuh), beside scaled_dot_product_attention in
  # bf16, each call behind a device sleep (the served call takes the device
  # less time than the host takes to queue it). Bound: q, k, v read and O
  # written in bf16, the LSE in float32, or the products at the bf16 peak.
  bf16 = {}
  for label, batch in (('served', 1), ('training', b)):
    qkv = torch.randn((batch, l, h, 3, d), device=device,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    bhl = [x.transpose(1, 2) for x in (q, k, v)]
    ms16 = median_ms(lambda: flash_attention.flash_attention(
        q, k, v, causal=True), host_ahead=True)
    lib16 = median_ms(
        lambda: F.scaled_dot_product_attention(*bhl, is_causal=True),
        host_ahead=True)
    bound16, by16 = bf16_bound_ms(4 * q.numel() * 2 + batch * h * l * 4,
                                  batch * flops)
    bf16[label] = (ms16, bound16, by16, lib16)
    print('flash_attention {} [{},{},{},{}] causal bf16: {:.4f} ms of device '
          'time ({:.1f} TFLOP/s; bound {:.4f} ms by {} at the bf16 peak), '
          'scaled_dot_product_attention bf16 {:.4f} ms; {}'.format(
              label, batch, l, h, d, ms16, batch * flops / ms16 / 1e9,
              bound16, by16, lib16, smi_line()))
    del qkv, q, k, v, bhl
  return dict(name='flash_attention_fwd', route='cuda',
              source='tensor2robot_tpu_torch/csrc/flash_attention_fwd.cu',
              replaces='tensor2robot_tpu/parallel/flash_attention.py:202',
              max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
              bound_by='operations', fp32_bound_ms=fp32_bound,
              tensor_core_bound_ms=bound, library_ms=lib,
              library_kernels=lib_kernels, sass_hmma=hmma, sass_mix=mix,
              bf16_sass_mix=bf16_mix, train_ms=train_ms,
              train_library_ms=train_lib, train_bound_ms=train_bound,
              bf16_ms=bf16['served'][0], bf16_bound_ms=bf16['served'][1],
              bf16_bound_by=bf16['served'][2],
              bf16_library_ms=bf16['served'][3],
              bf16_train_ms=bf16['training'][0],
              bf16_train_bound_ms=bf16['training'][1],
              bf16_train_bound_by=bf16['training'][2],
              bf16_train_library_ms=bf16['training'][3],
              shapes='per launch: [1,{},{},{}] causal f32, q/k/v strided '
              'views of the qkv projection'.format(l, h, d),
              train_shapes='per launch: [{},{},{},{}] causal f32, the same '
              'views'.format(b, l, h, d))


BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of max|plain|
# The functions of K5a's and K5b's libraries: the float32 tile loop and the
# bf16 kernel (csrc/flash_bwd_bf16.cuh), by a piece of their mangled names.
K5_FUNCTIONS = {'kv': 'flash_bwd_kv_kernel', 'q': 'flash_bwd_q_kernel'}
K5_BF16_FUNCTIONS = {'kv': 'flash_bwd_kv_bf16_kernel',
                     'q': 'flash_bwd_q_bf16_kernel'}


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
  # K5a and K5b in bf16 (device_type 'tpu'): their own kernels on the bf16
  # tensor cores (csrc/flash_bwd_bf16.cuh); beside them the backward of
  # scaled_dot_product_attention in bf16.
  qkv16, o16 = qkv.to(torch.bfloat16), d_out.to(torch.bfloat16)
  q16, k16, v16 = qkv16[..., 0, :], qkv16[..., 1, :], qkv16[..., 2, :]
  kv_bf16_ms = median_ms(lambda: fa.flash_attention_bwd_kv(
      q16, k16, v16, o16, lse, delta, True, scale))
  q_bf16_ms = median_ms(lambda: fa.flash_attention_bwd_q(
      q16, k16, v16, o16, lse, delta, True, scale))
  leaves16 = [x.detach().transpose(1, 2).requires_grad_()
              for x in (q16, k16, v16)]
  lib16_out = F.scaled_dot_product_attention(*leaves16, is_causal=True)
  lib16_ms = median_ms(lambda: torch.autograd.grad(
      lib16_out, leaves16, o16.transpose(1, 2), retain_graph=True))
  del qkv16, o16, q16, k16, v16, leaves16, lib16_out
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
  # bf16: q, k, v, dO read and dk, dv (or dq) written in bf16, the LSE and
  # delta rows in float32; or the products at the bf16 peak.
  kv_bf16_bound = bf16_bound_ms(6 * elem // 2 + 2 * rows, 4 * 2 * d * pairs)
  q_bf16_bound = bf16_bound_ms(5 * elem // 2 + 2 * rows, 3 * 2 * d * pairs)
  # The SASS by function: the float32 tile loop, and the bf16 kernel, whose
  # products must all be bf16 m16n8k16 (HMMA.16816.F32.BF16), none TF32.
  kv_mix = sass_mix('flash_attention_bwd_kv', function=K5_FUNCTIONS['kv'])
  q_mix = sass_mix('flash_attention_bwd_q', function=K5_FUNCTIONS['q'])
  kv_hmma, q_hmma = kv_mix['HMMA'], q_mix['HMMA']
  check(kv_hmma > 0, 'the SASS of flash_attention_bwd_kv holds no HMMA')
  check(q_hmma > 0, 'the SASS of flash_attention_bwd_q holds no HMMA')
  bf16_mix = {key: bf16_sass(name, K5_BF16_FUNCTIONS[key])
              for key, name in (('kv', 'flash_attention_bwd_kv'),
                                ('q', 'flash_attention_bwd_q'))}
  print('flash backward training [{},{},{},{}] causal f32: K5a (dk, dv) '
        '{:.4f} ms ({:.1f} TFLOP/s; bound {:.4f} ms on the CUDA cores\' '
        'float32 rate, {:.4f} ms for 3xTF32 on the tensor cores; {} HMMA in '
        'its SASS), K5b (dq) {:.4f} ms ({:.1f} TFLOP/s; bound {:.4f} ms on '
        'the CUDA cores\' float32 rate, {:.4f} ms for 3xTF32 on the tensor '
        'cores; {} HMMA in its SASS), delta pass {:.4f} ms; plain backward '
        '{:.4f} ms; scaled_dot_product_attention backward (dq, dk, dv) '
        '{:.4f} ms against K5a + K5b + delta {:.4f} ms (differs by {:.3g} of '
        'max); their float32 functions\' SASS, HMMA/LDS/integer: K5a '
        '{kv[HMMA]}/{kv[LDS]}/{kv[integer]}, K5b {q[HMMA]}/{q[LDS]}/'
        '{q[integer]}; {}'.format(
            b, l, h, d, kv_ms, 8 * d * pairs / kv_ms / 1e9, kv_fp32_bound,
            kv_bound, kv_hmma, q_ms, 6 * d * pairs / q_ms / 1e9, q_fp32_bound,
            q_bound, q_hmma, delta_ms, plain_ms, lib_ms,
            kv_ms + q_ms + delta_ms, lib_err, smi_line(), kv=kv_mix, q=q_mix))
  print('flash backward training [{},{},{},{}] causal bf16: K5a {:.4f} ms '
        '(bound {:.4f} ms by {}), K5b {:.4f} ms (bound {:.4f} ms by {}), at '
        'the bf16 peak; scaled_dot_product_attention backward bf16 {:.4f} ms '
        'against K5a + K5b + delta {:.4f} ms; {}'.format(
            b, l, h, d, kv_bf16_ms, kv_bf16_bound[0], kv_bf16_bound[1],
            q_bf16_ms, q_bf16_bound[0], q_bf16_bound[1], lib16_ms,
            kv_bf16_ms + q_bf16_ms + delta_ms, smi_line()))
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
               sass_mix=kv_mix, bf16_sass_mix=bf16_mix['kv'],
               bf16_ms=kv_bf16_ms,
               bf16_bound_ms=kv_bf16_bound[0],
               bf16_bound_by=kv_bf16_bound[1], bf16_library_ms=lib16_ms,
               shapes=shapes),
          dict(name='flash_attention_bwd_q', route='cuda',
               source='tensor2robot_tpu_torch/csrc/flash_attention_bwd_q.cu',
               replaces='tensor2robot_tpu/parallel/flash_attention.py:530',
               max_abs_err=err['dq'], ms=q_ms, plain_ms=plain_ms,
               bound_ms=q_bound, bound_by=q_by, fp32_bound_ms=q_fp32_bound,
               library_ms=lib_ms, library_note=library_note,
               sass_hmma=q_hmma, sass_mix=q_mix,
               bf16_sass_mix=bf16_mix['q'], bf16_ms=q_bf16_ms,
               bf16_bound_ms=q_bf16_bound[0], bf16_bound_by=q_bf16_bound[1],
               bf16_library_ms=lib16_ms, delta_ms=delta_ms,
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
# Phase 6c's steps (bf16) and 6d's (the MoE gin).
SEQ2ACT_BF16_STEPS, MOE_STEPS = 4, 4
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
    RANDOM_SEQ2ACT_LOOP.update(
        step_ms=step_ms, data_wait_ms=data_ms, peak_gb=round(peak_gb, 2),
        resident_ms=train_profile('seq2act train profile', trainer, model,
                                  state, raw, labels, 2, batch))
    del raw, labels
    phase_seq2act_train_serve(model, model_dir, state)
  return launches


def phase_seq2act_train_vs_plain(model, state, raw, labels,
                                 compare=None):
  """One step on one episode through the kernels and through the plain
  versions (K1's, K4's and K5's): the loss and every gradient, held by
  ``compare`` (``compare_steps``). Batch 1, so that the plain attention's
  dense [8, 4096, 4096] scores fit."""
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
  print('seq2act train step{}, kernels vs plain versions (1 episode): {}'
        .format(' (bf16)' if model.compute_dtype == torch.bfloat16 else '',
                (compare or compare_steps)('kernels vs plain', got_loss,
                                           want_loss, got, want)))


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


# Seq2Act's gins as written (phases 6c, 6d): device_type "tpu" (bfloat16
# activations), the long-context binding, the MoE gin.
SEQ2ACT_BC_GIN = ('tensor2robot_tpu_torch/research/seq2act/configs/'
                  'train_seq2act_bc.gin')
SEQ2ACT_MOE_GIN = ('tensor2robot_tpu_torch/research/seq2act/configs/'
                   'train_seq2act_moe.gin')
LONG_CONTEXT = ('Seq2ActBCModel.episode_length = 512',
                'Seq2ActBCModel.attention_mode = "flash"')
# The bf16 step against its plain rerun (K1, K4, K5a, K5b by their plain
# versions; cuDNN's bf16 convolutions and cuBLAS's bf16 GEMMs in both), by
# group of parameters: each gradient within this share of its scale (its
# largest magnitude, no lower than 1e-3 of the network's largest
# gradient). Both sum exact bf16 products in float32, in other orders, and
# round O, dq, dk and dv to bf16 once: one bf16 ulp (2 ** -8 = 3.9e-3
# relative) where the two roundings part, which the bf16 activations
# downstream carry on. K5a and K5b also round p and ds to bf16 for their
# second pair of products (csrc/flash_bwd_bf16.cuh), 2 ** -9 relative on
# each term of sums over up to 4,096 rows, where the plain versions keep
# them in float32. The layers behind more bf16 roundings between their
# gradient and the attention drift more. The bounds are some 3x what this
# phase measured on an NVIDIA H100 80GB HBM3 at 700 W before K5a and K5b
# rounded p and ds (in brackets, then after).
BF16_STEP_BOUNDS = (
    # 4 bf16 convolutions, their input gradients through every block and
    # the TokenLearner (7.8e-3, then 7.5e-3).
    ('tokenizer.conv', 3e-2),
    # The stem's LNs, embedding and TokenLearner: the same path, the LN
    # scales summing products of two bf16-rounded terms (9.2e-3, then
    # 8.7e-3).
    ('tokenizer.', 3e-2),
    # Summed over the batch's tokens from every block's input gradient, the
    # most roundings deep (1.3e-2, then 1.05e-2).
    ('transformer.pos_embedding', 4e-2),
    # The blocks' attention, MLP (or MoE) and LNs: the attention's dq, dk,
    # dv one bf16 rounding apart, carried through 8 blocks (7.5e-3, then
    # 7.5e-3).
    ('transformer.', 3e-2),
    # float32 on the float32 final LN, one block's rounding away (3.0e-3,
    # then 3.4e-3).
    ('action_head.', 1e-2),
)
# The float32 loss of float32 logits on bf16 activations (2.0e-5, then
# 8.6e-8).
BF16_LOSS_RTOL = 1e-4
# The map_out bias, 0 in exact arithmetic, of the largest gradient (2.6e-5,
# then 1.2e-5).
BF16_ZERO_GRADIENT = 1e-4
# Served logits, kernels vs plain versions, of their max: K4's bf16 O and
# the plain version's one rounding apart, through 8 blocks (7.0e-3, then
# 7.2e-3).
BF16_LOGITS_RTOL = 2e-2
TICK_MS = 1e3 / 30


def compare_steps_bf16(label, got_loss, want_loss, got, want):
  """A bf16 step's loss and gradients against another's, by group
  (BF16_STEP_BOUNDS); returns what it found, as text."""
  got_loss, want_loss = float(got_loss), float(want_loss)
  loss_err = abs(got_loss - want_loss) / abs(want_loss)
  check(loss_err <= BF16_LOSS_RTOL, 'bf16 seq2act loss, {}: {} vs {}'.format(
      label, got_loss, want_loss))
  largest = max(float(g.abs().max()) for g in want.values())
  zero = max(max(float(got[k].abs().max()), float(want[k].abs().max()))
             for k in SEQ2ACT_ZERO_GRADIENTS) / largest
  check(zero <= BF16_ZERO_GRADIENT, 'bf16 gradients that are 0 in exact '
        'arithmetic reach {:.3g} of the largest'.format(zero))
  worst = {}
  for k in want:
    if k in SEQ2ACT_ZERO_GRADIENTS:
      continue
    group = next(g for g, _ in BF16_STEP_BOUNDS if k.startswith(g))
    e = max_abs_err(got[k], want[k]) / max(float(want[k].abs().max()),
                                           1e-3 * largest)
    worst[group] = max(worst.get(group, (0.0, '')), (e, k))
  for group, bound in BF16_STEP_BOUNDS:
    e, k = worst[group]
    check(e <= bound, 'bf16 seq2act gradients, {}: {} differs by {:.3g} of '
          'its scale (bound {:g} for {})'.format(label, k, e, bound, group))
  return ('|dloss| {:.3g} relative (bound {:g}); worst gradient of each '
          'group, of its scale: {}; the map_out bias at {:.3g} of the largest '
          '(bound {:g})'.format(
              loss_err, BF16_LOSS_RTOL, '; '.join(
                  '{} {:.3g} at {} (bound {:g})'.format(
                      g, worst[g][0], worst[g][1], b)
                  for g, b in BF16_STEP_BOUNDS), zero, BF16_ZERO_GRADIENT))


def gin_train_eval(gin, bindings, model_dir, device):
  """``train_eval_model`` as ``gin`` and ``bindings`` configure it (as
  ``train_eval.main_gin`` parses them), the model on ``device``; its
  result."""
  from tensor2robot_tpu_torch import config

  config.register_framework_configurables()
  config.add_config_file_search_path(os.path.dirname(
      os.path.abspath(__file__)))
  config.clear_config()
  config.parse_config_files_and_bindings(
      [gin], ['Seq2ActBCModel.device = {!r}'.format(str(device))] +
      list(bindings))
  config.check_configurables()
  return config.get_configurable('train_eval_model')(model_dir=model_dir)


def run_bindings(steps, batch=None, data=None, nan_policy='raise'):
  """The bindings of a short training run on top of a gin: the steps, a
  log window and a checkpoint at the end, random episodes of ``batch``
  unless ``data`` (a file pattern) names records."""
  bindings = ['train_eval_model.max_train_steps = {}'.format(steps),
              'train_eval_model.log_every_n_steps = 1',
              'train_eval_model.save_checkpoints_steps = {}'.format(steps),
              'train_eval_model.nan_policy = {!r}'.format(nan_policy)]
  if data:
    bindings.append('TRAIN_DATA = {!r}'.format(data))
  else:
    bindings += ['train_eval_model.input_generator_train = '
                 '@DefaultRandomInputGenerator()',
                 'DefaultRandomInputGenerator.batch_size = {}'.format(batch)]
  if batch and data:
    bindings.append('TRAIN_BATCH_SIZE = {}'.format(batch))
  return bindings


@contextlib.contextmanager
def attention_dtypes():
  """The dtypes of every q that reaches the flash kernels' wrappers
  (forward, backward) meanwhile."""
  from tensor2robot_tpu_torch.parallel import flash_attention

  seen = collections.Counter()
  forward = flash_attention.flash_attention_forward
  backward = flash_attention.flash_attention_backward

  def fwd(q, *args, **kwargs):
    seen['forward', str(q.dtype)] += 1
    return forward(q, *args, **kwargs)

  def bwd(q, *args, **kwargs):
    seen['backward', str(q.dtype)] += 1
    return backward(q, *args, **kwargs)

  with mock.patch.object(flash_attention, 'flash_attention_forward', fwd), \
      mock.patch.object(flash_attention, 'flash_attention_backward', bwd):
    yield seen


def seq2act_step_launches(steps):
  from tensor2robot_tpu_torch import kernels

  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': steps,
               'flash_attention_fwd': 8 * steps,
               'flash_attention_bwd_kv': 8 * steps,
               'flash_attention_bwd_q': 8 * steps})
  return want


def phase_seq2act_bf16(device):
  """train_seq2act_bc.gin's long-context binding as written
  (device_type "tpu": bf16 activations), at batch 8 on random episodes
  (cut: the batch, as in phase 6, and the steps): launches, losses, the
  checkpoint, the step against its plain rerun (BF16_STEP_BOUNDS), a
  resident step's profile, and the trained checkpoint served in bf16."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.trainer import checkpointing

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  steps, batch = SEQ2ACT_BF16_STEPS, SEQ2ACT_TRAIN_BATCH
  with tempfile.TemporaryDirectory() as model_dir:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start = time.monotonic()
    with attention_dtypes() as dtypes:
      result = gin_train_eval(SEQ2ACT_BC_GIN, list(LONG_CONTEXT) +
                              run_bindings(steps, batch), model_dir, device)
    elapsed = time.monotonic() - start
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, trainer = result['state'], result['trainer']
    model = trainer.model
    check(model.compute_dtype == torch.bfloat16, 'the gin\'s device_type '
          '"tpu" did not make the compute dtype bfloat16')
    check(launches == seq2act_step_launches(steps), 'bf16 seq2act launch '
          'counts {} != expected {}'.format(launches,
                                            seq2act_step_launches(steps)))
    check(set(dtypes) == {('forward', 'torch.bfloat16'),
                          ('backward', 'torch.bfloat16')},
          'the flash kernels saw other dtypes than bf16: {}'.format(
              dict(dtypes)))
    check(all(v.dtype == torch.float32 for v in state.params.values()) and
          all(v.dtype == torch.float32 for v in state.opt_state['mu'].values()),
          'bf16 training left float32 params or optimizer state')
    restored = checkpointing.CheckpointManager(model_dir).restore(
        device=device)
    check(_states_equal(restored, state),
          'the bf16 seq2act checkpoint does not restore the final state')
    del restored
    loss = trainer.last_metrics['loss']
    windows = trainer.windows[1:]
    step_ms = statistics.median(w[1] * 1e3 for w in windows)
    data_ms = statistics.median(w[2] * 1e3 for w in windows)
    print('seq2act bf16 (train_seq2act_bc.gin, long-context binding, '
          'device_type "tpu"): {} steps of batch {} x {} frames in {:.1f}s, '
          'launches {} (q, k, v in {}); every loss finite, the last {:.4f}; '
          'median step {:.1f} ms ({:.2f} episodes/s), {:.1f} ms waiting; '
          'peak memory {:.2f} GB (phase 6, float32: {}); params and adam '
          'state float32; checkpoint restores equal; {}'.format(
              steps, batch, SEQ2ACT_EPISODE, elapsed, launches,
              sorted({d for _, d in dtypes}), loss, step_ms,
              batch * 1e3 / step_ms, data_ms, peak_gb,
              RANDOM_SEQ2ACT_LOOP.get('peak_gb', 'not measured'),
              smi_line()))
    numpy_features, numpy_labels = _random_batch(model, batch)
    raw, labels = trainer.put_batch(numpy_features), trainer.put_batch(
        numpy_labels)
    phase_seq2act_train_vs_plain(model, state, raw, labels,
                                 compare=compare_steps_bf16)
    out = {}
    resident_ms = train_profile('seq2act bf16 train profile', trainer, model,
                                state, raw, labels, 2, batch, out=out)
    flash_ms = flash_step_ms('seq2act bf16 step (phase 6c)', out,
                             resident_ms, peak_gb)
    del raw, labels
    serve_ms = serve_seq2act_bf16(model, model_dir, state)
  return launches, dict(step_ms=step_ms, data_wait_ms=data_ms,
                        resident_ms=resident_ms, busy_ms=out.get('busy_ms'),
                        flash_ms=flash_ms, peak_gb=peak_gb,
                        select_action_ms=serve_ms)


def _random_batch(model, batch, seed=1):
  """One random TRAIN batch of ``model``'s in-specs (numpy)."""
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.modes import ModeKeys

  data = input_generators.DefaultRandomInputGenerator(batch_size=batch)
  data.set_specification_from_model(model, ModeKeys.TRAIN)
  iterator = data.create_dataset_iterator(ModeKeys.TRAIN, seed=seed,
                                          prefetch=0)
  try:
    return next(iterator)
  finally:
    iterator.close()


def serve_seq2act_bf16(model, model_dir, state):
  """SequentialRegressionPolicy over a CheckpointPredictor of the trained
  bf16 checkpoint: 1 K1 and 8 K4 a predict, finite bin centers, the
  logits of one forward against the plain versions' (BF16_LOGITS_RTOL of
  their max) and the trained params' predict_step; wall ms a call against
  the 33 ms tick. Returns the median wall ms."""
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.parallel import flash_attention
  from tensor2robot_tpu_torch.policies import SequentialRegressionPolicy
  from tensor2robot_tpu_torch.predictors import CheckpointPredictor
  from tensor2robot_tpu_torch.preprocessors import pallas_crop
  from tensor2robot_tpu_torch.research.vrgripper import decoders

  predictor = CheckpointPredictor(model, model_dir, timeout=60.0)
  policy = SequentialRegressionPolicy(model, predictor=predictor)
  check(policy.restore() and predictor.model_version == state.step,
        'CheckpointPredictor did not restore the bf16 checkpoint')
  rng = np.random.RandomState(8)
  frames = [rng.randint(0, 256, (136, 168, 3), dtype=np.uint8)
            for _ in range(SEQ2ACT_STEPS + 1)]
  policy.reset()
  actions = [policy.SelectAction({'image': frames[0]}, None, 0)]  # warm
  torch.cuda.synchronize()
  wall_ms = []
  kernels.reset_launches()
  with attention_dtypes() as dtypes:
    for step, frame in enumerate(frames[1:], 1):
      start = time.monotonic()
      actions.append(policy.SelectAction({'image': frame}, None, step))
      wall_ms.append((time.monotonic() - start) * 1e3)
  launches = dict(kernels.LAUNCHES)
  want = dict.fromkeys(kernels.LAUNCHES, 0)
  want.update({'crop_convert': SEQ2ACT_STEPS,
               'flash_attention_fwd': 8 * SEQ2ACT_STEPS})
  check(launches == want, 'bf16 seq2act serving launch counts {} != {}'
        .format(launches, want))
  check(set(dtypes) == {('forward', 'torch.bfloat16')}, 'bf16 serving '
        'reached the flash kernel in {}'.format(dict(dtypes)))
  centers = set(decoders.get_discrete_bins(256, -1.0, 1.0).tolist())
  for action in actions:
    check(action.shape == (7,) and action.dtype == np.float32 and
          np.isfinite(action).all() and set(action.tolist()) <= centers,
          'bad bf16 seq2act action {}'.format(action))
  window = None
  for frame in frames:
    window = model.pack_features({'image': frame}, window, 0)
  serve = export_generators.make_serve_fn(model)
  got = serve(predictor.variables, window)['action_logits']
  trained = serve(state.variables(), window)['action_logits']
  with mock.patch.object(flash_attention, 'flash_attention',
                         flash_plain_blhd), \
      mock.patch.object(pallas_crop, 'crop_convert',
                        pallas_crop.crop_convert_plain):
    before = dict(kernels.LAUNCHES)
    want_logits = serve(predictor.variables, window)['action_logits']
    check(kernels.LAUNCHES == before, 'the plain forward launched a kernel')
  torch.cuda.synchronize()
  scale = float(want_logits.abs().max())
  e = max_abs_err(got, want_logits)
  check(got.dtype == torch.float32 and e <= BF16_LOGITS_RTOL * scale,
        'bf16 seq2act logits, kernels vs plain: {:.3g} of max (bound {:g})'
        .format(e / scale, BF16_LOGITS_RTOL))
  check(torch.equal(got, trained), 'the served bf16 logits are not the '
        'trained params\' predict_step')
  median = statistics.median(wall_ms)
  print('seq2act bf16 serving: {} SelectAction calls over a {}-frame window '
        'from the trained checkpoint (step {}), launches {} (bf16), finite '
        'float32 bin centers; logits vs plain versions within {:.3g} of '
        'max {:.3g} (bound {:g}), equal to the trained params\' '
        'predict_step; wall per call median {:.2f} ms (min {:.2f}, max '
        '{:.2f}) against the {:.1f} ms tick; {}'.format(
            SEQ2ACT_STEPS, SEQ2ACT_EPISODE, state.step, launches, e / scale,
            scale, BF16_LOGITS_RTOL, median, min(wall_ms), max(wall_ms),
            TICK_MS, smi_line()))
  profile('seq2act bf16 serving profile', lambda i: policy.SelectAction(
      {'image': frames[i]}, None, i), 2, 'SelectAction')
  return median


# Phase 6d: train_seq2act_moe.gin as written (6-frame episodes, batch 32,
# bf16, 8 experts, top 2) from MOE_EPISODES records of 6 frames that the
# phase writes, then with the long-context binding at batch 8 (cut: the
# batch, as in phase 6) from phase 6b's episodes; a 2-step dropout run and
# its rerun.
MOE_EPISODES, MOE_EPISODE_FILES, MOE_BATCH = 64, 4, 32
DROPOUT_STEPS = 2


def moe_stats(label, model, state, features, labels):
  """On one TRAIN forward of ``model`` at ``state``: the aux loss and the
  share of (token, choice) pairs each MoE layer dropped over capacity; and
  the MoE layers' device ms a step (one layer's forward and backward at
  the step's shape, median of 10 CUDA-event-timed calls, times the
  layers)."""
  from tensor2robot_tpu_torch.layers import moe

  layers = [(name, module) for name, module in model.network.named_modules()
            if isinstance(module, moe.MoEMlp)]
  seen = []
  hooks = [module.register_forward_hook(
      lambda m, inputs, out: seen.append((inputs[0].detach(),
                                          m.routing(inputs[0].detach())[1])))
           for _, module in layers]
  try:
    with torch.no_grad():
      _, (_, outputs, _) = model.loss_fn(state.params, state.model_state,
                                         features, labels, 'train')
  finally:
    for hook in hooks:
      hook.remove()
  aux = float(outputs['moe_aux_loss'])
  dropped = [float(routing.dropped_share()) for _, routing in seen]
  check(len(seen) == len(layers) and np.isfinite(aux), 'MoE stats missing')
  name, module = layers[0]
  params = {k[len(name) + 1:]: v.detach().requires_grad_()
            for k, v in state.params.items() if k.startswith(name + '.')}
  x = seen[0][0].requires_grad_()
  cotangent = torch.randn_like(x)

  def layer_step():
    out, layer_aux = torch.func.functional_call(module, params, (x,))
    return torch.autograd.grad((out * cotangent).sum() + layer_aux,
                               [x] + list(params.values()))

  layer_ms = median_ms(layer_step, iters=10, warmup=2)
  print('{}: aux loss {:.5f} (summed over {} layers); pairs dropped over '
        'capacity {} (capacity {} of {} tokens a layer, top {}); the MoE '
        'layers {:.3f} ms of device time a step ({} x {:.4f} ms, one '
        'layer\'s forward and backward at [{}]); {}'.format(
            label, aux, len(layers), ['{:.4f}'.format(d) for d in dropped],
            seen[0][1].capacity, x.shape[1], module.top_k,
            len(layers) * layer_ms, len(layers), layer_ms,
            ', '.join(str(n) for n in x.shape), smi_line()))
  return dict(aux_loss=aux, dropped=dropped,
              moe_ms=len(layers) * layer_ms)


def phase_moe(device, long_pattern):
  """train_seq2act_moe.gin through ``train_eval --gin_configs`` as written,
  from records of its 6-frame episodes; the same gin at the long-context
  binding from phase 6b's episodes; a dropout run and its rerun."""
  import contextlib
  import io

  from tensor2robot_tpu_torch import config
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  probe = jpeg_probe()
  encoder = 'cv2' if probe['cv2'] else 'PIL'
  report = {}
  with tempfile.TemporaryDirectory() as root:
    data_dir = os.path.join(root, 'episodes')
    os.makedirs(data_dir)
    spec_model = Seq2ActBCModel(episode_length=6, device=device)
    files, frame_bytes = write_episodes(data_dir, spec_model, encoder,
                                        MOE_EPISODES, MOE_EPISODE_FILES)
    pattern = os.path.join(data_dir, 'episodes-*')

    # (a) The gin as written, through the command line.
    model_dir = os.path.join(root, 'moe')
    argv = ['--model_dir', model_dir, '--gin_configs', SEQ2ACT_MOE_GIN]
    for binding in run_bindings(MOE_STEPS, data=pattern):
      argv += ['--gin_bindings', binding]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      check(train_eval.main(argv) == 0, 'the MoE gin failed')
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    # 48 tokens: attention_mode 'auto' is dense here, as JAX picks it.
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want['crop_convert'] = MOE_STEPS
    check(launches == want, 'MoE gin launch counts {} != {}'.format(
        launches, want))
    check(line['step'] == MOE_STEPS and np.isfinite(line['metrics']['loss']),
          'the MoE gin ended at step {} with loss {}'.format(
              line['step'], line['metrics']['loss']))
    # The gin's model, rebuilt from the bindings the run wrote.
    config.clear_config()
    config.parse_config_files_and_bindings(
        [SEQ2ACT_MOE_GIN], ['Seq2ActBCModel.device = "cuda"'] +
        run_bindings(MOE_STEPS, data=pattern))
    model = config.query_parameter('train_eval_model.t2r_model')
    moe_layer = model.network.transformer.block0.moe
    check(model.compute_dtype == torch.bfloat16 and
          moe_layer.num_experts == 8 and moe_layer.top_k == 2 and
          model._moe_aux_weight == 0.01, 'the MoE gin built another model')
    state = checkpointing.CheckpointManager(model_dir).restore(device=device)
    trainer = train_eval.Trainer(model, os.path.join(root, 'unused'))
    generator = config.query_parameter('train_eval_model.input_generator_train')
    generator.set_specification_from_model(model, ModeKeys.TRAIN)
    iterator = trainer.dataset_iterator(generator, ModeKeys.TRAIN, 1)
    numpy_features, numpy_labels = next(iterator)
    iterator.close()
    features, labels = model.preprocessor.preprocess(
        trainer.put_batch(numpy_features), trainer.put_batch(numpy_labels),
        ModeKeys.TRAIN, generator=trainer.crop_generator(1))
    print('seq2act MoE gin ({} as written: 6-frame episodes, batch {}, bf16, '
          '8 experts, top 2, aux weight 0.01, through train_eval '
          '--gin_configs) from {} episodes of 6 JPEG frames in {} files '
          '({:.1f} KB a frame, {}): {} steps, launches {} (48 tokens: '
          'attention_mode \'auto\' is dense, as in JAX); loss {:.4f}; the '
          'loop\'s median step {:.2f} ms, {:.2f} ms waiting for data; peak '
          'memory {:.2f} GB; {}'.format(
              SEQ2ACT_MOE_GIN, MOE_BATCH, MOE_EPISODES, len(files),
              frame_bytes / MOE_EPISODES / 6 / 1024, encoder, line['step'],
              launches, line['metrics']['loss'], line['step_ms'],
              line['data_wait_ms'], peak_gb, smi_line()))
    stats = moe_stats('seq2act MoE gin', model, state, features, labels)
    report['gin'] = dict(step_ms=line['step_ms'],
                         data_wait_ms=line['data_wait_ms'], peak_gb=peak_gb,
                         **stats)

    # Dropout: two runs of DROPOUT_STEPS from the same seed, bit for bit
    # (cuDNN deterministic in both).
    dropout_states = []
    torch.backends.cudnn.deterministic = True
    try:
      for run in range(2):
        result = gin_train_eval(
            SEQ2ACT_MOE_GIN, run_bindings(DROPOUT_STEPS, data=pattern) +
            ['Seq2ActBCModel.dropout_rate = 0.1'],
            os.path.join(root, 'dropout{}'.format(run)), device)
        dropout_states.append(result['state'])
        dropout_loss = result['trainer'].last_metrics['loss']
    finally:
      torch.backends.cudnn.deterministic = False
    check(_states_equal(*dropout_states), 'a dropout run and its rerun from '
          'the same seed and steps differ')
    print('seq2act MoE gin with Seq2ActBCModel.dropout_rate = 0.1: {} steps, '
          'loss {:.4f}; its rerun from the same seed equal bit for bit '
          '(params, adam state, step)'.format(DROPOUT_STEPS, dropout_loss))
    del dropout_states

    # (b) The long-context binding at batch 8, from phase 6b's episodes.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with attention_dtypes() as dtypes:
      result = gin_train_eval(
          SEQ2ACT_MOE_GIN, list(LONG_CONTEXT) + run_bindings(
              MOE_STEPS, SEQ2ACT_TRAIN_BATCH, data=long_pattern),
          os.path.join(root, 'moe_long'), device)
    launches_long = dict(kernels.LAUNCHES)
    peak_long = torch.cuda.max_memory_allocated() / 1e9
    state, trainer = result['state'], result['trainer']
    model = trainer.model
    check(launches_long == seq2act_step_launches(MOE_STEPS), 'long-context '
          'MoE launch counts {} != {}'.format(
              launches_long, seq2act_step_launches(MOE_STEPS)))
    check(set(d for _, d in dtypes) == {'torch.bfloat16'}, 'the long MoE '
          'step reached the flash kernels in {}'.format(dict(dtypes)))
    total_gb = torch.cuda.get_device_properties(device).total_memory / 1e9
    check(peak_long < total_gb, 'the long MoE step does not fit the card')
    windows = trainer.windows[1:]
    step_ms = statistics.median(w[1] * 1e3 for w in windows)
    data_ms = statistics.median(w[2] * 1e3 for w in windows)
    print('seq2act MoE gin, long-context binding (512 frames, flash, batch '
          '{}, bf16) from phase 6b\'s episodes: {} steps, launches {}; loss '
          '{:.4f}; the loop\'s median step {:.1f} ms, {:.1f} ms waiting for '
          'data; peak memory {:.2f} GB of the card\'s {:.2f}; {}'.format(
              SEQ2ACT_TRAIN_BATCH, MOE_STEPS, launches_long,
              trainer.last_metrics['loss'], step_ms, data_ms, peak_long,
              total_gb, smi_line()))
    iterator = trainer.dataset_iterator(trainer.train_generator,
                                        ModeKeys.TRAIN, 1)
    numpy_features, numpy_labels = next(iterator)
    iterator.close()
    raw, labels = (trainer.put_batch(numpy_features),
                   trainer.put_batch(numpy_labels))
    features, cropped_labels = model.preprocessor.preprocess(
        raw, labels, ModeKeys.TRAIN, generator=trainer.crop_generator(1))
    stats = moe_stats('seq2act MoE gin, long-context', model, state,
                      features, cropped_labels)
    del features, cropped_labels
    out = {}
    resident_ms = train_profile('seq2act MoE long-context train profile',
                                trainer, model, state, raw, labels, 2,
                                SEQ2ACT_TRAIN_BATCH, out=out)
    flash_ms = flash_step_ms('seq2act MoE long-context step (phase 6d)', out,
                             resident_ms, peak_long)
    report['long'] = dict(step_ms=step_ms, data_wait_ms=data_ms,
                          peak_gb=peak_long, resident_ms=resident_ms,
                          busy_ms=out.get('busy_ms'), flash_ms=flash_ms,
                          **stats)
    del raw, labels, state, trainer, result
  torch.cuda.empty_cache()
  return launches_long, report


# Seq2Act's episodes on disk: train_seq2act_bc.gin's long-context binding
# (512 frames of 136x168x3 an episode, JPEG, under the JAX model's names),
# cut to SEQ2ACT_EPISODES episodes in SEQ2ACT_EPISODE_FILES files; the
# flash loop trains SEQ2ACT_RECORDS_STEPS steps from them.
SEQ2ACT_EPISODES, SEQ2ACT_EPISODE_FILES = 64, 4
SEQ2ACT_RECORDS_STEPS = 8


def write_episodes(directory, model, encoder, episodes=SEQ2ACT_EPISODES,
                   num_files=SEQ2ACT_EPISODE_FILES):
  """``episodes`` episodes of ``model``'s in-specs by the port's writer
  (in ``num_files`` files):
  JPEG frames of smooth ramps that move a frame, with sensor noise; actions
  whose dims 0 and 1 name the episode and the frame (``episode_names``);
  ``state`` and ``task_id`` only where the specs ask for them. Returns
  (files, bytes of frames)."""
  from concurrent.futures import ThreadPoolExecutor

  from tensor2robot_tpu_torch.data.writer import TFRecordReplayWriter
  from tensor2robot_tpu_torch.modes import ModeKeys

  spec = {**model.preprocessor.get_in_feature_specification(ModeKeys.TRAIN),
          **model.preprocessor.get_in_label_specification(ModeKeys.TRAIN)}
  t, h, w, _ = spec['image'].shape
  rng = np.random.RandomState(0)
  noise = rng.randint(-6, 7, (16, h, w, 3)).astype(np.int16)
  yy, xx = np.mgrid[0:h, 0:w].astype(np.int16)
  steps = np.arange(t, dtype=np.int16)[:, None, None]

  def frames_of(episode):
    """The episode's t frames, uint8 [t, h, w, 3]."""
    image = np.stack([xx + 7 * steps + 11 * episode, yy + 3 * steps +
                      0 * xx, (xx + yy) // 2 + 5 * episode + 0 * steps],
                     -1) % 256
    image += noise[(episode + np.arange(t)) % 16]
    return np.clip(image, 0, 255).astype(np.uint8)

  per_file = episodes // num_files
  files, frame_bytes = [], 0
  with ThreadPoolExecutor(8) as pool:
    for f in range(num_files):
      files.append(os.path.join(directory, 'episodes-{:05d}-of-{:05d}'
                                '.tfrecord'.format(f, num_files)))
      with TFRecordReplayWriter() as writer:
        writer.open(files[-1])
        for e in range(f * per_file, (f + 1) * per_file):
          frames = list(pool.map(lambda image: encode_jpeg(image, encoder),
                                 frames_of(e)))
          frame_bytes += sum(len(x) for x in frames)
          action = rng.uniform(-1, 1, spec['action'].shape).astype(
              np.float32)
          action[:, 0] = -1 + 2 * e / (episodes - 1)
          action[:, 1] = -1 + 2 * np.arange(t) / (t - 1)
          values = {'image': frames, 'action': action}
          if 'state' in spec:
            values['state'] = rng.uniform(-1, 1, spec['state'].shape).astype(
                np.float32)
          if 'task_id' in spec:
            values['task_id'] = np.asarray([e % 8], np.int32)
          writer.write_numpy(spec, values)
  return files, frame_bytes


def episode_names(action):
  """The (episode, frame) that each row of a batch of ``write_episodes``'
  actions names: int [B, T, 2]."""
  action = np.asarray(action)
  return np.stack([
      np.rint((action[..., 0] + 1) / 2 * (SEQ2ACT_EPISODES - 1)),
      np.rint((action[..., 1] + 1) / 2 * (SEQ2ACT_EPISODE - 1))],
                  -1).astype(np.int64)


def loader_line(stats, seconds, frames_a_record):
  """The loader's rates over ``seconds`` from its stats (the records its
  workers parsed, the frames of them it decoded), as text."""
  records = stats['rows_parsed']
  return ('{:.1f} records/s, {:.0f} frames/s, {:.1f} MB/s of records, {} '
          'threads, {:.4f} ms of a worker a frame, decoding on CUDA device '
          '{}'.format(records / seconds, records * frames_a_record / seconds,
                      stats['parse_bytes'] / seconds / 1e6,
                      stats['n_workers'],
                      stats['worker_busy_us'] / 1e3 / max(
                          records * frames_a_record, 1),
                      stats['decode_device']))


def phase_seq2act_records(device, data_dir):
  """The researcher's workflow at full width: 512-frame episodes on disk,
  the native loader (nvJPEG on the card where the host has no libjpeg),
  ``train_eval --model seq2act --train_data`` with flash attention.
  Returns the launch counts of its training run and the episodes' file
  pattern (for the ring, phase 8)."""
  import contextlib
  import io

  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.data import native_loader
  from tensor2robot_tpu_torch.data import parser
  from tensor2robot_tpu_torch.data import tfrecord
  from tensor2robot_tpu_torch.modes import ModeKeys
  from tensor2robot_tpu_torch.research.seq2act import Seq2ActBCModel
  from tensor2robot_tpu_torch.trainer import checkpointing
  from tensor2robot_tpu_torch.trainer import train_eval

  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  probe = jpeg_probe()
  encoder = 'cv2' if probe['cv2'] else 'PIL' if probe['PIL'] else None
  check(encoder is not None, 'no JPEG encoder (cv2 or PIL) on this host')
  decoder = native_loader.jpeg_decoder()
  index = torch.cuda.current_device()
  model = Seq2ActBCModel(episode_length=SEQ2ACT_EPISODE,
                         attention_mode='flash', learning_rate=1e-4,
                         device=device)
  start = time.monotonic()
  files, frame_bytes = write_episodes(data_dir, model, encoder)
  frames = SEQ2ACT_EPISODES * SEQ2ACT_EPISODE
  print('seq2act records: wrote {} episodes of {} frames (136x168x3 JPEG by '
        '{}, {:.1f} KB a frame; {:.1f} MB in {} files) in {:.1f} s; the '
        'loader decodes with {}'.format(
            SEQ2ACT_EPISODES, SEQ2ACT_EPISODE, encoder,
            frame_bytes / frames / 1024,
            sum(os.path.getsize(f) for f in files) / 1e6, len(files),
            time.monotonic() - start, decoder))
  pattern = os.path.join(data_dir, 'episodes-*')
  feature_spec = model.preprocessor.get_in_feature_specification(
      ModeKeys.TRAIN)
  label_spec = model.preprocessor.get_in_label_specification(ModeKeys.TRAIN)
  check(feature_spec['image'].name == 'image0' and
        feature_spec['image'].data_format == 'jpeg',
        'the image spec is not the JAX model\'s on-disk image0 list')
  plan = native_loader.plan_for_specs(feature_spec, label_spec)
  check(plan is not None, 'the native loader does not plan the episodes')
  batch = SEQ2ACT_TRAIN_BATCH

  # The loader alone: two shuffled epochs at the train batch, after one
  # batch that makes the decoder's state.
  def stream_of(epochs):
    return native_loader.NativeBatchedStream(
        plan, files, batch_size=batch, shuffle=True, seed=0,
        num_epochs=epochs, device=index)

  stream = stream_of(1)
  next(iter(stream))
  stream.close()
  stream = stream_of(2)
  start = time.monotonic()
  batches = sum(1 for _ in stream)
  seconds = time.monotonic() - start
  stream.close()
  stats = stream.stats()
  check(batches == 2 * SEQ2ACT_EPISODES // batch, 'the loader gave {} '
        'batches'.format(batches))
  check(stats['decode_device'] == (index if decoder == 'nvjpeg' else -1),
        'the loader decoded on device {}, not {}'.format(
            stats['decode_device'], index))
  print('seq2act records: the native loader alone reads {} batches of {} '
        'episodes in {:.3f} s: {}; {}'.format(
            batches, batch, seconds, loader_line(stats, seconds,
                                                 SEQ2ACT_EPISODE),
            smi_line()))

  # The decoder's frames against libjpeg's (OpenCV's): the first file's
  # first batch, read in order; every other field bit-equal.
  stream = native_loader.NativeBatchedStream(plan, files[:1],
                                             batch_size=batch, num_epochs=1,
                                             device=index)
  got, got_labels = next(iter(stream))
  stream.close()
  if probe['cv2']:
    want, want_labels = parser.ExampleParser(
        feature_spec, label_spec).parse_batch(
            tfrecord.read_all_records(files[0])[:batch])
    diff = np.abs(got['image'].astype(np.int16) -
                  want['image'].astype(np.int16))
    atol = JPEG_PIXEL_ATOL if decoder == 'nvjpeg' else 0
    check(int(diff.max()) <= atol, '{} frames differ from libjpeg\'s by {} '
          '(tolerance {})'.format(decoder, int(diff.max()), atol))
    check(all(np.array_equal(got[k], want[k]) for k in want if k != 'image')
          and all(np.array_equal(got_labels[k], want_labels[k])
                  for k in want_labels), 'a field differs from the parser\'s')
    print('seq2act records: {} frames against libjpeg\'s (OpenCV) on {} '
          'frames: max |diff| {} (tolerance {}), mean {:.4f}; every other '
          'field bit-equal'.format(decoder, batch * SEQ2ACT_EPISODE,
                                   int(diff.max()), atol, float(diff.mean())))
  names = episode_names(got_labels['action'])
  check(np.array_equal(names[..., 1], np.broadcast_to(
      np.arange(SEQ2ACT_EPISODE), names.shape[:2])) and
        np.array_equal(names[:, :, 0], np.broadcast_to(
            np.arange(batch)[:, None], names.shape[:2])),
        'the first file\'s first batch does not name episodes 0..7')

  # Train through the command line, capturing what train_eval_model
  # returns (the final state, to hold the checkpoint against).
  captured = {}
  real_train_eval_model = train_eval.train_eval_model

  def capture(*args, **kwargs):
    captured.update(real_train_eval_model(*args, **kwargs),
                    generator=args[2])
    return captured

  steps = SEQ2ACT_RECORDS_STEPS
  with tempfile.TemporaryDirectory() as model_dir:
    out = io.StringIO()
    kernels.reset_launches()
    start = time.monotonic()
    with contextlib.redirect_stdout(out), mock.patch.object(
        train_eval, 'train_eval_model', capture):
      rc = train_eval.main([
          '--model', 'seq2act', '--device', device.type,
          '--episode_length', str(SEQ2ACT_EPISODE), '--attention_mode',
          'flash', '--learning_rate', '1e-4', '--batch_size', str(batch),
          '--max_train_steps', str(steps), '--log_every_n_steps', '1',
          '--save_checkpoints_steps', str(steps), '--nan_policy', 'raise',
          '--model_dir', model_dir, '--train_data', pattern])
    elapsed = time.monotonic() - start
    launches = dict(kernels.LAUNCHES)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    want_launches.update({'crop_convert': steps,
                          'flash_attention_fwd': 8 * steps,
                          'flash_attention_bwd_kv': 8 * steps,
                          'flash_attention_bwd_q': 8 * steps})
    check(launches == want_launches, 'seq2act records train launch counts '
          '{} != expected {}'.format(launches, want_launches))
    check(rc == 0 and line['data'] == 'native' and line['step'] == steps and
          np.isfinite(line['metrics']['loss']),
          'train_eval --model seq2act --train_data: {}'.format(line))
    state, trainer = captured['state'], captured['trainer']
    model = trainer.model
    restored = checkpointing.CheckpointManager(model_dir).restore(
        device=device)
    check(_states_equal(restored, state),
          'the seq2act records checkpoint does not restore the final state')
    del restored
    loop_s = sum(w[1] for w in trainer.windows)
    loop_stats = captured['generator'].stream.stats()
    check(loop_stats['decode_device'] == (index if decoder == 'nvjpeg'
                                          else -1),
          'the training loop\'s loader decoded on device {}'.format(
              loop_stats['decode_device']))

    # One step on a batch of the records against the plain versions, and
    # the resident step on that batch.
    data = input_generators.DefaultRecordInputGenerator(
        file_patterns=pattern, batch_size=batch, use_native=True)
    data.set_specification_from_model(model, ModeKeys.TRAIN)
    iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, 0)
    numpy_features, numpy_labels = next(iterator)
    iterator.close()
    raw, labels = (trainer.put_batch(numpy_features),
                   trainer.put_batch(numpy_labels))
    phase_seq2act_train_vs_plain(model, state, raw, labels)
    resident_ms = train_profile('seq2act records train profile', trainer,
                                model, state, raw, labels, 2, batch)
    del raw, labels
    # The loop itself under the profiler: each step takes its batch from
    # the live loader (whose decodes run beside it, on the host and, under
    # nvJPEG, on this card), as Trainer.train does.
    iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, state.step)
    current = [state]

    def loop_step(_):
      current[0], metrics = trainer._step(current[0],
                                          trainer.feed.put_batch(
                                              next(iterator)))
      float(metrics['loss'])

    loop_step(0)   # warm: the loader's first batch
    profile('seq2act records loop profile', loop_step, 3,
            'step of {} from the loader'.format(batch))
    iterator.close()
    del current
  print('seq2act records train: train_eval --model seq2act --train_data '
        'trained {} steps of batch {} x {} frames from the episodes through '
        'the native loader in {:.1f} s, launches {}; loss {:.4f}; checkpoint '
        'restores equal. The loop\'s median step {:.2f} ms, of which {:.2f} '
        'ms waiting for data; a resident step {:.2f} ms. Its loader over the '
        'loop\'s {:.3f} s: {}. The random generator\'s loop (phase 6): step '
        '{:.2f} ms, data wait {:.2f} ms, resident step {:.2f} ms; {}'.format(
            steps, batch, SEQ2ACT_EPISODE, elapsed, launches,
            line['metrics']['loss'], line['step_ms'], line['data_wait_ms'],
            resident_ms, loop_s, loader_line(loop_stats, loop_s,
                                             SEQ2ACT_EPISODE),
            RANDOM_SEQ2ACT_LOOP['step_ms'],
            RANDOM_SEQ2ACT_LOOP['data_wait_ms'],
            RANDOM_SEQ2ACT_LOOP['resident_ms'], smi_line()))
  torch.cuda.empty_cache()
  return launches, pattern


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
  of o, m and l relative to each one's max, o's absolute error, and K6's
  state."""
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
  return rel, max_abs_err(got[0], want[0]), got


def phase_ring_kernel(device, gen, world):
  """K6 against its plain version at the 4-rank hop shape (diagonal, full
  and hidden hops from a carried state, f32 and bf16), at an odd shape and
  at a hop hidden from its first queries only; the same bits run to run; a
  misaligned view refused; a replay of the four-shard hop schedule on one
  card against K4's O and LSE over the whole sequence; then timed at the
  main path's launch shape and at the 4-rank hop, beside both bounds and
  its SASS mix, and in bf16 at the one-rank launch [8, 4096, 8, 64] and
  the 4-rank hops beside the bf16 bound and its bf16 function's SASS."""
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
      rel, _, _ = carry_errors(q, block[:, :, :, 1], block[:, :, :, 2],
                               state, l, k_offset, True)
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
    rel, _, _ = carry_errors(q, kv[..., 0, :], kv[..., 1, :],
                             carry_state(2, 3, 100, 128, device), 40, 30,
                             True)
    check(rel <= CARRY_RTOL, 'K6 odd shape {}: {:.3g} of max'.format(dtype,
                                                                      rel))
    print('flash_attention_carry odd [2,100/72,3,128] causal at offsets 40/30 '
          '{}: within {:.3g} of max (tolerance {:g})'.format(
              str(dtype).split('.')[-1], rel, CARRY_RTOL))
    # Queries 128.. against keys 148..: the first 20 see no key, so the
    # first warp takes no key tile and the second masks its first rows.
    qkv = torch.randn((2, 2 * 128, h, 3, d), device=device,
                      generator=gen).to(dtype)
    q = qkv[:, 128:, :, 0]
    state = carry_state(2, h, 128, d, device)
    fa.flash_attention_carry_plain(q, qkv[:, :128, :, 1],
                                   qkv[:, :128, :, 2], *state, 128, 0, True,
                                   d ** -0.5)
    kv = torch.randn((2, 128, h, 2, d), device=device,
                     generator=gen).to(dtype)
    rel, _, got = carry_errors(q, kv[..., 0, :], kv[..., 1, :], state, 128,
                               148, True)
    check(rel <= CARRY_RTOL, 'K6 partly hidden hop {}: {:.3g} of max'.format(
        dtype, rel))
    check(all(torch.equal(g[:, :, :16], x[:, :, :16])
              for g, x in zip(got, state)),
          'K6 changed the rows of a warp that takes no key')
    print('flash_attention_carry partly hidden hop [2,128,{},{}] causal at '
          'offsets 128/148 {}: within {:.3g} of max (tolerance {:g}); the '
          'first warp\'s rows, which see no key, bit-equal'.format(
              h, d, str(dtype).split('.')[-1], rel, CARRY_RTOL))

  # The same bits run to run, at the 4-rank diagonal hop.
  qkv = torch.randn((b, l, h, 3, d), device=device, generator=gen)
  runs = []
  for _ in range(2):
    state = carry_state(b, h, l, d, device)
    fa.flash_attention_carry(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :],
                             *state, l, l, True, d ** -0.5)
    runs.append(state)
  torch.cuda.synchronize()
  check(all(torch.equal(x, y) for x, y in zip(*runs)),
        'K6 gives other bits on a second run')
  # A view whose rows do not start on 16 bytes is refused, not copied.
  odd = torch.randn((1, 128, 2, d + 1), device=device)[..., 1:]
  try:
    fa.flash_attention_carry(odd, odd, odd, *carry_state(1, 2, 128, d, device),
                             0, 0, True, d ** -0.5)
  except ValueError:
    pass
  else:
    raise AssertionError('K6 took a view whose rows are not 16-byte aligned')
  print('flash_attention_carry: the same bits run to run; a misaligned view '
        'refused with ValueError')
  del qkv, runs, odd

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

  def timed(shape, q_offset, k_offset, plain=False, dtype=torch.float32):
    tb, tl, th, td = shape
    tq = torch.randn((tb, tl, th, 3, td), device=device,
                     generator=gen).to(dtype)
    state = carry_state(tb, th, tl, td, device)
    args = (tq[..., 0, :], tq[..., 1, :], tq[..., 2, :], *state, q_offset,
            k_offset, True, td ** -0.5)
    # A bf16 hop takes the device less time than the host takes to queue
    # it: behind a device sleep, the events time the device alone.
    ms = median_ms(lambda: fa.flash_attention_carry(*args),
                   host_ahead=dtype == torch.bfloat16)
    plain_ms = (median_ms(lambda: fa.flash_attention_carry_plain(*args),
                          iters=10, warmup=2) if plain else None)
    pairs = causal_pairs(tb, th, tl, tl, q_offset, k_offset)
    # q, k, v read once; the float32 o, m, l read and written.
    state_bytes = 2 * (tb * th * tl * (td + 2) * 4)
    if dtype == torch.bfloat16:
      # bf16 q, k, v, or the function's two products at the bf16 peak.
      bound, by = bf16_bound_ms(3 * tb * tl * th * td * 2 + state_bytes,
                                4 * td * pairs)
      return ms, plain_ms, bound, by, pairs, None
    nbytes = 3 * tb * tl * th * td * 4 + state_bytes
    fp32_bound, _ = bound_ms(nbytes, 4 * td * pairs)
    # 3xTF32 on the tensor cores, or the bytes if they take longer.
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = tensor_core_bound_ms(4 * td * pairs)
    bound, by = ((t_ops, 'operations') if t_ops >= t_bytes else
                 (t_bytes, 'bytes'))
    return ms, plain_ms, bound, by, pairs, fp32_bound

  batch = 8 if world == 1 else 32
  main_shape = (batch, 4 * l // world, h, d)
  # The main path's launches: at one rank the diagonal hop over the whole
  # sequence; at four, full hops (and diagonal and hidden ones).
  main_offsets = (0, 0) if world == 1 else (main_shape[1], 0)
  ms, plain, bound, by, pairs, fp32_bound = timed(main_shape, *main_offsets,
                                                  plain=True)
  err = carry_errors(*(torch.randn(main_shape, device=device, generator=gen)
                       for _ in range(3)),
                     carry_state(batch, h, main_shape[1], d, device),
                     *main_offsets, True)
  check(err[0] <= CARRY_RTOL, 'K6 at the main path\'s shape: {:.3g} of max'
        .format(err[0]))
  diag = timed(RING_HOP, l, l)
  full_hop = timed(RING_HOP, 2 * l, 0)
  mix = sass_mix('flash_attention_carry', function=FWD_FUNCTION)
  check(mix['HMMA'] > 0, 'the SASS of flash_attention_carry holds no HMMA')
  # bf16 (csrc/flash_fwd_bf16.cuh, p split in two halves): the one-rank
  # launch and the 4-rank hops.
  bf16_mix = bf16_sass('flash_attention_carry', FWD_BF16_FUNCTION)
  one16 = timed((8, 4 * l, h, d), 0, 0, dtype=torch.bfloat16)
  diag16 = timed(RING_HOP, l, l, dtype=torch.bfloat16)
  full16 = timed(RING_HOP, 2 * l, 0, dtype=torch.bfloat16)
  print('flash_attention_carry per launch at the main path\'s shape {} '
        'causal f32 at offsets {}: {:.4f} ms ({:.1f} TFLOP/s), plain {:.4f} ms, '
        'bound {:.4f} ms ({}) for 3xTF32 on the tensor cores, {:.4f} ms on '
        'the CUDA cores\' float32 rate; no single PyTorch call takes a '
        'carried (o, m, l); at the 4-rank hop [{},{},{},{}]: diagonal {:.4f} '
        'ms (bounds {:.4f} 3xTF32, {:.4f} float32), full {:.4f} ms (bounds '
        '{:.4f}, {:.4f}); its SASS: {} HMMA, {} LDS, {} integer; {}'.format(
            list(main_shape), main_offsets, ms, 4 * d * pairs / ms / 1e9,
            plain, bound, by, fp32_bound, b, l, h, d, diag[0], diag[2],
            diag[5], full_hop[0], full_hop[2], full_hop[5], mix['HMMA'],
            mix['LDS'], mix['integer'], smi_line()))
  print('flash_attention_carry bf16 (p split in two bf16 halves; device '
        'time): the one-rank launch [8,{},{},{}] causal at offsets (0, 0) '
        '{:.4f} ms '
        '({:.1f} TFLOP/s of the function\'s products; bound {:.4f} ms by {} '
        'at the bf16 peak); at the 4-rank hop [{},{},{},{}]: diagonal {:.4f} '
        'ms (bound {:.4f} by {}), full {:.4f} ms (bound {:.4f} by {}); '
        '{}'.format(4 * l, h, d, one16[0], 4 * d * one16[4] / one16[0] / 1e9,
                    one16[2], one16[3], b, l, h, d, diag16[0], diag16[2],
                    diag16[3], full16[0], full16[2], full16[3], smi_line()))
  return dict(name='flash_attention_carry', route='cuda',
              source='tensor2robot_tpu_torch/csrc/flash_attention_carry.cu',
              replaces='tensor2robot_tpu/parallel/flash_attention.py:342',
              max_abs_err=err[1], ms=ms, plain_ms=plain, bound_ms=bound,
              bound_by=by, fp32_bound_ms=fp32_bound,
              tensor_core_bound_ms=bound, library_ms=None,
              library_note='no single PyTorch call takes a carried (o, m, l)',
              sass_hmma=mix['HMMA'], sass_mix=mix,
              shapes='per launch: {} causal f32 at offsets {}'.format(
                  list(main_shape), main_offsets),
              hop_ms={'diagonal': diag[0], 'full': full_hop[0]},
              hop_bound_ms={'diagonal': diag[2], 'full': full_hop[2]},
              hop_fp32_bound_ms={'diagonal': diag[5], 'full': full_hop[5]},
              max_rel_err=max(worst, err[0]),
              bf16_ms=one16[0], bf16_bound_ms=one16[2],
              bf16_bound_by=one16[3], bf16_sass_mix=bf16_mix,
              bf16_shapes='per launch: [8,{},{},{}] causal bf16 at offsets '
              '(0, 0)'.format(4 * l, h, d),
              bf16_hop_ms={'diagonal': diag16[0], 'full': full16[0]},
              bf16_hop_bound_ms={'diagonal': diag16[2], 'full': full16[2]})


def phase_ring_train(world, pattern):
  """Spawns ``world`` NCCL ranks (``ring_rank``), one a card; each trains
  the full-width 512-frame binding with ring attention from the episodes
  at ``pattern``, its loader on the trainer's share of the host's cores
  for one of ``world`` ranks. Returns rank 0's report."""
  import torch.multiprocessing as torch_mp

  import socket

  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
  with tempfile.TemporaryDirectory() as out_dir:
    context = torch_mp.start_processes(
        ring_rank, args=(world, out_dir, pattern, port), nprocs=world,
        join=False, start_method='spawn')
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
        'loop\'s median step {} ms, of which waiting for data {} ms, a '
        'resident step {} ms ({:.2f} episodes/s on rank 0); their loaders: '
        '{}; {}'.format(
            world, [round(r['peak_gb'], 2) for r in reports],
            [round(r['step_ms'], 2) for r in reports],
            [round(r['data_ms'], 2) for r in reports],
            [round(r['resident_ms'], 2) for r in reports],
            batch * 1e3 / reports[0]['resident_ms'],
            ' | '.join('rank {}: {}'.format(r['rank'], r['loader'])
                       for r in reports), smi_line()))
  return reports[0]


def recording_episodes(pattern, batch, threads):
  """A record generator of the episodes at ``pattern`` that keeps, for
  each batch it yields, the (episode, frame) its actions name
  (``names``), and the device index each iterator was given
  (``devices``)."""
  from tensor2robot_tpu_torch.data import input_generators

  class RecordingEpisodes(input_generators.DefaultRecordInputGenerator):

    def __init__(self):
      super().__init__(file_patterns=pattern, batch_size=batch,
                       use_native=True, num_native_threads=threads)
      self.names, self.devices = [], []

    def _create_iterator(self, mode, num_epochs, seed, frames, shard_index,
                         num_shards, device):
      self.devices.append(device)
      inner = super()._create_iterator(mode, num_epochs, seed, frames,
                                       shard_index, num_shards, device)
      try:
        for features, labels in inner:
          self.names.append(episode_names(labels['action']))
          yield features, labels
      finally:
        inner.close()

  return RecordingEpisodes()


def check_rank_episodes(data, rank, world, device, group):
  """A ring rank's batches from records: its loader was given its card's
  index (and decoded there, under nvJPEG); every batch holds frames
  [r T/N, (r + 1) T/N) of whole episodes; and every rank had the same
  episodes at every step (an all-gather of the episodes its actions
  name)."""
  import torch.distributed as dist
  from tensor2robot_tpu_torch.data import native_loader

  check(data.devices and all(d == device.index for d in data.devices),
        'rank {}: the loader was given devices {}, not {}'.format(
            rank, data.devices, device.index))
  decode_device = data.stream.stats()['decode_device']
  check(decode_device == (device.index if native_loader.decoder() ==
                          'nvjpeg' else -1),
        'rank {}: the loader decoded on device {}'.format(rank,
                                                         decode_device))
  per_rank = SEQ2ACT_EPISODE // world
  frames = np.arange(rank * per_rank, (rank + 1) * per_rank)
  names = np.stack(data.names[:RING_STEPS])          # [steps, B, T/N, 2]
  check(np.array_equal(names[..., 1], np.broadcast_to(frames,
                                                      names.shape[:-1])),
        'rank {}: its batches hold other frames than {}..{}'.format(
            rank, frames[0], frames[-1]))
  episodes = names[..., 0]
  check(np.array_equal(episodes, np.broadcast_to(episodes[..., :1],
                                                 episodes.shape)),
        'rank {}: a row mixes episodes'.format(rank))
  mine = torch.from_numpy(np.ascontiguousarray(episodes[..., 0])).to(device)
  everyone = [torch.empty_like(mine) for _ in range(world)]
  dist.all_gather(everyone, mine, group=group)
  check(all(torch.equal(theirs, mine) for theirs in everyone),
        'rank {}: the ranks read other episodes at some step'.format(rank))
  return episodes[..., 0]


class LossRecorder:
  """A hook builder whose hook keeps every step's loss (on the host)."""

  def __init__(self):
    self.losses = []

  def create_hooks(self, t2r_model, trainer):
    del t2r_model, trainer
    recorder = self

    class Hook:
      def begin(self, trainer):
        pass

      def after_step(self, trainer, state, step, metrics):
        recorder.losses.append(float(metrics['loss']))

      def end(self, trainer, state):
        pass

    return [Hook()]


# The ring under the gin: steps, and its loss against the flags run's at
# the same step: the same model, seed and episodes; relative, for cuDNN's
# weight gradients, whose sums may take another order from run to run.
RING_GIN_STEPS, RING_GIN_RTOL = 2, 1e-5


def ring_rank(rank, world, out_dir, pattern, port):
  """One rank of ``phase_ring_train``: trains RING_STEPS steps through
  ``train_eval_model`` from the episodes at ``pattern`` and checks the
  launches, the losses, the weights on every rank, the checkpoint and the
  rank's episodes and frames (``check_rank_episodes``); one ring step
  against one flash step; a profile; the trained checkpoint served by the
  flash policy. Then ``train_eval --gin_configs`` with
  ``Seq2ActBCModel.attention_mode = "ring"`` as torchrun starts it (on
  ``port``), RING_GIN_STEPS steps at the same shape: its loss equal to the
  first run's at that step."""
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
  data = recording_episodes(pattern, batch,
                            train_eval.loader_threads(world))
  model_dir = os.path.join(out_dir, 'model')
  recorder = LossRecorder()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  start = time.monotonic()
  result = train_eval.train_eval_model(
      model, model_dir, data, max_train_steps=RING_STEPS, log_every_n_steps=1,
      save_checkpoints_steps=RING_STEPS, nan_policy='raise', seed=0,
      train_hook_builders=[recorder])
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
  episodes = check_rank_episodes(data, rank, world, device, group)
  windows = trainer.windows[1:]
  step_ms = statistics.median(w[1] * 1e3 for w in windows)
  data_ms = statistics.median(w[2] * 1e3 for w in windows)
  loop_s = sum(w[1] for w in trainer.windows)
  report = dict(rank=rank, world=world, batch=batch, launches=launches,
                peak_gb=peak_gb, step_ms=step_ms, data_ms=data_ms, loss=loss,
                metrics=trainer.last_metrics, seconds=elapsed,
                loader=loader_line(data.stream.stats(), loop_s,
                                   SEQ2ACT_EPISODE // world))
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
    print('seq2act ring train: every rank read frames [r {0}/{1}, (r + 1) '
          '{0}/{1}) of the same episodes at every step (first steps\' '
          'episodes {2}); rank 0\'s loader over the loop\'s {3:.3f} s: '
          '{4}'.format(SEQ2ACT_EPISODE, world, episodes[:2, :8].tolist(),
                       loop_s, report['loader']))

  # This rank's frames of a train batch for the resident-batch step; a
  # batch of whole episodes for the comparison with a flash step below.
  iterator = trainer.dataset_iterator(data, ModeKeys.TRAIN, 1)
  numpy_features, numpy_labels = next(iterator)
  iterator.close()
  raw = trainer.put_batch(numpy_features)
  labels = trainer.put_batch(numpy_labels)
  whole = input_generators.DefaultRecordInputGenerator(
      file_patterns=pattern, batch_size=RING_VS_FLASH_BATCH, use_native=True)
  whole.set_specification_from_model(model, ModeKeys.TRAIN)
  iterator = whole.create_dataset_iterator(ModeKeys.TRAIN, seed=1,
                                           prefetch=0, device=device.index)
  numpy_features, numpy_labels = next(iterator)
  iterator.close()

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
  dist.destroy_process_group()
  del model, state, result, trainer
  torch.cuda.empty_cache()
  report['gin'] = ring_gin_rank(rank, world, out_dir, pattern, port, batch,
                                recorder.losses[RING_GIN_STEPS - 1])
  with open(os.path.join(out_dir, 'rank{}.json'.format(rank)), 'w') as f:
    json.dump(report, f)


def ring_gin_rank(rank, world, out_dir, pattern, port, batch, flags_loss):
  """``train_eval.main`` on train_seq2act_bc.gin with the ring bound, as
  torchrun starts a rank: main_gin builds the group (NCCL on
  cuda:LOCAL_RANK), hands it to the model and destroys it. float32
  (device_type "gpu") at the first run's shape, episodes and seed; rank 0
  holds its loss at RING_GIN_STEPS to the first run's."""
  import contextlib
  import io

  import torch.distributed as dist
  from tensor2robot_tpu_torch import kernels
  from tensor2robot_tpu_torch.trainer import train_eval

  os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                    MASTER_PORT=str(port))
  argv = ['--model_dir', os.path.join(out_dir, 'gin_model'),
          '--gin_configs', SEQ2ACT_BC_GIN]
  for binding in ['Seq2ActBCModel.episode_length = {}'.format(
                      SEQ2ACT_EPISODE),
                  'Seq2ActBCModel.attention_mode = "ring"',
                  'Seq2ActBCModel.device_type = "gpu"'] + run_bindings(
                      RING_GIN_STEPS, batch, data=pattern):
    argv += ['--gin_bindings', binding]
  kernels.reset_launches()
  out = io.StringIO()
  start = time.monotonic()
  with contextlib.redirect_stdout(out):
    check(train_eval.main(argv) == 0, 'the ring gin failed')
  seconds = time.monotonic() - start
  check(not dist.is_initialized(), 'main_gin left its group')
  launches = dict(kernels.LAUNCHES)
  check(launches['flash_attention_carry'] == 8 * world * RING_GIN_STEPS and
        launches['crop_convert'] == RING_GIN_STEPS, 'rank {}: ring gin '
        'launches {}'.format(rank, launches))
  if rank:
    return {'launches': launches}
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  loss = line['metrics']['loss']
  check(line['world_size'] == world and line['step'] == RING_GIN_STEPS and
        abs(loss - flags_loss) <= RING_GIN_RTOL * abs(flags_loss),
        'the ring under the gin: world {}, step {}, loss {} against the '
        'first run\'s {}'.format(line['world_size'], line['step'], loss,
                                 flags_loss))
  print('seq2act ring under train_seq2act_bc.gin (attention_mode "ring" '
        'bound, main_gin\'s group over {} ranks, batch {}, float32): {} '
        'steps in {:.1f}s, launches a rank {}; loss at step {} {:.6f}, the '
        'first run\'s {:.6f} (bound {:g} relative); the loop\'s median step '
        '{:.1f} ms; {}'.format(world, batch, RING_GIN_STEPS, seconds,
                               launches, RING_GIN_STEPS, loss, flags_loss,
                               RING_GIN_RTOL, line['step_ms'], smi_line()))
  return {'launches': launches, 'loss': loss, 'flags_loss': flags_loss,
          'step_ms': line['step_ms']}


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
  paths = {'serve': phase_slice(device), 'train': phase_train(device)}
  critic_dir = tempfile.TemporaryDirectory()
  try:
    paths.update(phase_records(device, critic_dir.name))
    paths['records_coef_train'] = phase_records_coef(device,
                                                     critic_dir.name)
    paths.update(phase_gins(device, critic_dir.name))
  finally:
    critic_dir.cleanup()
  paths.update({'seq2act': phase_seq2act(device),
                'seq2act_train': phase_seq2act_train(device)})
  paths['seq2act_bf16_train'], bf16_report = phase_seq2act_bf16(device)
  # K1 and K2f report their serving launches, K2b and K3 their training
  # ones, K4 its seq2act ones, K5a and K5b their seq2act training ones, K6
  # its ring training ones; every path's counts are listed too.
  entries = [(crop, 'serve'), (pool, 'serve'), (pool_backward, 'train'),
             (wgrad_entry, 'train'), (flash, 'seq2act'),
             (flash_kv, 'seq2act_train'), (flash_q, 'seq2act_train')]
  episodes_dir = tempfile.TemporaryDirectory()
  try:
    paths['seq2act_records_train'], pattern = phase_seq2act_records(
        device, episodes_dir.name)
    paths['seq2act_moe_train'], moe_report = phase_moe(device, pattern)
    carry = phase_ring_kernel(device, gen, world)
    ring = phase_ring_train(world, pattern)
  finally:
    episodes_dir.cleanup()
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
  print(json.dumps({'seq2act_variants': {
      'bf16': bf16_report, 'moe': moe_report, 'ring_gin': ring['gin']}}))
  print(json.dumps({'kernels': [entry for entry, _ in entries]}))
  print(smi_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
