"""Serve the QT-Opt Grasping44 CEM policy on the GPU.

The port's counterpart of ``bin/t2r_serve``: stands up a ``PolicyServer``
over the flagship critic's batched CEM selector and answers requests over
the stdlib HTTP/JSON front end, or drives it with closed-loop synthetic
clients and prints one JSON stats line.

Examples:

    # Random weights, HTTP on :8080, the 30 Hz SLO:
    python -m tensor2robot_tpu_torch.serving.serve --init_randomly \\
        --port 8080 --slo_ms 33

    # Capacity check without HTTP: 16 clients for 20 s, one JSON line:
    python -m tensor2robot_tpu_torch.serving.serve --init_randomly \\
        --synthetic_load 16 --duration 20

Weights: restoring a checkpoint without JAX is not ported yet, so
``--init_randomly`` is required (weights drawn from ``--seed``). The
network runs in float32 with TF32 off for convolutions and matrix
products, unless ``--compute_dtype bfloat16``. Everything runs on
``--device`` (``cuda`` by default; ``cpu`` only when asked for).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.serving.frontend import build_http_server
from tensor2robot_tpu_torch.serving.server import PolicyServer, ServingConfig

__all__ = ['build_policy', 'main', 'make_parser', 'run_synthetic_load',
           'synthetic_state']

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def synthetic_state(feature_spec, rng: np.random.RandomState):
  """One random request matching ``feature_spec``."""
  state = {}
  for name, (shape, dtype) in feature_spec.items():
    if np.dtype(dtype) == np.uint8:
      state[name] = rng.randint(0, 255, shape).astype(np.uint8)
    else:
      state[name] = rng.uniform(0, 1, shape).astype(dtype)
  return state


def run_synthetic_load(server, feature_spec, clients: int,
                       duration_s: float):
  """Drives ``clients`` closed-loop clients for ``duration_s`` seconds."""
  stop = threading.Event()
  completed = []
  failed = []

  def client(seed):
    rng = np.random.RandomState(seed)
    state = synthetic_state(feature_spec, rng)
    while not stop.is_set():
      try:
        result = server.select_action(state, timeout_s=60.0)
        completed.append(result.latency_ms)
      except Exception as e:  # noqa: BLE001 — count, keep driving
        failed.append(repr(e))

  threads = [threading.Thread(target=client, args=(i,), daemon=True)
             for i in range(clients)]
  start = time.monotonic()
  for t in threads:
    t.start()
  time.sleep(duration_s)
  stop.set()
  for t in threads:
    t.join()
  elapsed = time.monotonic() - start
  return {'clients': clients, 'duration_s': round(elapsed, 2),
          'completed': len(completed), 'failed': len(failed),
          'actions_per_sec': round(len(completed) / elapsed, 2)}


def build_policy(device='cuda', num_convs=(6, 6, 3), cem_samples=64,
                 cem_iters=3, num_elites=10, seed=0,
                 compute_dtype=torch.float32):
  """The flagship model on ``device``, random weights from ``seed``, and
  its batched CEM selector: ``(model, variables, batch_select)``."""
  model = t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device=device, compute_dtype=compute_dtype,
      network_kwargs={'num_convs': tuple(num_convs)})
  variables = model.init_variables(torch.Generator().manual_seed(seed))
  batch_select = model.make_batched_select_action(
      cem_samples=cem_samples, cem_iters=cem_iters, num_elites=num_elites)
  return model, variables, batch_select


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--init_randomly', action='store_true',
                      help='random weights from --seed (required until '
                      'checkpoint restore is ported)')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  parser.add_argument('--compute_dtype', default='float32',
                      choices=sorted(_DTYPES))
  parser.add_argument('--num_convs', default='6,6,3',
                      help='depth of the three conv stacks')
  parser.add_argument('--model_dir', default='',
                      help='where serving telemetry.jsonl lands (none by '
                      'default)')
  parser.add_argument('--port', type=int, default=8080)
  parser.add_argument('--host', default='127.0.0.1')
  parser.add_argument('--max_batch_size', type=int, default=8)
  parser.add_argument('--max_wait_ms', type=float, default=5.0)
  parser.add_argument('--max_queue_depth', type=int, default=64)
  parser.add_argument('--slo_ms', type=float, default=33.0)
  parser.add_argument('--report_interval_s', type=float, default=10.0)
  parser.add_argument('--image_shape', default='512,640,3',
                      help='per-request camera frame shape (uint8)')
  parser.add_argument('--cem_samples', type=int, default=64)
  parser.add_argument('--cem_iters', type=int, default=3)
  parser.add_argument('--num_elites', type=int, default=10)
  parser.add_argument('--synthetic_load', type=int, default=0, metavar='N',
                      help='drive N closed-loop synthetic clients instead '
                      'of serving HTTP; print a JSON stats line')
  parser.add_argument('--duration', type=float, default=20.0,
                      help='synthetic load duration in seconds')
  return parser


def main(argv=None) -> int:
  parser = make_parser()
  args = parser.parse_args(argv)
  if not args.init_randomly:
    parser.error('restoring weights is not ported yet; pass '
                 '--init_randomly')

  device = torch.device(args.device)
  if device.type == 'cuda':
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('built CUDA kernels in {:.1f}s'.format(kernels.build()))
  model, variables, batch_select = build_policy(
      device=device,
      num_convs=[int(n) for n in args.num_convs.split(',')],
      cem_samples=args.cem_samples, cem_iters=args.cem_iters,
      num_elites=args.num_elites, seed=args.seed,
      compute_dtype=_DTYPES[args.compute_dtype])
  image_shape = tuple(int(d) for d in args.image_shape.split(','))
  feature_spec = model.serving_feature_spec(image_shape=image_shape)
  batch = args.max_batch_size

  # One batch before the server starts, so that no request pays for the
  # first launches.
  rng = np.random.RandomState(args.seed)
  warm = [synthetic_state(feature_spec, rng) for _ in range(batch)]
  batch_select(variables, {name: np.stack([w[name] for w in warm])
                           for name in feature_spec}, 0)

  config = ServingConfig(
      max_batch_size=batch, max_wait_ms=args.max_wait_ms,
      max_queue_depth=args.max_queue_depth, slo_ms=args.slo_ms,
      report_interval_s=args.report_interval_s)
  service = PolicyServer(batch_select, variables, config,
                         model_dir=args.model_dir or None,
                         feature_spec=feature_spec,
                         aot_info={'device': str(device)})
  service.start()
  try:
    if args.synthetic_load:
      stats = run_synthetic_load(service, feature_spec, args.synthetic_load,
                                 args.duration)
      stats.update({k: v for k, v in service.stats().items()
                    if not isinstance(v, (dict, list))})
      stats['p99_ms'] = service.stats()['latency_ms'].get('p99', 0.0)
      stats['device'] = str(device)
      print(json.dumps(stats))
      return 0
    httpd, port = build_http_server(service, host=args.host, port=args.port)
    print('serving {} on http://{}:{} (batch {}, wait {:g} ms, SLO {:g} ms, '
          'device {}); Ctrl-C to stop'.format(
              type(model).__name__, args.host, port, batch,
              args.max_wait_ms, args.slo_ms, device))
    try:
      httpd.serve_forever()
    except KeyboardInterrupt:
      pass
    finally:
      httpd.shutdown()
    return 0
  finally:
    service.drain(timeout_s=10.0)
    service.close()


if __name__ == '__main__':
  sys.exit(main())
