"""Serve the QT-Opt Grasping44 CEM policy on the GPU.

The port's counterpart of ``bin/t2r_serve``: stands up a ``PolicyServer``
over the flagship critic's batched CEM selector and answers requests over
the stdlib HTTP/JSON front end, or drives it with closed-loop synthetic
clients and prints one JSON stats line.

Weights come from one of three sources:

  * ``--checkpoint_dir``: the trainer's ``model_dir``. A
    ``CheckpointPredictor`` waits up to ``--restore_timeout`` seconds for
    its first checkpoint (and exits if none comes), and a poll thread
    looks for a newer one every ``--poll_secs`` and hot-swaps it into the
    running server (``PolicyServer.swap_params``) with no request
    dropped; a poll that fails keeps the old weights and says so on
    stderr. Telemetry goes to ``<checkpoint_dir>/serving`` unless
    ``--model_dir`` says otherwise;
  * ``--export_dir``: a versioned export root (an exporter's
    ``<model_dir>/export/<name>``). An ``ExportedModelPredictor`` waits for
    its first committed version the same way, and the same poll thread
    hot-swaps each newer version in; telemetry goes to
    ``<export_dir>/serving``;
  * ``--init_randomly``: weights drawn from ``--seed``.

Examples:

    # Serve what the trainer writes, HTTP on :8080, the 30 Hz SLO:
    python -m tensor2robot_tpu_torch.serving.serve \\
        --checkpoint_dir /tmp/qtopt --port 8080 --slo_ms 33

    # Capacity check without HTTP: 16 clients for 20 s, one JSON line:
    python -m tensor2robot_tpu_torch.serving.serve --init_randomly \\
        --synthetic_load 16 --duration 20

    # A fleet of 2 replicas behind the router (on one card, keep to
    # --replicas 1: see below):
    python -m tensor2robot_tpu_torch.serving.serve \\
        --checkpoint_dir /tmp/qtopt --replicas 2

With ``--replicas N`` above 1, or ``--autoscale_max`` above it, a
``ServingFleet`` serves: N ``PolicyServer`` replicas behind the
telemetry-weighted router, each calling the weights through its own copy of
the critic's module (``functional_call`` swaps a module's tensors while it
runs) and answering one warm batch before it enters rotation. The poll
thread rolls each newer checkpoint through the fleet one replica at a time
(``ServingFleet.rolling_swap``). The serving dir is fleet-shaped: the
router's stream ``telemetry.0.jsonl``, replica *i*'s ``telemetry.<i>.jsonl``.
Every replica is a thread of this process on the same card, so on one card
more replicas serve fewer actions a second, not more: the card waits on
the threads' launches (on an H100, 235, 169 and 50 actions/s at 1, 2 and 4
replicas; ``PERF.md`` section 6). The autoscaler adds replicas as the
router's queues fill, and on one card the slowdown a replica causes fills
them further, so ``--autoscale_max`` grows such a fleet to its ceiling.

The network runs in float32 with TF32 off for convolutions and matrix
products, unless ``--compute_dtype bfloat16``. Everything runs on
``--device`` (``cuda`` by default; ``cpu`` only when asked for).
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.predictors.checkpoint_predictor import (
    CheckpointPredictor)
from tensor2robot_tpu_torch.predictors.exported_model_predictor import (
    ExportedModelPredictor)
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.serving.fleet import (
    ServingFleet,
    ServingFleetConfig,
)
from tensor2robot_tpu_torch.serving.frontend import build_http_server
from tensor2robot_tpu_torch.serving.router import LocalReplicaHandle
from tensor2robot_tpu_torch.serving.server import PolicyServer, ServingConfig

__all__ = ['Serving', 'build_model', 'build_policy', 'build_predictor',
           'build_replica', 'build_server', 'main', 'make_parser',
           'run_synthetic_load', 'start', 'synthetic_state']

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
  """Drives ``clients`` closed-loop clients for ``duration_s`` seconds.

  The stats count the answers of each params version
  (``versions_served``) and when, on the monotonic clock, each version
  gave its first answer (``first_answer_monotonic``).
  """
  stop = threading.Event()
  lock = threading.Lock()
  completed, failed = [], []
  versions, first_answer = {}, {}

  def client(seed):
    rng = np.random.RandomState(seed)
    state = synthetic_state(feature_spec, rng)
    while not stop.is_set():
      try:
        result = server.select_action(state, timeout_s=60.0)
      except Exception as e:  # noqa: BLE001 — count, keep driving
        failed.append(repr(e))
        continue
      answered = time.monotonic()
      with lock:
        completed.append(result.latency_ms)
        key = str(result.version)
        versions[key] = versions.get(key, 0) + 1
        first_answer[key] = min(first_answer.get(key, answered), answered)

  threads = [threading.Thread(target=client, args=(i,), daemon=True)
             for i in range(clients)]
  start_time = time.monotonic()
  for t in threads:
    t.start()
  time.sleep(duration_s)
  stop.set()
  for t in threads:
    t.join()
  elapsed = time.monotonic() - start_time
  return {'clients': clients, 'duration_s': round(elapsed, 2),
          'completed': len(completed), 'failed': len(failed),
          'actions_per_sec': round(len(completed) / elapsed, 2),
          'versions_served': versions,
          'first_answer_monotonic': first_answer}


def build_model(device='cuda', num_convs=(6, 6, 3),
                compute_dtype=torch.float32):
  """The flagship critic on ``device``."""
  return t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
      device=device, compute_dtype=compute_dtype,
      network_kwargs={'num_convs': tuple(num_convs)})


def build_policy(device='cuda', num_convs=(6, 6, 3), cem_samples=64,
                 cem_iters=3, num_elites=10, seed=0,
                 compute_dtype=torch.float32):
  """The flagship model on ``device``, random weights from ``seed``, and
  its batched CEM selector: ``(model, variables, batch_select)``."""
  model = build_model(device, num_convs, compute_dtype)
  variables = model.init_variables(torch.Generator().manual_seed(seed))
  batch_select = model.make_batched_select_action(
      cem_samples=cem_samples, cem_iters=cem_iters, num_elites=num_elites)
  return model, variables, batch_select


def build_predictor(model, args):
  """The weights' source: ``(predictor, polls)``. From
  ``--checkpoint_dir`` (``--export_dir``), the newest checkpoint (export)
  within ``--restore_timeout`` (else the process exits) and ``polls``
  True; else random weights from ``--seed``."""
  if getattr(args, 'export_dir', ''):
    predictor = ExportedModelPredictor(args.export_dir, model,
                                       timeout=args.restore_timeout)
    if not predictor.restore():
      raise SystemExit('no export appeared under {} within {}s'.format(
          args.export_dir, args.restore_timeout))
    return predictor, True
  predictor = CheckpointPredictor(model, args.checkpoint_dir or None,
                                  timeout=args.restore_timeout)
  if args.checkpoint_dir:
    if not predictor.restore():
      raise SystemExit('no checkpoint appeared under {} within {}s'.format(
          args.checkpoint_dir, args.restore_timeout))
    return predictor, True
  predictor.init_randomly(seed=args.seed)
  return predictor, False


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  source = parser.add_mutually_exclusive_group(required=True)
  source.add_argument('--checkpoint_dir', default='',
                      help='the trainer model_dir to serve and poll '
                      'checkpoints from')
  source.add_argument('--export_dir', default='',
                      help='a versioned export root to serve and poll '
                      '(<model_dir>/export/latest_exporter)')
  source.add_argument('--init_randomly', action='store_true',
                      help='random weights from --seed (smoke and '
                      'capacity checks)')
  parser.add_argument('--poll_secs', type=float, default=30.0,
                      help='seconds between looks for a newer checkpoint '
                      '(export)')
  parser.add_argument('--restore_timeout', type=float, default=600.0,
                      help='seconds to wait for the first checkpoint or '
                      'export (and for a newer one while polling)')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  parser.add_argument('--compute_dtype', default='float32',
                      choices=sorted(_DTYPES))
  parser.add_argument('--num_convs', default='6,6,3',
                      help='depth of the three conv stacks')
  parser.add_argument('--model_dir', default='',
                      help='where serving telemetry.jsonl lands (default: '
                      '<checkpoint_dir or export_dir>/serving, a '
                      'subdirectory, so that the server never writes into '
                      'a live trainer\'s files; none for --init_randomly)')
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
  parser.add_argument('--replicas', type=int, default=1,
                      help='PolicyServer replicas behind the fleet router '
                      '(1: one server, no router). Replicas are threads of '
                      'this process: on one card more of them serve fewer '
                      'actions a second')
  parser.add_argument('--autoscale_max', type=int, default=0,
                      help='run the autoscaler with this replica ceiling '
                      '(above --replicas); 0: a fixed fleet. On one card '
                      'it grows the fleet to the ceiling and cuts '
                      'throughput (see --replicas)')
  parser.add_argument('--fleet_report_interval_s', type=float, default=10.0,
                      help='cadence of t2r.serving_fleet.v1 windows (and '
                      'autoscale decisions)')
  parser.add_argument('--stale_after_s', type=float, default=30.0,
                      help='replica heartbeat age that ejects it from '
                      'rotation')
  parser.add_argument('--synthetic_load', type=int, default=0, metavar='N',
                      help='drive N closed-loop synthetic clients instead '
                      'of serving HTTP; print a JSON stats line')
  parser.add_argument('--duration', type=float, default=20.0,
                      help='synthetic load duration in seconds')
  return parser


class Serving:
  """A running service: the model, its predictor, the ``PolicyServer`` or
  ``ServingFleet`` and the poll thread that swaps newer checkpoints
  (exports) into it, one server at once or the fleet one replica at a
  time. ``stop`` drains the service and ends the thread."""

  def __init__(self, model, predictor, service, feature_spec, polls,
               poll_secs):
    self.model = model
    self.predictor = predictor
    self.service = service
    self.feature_spec = feature_spec
    self.is_fleet = isinstance(service, ServingFleet)
    self.swaps = []   # (version, monotonic time of the swap) a swap
    self._version = predictor.versioned_variables[0]
    self._stop = threading.Event()
    self._thread = None
    if polls:
      self._thread = threading.Thread(target=self._poll_loop,
                                      args=(poll_secs,), daemon=True,
                                      name='t2r-torch-checkpoint-poll')
      self._thread.start()

  @property
  def params_version(self) -> int:
    """The version the poll thread last swapped in (or started with)."""
    return self._version

  def _poll_loop(self, poll_secs: float) -> None:
    while not self._stop.wait(poll_secs):
      try:
        if not self.predictor.restore():
          continue
        version, variables = self.predictor.versioned_variables
        if version == self._version:
          continue
        if self.is_fleet:
          # One replica at a time: both versions serve during the wave,
          # each replica's swap being drain-free.
          wave = self.service.rolling_swap(variables, version)
          message = 'rolling-swapped the fleet to params v{} (wave: {})'
          message = message.format(version, wave)
        else:
          self.service.swap_params(variables, version)
          message = 'hot-swapped to params v{}'.format(version)
        self._version = version
        self.swaps.append((version, time.monotonic()))
        print(message, flush=True)
      except Exception as e:  # noqa: BLE001 — keep serving the old weights
        print('hot-swap poll failed, serving params v{} still: {!r}'.format(
            self._version, e), file=sys.stderr, flush=True)

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join()
    self.service.close()   # answers every accepted request first
    self.predictor.close()


def build_server(model, predictor, feature_spec, config, warm, network=None,
                 cem_samples=64, cem_iters=3, num_elites=10, **server_kwargs):
  """A started ``PolicyServer`` over the predictor's current versioned
  weights, calling them through ``network`` (the model's own module by
  default), that has answered the batch ``warm`` first, so that no request
  pays for the first launches. ``server_kwargs`` go to the server
  (``model_dir`` or ``telemetry``, ``aot_info``)."""
  batch_select = model.make_batched_select_action(
      cem_samples=cem_samples, cem_iters=cem_iters, num_elites=num_elites,
      network=network)
  version, variables = predictor.versioned_variables
  batch_select(variables, warm, 0)
  server = PolicyServer(batch_select, variables, config, version=version,
                        feature_spec=feature_spec, **server_kwargs)
  server.start()
  return server


def build_replica(replica_id, telemetry, model, predictor, feature_spec,
                  config, warm, **cem):
  """One fleet replica, ready to serve: ``build_server`` through the
  replica's own copy of the critic's module (``functional_call`` swaps a
  module's tensors while it runs, so replicas must not share one; the
  weight tensors of a version they share, read only), reporting into
  ``telemetry``. The ``(replica_id, telemetry) -> handle`` factory of
  ``ServingFleet`` once the other arguments are bound."""
  server = build_server(model, predictor, feature_spec, config, warm,
                        network=copy.deepcopy(model.network),
                        telemetry=telemetry,
                        aot_info={'device': str(model.device),
                                  'replica': int(replica_id)}, **cem)
  return LocalReplicaHandle(replica_id, server)


def start(args, fleet=None) -> Serving:
  """Builds the kernels (on a card), the model, the weights' source and the
  selector, and starts one server, or a fleet of ``--replicas``, each
  having answered one warm batch, and the poll thread.

  ``fleet`` None serves a fleet when ``--replicas`` is above 1 or
  ``--autoscale_max`` above it, else one server without a router, as the
  JAX package's ``t2r_serve`` does; True serves a fleet of any size (one
  replica behind the router measures the router's own cost)."""
  device = torch.device(args.device)
  if device.type == 'cuda':
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('built CUDA kernels in {:.1f}s'.format(kernels.build()))
  model = build_model(device, [int(n) for n in args.num_convs.split(',')],
                      _DTYPES[args.compute_dtype])
  predictor, polls = build_predictor(model, args)
  image_shape = tuple(int(d) for d in args.image_shape.split(','))
  feature_spec = model.serving_feature_spec(image_shape=image_shape)
  batch = args.max_batch_size
  rng = np.random.RandomState(args.seed)
  warm_states = [synthetic_state(feature_spec, rng) for _ in range(batch)]
  warm = {name: np.stack([w[name] for w in warm_states])
          for name in feature_spec}

  source_dir = args.checkpoint_dir or args.export_dir
  model_dir = args.model_dir or (
      os.path.join(source_dir, 'serving') if source_dir else '')
  config = ServingConfig(
      max_batch_size=batch, max_wait_ms=args.max_wait_ms,
      max_queue_depth=args.max_queue_depth, slo_ms=args.slo_ms,
      report_interval_s=args.report_interval_s)
  cem = dict(cem_samples=args.cem_samples, cem_iters=args.cem_iters,
             num_elites=args.num_elites)
  fleet_size = max(1, args.replicas)
  max_replicas = max(fleet_size, args.autoscale_max)
  if fleet is None:
    fleet = fleet_size > 1 or max_replicas > fleet_size
  if fleet:
    factory = functools.partial(
        build_replica, model=model, predictor=predictor,
        feature_spec=feature_spec, config=config, warm=warm, **cem)
    service = ServingFleet(
        factory, ServingFleetConfig(
            min_replicas=fleet_size, max_replicas=max_replicas,
            autoscale=args.autoscale_max > 0,
            report_interval_s=args.fleet_report_interval_s,
            stale_after_s=args.stale_after_s, slo_ms=args.slo_ms),
        model_dir=model_dir or None, initial_replicas=fleet_size)
    service.start()
    print('fleet: {} replica(s) (max {}, autoscale {})'.format(
        fleet_size, max_replicas, 'on' if args.autoscale_max else 'off'),
          flush=True)
  else:
    service = build_server(model, predictor, feature_spec, config, warm,
                           model_dir=model_dir or None,
                           aot_info={'device': str(device)}, **cem)
  return Serving(model, predictor, service, feature_spec, polls,
                 args.poll_secs)


def main(argv=None) -> int:
  args = make_parser().parse_args(argv)
  serving = start(args)
  service = serving.service
  try:
    if args.synthetic_load:
      stats = run_synthetic_load(service, serving.feature_spec,
                                 args.synthetic_load, args.duration)
      stats.update({k: v for k, v in service.stats().items()
                    if not isinstance(v, (dict, list))})
      stats['p99_ms'] = service.stats()['latency_ms'].get('p99', 0.0)
      stats['device'] = args.device
      print(json.dumps(stats))
      return 0
    httpd, port = build_http_server(service, host=args.host, port=args.port)
    print('serving {} v{} on http://{}:{} ({}batch {}, wait {:g} ms, SLO '
          '{:g} ms, device {}); Ctrl-C to stop'.format(
              type(serving.model).__name__, serving.params_version,
              args.host, port,
              '{} replicas, '.format(args.replicas) if serving.is_fleet
              else '', args.max_batch_size, args.max_wait_ms, args.slo_ms,
              args.device), flush=True)
    try:
      httpd.serve_forever()
    except KeyboardInterrupt:
      pass
    finally:
      httpd.shutdown()
    return 0
  finally:
    serving.stop()


if __name__ == '__main__':
  sys.exit(main())
