"""Runnable serving-fleet bench: aggregate throughput-at-SLO against replicas.

    python -m tensor2robot_tpu_torch.serving.fleet_bench [--device cpu]

The port's counterpart of the JAX package's ``serving/fleet_bench.py``, with
its defaults. It stands up a ``ServingFleet`` of 1, 2 and 4 PolicyServer
replicas behind the telemetry-weighted router, drives each for
``--duration`` seconds with closed-loop clients, and prints ONE JSON line
holding the ``SERVING_FLEET_BENCH_KEYS`` quantities (`serving/fleet.py`)
and the per-fleet detail under ``serving_fleet``.

The policy is the sim critic's CEM selector
(``research/qtopt/grasping_sim.make_sim_critic_model`` at 96x128 behind
``rl/loop.make_cem_select_fn``, 32 samples x 2 iterations, 8 elites): this
bench measures the fleet (routing, scale-out, rolling swap) on a program
whose single replica sits inside the 33 ms SLO. Each replica calls the
weights through its own copy of the critic's module and answers one warm
batch before it enters rotation; the warm batch counts towards its time to
ready. Everything runs on ``--device``: ``cuda`` by default, ``cpu`` only
when asked for.

Contracts measured, not asserted:
  * ``serving_fleet_request_time_compiles``: ``kernels.BUILDS`` across
    every load phase (eager PyTorch compiles no program; the port's
    compiles are its nvcc builds, all made at start-up).
  * ``serving_fleet_scaleup_compiles``: the same count across the largest
    fleet's scale-out from 1 replica.
  * ``fleet_scaleup_time_to_ready_s``: the slowest of those scale-ups,
    factory start through rotation entry.
  * ``serving_fleet_swap_failed`` / ``serving_fleet_swap_versions_served``:
    the mid-load rolling swap of the largest fleet: failed requests
    fleet-wide, and the versions observed serving.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from tensor2robot_tpu_torch import kernels
from tensor2robot_tpu_torch.observability import (
    TelemetryRegistry,
    read_telemetry,
)
from tensor2robot_tpu_torch.research.qtopt import grasping_sim
from tensor2robot_tpu_torch.rl.loop import make_cem_select_fn
from tensor2robot_tpu_torch.serving.fleet import (
    ServingFleet,
    ServingFleetConfig,
)
from tensor2robot_tpu_torch.serving.router import LocalReplicaHandle
from tensor2robot_tpu_torch.serving.server import PolicyServer, ServingConfig

__all__ = ['build_sim_batch_select', 'main', 'run_bench']


def build_sim_batch_select(height: int, width: int, cem_samples: int,
                           cem_iters: int, num_elites: int, device='cuda'):
  """``(make_batch_select, variables, feature_spec)`` for the sim critic.

  ``make_batch_select()`` returns a new ``batch_select(variables, states,
  seed) -> {'action', 'q'}`` through a copy of the critic's module of its
  own, one for each replica.
  """
  model = grasping_sim.make_sim_critic_model(height=height, width=width,
                                             device=device)
  variables = model.init_variables(torch.Generator().manual_seed(0))

  def make_batch_select():
    select = make_cem_select_fn(model, cem_samples=cem_samples,
                                cem_iters=cem_iters, num_elites=num_elites,
                                network=copy.deepcopy(model.network))

    def batch_select(variables, states, seed):
      generator = torch.Generator(device=model.device)
      generator.manual_seed(int(seed))
      actions, q = select(variables, states, generator)
      return {'action': actions, 'q': q}

    return batch_select

  feature_spec = {
      'image': ((height, width, 3), np.uint8),
      'gripper_closed': ((), np.float32),
      'height_to_bottom': ((), np.float32),
  }
  return make_batch_select, variables, feature_spec


def run_bench(batch: int = 8, height: int = 96, width: int = 128,
              cem_samples: int = 32, cem_iters: int = 2,
              num_elites: int = 8, duration_s: float = 3.0,
              replica_counts=(1, 2, 4), device='cuda') -> dict:
  device = torch.device(device)
  if device.type == 'cuda':
    kernels.build()   # the start-up builds; every replica reuses them
  make_batch_select, variables, feature_spec = build_sim_batch_select(
      height, width, cem_samples, cem_iters, num_elites, device)
  serving_config = ServingConfig(max_batch_size=batch, max_wait_ms=2.0,
                                 max_queue_depth=8 * batch, slo_ms=33.0,
                                 report_interval_s=0.5)
  warm_state = {
      name: np.zeros((batch,) + shape, dtype)
      for name, (shape, dtype) in feature_spec.items()}

  def run_fleet(replicas, with_swap=False, scale_from_one=False):
    with tempfile.TemporaryDirectory(prefix='fleet_bench_') as fleet_dir:
      return run_fleet_in(fleet_dir, replicas, with_swap, scale_from_one)

  def run_fleet_in(fleet_dir, replicas, with_swap, scale_from_one):
    registry = TelemetryRegistry()  # per fleet: p99 must not mix runs

    def factory(replica_id, telemetry):
      batch_select = make_batch_select()
      # One warm batch BEFORE the replica enters rotation: the first
      # launches are readiness cost (inside time_to_ready_s), not request
      # latency.
      batch_select(variables, warm_state, 0)
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      server = PolicyServer(
          batch_select, variables, serving_config, version=1,
          telemetry=telemetry, feature_spec=feature_spec,
          registry=registry, aot_info={'device': str(device)})
      server.start()
      return LocalReplicaHandle(replica_id, server)

    config = ServingFleetConfig(
        min_replicas=1, max_replicas=replicas, autoscale=False,
        report_interval_s=0.5, health_interval_s=0.2,
        stale_after_s=10.0, slo_ms=33.0)
    fleet = ServingFleet(
        factory, config, model_dir=fleet_dir,
        initial_replicas=1 if scale_from_one else replicas,
        registry=registry)
    fleet.start()
    scaleup_seconds = []
    builds_before_scaleup = kernels.BUILDS
    if scale_from_one:
      for _ in range(replicas - 1):
        _, ready_s = fleet.scale_up(reason='bench')
        scaleup_seconds.append(ready_s)
    scaleup_builds = kernels.BUILDS - builds_before_scaleup

    stop = threading.Event()
    completed = [0]
    versions = set()
    failures = []
    lock = threading.Lock()

    def client(seed):
      client_rng = np.random.RandomState(seed)
      state = {'image': client_rng.randint(0, 255, (height, width, 3)
                                           ).astype(np.uint8),
               'gripper_closed': np.float32(0.0),
               'height_to_bottom': np.float32(0.1)}
      while not stop.is_set():
        try:
          result = fleet.select_action(state, timeout_s=120.0)
          with lock:
            completed[0] += 1
            versions.add(result.version)
        except Exception as e:  # noqa: BLE001 — every failure is the metric
          with lock:
            failures.append(repr(e)[:120])

    # 1.25x each replica's batch in closed-loop clients: enough to keep
    # every batcher fed without queueing so deep that the client threads'
    # own contention becomes the thing measured.
    clients = max(batch, (5 * batch * replicas) // 4)
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    builds_before = kernels.BUILDS
    start = time.perf_counter()
    for t in threads:
      t.start()
    if with_swap:
      time.sleep(duration_s / 2)
      # The same weights labelled v2 (what a checkpoint poll does),
      # walked across the fleet one replica at a time.
      fleet.rolling_swap(variables, version=2)
      time.sleep(duration_s / 2)
    else:
      time.sleep(duration_s)
    stop.set()
    for t in threads:
      t.join()
    elapsed = time.perf_counter() - start
    request_builds = kernels.BUILDS - builds_before
    stats = fleet.stats()
    fleet.close()
    # The published p99 is the median steady-state window p99 of the
    # fleet's own t2r.serving_fleet.v1 records: the windowed quantity the
    # live SLO monitoring and the doctor judge. A whole-run p99 of a
    # seconds-long run is one host stall away from an outlier.
    window_p99s = [
        r['p99_ms'] for r in read_telemetry(
            os.path.join(fleet_dir, 'telemetry.0.jsonl'))
        if r.get('kind') == 'serving_fleet'
        and (r.get('requests') or 0) >= 100]
    if window_p99s:
      p99 = sorted(window_p99s)[len(window_p99s) // 2]
    else:
      p99 = stats['latency_ms'].get('p99', 0.0)
    return {
        'replicas': replicas,
        'actions_per_sec': round(completed[0] / elapsed, 2),
        'p99_ms': round(p99, 2),
        'p99_ms_cumulative': round(
            stats['latency_ms'].get('p99', 0.0), 2),
        'window_p99s_ms': [round(p, 2) for p in window_p99s],
        'slo_met': bool(completed[0] > 0 and p99 < 33.0),
        'failed': len(failures),
        'versions_served': sorted(versions),
        'request_time_compiles': request_builds,
        'scaleup_compiles': scaleup_builds,
        'scaleup_seconds': [round(s, 4) for s in scaleup_seconds],
        'clients': clients,
    }

  counts = sorted(replica_counts)
  runs = {}
  for n in counts:
    biggest = n == counts[-1] and n > 1
    runs[n] = run_fleet(n, with_swap=biggest, scale_from_one=biggest)
  curve = [runs[n]['actions_per_sec'] for n in counts]
  top = runs[counts[-1]]
  out = {
      'serving_fleet_scaling_monotonic': bool(
          all(a < b for a, b in zip(curve, curve[1:]))),
      'serving_fleet_request_time_compiles': sum(
          r['request_time_compiles'] for r in runs.values()),
      'serving_fleet_scaleup_compiles': top['scaleup_compiles'],
      'fleet_scaleup_time_to_ready_s': round(
          max(top['scaleup_seconds'] or [0.0]), 4),
      'serving_fleet_swap_failed': top['failed'],
      'serving_fleet_swap_versions_served': top['versions_served'],
      'serving_fleet': {str(n): runs[n] for n in counts},
      'device': str(device),
  }
  for n in counts:
    out['serving_fleet_actions_per_sec_r{}'.format(n)] = \
        runs[n]['actions_per_sec']
    out['serving_fleet_p99_ms_r{}'.format(n)] = runs[n]['p99_ms']
  return out


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(
      description=__doc__,
      formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--batch', type=int, default=8)
  parser.add_argument('--height', type=int, default=96)
  parser.add_argument('--width', type=int, default=128)
  parser.add_argument('--cem_samples', type=int, default=32)
  parser.add_argument('--cem_iters', type=int, default=2)
  parser.add_argument('--num_elites', type=int, default=8)
  parser.add_argument('--duration', type=float, default=3.0)
  parser.add_argument('--replica_counts', default='1,2,4')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (default) or 'cpu'")
  args = parser.parse_args(argv)
  out = run_bench(
      batch=args.batch, height=args.height, width=args.width,
      cem_samples=args.cem_samples, cem_iters=args.cem_iters,
      num_elites=args.num_elites, duration_s=args.duration,
      replica_counts=tuple(int(n) for n in args.replica_counts.split(',')),
      device=args.device)
  print(json.dumps(out))
  return 0


if __name__ == '__main__':
  sys.exit(main())
