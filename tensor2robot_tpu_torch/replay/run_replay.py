"""Runs a sharded replay service behind its HTTP door (the JAX package's
``bin/t2r_replay``, with the same flags).

Collectors POST records to ``/v1/append``; learners POST ``/v1/sample`` and
receive batches in the native loader's layout. The service is numpy and
threads: it needs no card.

Examples:

    # 4 shards x 4096 examples, ring retention, uniform sampling,
    # telemetry under /runs/qtopt/replay:
    python -m tensor2robot_tpu_torch.replay.run_replay --port 8090 \
        --model_dir /runs/qtopt/replay

    # Prioritized sampling over a reservoir, capped at 2 GiB a shard:
    python -m tensor2robot_tpu_torch.replay.run_replay \
        --retention reservoir --policy prioritized --capacity_mb 2048

    # Self-contained smoke (4 synthetic writers and 1 sampler for N
    # seconds; prints a JSON stats line and exits):
    python -m tensor2robot_tpu_torch.replay.run_replay --selfcheck 5
"""

import argparse
import json
import signal
import sys
import threading
import time


def _build_service(args):
  from tensor2robot_tpu_torch.replay import ReplayConfig, ReplayService

  config = ReplayConfig(
      num_shards=args.shards,
      batch_size=args.batch_size,
      retention=args.retention,
      policy=args.policy,
      priority_alpha=args.priority_alpha,
      capacity_examples_per_shard=args.capacity_examples,
      capacity_bytes_per_shard=(None if args.capacity_mb <= 0
                                else int(args.capacity_mb * 2**20)),
      max_queue_depth=args.max_queue_depth,
      max_wait_ms=args.max_wait_ms,
      report_interval_s=args.report_interval,
      seed=args.seed)
  return ReplayService(config, model_dir=args.model_dir)


def _selfcheck(args):
  """Synthetic writers + sampler against an in-process service."""
  import numpy as np

  from tensor2robot_tpu_torch.replay import LocalReplayClient, encode_example

  service = _build_service(args).start()
  client = LocalReplayClient(service)
  stop = threading.Event()
  appended = [0] * args.selfcheck_writers
  sampled = [0]

  def writer(index):
    rng = np.random.RandomState(index)
    while not stop.is_set():
      client.append(encode_example({
          'features/state': rng.rand(8).astype(np.float32),
          'labels/reward': rng.rand(1).astype(np.float32)}))
      appended[index] += 1

  def sampler():
    while not stop.is_set():
      try:
        batch = client.sample(args.batch_size, wait=True, wait_timeout_s=5)
      except Exception:  # noqa: BLE001 - drained at shutdown
        return
      sampled[0] += batch.features['state'].shape[0]

  threads = [threading.Thread(target=writer, args=(i,), daemon=True)
             for i in range(args.selfcheck_writers)]
  threads.append(threading.Thread(target=sampler, daemon=True))
  for thread in threads:
    thread.start()
  t0 = time.monotonic()
  time.sleep(args.selfcheck)
  stop.set()
  for thread in threads:
    thread.join(timeout=5)
  elapsed = time.monotonic() - t0
  stats = service.stats()
  service.close()
  print(json.dumps({
      'seconds': round(elapsed, 2),
      'writers': args.selfcheck_writers,
      'append_examples_per_sec': round(sum(appended) / elapsed, 1),
      'sample_examples_per_sec': round(sampled[0] / elapsed, 1),
      'occupancy_examples': stats['occupancy_examples'],
      'occupancy_bytes': stats['occupancy_bytes'],
  }))
  return 0


def main(argv=None):
  parser = argparse.ArgumentParser(
      description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--host', default='0.0.0.0')
  parser.add_argument('--port', type=int, default=8090)
  parser.add_argument('--shards', type=int, default=4)
  parser.add_argument('--batch_size', type=int, default=32,
                      help='Default sampled megabatch size.')
  parser.add_argument('--retention', default='ring',
                      choices=('ring', 'reservoir'))
  parser.add_argument('--policy', default='uniform',
                      choices=('uniform', 'prioritized'))
  parser.add_argument('--priority_alpha', type=float, default=0.6)
  parser.add_argument('--capacity_examples', type=int, default=4096,
                      help='Per-shard example bound.')
  parser.add_argument('--capacity_mb', type=float, default=0,
                      help='Per-shard byte bound in MiB (0 = unbounded).')
  parser.add_argument('--max_queue_depth', type=int, default=64)
  parser.add_argument('--max_wait_ms', type=float, default=5.0)
  parser.add_argument('--report_interval', type=float, default=10.0)
  parser.add_argument('--model_dir', default=None,
                      help='Telemetry dir (telemetry.jsonl + heartbeat); '
                           'give the doctor its own subdir, never a live '
                           "trainer's model_dir.")
  parser.add_argument('--seed', type=int, default=None)
  parser.add_argument('--selfcheck', type=float, default=0,
                      help='Run N seconds of synthetic load in-process, '
                           'print stats JSON, exit.')
  parser.add_argument('--selfcheck_writers', type=int, default=4)
  args = parser.parse_args(argv)

  if args.selfcheck:
    return _selfcheck(args)

  from tensor2robot_tpu_torch.replay.frontend import build_http_server

  service = _build_service(args).start()
  httpd, port = build_http_server(service, host=args.host, port=args.port)
  print('run_replay: {} shards x {} examples ({} retention, {} '
        'sampling), serving on {}:{}'.format(
            args.shards, args.capacity_examples, args.retention,
            args.policy, args.host, port), flush=True)

  def _shutdown(signum, frame):
    print('run_replay: signal {}, shutting down'.format(signum),
          flush=True)
    threading.Thread(target=httpd.shutdown, daemon=True).start()

  signal.signal(signal.SIGTERM, _shutdown)
  signal.signal(signal.SIGINT, _shutdown)
  try:
    httpd.serve_forever()
  finally:
    service.close()
  return 0


if __name__ == '__main__':
  sys.exit(main())
