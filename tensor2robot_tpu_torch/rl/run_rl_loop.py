"""Runs the actor-learner loop (``rl/loop.py``) from the shell (the JAX
package's ``bin/t2r_rl_loop``, with the same flags and ``--device``).

The live QT-Opt cycle over the vectorized grasping MDP (``envs/``): a CEM
actor sweeps ``--num_envs`` scenario-randomized env slots an acting step,
finished episodes flush into a replay service, and the Bellman learner
trains from it concurrently and hot-swaps the actor's weights. Telemetry
(``t2r.rl.v1`` windows, heartbeat) lands under ``--model_dir``. The loop
runs on the card unless ``--device cpu`` is given.

Usage:

    # 60-second run, in-process replay, randomized scenarios:
    python -m tensor2robot_tpu_torch.rl.run_rl_loop --model_dir /tmp/rl_run \
        --seconds 60

    # Feed a standing replay service (replay.run_replay) instead:
    python -m tensor2robot_tpu_torch.rl.run_rl_loop --model_dir /tmp/rl_run \
        --seconds 60 --replay_endpoint localhost:8765

    # Tiny self-check (wiring smoke, seconds):
    python -m tensor2robot_tpu_torch.rl.run_rl_loop --selfcheck --device cpu

Prints the run's summary as JSON on stdout.
"""

import argparse
import json
import sys
import tempfile


def make_parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--model_dir', default=None,
                      help='telemetry + learner run dir (required unless '
                      '--selfcheck)')
  parser.add_argument('--num_envs', type=int, default=64,
                      help='vectorized env slots per acting step')
  parser.add_argument('--height', type=int, default=48)
  parser.add_argument('--width', type=int, default=64)
  parser.add_argument('--episode_length', type=int, default=3)
  parser.add_argument('--seconds', type=float, default=None,
                      help='wallclock budget for the closed run')
  parser.add_argument('--episodes', type=int, default=None,
                      help='stop after this many completed episodes')
  parser.add_argument('--learner_steps', type=int, default=None,
                      help='stop after this many Bellman steps')
  parser.add_argument('--batch_size', type=int, default=16)
  parser.add_argument('--cem_samples', type=int, default=16)
  parser.add_argument('--cem_iters', type=int, default=2)
  parser.add_argument('--num_elites', type=int, default=4)
  parser.add_argument('--explore_prob', type=float, default=0.15)
  parser.add_argument('--swap_poll_steps', type=int, default=4)
  parser.add_argument('--publish_every_steps', type=int, default=10)
  parser.add_argument('--report_interval_s', type=float, default=5.0)
  parser.add_argument('--replay_endpoint', default=None,
                      help='host:port / URL of a replay service '
                      '(default: in-process service)')
  parser.add_argument('--num_shards', type=int, default=2,
                      help='shards of the in-process replay service')
  parser.add_argument('--no_randomize', action='store_true',
                      help='pin every env slot to the reference scenario '
                      'constants instead of the randomized sweep')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--device', default='cuda',
                      help="where the loop runs ('cpu' only when asked for)")
  parser.add_argument('--selfcheck', action='store_true',
                      help='tiny wiring smoke: small envs, short run, '
                      'temp model_dir unless --model_dir is given')
  return parser


def main(argv=None):
  parser = make_parser()
  args = parser.parse_args(argv)

  if args.selfcheck:
    args.num_envs = min(args.num_envs, 8)
    args.height, args.width = 32, 40
    args.cem_samples, args.cem_iters, args.num_elites = 8, 2, 3
    args.batch_size = 8
    args.report_interval_s = min(args.report_interval_s, 1.0)
    if args.seconds is None and args.episodes is None and \
        args.learner_steps is None:
      args.seconds = 10.0
      args.learner_steps = 20
  if args.seconds is None and args.episodes is None and \
      args.learner_steps is None:
    parser.error('give at least one of --seconds / --episodes / '
                 '--learner_steps')
  if args.model_dir is None and not args.selfcheck:
    parser.error('--model_dir is required (or use --selfcheck)')

  from tensor2robot_tpu_torch.envs import ScenarioConfig
  from tensor2robot_tpu_torch.rl.loop import RLLoopConfig, build_grasping_loop

  config = RLLoopConfig(
      cem_samples=args.cem_samples, cem_iters=args.cem_iters,
      num_elites=args.num_elites, explore_prob=args.explore_prob,
      batch_size=args.batch_size,
      swap_poll_steps=args.swap_poll_steps,
      publish_every_steps=args.publish_every_steps,
      report_interval_s=args.report_interval_s, seed=args.seed)
  scenario_config = (ScenarioConfig() if args.no_randomize
                     else ScenarioConfig.randomized())

  tmp_dir = None
  model_dir = args.model_dir
  if model_dir is None:
    tmp_dir = tempfile.TemporaryDirectory()
    model_dir = tmp_dir.name
  try:
    loop = build_grasping_loop(
        model_dir, num_envs=args.num_envs, height=args.height,
        width=args.width, episode_length=args.episode_length,
        scenario_config=scenario_config, replay=args.replay_endpoint,
        config=config, num_shards=args.num_shards, seed=args.seed,
        device=args.device)
    try:
      summary = loop.run(max_seconds=args.seconds,
                         max_episodes=args.episodes,
                         max_learner_steps=args.learner_steps)
    finally:
      loop.close()
    summary.pop('windows', None)
    print(json.dumps(summary, indent=2, sort_keys=True))
    if args.selfcheck:
      ok = (summary['episodes'] > 0 and summary['learner_steps'] > 0
            and summary['transitions'] > 0
            and summary['act_jit_cache'] <= 1.0)
      print('selfcheck:', 'OK' if ok else 'FAIL', file=sys.stderr)
      return 0 if ok else 1
    return 0
  finally:
    if tmp_dir is not None:
      tmp_dir.cleanup()


if __name__ == '__main__':
  sys.exit(main())
