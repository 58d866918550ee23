"""Off-policy RL of the port (the JAX package's ``rl/``): the collect and
eval loop, the episode runner, Bellman training of a critic against a
lagged filesystem target, and the live actor-learner loop (``loop.py``).
``run_env`` is the module; its function is ``run_env.run_env``."""

from tensor2robot_tpu_torch.rl import run_env
from tensor2robot_tpu_torch.rl.collect_eval import collect_eval_loop
from tensor2robot_tpu_torch.rl.loop import (
    RLLoop,
    RLLoopConfig,
    build_grasping_loop,
)
from tensor2robot_tpu_torch.rl.offpolicy import (
    BellmanQTOptTrainer,
    concat_ranking_pairs,
    pairwise_ranking_accuracy,
    ranking_accuracy_from_scores,
)

__all__ = ['BellmanQTOptTrainer', 'RLLoop', 'RLLoopConfig',
           'build_grasping_loop', 'collect_eval_loop',
           'concat_ranking_pairs', 'pairwise_ranking_accuracy',
           'ranking_accuracy_from_scores', 'run_env']
