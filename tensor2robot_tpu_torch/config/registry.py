"""Registers the port's configurables under the JAX package's names.

Each one the port has and the QT-Opt, Seq2Act, Grasp2Vec and pose env
gins name (the trainer, the record input generator, the critic and its
preprocessor, the split decode's wrapper, Seq2Act's model and
``EP_RULES_MOE``), the random input generator, and the optimizers,
learning rates, exporters, export generators and hook builders; the
collect job's (``collect_eval_loop``, ``run_env``, the replay writer, the
policies and ``CheckpointPredictor``, and the synthetic grasping MDP's
env, random policy and transitions); Grasp2Vec's model, preprocessor and
losses; MAML's model, inner loop, preprocessors and input generators; the
pose toy env, its random policy, models and transitions; the vrgripper
and Watch-Try-Learn models, their preprocessor and action decoders; the
reliability layer's ``configure_fault_injector`` (``RetryPolicy``, which
the JAX package registers, is not: no configurable of the port takes one).
A gin that names anything else fails in ``ginlike.check_configurables``,
naming it.
"""

from __future__ import annotations

import threading

from tensor2robot_tpu_torch.config import ginlike

__all__ = ['register_all']

_REGISTERED = False
_LOCK = threading.Lock()


def register_all() -> None:
  global _REGISTERED
  with _LOCK:
    if _REGISTERED:
      return
    _REGISTERED = True

  from tensor2robot_tpu_torch.data import input_generators
  from tensor2robot_tpu_torch.data import writer
  from tensor2robot_tpu_torch.export import export_generators
  from tensor2robot_tpu_torch.export import exporters
  from tensor2robot_tpu_torch.hooks import async_export_hook_builder
  from tensor2robot_tpu_torch.hooks import td3
  from tensor2robot_tpu_torch.hooks import variable_logger_hook
  from tensor2robot_tpu_torch.meta_learning import maml_inner_loop
  from tensor2robot_tpu_torch.meta_learning import maml_model
  from tensor2robot_tpu_torch.meta_learning import meta_data
  from tensor2robot_tpu_torch.meta_learning import preprocessors as meta_pre
  from tensor2robot_tpu_torch.models import optimizers
  from tensor2robot_tpu_torch.parallel import sharding
  from tensor2robot_tpu_torch.policies import policies
  from tensor2robot_tpu_torch.predictors import checkpoint_predictor
  from tensor2robot_tpu_torch.preprocessors import device_decode
  from tensor2robot_tpu_torch.reliability import fault_injection
  from tensor2robot_tpu_torch.research import grasp2vec
  from tensor2robot_tpu_torch.research import pose_env
  from tensor2robot_tpu_torch.research import seq2act
  from tensor2robot_tpu_torch.research import vrgripper
  from tensor2robot_tpu_torch.research.qtopt import grasping_sim
  from tensor2robot_tpu_torch.research.qtopt import t2r_models
  from tensor2robot_tpu_torch.rl import collect_eval
  from tensor2robot_tpu_torch.rl import run_env
  from tensor2robot_tpu_torch.trainer import train_eval

  register = ginlike.external_configurable

  # The trainer, exporters and hooks.
  register(train_eval.train_eval_model, 'train_eval_model')
  register(exporters.create_default_exporters, 'create_default_exporters')
  register(export_generators.DefaultExportGenerator,
           'DefaultExportGenerator')
  register(export_generators.VariablesExportGenerator,
           'VariablesExportGenerator')
  register(async_export_hook_builder.AsyncExportHookBuilder,
           'AsyncExportHookBuilder')
  register(td3.TD3Hooks, 'TD3Hooks')
  register(variable_logger_hook.VariableLoggerHook, 'VariableLoggerHook')

  # The reliability layer: a gin arms faults (the trainer's command line
  # calls configure_fault_injector where a gin binds it).
  register(fault_injection.configure_fault_injector,
           'configure_fault_injector')

  # Input generators: the gins' records, and random batches.
  register(input_generators.DefaultRecordInputGenerator,
           'DefaultRecordInputGenerator')
  register(input_generators.DefaultRandomInputGenerator,
           'DefaultRandomInputGenerator')

  # Optimizers and learning rates.
  register(optimizers.create_adam_optimizer, 'create_adam_optimizer')
  register(optimizers.create_sgd_optimizer, 'create_sgd_optimizer')
  register(optimizers.create_momentum_optimizer,
           'create_momentum_optimizer')
  register(optimizers.create_rms_prop_optimizer,
           'create_rms_prop_optimizer')
  register(optimizers.create_constant_learning_rate,
           'create_constant_learning_rate')
  register(optimizers.create_exponential_decay_learning_rate,
           'create_exponential_decay_learning_rate')
  register(optimizers.piecewise_constant_learning_rate,
           'piecewise_constant_learning_rate')

  # The QT-Opt critic, its preprocessor and the split decode's wrapper.
  register(
      t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom,
      'Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom')
  register(t2r_models.DefaultGrasping44ImagePreprocessor,
           'DefaultGrasping44ImagePreprocessor')
  register(device_decode.wrap_model_with_device_decode,
           'wrap_model_with_device_decode')

  # The collect job: its loop, episode runner and writer, the policies and
  # their predictor, and the synthetic grasping MDP.
  register(collect_eval.collect_eval_loop, 'collect_eval_loop')
  register(run_env.run_env, 'run_env')
  register(writer.TFRecordReplayWriter, 'TFRecordReplayWriter')
  register(policies.CEMPolicy, 'CEMPolicy')
  register(policies.DeviceCEMPolicy, 'DeviceCEMPolicy')
  register(policies.RegressionPolicy, 'RegressionPolicy')
  register(policies.OUExploreRegressionPolicy, 'OUExploreRegressionPolicy')
  register(policies.ScheduledExplorationRegressionPolicy,
           'ScheduledExplorationRegressionPolicy')
  register(policies.PerEpisodeSwitchPolicy, 'PerEpisodeSwitchPolicy')
  register(checkpoint_predictor.CheckpointPredictor, 'CheckpointPredictor')
  register(grasping_sim.SimGraspingEnv, 'SimGraspingEnv')
  register(grasping_sim.SimGraspingRandomPolicy, 'SimGraspingRandomPolicy')
  register(grasping_sim.episode_to_transitions_grasping,
           'episode_to_transitions_grasping')

  # Grasp2Vec: its model, its preprocessor and its two embedding losses.
  register(grasp2vec.Grasp2VecModel, 'Grasp2VecModel')
  register(grasp2vec.Grasp2VecPreprocessor, 'Grasp2VecPreprocessor')
  register(grasp2vec.losses.n_pairs_loss, 'NPairsLoss')
  register(grasp2vec.losses.triplet_loss, 'TripletLoss')

  # Meta learning: MAML, its inner loop, preprocessors and inputs.
  register(maml_model.MAMLRegressionModel, 'MAMLRegressionModel')
  register(maml_inner_loop.MAMLInnerLoopGradientDescent,
           'MAMLInnerLoopGradientDescent')
  register(meta_pre.MAMLPreprocessorV2, 'MAMLPreprocessorV2')
  register(meta_pre.FixedLenMetaExamplePreprocessor,
           'FixedLenMetaExamplePreprocessor')
  register(meta_data.MetaRecordInputGenerator, 'MetaRecordInputGenerator')
  register(meta_data.MAMLRandomInputGenerator, 'MAMLRandomInputGenerator')

  # The pose toy task: its env and random policy, models and transitions.
  register(pose_env.PoseToyEnv, 'PoseToyEnv')
  register(pose_env.PoseEnvRandomPolicy, 'PoseEnvRandomPolicy')
  register(pose_env.PoseEnvRegressionModel, 'PoseEnvRegressionModel')
  register(pose_env.PoseEnvContinuousMCModel, 'PoseEnvContinuousMCModel')
  register(pose_env.PoseEnvRegressionModelMAML, 'PoseEnvRegressionModelMAML')
  register(pose_env.episode_to_transitions_pose_toy,
           'episode_to_transitions_pose_toy')

  # VRGripper and Watch-Try-Learn: the models, the preprocessor and the
  # action decoders.
  for name in ('VRGripperRegressionModel', 'VRGripperDomainAdaptiveModel',
               'DefaultVRGripperPreprocessor',
               'VRGripperEnvRegressionModelMAML', 'VRGripperEnvTecModel',
               'VRGripperEnvSequentialModel', 'VRGripperEnvSimpleTrialModel',
               'VRGripperEnvVisionTrialModel', 'MSEDecoder',
               'MDNActionDecoder', 'MAFDecoder', 'DiscreteDecoder'):
    register(getattr(vrgripper, name), name)

  # Seq2Act, and the parameter rules of train_seq2act_moe.gin (zero-arg
  # factories, as the JAX registry binds them: @EP_RULES_MOE()).
  register(seq2act.Seq2ActBCModel, 'Seq2ActBCModel')

  def _ep_rules_moe():
    return sharding.EP_RULES_MOE

  register(_ep_rules_moe, 'EP_RULES_MOE')
