"""Meta-learning (the JAX package's ``meta_learning/``): MAML's inner loop
and models, the meta layout's preprocessors and data, meta-example
records, the meta policies and the meta-RL episode loop."""

from tensor2robot_tpu_torch.meta_learning import meta_data
from tensor2robot_tpu_torch.meta_learning.maml_inner_loop import (
    MAMLInnerLoopGradientDescent,
)
from tensor2robot_tpu_torch.meta_learning.maml_model import (
    MAMLModel,
    MAMLRegressionModel,
)
from tensor2robot_tpu_torch.meta_learning.meta_policies import (
    MAMLCEMPolicy,
    MAMLRegressionPolicy,
    MetaLearningPolicy,
    ScheduledExplorationMAMLRegressionPolicy,
)
from tensor2robot_tpu_torch.meta_learning.preprocessors import (
    FixedLenMetaExamplePreprocessor,
    MAMLPreprocessorV2,
    create_maml_feature_spec,
    create_maml_label_spec,
)
from tensor2robot_tpu_torch.meta_learning.run_meta_env import run_meta_env

__all__ = [
    'FixedLenMetaExamplePreprocessor',
    'MAMLCEMPolicy',
    'MAMLInnerLoopGradientDescent',
    'MAMLModel',
    'MAMLPreprocessorV2',
    'MAMLRegressionModel',
    'MAMLRegressionPolicy',
    'MetaLearningPolicy',
    'ScheduledExplorationMAMLRegressionPolicy',
    'create_maml_feature_spec',
    'create_maml_label_spec',
    'meta_data',
    'run_meta_env',
]
