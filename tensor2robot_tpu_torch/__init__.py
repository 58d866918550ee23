"""tensor2robot_tpu_torch: the PyTorch + CUDA port of the JAX package.

The port runs on an NVIDIA H100. Plain tensor code is PyTorch; each Pallas
TPU kernel of the JAX package that a ported path runs has a hand-written
CUDA counterpart under ``csrc/``, built and loaded by ``kernels``, with a
plain PyTorch version beside it that runs on CPU tensors. Entry points run
on ``cuda`` unless the caller asks for the CPU. The package imports no
JAX and nothing of ``tensor2robot_tpu``.

Ported so far: serving the QT-Opt Grasping44 CEM policy
(``serving.serve`` -> ``serving.PolicyServer`` ->
``research.qtopt.t2r_models`` -> ``research.qtopt.networks``), training
its critic (``trainer.train_eval``), and serving the long-context Seq2Act
policy (``policies.SequentialRegressionPolicy`` ->
``predictors.CheckpointPredictor`` -> ``export.export_generators`` ->
``research.seq2act`` -> ``layers.transformer`` ->
``parallel.flash_attention``), and the gins driving both
(``trainer.train_eval --gin_configs`` -> ``config`` ->
``train_eval_model``, its exporters under ``export`` and hooks under
``hooks``; ``serving.serve --export_dir`` ->
``predictors.ExportedModelPredictor``).
"""
