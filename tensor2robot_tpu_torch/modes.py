"""Run-mode keys (the JAX package's ``modes.py``)."""


class ModeKeys:
  TRAIN = 'train'
  EVAL = 'eval'
  PREDICT = 'predict'

  ALL = (TRAIN, EVAL, PREDICT)

