"""The RT-1-style seq2act policy of the port (serving)."""

from tensor2robot_tpu_torch.research.seq2act.seq2act_model import (
    RT1StyleNet,
    Seq2ActBCModel,
    Seq2ActPreprocessor,
)

__all__ = ['RT1StyleNet', 'Seq2ActBCModel', 'Seq2ActPreprocessor']
