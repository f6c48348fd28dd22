"""Training-step building blocks of the port (counterpart of
``mxnet_tpu/parallel``). Ported so far: the functional optimizers and the
one-device ``TrainStep``."""
from .spmd import (FunctionalOptimizer, TrainStep, cross_entropy_loss,
                   functional_optimizer)

__all__ = ["FunctionalOptimizer", "TrainStep", "cross_entropy_loss",
           "functional_optimizer"]
