"""Training-step building blocks of the port (counterpart of
``mxnet_tpu/parallel``). Ported so far: the functional optimizers."""
from .spmd import FunctionalOptimizer, functional_optimizer

__all__ = ["FunctionalOptimizer", "functional_optimizer"]
