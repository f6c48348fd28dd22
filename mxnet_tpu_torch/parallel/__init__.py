"""Training-step building blocks of the port (counterpart of
``mxnet_tpu/parallel``): the functional optimizers, ``TrainStep`` on one
device or data parallel over a mesh (``mesh.py``, one process a device),
ZeRO, and the batch placement ``FusedSPMDGroup`` uses (``feed.py``)."""
from .mesh import (default_mesh, make_mesh, mp_size, set_default_mesh,
                   train_mesh)
from .spmd import (FunctionalOptimizer, ShardingRuleError, TrainStep,
                   cross_entropy_loss, data_sharding,
                   functional_from_optimizer, functional_optimizer,
                   param_shardings, parse_rules, replicated)

__all__ = ["FunctionalOptimizer", "TrainStep", "cross_entropy_loss",
           "functional_optimizer", "functional_from_optimizer",
           "make_mesh", "train_mesh", "mp_size", "default_mesh",
           "set_default_mesh", "data_sharding", "replicated",
           "param_shardings", "parse_rules", "ShardingRuleError"]
