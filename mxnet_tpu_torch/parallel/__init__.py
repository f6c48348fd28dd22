"""Training-step building blocks of the port (counterpart of
``mxnet_tpu/parallel``): the functional optimizers, ``TrainStep`` on one
device or data parallel over a mesh (``mesh.py``, one process a device),
ZeRO, the batch placement ``FusedSPMDGroup`` uses (``feed.py``), ring and
Ulysses attention over a sequence axis (``ring.py``) and the GPipe
schedule over a pipeline axis (``pipeline.py``)."""
from .feed import DeviceQueueIter, place_batch_array
from .mesh import (axis_group, default_mesh, make_mesh, mp_size,
                   set_default_mesh, train_mesh)
from .pipeline import pipeline, pipeline_apply
from .ring import (full_attention, ring_attention, ring_attention_inner,
                   ulysses_attention, ulysses_attention_inner)
from .spmd import (FunctionalOptimizer, ShardingRuleError, TrainStep,
                   cross_entropy_loss, data_sharding,
                   functional_from_optimizer, functional_optimizer,
                   param_shardings, parse_rules, replicated)

__all__ = ["FunctionalOptimizer", "TrainStep", "cross_entropy_loss",
           "functional_optimizer", "functional_from_optimizer",
           "make_mesh", "train_mesh", "mp_size", "default_mesh",
           "set_default_mesh", "data_sharding", "replicated",
           "param_shardings", "parse_rules", "ShardingRuleError",
           "DeviceQueueIter", "place_batch_array", "axis_group",
           "full_attention", "ring_attention", "ring_attention_inner",
           "ulysses_attention", "ulysses_attention_inner", "pipeline",
           "pipeline_apply"]
