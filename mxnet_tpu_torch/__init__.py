"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It sits beside the JAX package, keeps its file names, parameter names,
layouts and file formats, and imports neither JAX nor ``mxnet_tpu``.
Entry points run on ``cuda`` (``gpu(0)``) unless the caller passes the
CPU (``device="cpu"``, ``mx.cpu()``).

Ported so far, six paths over the six hand-written CUDA kernels
(``kernels``, all six TPU kernels of the JAX package):

- generative serving: ``models.transformer`` prefill and paged decode
  behind ``serving.GenerateServer``, on the flash-attention forward (B5);
- transformer training: ``make_train_step`` with the functional
  optimizers, on the flash-attention backward (B6 dq, B7 dk/dv);
- fused image serving: ``models.resnet`` through the IR ``fusion`` pass
  (``symbol``, ``ir``) into ``serving.AOTPredictor`` behind
  ``serving.ModelServer``, on the fused BN-apply convolution (B1);
- fused ResNet training: ``parallel.TrainStep(mesh=None)``, on B1 and the
  fused weight and data gradients (B2, B3);
- the symbolic front end: ``nd`` (NDArray and its ``.npz`` files),
  ``autograd``, ``random``, ``sym``, ``executor`` (``bind``,
  ``simple_bind``), ``optimizer``, ``metric``, ``io``, ``model``,
  ``callback`` and ``mod.Module.fit``, which trains the fused ResNet on
  B1–B3 through ``Executor.forward_backward``;
- data-parallel training, one process a device over
  ``torch.distributed``: ``parallel.TrainStep(mesh=parallel.make_mesh(...))``
  (ZeRO with ``zero=True``) and ``Module(kvstore='tpu')`` (``kv``), on B1–B3
  through the fused unit's data-parallel wrappers.

ROADMAP.md lists what remains.
"""
from . import autograd, callback, io, metric, model, name  # noqa: F401
from . import initializer, lr_scheduler, optimizer, random  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import module as mod  # noqa: F401
from . import parallel  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .base import MXNetError
from .context import Context, cpu, current_context, gpu, resolve_device

kvstore = kv
init = initializer
opt = optimizer
symbol = sym
ndarray = nd
module = mod

__all__ = ["MXNetError", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "AttrScope", "nd", "sym", "autograd",
           "random", "init", "initializer", "opt", "optimizer", "metric",
           "io", "mod", "model", "callback", "lr_scheduler", "name", "kv",
           "kvstore", "parallel"]
