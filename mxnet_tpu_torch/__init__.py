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
  through the fused unit's data-parallel wrappers;
- the data plane: ``recordio``, record shards read through leases
  (``data``), ``io``'s record, image, CSV, LibSVM and MNIST iterators and
  ``image``, fed to the card by ``parallel.feed.DeviceQueueIter``;
- Gluon: ``gluon`` (Parameter, Block, HybridBlock whose ``hybridize``
  runs one traced graph, ``nn``, ``loss``, ``Trainer``, ``data``) and its
  vision model zoo, and ``embedding.SparseEmbedding`` on the server tier;
- the op families behind them on torch's libraries (``ops``: nn, tensor,
  random, contrib and vision; ``nd.contrib``/``nd.random`` and their
  ``sym`` twins), the symbol model zoo (``models``) with the SSD300
  detector and its mAP metrics (``contrib``).
- the single-process tail: ``operator`` (``CustomOp``/``CustomOpProp`` and
  the ``Custom`` op), ``monitor`` (``Monitor``, ``fit(monitor=)``), the
  profiler's trace events, ``rtc`` (CUDA source compiled at run time with
  NVRTC and launched on the card), ``visualization`` (``print_summary``,
  ``plot_network``), ``contrib.tensorboard``, ``executor_manager``,
  ``log``, ``libinfo``, ``util`` and ``test_utils``;
- the multi-process training plane: ``dist`` (the launcher's job over
  ``torch.distributed``), the ``dist_*`` kvstores with 2-bit compression,
  ``Module.fit(kvstore='dist_sync')`` on the fused step over every worker,
  ``zero_wire='2bit'``, ZeRO over the parameter servers, the server entry
  point (``python -m mxnet_tpu_torch.kvstore_server``) and ``launch``
  (``python -m mxnet_tpu_torch.launch``);
- the host runtime and the C predict ABI: ``engine`` (the native
  dependency engine), ``storage`` (the pooled host buffers) and the native
  RecordIO route, built from ``src/`` with g++ by ``_native``, and
  ``c_predict``, the backend of the port's C predict library
  (``src/c_predict_api.h``), which serves a model from a C program through
  ``serving.AOTPredictor``, B1 on the card for the fused ResNet.

ROADMAP.md lists what remains.
"""
from . import autograd, callback, contrib, io, metric, model  # noqa: F401
from . import gluon  # noqa: F401
from . import name  # noqa: F401
from . import initializer, lr_scheduler, optimizer, random  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import module as mod  # noqa: F401
from . import parallel  # noqa: F401
from . import recordio  # noqa: F401
from . import config  # noqa: F401
from . import chaos, embedding, ir, kvstore_server, profiler  # noqa: F401
from . import checkpoint, health  # noqa: F401
from . import dist  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from . import serving, tracker  # noqa: F401
from . import operator  # noqa: F401
from . import monitor  # noqa: F401
from . import monitor as mon  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401
from . import executor_manager, libinfo, log, rtc, test_utils  # noqa: F401
from . import storage  # noqa: F401
from . import engine  # noqa: F401
from .util import is_np_array  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .base import MXNetError
from .context import (Context, cpu, cpu_pinned, current_context, gpu,
                      num_gpus, resolve_device)
from .executor import Executor  # noqa: F401
from .model import load_checkpoint, save_checkpoint  # noqa: F401

kvstore = kv
rnd = random
init = initializer
opt = optimizer
symbol = sym
ndarray = nd
module = mod

__all__ = ["MXNetError", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "AttrScope", "nd", "sym", "autograd",
           "random", "init", "initializer", "opt", "optimizer", "metric",
           "io", "mod", "model", "callback", "lr_scheduler", "name", "kv",
           "kvstore", "parallel", "contrib", "recordio", "gluon", "rnd",
           "config", "chaos", "embedding", "ir", "kvstore_server",
           "profiler", "serving", "tracker", "checkpoint",
           "CheckpointManager", "health", "dist", "Executor", "load_checkpoint",
           "save_checkpoint", "num_gpus", "cpu_pinned", "operator",
           "monitor", "mon", "visualization", "viz", "rtc", "log",
           "libinfo", "executor_manager", "test_utils", "is_np_array",
           "storage", "engine"]
