"""``mx.gluon``, the imperative high-level API (counterpart of
``mxnet_tpu/gluon``): ``Parameter``/``ParameterDict``, ``Block``,
``HybridBlock`` (``hybridize`` runs one traced graph; ``export``),
``SymbolBlock``, ``nn``, ``loss``, ``Trainer``, ``utils``, ``data`` and the
vision ``model_zoo``. Convolutions and products run on torch's libraries
(cuDNN and cuBLAS on the card), as the JAX package leaves them to XLA.

Not ported yet, raising by name on use: ``rnn``, ``contrib`` and
``data.vision`` (ROADMAP.md Queue A item 9, second part).
"""
from . import data, loss, model_zoo, nn, utils  # noqa: F401
from ._not_ported import not_ported_module
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401

rnn = not_ported_module("mxnet_tpu_torch.gluon.rnn",
                        "the recurrent cells and layers")
contrib = not_ported_module("mxnet_tpu_torch.gluon.contrib",
                            "gluon.contrib")
