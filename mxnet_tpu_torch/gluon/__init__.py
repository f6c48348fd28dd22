"""``mx.gluon``, the imperative high-level API (counterpart of
``mxnet_tpu/gluon``): ``Parameter``/``ParameterDict``, ``Block``,
``HybridBlock`` (``hybridize`` runs one traced graph; ``export``),
``SymbolBlock``, ``nn``, ``rnn`` (the recurrent cells and the fused
``RNN``/``LSTM``/``GRU`` layers), ``contrib`` (its recurrent cells),
``loss``, ``Trainer``, ``utils``, ``data`` (with ``data.vision``) and the
vision ``model_zoo``. Convolutions, products and the recurrent layers run
on torch's libraries (cuDNN and cuBLAS on the card), as the JAX package
leaves them to XLA.
"""
from . import contrib, data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401
