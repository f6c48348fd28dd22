"""Serving on PyTorch (counterpart of ``mxnet_tpu/serving``): the
bound-symbol :class:`AOTPredictor` behind the dynamic-batching
:class:`ModelServer`, and generative serving (paged KV cache, prefill +
decode, the continuous-batching :class:`GenerateServer`)."""
from .broker import (
    DeadlineExceeded,
    GenerateServer,
    ModelServer,
    ServerClosed,
    ServerOverloaded,
)
from .generate import (
    GenerateError,
    GenerativePredictor,
    PagePool,
    PagePoolExhausted,
)
from .predictor import AOTPredictor, ServingError

__all__ = ["AOTPredictor", "DeadlineExceeded", "GenerateError",
           "GenerateServer", "GenerativePredictor", "ModelServer", "PagePool",
           "PagePoolExhausted", "ServerClosed", "ServerOverloaded",
           "ServingError"]
