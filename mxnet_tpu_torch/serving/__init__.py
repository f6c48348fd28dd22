"""Serving on PyTorch (counterpart of ``mxnet_tpu/serving``): the
bound-symbol :class:`AOTPredictor` behind the dynamic-batching
:class:`ModelServer`, and generative serving (paged KV cache, prefill +
decode, the continuous-batching :class:`GenerateServer` with its
shared-prefix KV cache and speculative decoding)."""
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
    PrefixIndex,
)
from .predictor import (AOTPredictor, ServingError, env_batch_ladder,
                        validate_ladder)

__all__ = ["AOTPredictor", "DeadlineExceeded", "GenerateError",
           "GenerateServer", "GenerativePredictor", "ModelServer", "PagePool",
           "PagePoolExhausted", "PrefixIndex", "ServerClosed",
           "ServerOverloaded", "ServingError", "env_batch_ladder",
           "validate_ladder"]
