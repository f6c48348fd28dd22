"""Model definitions of the PyTorch port (counterpart of
``mxnet_tpu/models``).

The symbolic image-classification builders of
``example/image-classification/symbols`` each expose ``get_symbol(
num_classes, ...)``, a Symbol with a ``SoftmaxOutput`` head whose JSON is
the JAX builder's: ``lenet``, ``mlp``, ``alexnet``, ``vgg``, ``inception``,
``mobilenet``, ``resnext`` and ``resnet``; :func:`get_symbol` dispatches by
network name as the reference's training scripts do. ``bench_transformer``
is the symbolic transformer encoder, and ``transformer`` the generative
model (not a Symbol).
"""
from ..base import MXNetError
from . import (  # noqa: F401
    alexnet, bench_transformer, inception, lenet, mlp, mobilenet, resnet,
    resnext, vgg,
)

_BUILDERS = {
    "mlp": mlp,
    "bench-transformer": bench_transformer,
    "lenet": lenet,
    "resnet": resnet,
    "resnext": resnext,
    "alexnet": alexnet,
    "vgg": vgg,
    "mobilenet": mobilenet,
    "inception-v3": inception,
    "inception-bn": inception,
    "googlenet": inception,
    "ssd": None,
}
_VERSION_KW = {"inception-v3": "v3", "inception-bn": "bn",
               "googlenet": "v1"}


def get_symbol(network, **kwargs):
    """The network's Symbol, as the reference's training scripts build it
    (``import_module('symbols.' + network).get_symbol(...)``); the
    inception names pick their ``version``."""
    if network not in _BUILDERS:
        raise ValueError("unknown network %r; have %s"
                         % (network, sorted(_BUILDERS)))
    if _BUILDERS[network] is None:
        raise MXNetError("get_symbol(%r) is not ported yet (its detection "
                         "ops: ROADMAP.md Queue A item 7d)" % network)
    if network in _VERSION_KW:
        kwargs.setdefault("version", _VERSION_KW[network])
    return _BUILDERS[network].get_symbol(**kwargs)
