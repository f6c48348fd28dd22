"""The ``Custom`` operator node (counterpart of ``mxnet_tpu/ops/custom.py``):
a registry entry whose function runs a Python ``CustomOp`` through the
autograd bridge of ``mxnet_tpu_torch/operator.py``."""
from .registry import get as _get_op
from .registry import register


def _num_outputs(attrs):
    from ..operator import custom_num_outputs

    return custom_num_outputs(attrs)


@register(name="Custom", num_outputs=_num_outputs)
def Custom(*data, op_type="", __is_train__=False, **kwargs):
    """Apply a registered custom operator (``mx.nd.Custom``).

    ``op_type`` names a class registered with ``mx.operator.register``;
    the other kwargs go to its constructor as strings. On ``meta`` tensors
    (shape inference) the prop's ``infer_shape``/``infer_type`` answer and
    the body is never called. Under ``MXNET_BACKWARD_DO_MIRROR=1`` (or any
    remat plan that recomputes this node) the backward reruns the body's
    ``forward``, as ``jax.checkpoint`` reruns the JAX package's callback.
    """
    from ..operator import custom_call

    return custom_call(data, op_type, kwargs, is_train=__is_train__)


def _arg_order(attrs):
    from ..operator import custom_arg_order

    return custom_arg_order(attrs)


_get_op("Custom").kwarg_input_order = _arg_order
