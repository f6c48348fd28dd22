"""Tensor ops of the image-serving path (counterpart of the matching
entries of ``mxnet_tpu/ops/tensor.py``): ``broadcast_add`` and its
aliases, ``_copy``/``identity``, ``Flatten`` and ``transpose``."""
from __future__ import annotations

from .registry import register


@register(name="broadcast_add",
          aliases=("elemwise_add", "_plus", "_add", "_Plus"))
def broadcast_add(lhs, rhs):
    return lhs + rhs


@register(name="_copy", aliases=("identity",))
def _copy(data):
    return data


@register(name="Flatten", aliases=("flatten",))
def flatten(data):
    return data.reshape(data.shape[0], -1)


@register(name="transpose")
def transpose(data, axes=()):
    """``axes`` as in numpy; empty reverses the dims. Returns a view: a
    consumer that needs contiguous memory copies it (the fused conv
    wrapper does)."""
    if not axes:
        axes = tuple(range(data.dim() - 1, -1, -1))
    return data.permute(*(int(a) for a in axes))
