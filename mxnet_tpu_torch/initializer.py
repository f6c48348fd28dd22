"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``): the
name-suffix dispatch of :class:`Initializer` and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal`` and ``Xavier``, with ``create`` and
``register``.

An initializer fills a tensor in place from numpy draws made in float64 and
rounded to float32, as the JAX package's do, and draws from this module's
own ``numpy.random.RandomState`` (the counterpart of the JAX package's
``random.initializer_rng()``). :func:`seeded` reseeds it for a block, so
one seed gives bit-identical parameters in both packages. Not ported yet:
``MSRAPrelu``, ``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``,
``Mixed`` and ``Load``.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from .base import MXNetError

_INIT_RNG = None


def _rng():
    """The RandomState behind the initializers; unseeded runs draw fresh
    entropy."""
    global _INIT_RNG
    if _INIT_RNG is None:
        _INIT_RNG = np.random.RandomState()
    return _INIT_RNG


@contextlib.contextmanager
def seeded(seed):
    """Draw from ``RandomState(seed & 0x7FFFFFFF)`` inside the block, then
    restore the previous state (``TrainStep.init_params``)."""
    global _INIT_RNG
    prev = _INIT_RNG
    _INIT_RNG = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    try:
        yield
    finally:
        _INIT_RNG = prev


_INIT_REGISTRY = {}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name, with attributes, handed to an initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer with the reference's name-suffix dispatch: weights
    get :meth:`_init_weight`, biases and betas zeros, gammas ones, moving
    means zeros and moving variances ones."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._set(arr, np.zeros(arr.shape))
        elif name.endswith("gamma"):
            self._set(arr, np.ones(arr.shape))
        elif name.endswith("moving_mean") or name.endswith("running_mean") \
                or name.endswith("moving_inv_var") \
                or name.endswith("moving_avg") or name.endswith("min") \
                or name.endswith("max"):
            self._set(arr, np.zeros(arr.shape))
        elif name.endswith("moving_var") or name.endswith("running_var"):
            self._set(arr, np.ones(arr.shape))
        else:
            self._init_weight(desc, arr)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    @staticmethod
    def _set(arr, value):
        """Fill ``arr`` in place with ``value`` rounded to float32, then to
        the tensor's dtype."""
        with torch.no_grad():
            arr.copy_(torch.from_numpy(
                np.ascontiguousarray(value, dtype=np.float32)))


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._set(arr, np.zeros(arr.shape))


@register
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._set(arr, np.ones(arr.shape))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        self._set(arr, np.full(arr.shape, self.value))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        self._set(arr, _rng().uniform(-self.scale, self.scale,
                                      tuple(arr.shape)))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        self._set(arr, _rng().normal(0, self.sigma, tuple(arr.shape)))


@register
class Xavier(Initializer):
    """Uniform or gaussian over the average, input or output fan."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2: %r %s"
                             % (desc, (shape,)))
        hw_scale = 1.0
        for s in shape[2:]:
            hw_scale *= s
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, _rng().uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, _rng().normal(0, scale, shape))
        else:
            raise MXNetError("unknown rnd_type %r" % self.rnd_type)


def create(name, **kwargs):
    """An initializer by registered name (an instance passes through)."""
    if isinstance(name, Initializer):
        return name
    klass = _INIT_REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("unknown initializer %r" % name)
    return klass(**kwargs)
