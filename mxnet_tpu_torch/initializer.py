"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``): the
name-suffix dispatch of :class:`Initializer` (with an ``__init__``
attribute of the parameter overriding it) and ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier``, ``MSRAPrelu``,
``Orthogonal``, ``Bilinear``, ``LSTMBias`` and ``FusedRNN``, the
``Mixed`` and ``Load`` dispatchers, ``create`` and ``register``.

An initializer fills a tensor or an ``NDArray`` in place from numpy draws
made in float64 and rounded to float32, as the JAX package's do, drawn
from ``random.initializer_rng()``, which ``mx.random.seed`` reseeds as the
JAX package's does. :func:`seeded` reseeds it for a block. So one seed
gives bit-identical parameters in both packages. ``LSTMBias`` sets the
forget gate's bias; ``FusedRNN`` fills the ``RNN`` op's flat parameter
vector (the ``fusedrnn`` ``__init__`` attribute the symbol stamps on it).
"""
from __future__ import annotations

import contextlib
import json
import re

import numpy as np
import torch

from .base import MXNetError

def _rng():
    """The initializers' ``RandomState``: ``random.initializer_rng()``,
    which ``mx.random.seed`` reseeds."""
    from .random import initializer_rng

    return initializer_rng()


@contextlib.contextmanager
def seeded(seed):
    """Draw from ``RandomState(seed & 0x7FFFFFFF)`` inside the block, then
    restore the previous stream (``TrainStep.init_params``)."""
    from .random import set_initializer_rng

    prev = set_initializer_rng(np.random.RandomState(int(seed) & 0x7FFFFFFF))
    try:
        yield
    finally:
        set_initializer_rng(prev)


_INIT_REGISTRY = {}


def _tensor(arr):
    """The tensor behind ``arr`` (an NDArray's, or ``arr`` itself)."""
    return getattr(arr, "tensor", arr)


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
        """Fill ``arr`` (a tensor or an NDArray) in place with ``value``
        rounded to float32, then to the array's dtype."""
        with torch.no_grad():
            _tensor(arr).copy_(torch.from_numpy(
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


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier with the PReLU gain, magnitude 2 / (1 + slope**2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """A (scaled) orthonormal basis from the SVD of a random matrix."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _rng().uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = _rng().normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        self._set(arr, self.scale * q.reshape(tuple(arr.shape)))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel."""

    def _init_weight(self, desc, arr):
        shape = tuple(arr.shape)
        weight = np.zeros(shape, dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight)


@register
class LSTMBias(Initializer):
    """Zeros, with ``forget_bias`` on the second quarter (the forget gate
    of an i, f, g, o bias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(tuple(arr.shape), dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


@register
class FusedRNN(Initializer):
    """The ``RNN`` op's flat parameter vector: U(-0.07, 0.07) over all of
    it (the JAX package's draw, whatever ``init`` says), then, for lstm,
    ``forget_bias`` on each layer-direction's forget-gate ``b_ih``."""

    def __init__(self, init=None, num_hidden=0, num_layers=0, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init or Uniform(0.07)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .ops.rnn import GATES

        flat = _rng().uniform(-0.07, 0.07, tuple(arr.shape)) \
            .astype(np.float32)
        h, layers = self._num_hidden, self._num_layers
        d = 2 if self._bidirectional else 1
        ngates = GATES[self._mode]
        if self._mode == "lstm":
            off = arr.shape[0] - layers * d * 2 * ngates * h
            for _ in range(layers * d):
                flat[off + h:off + 2 * h] = self._forget_bias
                off += 2 * ngates * h
        self._set(arr, flat)


class Mixed:
    """The first initializer whose pattern ``re.search``-es the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.search(str(name)):
                init(name, arr)
                return
        raise MXNetError("no initializer pattern matches %r" % str(name))


class Load:
    """Values from a saved dict (or ``.params`` file, ``arg:``/``aux:``
    prefixes dropped, staged on the CPU), else ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray.utils import load as nd_load

            param = nd_load(param, ctx=cpu())
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            with torch.no_grad():
                _tensor(arr).copy_(_tensor(self.param[name]))
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError("cannot init %r: not found and no default"
                             % name)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One
_INIT_REGISTRY["msra_prelu"] = MSRAPrelu


def create(name, **kwargs):
    """An initializer by registered name (an instance passes through)."""
    if isinstance(name, Initializer):
        return name
    klass = _INIT_REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("unknown initializer %r" % name)
    return klass(**kwargs)


class init:
    """The initializers under one name (``mx.init.Xavier``), as the JAX
    package's ``initializer.init`` namespace."""
    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Orthogonal = Orthogonal
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    FusedRNN = FusedRNN
    Mixed = Mixed
    Load = Load
    Initializer = Initializer
    InitDesc = InitDesc
