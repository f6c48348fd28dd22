"""Gluon's basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Activation, LeakyReLU, Dropout, BatchNorm, Embedding, Flatten,
LayerNorm, InstanceNorm, Lambda and HybridLambda.

Each layer calls the registered op through ``invoke``: eagerly the op runs
on its tensors (cuDNN and cuBLAS on the card), and given Symbols (the
trace of ``hybridize``/``export``) it composes a graph node. A layer's
parameters are placeholders named as the parameters while tracing.
"""
from __future__ import annotations

import numpy as np

from ... import ndarray as nd_mod
from ...base import MXNetError
from ...ndarray.ndarray import invoke
from ..block import Block, HybridBlock
from ..parameter import DeferredInitializationError


class _Stack:
    """The container surface Sequential and HybridSequential share."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                for layer in layers:
                    net.add(layer)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class Sequential(_Stack, Block):
    """Stack of blocks."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stack of HybridBlocks."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._children.values():
            hybrid = isinstance(block, HybridBlock) and block._active
            x = block(x) if hybrid else block.forward(x)
        return x


class _ParamLayer(HybridBlock):
    """Deferred shapes: a subclass's ``_infer_param_shapes`` sets them from
    the first input."""

    def _get_params(self, x):
        from ...symbol.symbol import Symbol, var

        if isinstance(x, Symbol):
            # tracing: one placeholder a parameter, kept on the parameter
            # so that shared layers reuse one graph variable
            out = {}
            for k, p in self._reg_params.items():
                ph = getattr(p, "_sym_placeholder", None)
                if ph is None:
                    ph = p._sym_placeholder = var(p.name)
                out[k] = ph
            return out
        try:
            return {k: p.data() for k, p in self._reg_params.items()}
        except (DeferredInitializationError, MXNetError):
            self._infer_param_shapes(x)
            for p in self._reg_params.values():
                if p._data is None:
                    p._finish_deferred_init()
            return {k: p.data() for k, p in self._reg_params.items()}

    def _infer_param_shapes(self, x):
        pass


def _activation(activation):
    return Activation(activation, prefix=activation + "_") \
        if activation else None


class Dense(_ParamLayer):
    """Fully connected."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self._use_bias = use_bias
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            self.act = _activation(activation)

    def _infer_param_shapes(self, x):
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def forward(self, x):
        params = self._get_params(x)
        out = invoke("FullyConnected",
                     [x, params["weight"], params.get("bias")],
                     {"num_hidden": self._units,
                      "no_bias": not self._use_bias,
                      "flatten": self._flatten})
        return self.act(out) if self.act is not None else out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return invoke("Activation", [x], {"act_type": self._act_type})


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return invoke("LeakyReLU", [x, None],
                      {"act_type": "leaky", "slope": self._alpha})


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        return invoke("Dropout", [x], {"p": self._rate, "axes": self._axes})


class BatchNorm(_ParamLayer):
    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._kwargs = {"axis": axis, "eps": epsilon,
                            "momentum": momentum, "fix_gamma": not scale,
                            "use_global_stats": use_global_stats}
            self._axis = axis
            self._in_channels = in_channels
            shape = (in_channels,)
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null", shape=shape,
                init=gamma_initializer, allow_deferred_init=True,
                differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null", shape=shape,
                init=beta_initializer, allow_deferred_init=True,
                differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=shape,
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=shape,
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _infer_param_shapes(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        if np.dtype(dtype).name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def forward(self, x):
        params = self._get_params(x)
        return invoke("BatchNorm",
                      [x, params["gamma"], params["beta"],
                       params["running_mean"], params["running_var"]],
                      self._kwargs)


class Embedding(_ParamLayer):
    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._input_dim = input_dim
            self._output_dim = output_dim
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def forward(self, x):
        params = self._get_params(x)
        return invoke("Embedding", [x, params["weight"]],
                      {"input_dim": self._input_dim,
                       "output_dim": self._output_dim})


class Flatten(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        return invoke("Flatten", [x], {})


class _Norm(_ParamLayer):
    """LayerNorm's and InstanceNorm's gamma and beta over one axis."""

    def __init__(self, axis, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._axis = axis
            self._epsilon = epsilon
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)


class LayerNorm(_Norm):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def _infer_param_shapes(self, x):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        params = self._get_params(x)
        return invoke("LayerNorm", [x, params["gamma"], params["beta"]],
                      {"axis": self._axis, "eps": self._epsilon})


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)

    def _infer_param_shapes(self, x):
        c = x.shape[1]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def forward(self, x):
        params = self._get_params(x)
        return invoke("InstanceNorm", [x, params["gamma"], params["beta"]],
                      {"eps": self._epsilon})


def _function(function):
    """``function`` itself, or the ``mx.nd`` function of that name."""
    if isinstance(function, str):
        try:
            return getattr(nd_mod, function)
        except (AttributeError, MXNetError):
            raise ValueError("Function name %s is not found in nd."
                             % function) from None
    if callable(function):
        return function
    raise ValueError("Unrecognized function in lambda: {}".format(function))


class Lambda(Block):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = _function(function)
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = _function(function)

    def forward(self, *args):
        return self._func_impl(*args)
