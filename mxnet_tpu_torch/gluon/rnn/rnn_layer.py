"""Gluon's fused recurrent layers ``RNN``, ``LSTM`` and ``GRU`` (counterpart
of ``mxnet_tpu/gluon/rnn/rnn_layer.py``) over the fused ``RNN`` op
(``ops/rnn.py``: one product for a layer's whole input sequence, then the
time loop, on cuBLAS on the card).

The parameters are the reference's, one set per layer and direction
(``l0_i2h_weight``, ``r0_h2h_bias``, ...), and are concatenated into the
op's flat vector at each call (``_fused_parameters``): every (i2h, h2h)
weight pair, then every (i2h, h2h) bias pair, the order ``ops/rnn.py``
``_unpack`` reads. Only layer 0's ``i2h`` weights depend on the input
width, so a deferred first call sets those shapes from the input. Layout
``NTC`` swaps the batch and time axes around the op. Under a trace
(``hybridize``) the parameters are placeholders and missing begin states
are built from the input's rows (``rnn_cell.zeros_state_like``).
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import ndarray as nd
from ...ndarray.ndarray import NDArray, invoke
from ...symbol.symbol import Symbol
from ..block import HybridBlock
from ..parameter import DeferredInitializationError
from .rnn_cell import _placeholders, zeros_state_like

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, h = self._gates, hidden_size
        self._rnn_param_names = []
        with self.name_scope():
            for layer in range(num_layers):
                for d in ("l", "r")[:self._dir]:
                    in_size = input_size if layer == 0 else h * self._dir
                    names = ["%s%d_i2h_weight" % (d, layer),
                             "%s%d_h2h_weight" % (d, layer),
                             "%s%d_i2h_bias" % (d, layer),
                             "%s%d_h2h_bias" % (d, layer)]
                    shapes = [(ng * h, in_size if in_size else 0),
                              (ng * h, h), (ng * h,), (ng * h,)]
                    inits = [i2h_weight_initializer, h2h_weight_initializer,
                             i2h_bias_initializer, h2h_bias_initializer]
                    for pname, shp, ini in zip(names, shapes, inits):
                        # registered, so that a traced call binds them
                        self._reg_params[pname] = self.params.get(
                            pname, shape=shp, init=ini,
                            allow_deferred_init=True)
                    self._rnn_param_names.append(names)

    def _infer_param_shapes(self, x):
        input_size = x.shape[2]
        ng, h = self._gates, self._hidden_size
        for layer_names in self._rnn_param_names[:self._dir]:
            self.params.get(layer_names[0]).shape = (ng * h, input_size)

    def _fused_parameters(self, symbolic=False):
        """The parameters (their graph variables when ``symbolic``)
        concatenated into the op's flat layout: all (w_ih, w_hh) pairs,
        then all (b_ih, b_hh) pairs."""
        values = _placeholders(self) if symbolic else \
            {k: p.data() for k, p in self._reg_params.items()}
        weights, biases = [], []
        for names in self._rnn_param_names:
            i2h_w, h2h_w, i2h_b, h2h_b = (values[n] for n in names)
            weights += [i2h_w.reshape((-1,)), h2h_w.reshape((-1,))]
            biases += [i2h_b, h2h_b]
        return invoke("Concat", weights + biases, {"dim": 0})

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zeros of each state's ``(layers * directions, batch, hidden)``
        shape (``kwargs`` go to ``nd.zeros``), or ``func(name=...,
        shape=...)`` each."""
        states = []
        for info in self.state_info(batch_size):
            if func is None:
                states.append(nd.zeros(info["shape"], **kwargs))
            else:
                info.update(kwargs)
                states.append(func(name="%sh0" % self.prefix, **info))
        return states

    def forward(self, inputs, states=None):
        symbolic = isinstance(inputs, Symbol)
        if self._layout == "NTC":
            inputs = invoke("swapaxes", [inputs], {"dim1": 0, "dim2": 1})
        skip_states = states is None
        if skip_states:
            if symbolic:
                states = [zeros_state_like(inputs, 1, info["shape"], 1)
                          for info in self.state_info(0)]
            else:
                states = self.begin_state(inputs.shape[1],
                                          ctx=inputs.context,
                                          dtype=inputs.dtype)
        if isinstance(states, (NDArray, Symbol)):
            states = [states]
        if symbolic:
            params = self._fused_parameters(symbolic=True)
        else:
            try:
                params = self._fused_parameters()
            except (DeferredInitializationError, MXNetError):
                self._infer_param_shapes(inputs)
                for names in self._rnn_param_names:
                    for n in names:
                        p = self.params.get(n)
                        if p._data is None:
                            p._finish_deferred_init()
                params = self._fused_parameters()
        op_inputs = [inputs, params, states[0]]
        if self._mode == "lstm":
            op_inputs.append(states[1])
        outputs = invoke("RNN", op_inputs, {
            "state_size": self._hidden_size, "num_layers": self._num_layers,
            "bidirectional": self._dir == 2, "mode": self._mode,
            "p": self._dropout, "state_outputs": True})
        outputs = list(outputs)
        out, out_states = outputs[0], outputs[1:]
        if self._layout == "NTC":
            out = invoke("swapaxes", [out], {"dim1": 0, "dim2": 1})
        if skip_states:
            return out
        return out, out_states

    def __repr__(self):
        s = "{name}({_hidden_size}, {_layout}, num_layers={_num_layers}"
        if self._dropout:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        return s.format(name=self.__class__.__name__, **self.__dict__)


class RNN(_RNNLayer):
    """Elman RNN, ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Long short-term memory: states ``[h, c]``."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Gated recurrent unit (cuDNN's form)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
