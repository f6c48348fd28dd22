"""Convolutional recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``): ``Conv2DLSTMCell``,
an LSTM whose input and state products are 2-D convolutions (cuDNN on
the card), states ``(N, hidden_channels, H', W')``."""
from __future__ import annotations

from ....ndarray.ndarray import invoke
from ....symbol.symbol import Symbol
from ...rnn.rnn_cell import RecurrentCell, _act, _placeholders

__all__ = ["Conv2DLSTMCell"]


def _pair(v):
    return (v,) * 2 if isinstance(v, int) else tuple(v)


class Conv2DLSTMCell(RecurrentCell):
    """ConvLSTM (Shi et al. 2015): gates i, f, g, o from ``i2h`` and
    ``h2h`` convolutions; the ``h2h`` kernel pads to keep the state's
    size."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=(0, 0), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)  # (C, H, W)
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _pair(i2h_kernel)
        self._h2h_kernel = _pair(h2h_kernel)
        self._i2h_pad = _pair(i2h_pad)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        ci = self._input_shape[0]
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight",
                shape=(4 * hidden_channels, ci) + self._i2h_kernel,
                allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight",
                shape=(4 * hidden_channels, hidden_channels)
                + self._h2h_kernel,
                allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(4 * hidden_channels,), init="zeros",
                allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(4 * hidden_channels,), init="zeros",
                allow_deferred_init=True)

    def state_info(self, batch_size=0):
        _c, h, w = self._input_shape
        oh = h + 2 * self._i2h_pad[0] - self._i2h_kernel[0] + 1
        ow = w + 2 * self._i2h_pad[1] - self._i2h_kernel[1] + 1
        shape = (batch_size, self._hidden_channels, oh, ow)
        return [{"shape": shape, "__layout__": "NCHW"},
                {"shape": shape, "__layout__": "NCHW"}]

    def _alias(self):
        return "conv_lstm"

    def step(self, inputs, states):
        if isinstance(inputs, Symbol):
            p = _placeholders(self)
        else:
            for param in self._reg_params.values():
                if param._data is None:
                    param._finish_deferred_init()
            p = {k: v.data() for k, v in self._reg_params.items()}
        nf = 4 * self._hidden_channels
        i2h = invoke("Convolution", [inputs, p["i2h_weight"], p["i2h_bias"]],
                     {"kernel": self._i2h_kernel, "pad": self._i2h_pad,
                      "num_filter": nf})
        h2h = invoke("Convolution", [states[0], p["h2h_weight"],
                                     p["h2h_bias"]],
                     {"kernel": self._h2h_kernel, "pad": self._h2h_pad,
                      "num_filter": nf})
        slices = invoke("SliceChannel", [i2h + h2h],
                        {"num_outputs": 4, "axis": 1})
        i = _act(slices[0], "sigmoid")
        f = _act(slices[1], "sigmoid")
        g = _act(slices[2], "tanh")
        o = _act(slices[3], "sigmoid")
        next_c = f * states[1] + i * g
        next_h = o * _act(next_c, "tanh")
        return next_h, [next_h, next_c]
