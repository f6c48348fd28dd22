"""The fused ``RNN`` op (counterpart of the reference's ``RNN`` in
``mxnet_tpu/ops/nn.py``): ``lstm``, ``gru``, ``rnn_relu`` and ``rnn_tanh``
over a whole ``(T, N, I)`` sequence, several layers, bidirectional, with
dropout between layers in training.

The parameters come as one flat vector in the reference's layout: every
layer-direction's ``W_ih`` then ``W_hh`` (gate rows stacked: i, f, g, o for
lstm; r, z, n for gru), then every layer-direction's ``b_ih`` then
``b_hh``. The GRU is cuDNN's form, ``n = tanh(x_n + r * (W_hn h + b_hn))``.
Each layer-direction projects the whole sequence's inputs with one matmul
and then runs a loop of torch ops over the time steps (the reference's
``lax.scan``); the reverse direction runs on the sequence flipped in time
and flips its outputs back.

The op's batch is axis 1, while a data-parallel mesh splits axis 0: under a
mesh it raises by name.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

GATES = {"lstm": 4, "gru": 3, "rnn_relu": 1, "rnn_tanh": 1}


def param_size(mode, state_size, num_layers, bidirectional, input_size):
    """Length of the flat parameter vector."""
    h, g = int(state_size), GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(int(num_layers)):
        in_size = input_size if layer == 0 else h * d
        size += d * (g * h * in_size + g * h * h)
    return size + int(num_layers) * d * 2 * g * h


def _unpack(parameters, mode, h, layers, d, input_size):
    """``[(w_ih, w_hh, b_ih, b_hh)]`` per layer-direction, views of the
    flat vector."""
    g, off = GATES[mode], 0

    def take(*shape):
        nonlocal off
        n = 1
        for v in shape:
            n *= v
        t = parameters.narrow(0, off, n).view(*shape)
        off += n
        return t

    weights = [(take(g * h, input_size if layer == 0 else h * d),
                take(g * h, h))
               for layer in range(layers) for _ in range(d)]
    biases = [(take(g * h), take(g * h)) for _ in range(layers * d)]
    return [w + b for w, b in zip(weights, biases)]


def _cell(mode, x_proj, h, c, w_hh, b_hh):
    hh = torch.matmul(h, w_hh.t()) + b_hh
    if mode == "lstm":
        i, f, g, o = (x_proj + hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        xr, xz, xn = x_proj.chunk(3, dim=-1)
        hr, hz, hn = hh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    pre = x_proj + hh
    if mode == "rnn_relu":
        return torch.maximum(pre, pre.new_zeros(())), c
    return torch.tanh(pre), c


@register(name="RNN", aliases=("rnn",), needs_rng=True,
          num_outputs=lambda attrs: 3 if attrs.get("mode") == "lstm" else 2,
          num_visible_outputs=lambda attrs: (
              (3 if attrs.get("mode") == "lstm" else 2)
              if attrs.get("state_outputs") else 1))
def rnn(gen, data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, __is_train__=False):
    """Outputs ``(out (T, N, D*H), h_T (L*D, N, H)[, c_T])``; ``state``
    and ``state_cell`` are the initial ``(L*D, N, H)`` states (the cell's
    zeros when absent). The output and state counts a symbol exposes are
    the reference's: they read ``mode`` from the given attributes."""
    if mode not in GATES:
        raise MXNetError("RNN: unknown mode %r" % (mode,))
    from .nn import dp_group

    if dp_group()[0] is not None:
        raise MXNetError("RNN under a data-parallel mesh is not ported (its "
                         "batch is axis 1; the mesh splits axis 0)")
    t_len, n, input_size = data.shape
    h_size, layers = int(state_size), int(num_layers)
    d = 2 if bidirectional else 1
    cells = _unpack(parameters, mode, h_size, layers, d, input_size)
    h0 = state.reshape(layers, d, n, h_size)
    c0 = state_cell.reshape(layers, d, n, h_size) \
        if mode == "lstm" and state_cell is not None \
        else data.new_zeros((layers, d, n, h_size))
    x, h_last, c_last = data, [], []
    for layer in range(layers):
        outs = []
        for direction in range(d):
            w_ih, w_hh, b_ih, b_hh = cells[layer * d + direction]
            xs = x if direction == 0 else x.flip(0)
            x_proj = torch.matmul(xs, w_ih.t()) + b_ih
            h, c = h0[layer, direction], c0[layer, direction]
            ys = []
            for t in range(t_len):
                h, c = _cell(mode, x_proj[t], h, c, w_hh, b_hh)
                ys.append(h)
            ys = torch.stack(ys)
            outs.append(ys if direction == 0 else ys.flip(0))
            h_last.append(h)
            c_last.append(c)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and __is_train__ and layer < layers - 1:
            keep = 1.0 - p
            x = x * (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                     .bernoulli_(keep, generator=gen) / keep)
    h_n = torch.stack(h_last).reshape(layers * d, n, h_size)
    if mode == "lstm":
        return x, h_n, torch.stack(c_last).reshape(layers * d, n, h_size)
    return x, h_n
