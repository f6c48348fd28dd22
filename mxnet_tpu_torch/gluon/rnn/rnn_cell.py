"""Gluon's recurrent cells (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``): the ``RecurrentCell`` base with
``begin_state`` and ``unroll``, ``RNNCell``, ``LSTMCell``, ``GRUCell``,
``SequentialRNNCell``, ``DropoutCell``, the modifier cells ``ZoneoutCell``
and ``ResidualCell``, and ``BidirectionalCell``.

A step calls the registered ops through ``invoke``, so a cell runs eagerly
on NDArrays (the products on cuBLAS on the card) and composes graph nodes
on Symbols: a hybridized cell traces its step once per input shape
(``HybridBlock`` takes the ``(x, [states])`` nesting), and a hybridized
block around ``unroll`` traces the whole unrolled sequence. Under a trace
the parameters are placeholders named as the parameters, and a begin
state the caller did not give is built from the input (zeros of the
batch's rows), since a Symbol has no shape. Random masks (``DropoutCell``,
``ZoneoutCell``) are ``Dropout`` draws from the context's stream.
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import ndarray as nd
from ...ndarray.ndarray import invoke
from ...symbol.symbol import Symbol, var
from ..block import HybridBlock
from ..parameter import DeferredInitializationError

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _placeholders(block):
    """Each registered parameter's graph variable, kept on the parameter so
    that a cell stepped many times in one trace reuses one variable."""
    out = {}
    for k, p in block._reg_params.items():
        ph = getattr(p, "_sym_placeholder", None)
        if ph is None:
            ph = p._sym_placeholder = var(p.name)
        out[k] = ph
    return out


def zeros_state_like(x, batch_axis, shape, state_batch_axis):
    """Zeros of ``shape`` whose axis ``state_batch_axis`` has the length of
    the Symbol ``x``'s ``batch_axis``, built from ``x``'s rows by ops (a
    Symbol has no shape to read)."""
    rows = x if batch_axis == 0 else invoke(
        "swapaxes", [x], {"dim1": 0, "dim2": batch_axis})
    rows = invoke("Reshape", [rows], {"shape": (0, -1)})
    rows = invoke("zeros_like", [invoke("slice_axis", [rows], {
        "axis": 1, "begin": 0, "end": 1})], {})                 # (N, 1)
    rest = tuple(s for i, s in enumerate(shape) if i != state_batch_axis)
    rows = invoke("Reshape", [rows], {"shape": (0,) + (1,) * len(rest)})
    out = invoke("tile", [rows], {"reps": (1,) + rest})      # (N, *rest)
    if state_batch_axis:
        order = list(range(1, len(shape)))
        order.insert(state_batch_axis, 0)
        out = invoke("transpose", [out], {"axes": tuple(order)})
    return out


class RecurrentCell(HybridBlock):
    """The base of the cells: ``state_info``, ``begin_state``, ``unroll``
    over a sequence, and ``step`` (one time step) in the subclasses."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, ctx=None, dtype=None,
                    **kwargs):
        """The initial states: zeros on ``ctx`` (``func=None``), or
        ``func(name=..., shape=...)`` each (``sym.zeros`` for a graph)."""
        assert not self._modified, (
            "After applying modifier cells the base cell cannot be called "
            "directly. Call the modifier cell instead.")
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = info["shape"]
            if func is None:
                extra = {}
                if ctx is not None:
                    extra["ctx"] = ctx
                if dtype is not None:
                    extra["dtype"] = dtype
                state = nd.zeros(shape, **extra)
            else:
                state = func(name="%sbegin_state_%d" % (self._prefix,
                                                         self._init_counter),
                             shape=shape, **kwargs)
            states.append(state)
        return states

    def _zero_begin_state(self, inputs, batch_axis):
        """``begin_state`` of zeros for ``inputs``' batch (on a Symbol,
        built from the input's rows)."""
        if not isinstance(inputs, Symbol):
            return self.begin_state(inputs.shape[batch_axis],
                                    ctx=inputs.context, dtype=inputs.dtype)
        return [zeros_state_like(inputs, batch_axis, info["shape"], 0)
                for info in self.state_info(0)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over ``length`` steps of ``inputs`` (one array,
        its time axis by ``layout``). Returns ``(outputs, states)``:
        outputs stacked on the time axis unless ``merge_outputs`` is
        False; with ``valid_length``, the states are each sequence's last
        valid step's and the outputs past it are zero."""
        self.reset()
        axis = layout.find("T")
        batch_axis = layout.find("N")
        if begin_state is None:
            begin_state = self._zero_begin_state(inputs, batch_axis)
        states = begin_state
        outputs, all_states = [], []
        seq = [invoke("squeeze", [invoke("slice_axis", [inputs], {
            "axis": axis, "begin": i, "end": i + 1})], {"axis": axis})
            for i in range(length)]
        for i in range(length):
            output, states = self(seq[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [invoke("SequenceLast", [
                invoke("stack", [s[j] for s in all_states], {"axis": 0}),
                valid_length], {"use_sequence_length": True, "axis": 0})
                for j in range(len(states))]
            outputs = _mask_outputs(outputs, valid_length, axis)
        if merge_outputs is None or merge_outputs:
            outputs = invoke("stack", outputs, {"axis": axis})
        return outputs, states

    def _get_params(self):
        try:
            return {k: p.data() for k, p in self._reg_params.items()}
        except (DeferredInitializationError, MXNetError):
            return None

    def forward(self, inputs, states):
        self._counter += 1
        return self.step(inputs, states)

    def step(self, inputs, states):
        raise NotImplementedError


def _mask_outputs(outputs, valid_length, axis):
    stacked = invoke("stack", outputs, {"axis": 0})
    masked = invoke("SequenceMask", [stacked, valid_length],
                    {"use_sequence_length": True, "axis": 0})
    return [invoke("squeeze", [invoke("slice_axis", [masked], {
        "axis": 0, "begin": i, "end": i + 1})], {"axis": 0})
        for i in range(len(outputs))]


class _BaseFusibleCell(RecurrentCell):
    """A cell with ``i2h``/``h2h`` weights and biases of ``ngates`` gates."""

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, ngates, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._ngates = ngates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ngates * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ngates * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ngates * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ngates * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)

    def _ensure_params(self, inputs):
        if isinstance(inputs, Symbol):
            return _placeholders(self)
        p = self._get_params()
        if p is None:
            self.i2h_weight.shape = (self._ngates * self._hidden_size,
                                     inputs.shape[-1])
            for param in self._reg_params.values():
                if param._data is None:
                    param._finish_deferred_init()
            p = {k: v.data() for k, v in self._reg_params.items()}
        return p

    def _fc(self, x, w, b, num_hidden):
        return invoke("FullyConnected", [x, w, b],
                      {"num_hidden": num_hidden, "flatten": False})


def _act(x, act_type):
    return invoke("Activation", [x], {"act_type": act_type})


class RNNCell(_BaseFusibleCell):
    """Elman cell: ``h' = act(W_ih x + b_ih + W_hh h + b_hh)``."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 1, prefix=prefix,
                         params=params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def step(self, inputs, states):
        p = self._ensure_params(inputs)
        i2h = self._fc(inputs, p["i2h_weight"], p["i2h_bias"],
                       self._hidden_size)
        h2h = self._fc(states[0], p["h2h_weight"], p["h2h_bias"],
                       self._hidden_size)
        output = _act(i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_BaseFusibleCell):
    """LSTM cell, gates in the order i, f, g, o."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 4, prefix=prefix,
                         params=params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def step(self, inputs, states):
        p = self._ensure_params(inputs)
        h = self._hidden_size
        i2h = self._fc(inputs, p["i2h_weight"], p["i2h_bias"], 4 * h)
        h2h = self._fc(states[0], p["h2h_weight"], p["h2h_bias"], 4 * h)
        slices = invoke("SliceChannel", [i2h + h2h],
                        {"num_outputs": 4, "axis": 1})
        in_gate = _act(slices[0], "sigmoid")
        forget_gate = _act(slices[1], "sigmoid")
        in_transform = _act(slices[2], "tanh")
        out_gate = _act(slices[3], "sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * _act(next_c, "tanh")
        return next_h, [next_h, next_c]


class GRUCell(_BaseFusibleCell):
    """GRU cell (cuDNN's form: ``n = tanh(x_n + r * (W_hn h + b_hn))``)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, 3, prefix=prefix,
                         params=params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def step(self, inputs, states):
        p = self._ensure_params(inputs)
        h = self._hidden_size
        i2h = self._fc(inputs, p["i2h_weight"], p["i2h_bias"], 3 * h)
        h2h = self._fc(states[0], p["h2h_weight"], p["h2h_bias"], 3 * h)
        i2h_r, i2h_z, i2h_n = invoke("SliceChannel", [i2h],
                                     {"num_outputs": 3, "axis": 1})
        h2h_r, h2h_z, h2h_n = invoke("SliceChannel", [h2h],
                                     {"num_outputs": 3, "axis": 1})
        reset_gate = _act(i2h_r + h2h_r, "sigmoid")
        update_gate = _act(i2h_z + h2h_z, "sigmoid")
        next_h_tmp = _act(i2h_n + reset_gate * h2h_n, "tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its states."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def _zero_begin_state(self, inputs, batch_axis):
        if not isinstance(inputs, Symbol):
            return self.begin_state(batch_size=inputs.shape[batch_axis],
                                    ctx=inputs.context, dtype=inputs.dtype)
        return sum([c._zero_begin_state(inputs, batch_axis)
                    for c in self._children.values()], [])

    def step(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]


class DropoutCell(RecurrentCell):
    """Dropout on the step's input (no state)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def step(self, inputs, states):
        if self._rate > 0:
            inputs = invoke("Dropout", [inputs], {"p": self._rate,
                                                  "axes": self._axes})
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell wrapping a base cell, whose parameters it shares."""

    def __init__(self, base_cell):
        assert not base_cell._modified, (
            "Cell %s is already modified. One cell cannot be modified twice"
            % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def _zero_begin_state(self, inputs, batch_axis):
        self.base_cell._modified = False
        try:
            return self.base_cell._zero_begin_state(inputs, batch_axis)
        finally:
            self.base_cell._modified = True


def _mask_like(p, like):
    """``Dropout(ones, p, mode="always")``: 0, or 1 / (1 - p), a cell."""
    return invoke("Dropout", [invoke("ones_like", [like], {})],
                  {"p": p, "mode": "always"})


class ZoneoutCell(ModifierCell):
    """Zoneout: each unit keeps its previous output (state) with
    probability ``zoneout_outputs`` (``zoneout_states``)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), (
            "BidirectionalCell doesn't support zoneout. Apply zoneout to the "
            "cells underneath instead.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def step(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        prev_output = self._prev_output if self._prev_output is not None \
            else invoke("zeros_like", [next_output], {})
        output = invoke("where", [_mask_like(p_outputs, next_output),
                                  next_output, prev_output], {}) \
            if p_outputs != 0.0 else next_output
        new_states = [invoke("where", [_mask_like(p_states, new_s), new_s,
                                       old_s], {})
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus the step's input."""

    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def step(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


def _swap(x, axis):
    return invoke("swapaxes", [x], {"dim1": 0, "dim2": axis}) if axis \
        else x


def _reverse(x, axis, valid_length):
    """``x`` reversed along time axis ``axis`` (each sequence within its
    ``valid_length``, when given)."""
    if valid_length is None:
        rev = invoke("SequenceReverse", [_swap(x, axis)],
                     {"use_sequence_length": False})
    else:
        rev = invoke("SequenceReverse", [_swap(x, axis), valid_length],
                     {"use_sequence_length": True})
    return _swap(rev, axis)


class BidirectionalCell(RecurrentCell):
    """A left-to-right and a right-to-left cell over one sequence; only
    ``unroll`` runs it, and the outputs are concatenated on the features."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError("Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def _zero_begin_state(self, inputs, batch_axis):
        if not isinstance(inputs, Symbol):
            return self.begin_state(batch_size=inputs.shape[batch_axis],
                                    ctx=inputs.context, dtype=inputs.dtype)
        return sum([c._zero_begin_state(inputs, batch_axis)
                    for c in self._children.values()], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        axis = layout.find("T")
        if begin_state is None:
            begin_state = self._zero_begin_state(inputs, layout.find("N"))
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(0))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=True, valid_length=valid_length)
        rev_inputs = _reverse(inputs, axis, valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=rev_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=True, valid_length=valid_length)
        r_outputs_rev = _reverse(r_outputs, axis, valid_length)
        outputs = invoke("Concat", [l_outputs, r_outputs_rev], {"dim": 2})
        return outputs, l_states + r_states
