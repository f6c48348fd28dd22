"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``): ``VariationalDropoutCell``,
one dropout mask a sequence for the inputs, the first state and the
outputs (drawn at the first step after ``reset``, from the context's
stream)."""
from __future__ import annotations

from ...rnn.rnn_cell import ModifierCell, _mask_like

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    """The same dropout mask at every time step of a sequence."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def step(self, inputs, states):
        if self.drop_states:
            if self.drop_states_mask is None:
                self.drop_states_mask = _mask_like(self.drop_states,
                                                   states[0])
            states = [states[0] * self.drop_states_mask] + list(states[1:])
        if self.drop_inputs:
            if self.drop_inputs_mask is None:
                self.drop_inputs_mask = _mask_like(self.drop_inputs, inputs)
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs:
            if self.drop_outputs_mask is None:
                self.drop_outputs_mask = _mask_like(self.drop_outputs,
                                                    next_output)
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states
