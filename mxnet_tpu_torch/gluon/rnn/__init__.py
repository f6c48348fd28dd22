"""Gluon's recurrent cells and fused layers (counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,  # noqa: F401
                       LSTMCell, ModifierCell, RecurrentCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
