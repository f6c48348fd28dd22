"""PythonModule / PythonLossModule — the module API over Python compute
(counterpart of ``mxnet_tpu/module/python_module.py``).

``PythonModule`` stubs the parameter and optimizer surface, so a subclass
implements ``forward`` (and ``backward`` to train) and
``_compute_output_shapes``; ``PythonLossModule`` is a loss head whose
``backward`` gives d(loss)/d(scores) (``grad_func``, or softmax cross
entropy's ``p - onehot(y)``) to the module before it.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import ndarray as nd
from .base_module import BaseModule


class PythonModule(BaseModule):
    """Subclass and implement ``forward`` (and ``backward`` if training);
    parameter-free by default."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        if isinstance(data_names, tuple):
            data_names = list(data_names)
        if isinstance(label_names, tuple):
            label_names = list(label_names)
        self._data_names = data_names
        self._label_names = label_names or []
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- properties ----------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- params (none by default) --------------------------------------------
    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is None:
            return
        eval_metric.update(labels, self.get_outputs())

    # -- bind ----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        assert grad_req == "write", "PythonModule only supports write grad_req"
        self._data_shapes = [
            d if isinstance(d, DataDesc) else DataDesc(d[0], tuple(d[1]))
            for d in data_shapes
        ]
        self._label_shapes = (
            [l if isinstance(l, DataDesc) else DataDesc(l[0], tuple(l[1]))
             for l in label_shapes]
            if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Subclass: [(name, shape)] of the outputs."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss head in pure Python: forward stores the scores, backward
    produces d(loss)/d(scores) via ``grad_func`` (or cross-entropy-style
    pass-through by default)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        assert len(data_names) == 1 and data_names[0] == "data"
        assert len(label_names) == 1 and label_names[0] == "softmax_label"
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0] if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head"
        assert self.for_training
        if self._grad_func is not None:
            grad = self._grad_func(self._scores, self._labels)
            if not isinstance(grad, nd.NDArray):
                grad = nd.array(grad, ctx=self._scores.context)
            self._scores_grad = grad
        else:
            # default: d/dx of cross-entropy(softmax(x)) = p - onehot(y)
            scores = self._scores.asnumpy()
            labels = self._labels.asnumpy().astype(np.int64)
            e = np.exp(scores - scores.max(axis=1, keepdims=True))
            p = e / e.sum(axis=1, keepdims=True)
            p[np.arange(len(labels)), labels] -= 1.0
            self._scores_grad = nd.array(p, ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()
