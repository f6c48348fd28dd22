"""Legacy data-parallel execution helpers (``mx.executor_manager``;
counterpart of ``mxnet_tpu/executor_manager.py``): the batch split by
workload, the argument-name checks, batch loading, and
``DataParallelExecutorManager``, a thin wrapper over the Module executor
group, over one context or a list of them."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["_split_input_slice", "_check_arguments", "_load_data",
           "_load_label", "DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice for each device, in proportion to its workload."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size cannot be smaller than the device list")
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Refuse duplicate argument or auxiliary-state names."""
    args = symbol.list_arguments()
    if len(set(args)) != len(args):
        raise MXNetError("duplicate argument names in symbol: %r" % (args,))
    auxs = symbol.list_auxiliary_states()
    if len(set(auxs)) != len(auxs):
        raise MXNetError("duplicate aux names in symbol: %r" % (auxs,))


def _load_general(data, targets, slices=None):
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, list):
            for slice_idx, d_dst in zip(slices, d_targets):
                d_src[slice_idx].copyto(d_dst)
        else:
            d_src.copyto(d_targets)


def _load_data(batch, targets, slices=None):
    _load_general(batch.data, targets, slices)


def _load_label(batch, targets, slices=None):
    _load_general(batch.label, targets, slices)


class DataParallelExecutorManager:
    """A forwarding wrapper over ``module.executor_group``'s group, kept
    for scripts written against the pre-Module trainer."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        from .module.executor_group import DataParallelExecutorGroup

        contexts = ctx if isinstance(ctx, (list, tuple)) else [ctx]
        self.symbol = symbol
        self.contexts = contexts
        self.arg_names = symbol.list_arguments()
        self.param_names = param_names or [
            n for n in self.arg_names
            if n not in [d[0] for d in train_data.provide_data]
            and n not in [l[0] for l in (train_data.provide_label or [])]]
        self.aux_names = symbol.list_auxiliary_states()
        self._group = DataParallelExecutorGroup(
            symbol, contexts, work_load_list or [1] * len(contexts),
            train_data.provide_data, train_data.provide_label,
            self.param_names, for_training=True, inputs_need_grad=False,
            logger=logger)

    @property
    def param_arrays(self):
        return self._group.param_arrays

    @property
    def grad_arrays(self):
        return self._group.grad_arrays

    @property
    def aux_arrays(self):
        return self._group.aux_arrays

    def set_params(self, arg_params, aux_params):
        self._group.set_params(arg_params, aux_params)

    def install_monitor(self, monitor):
        self._group.install_monitor(monitor)

    def load_data_batch(self, data_batch):
        self._cur_batch = data_batch

    def forward(self, is_train=False):
        self._group.forward(self._cur_batch, is_train=is_train)

    def backward(self):
        self._group.backward()

    def update_metric(self, metric, labels):
        self._group.update_metric(metric, labels)
