"""DataParallelExecutorGroup for one context (counterpart of
``mxnet_tpu/module/executor_group.py``): one executor bound by
``simple_bind`` with per-argument ``grad_req`` (``null`` for inputs unless
``inputs_need_grad``, for fixed parameters and outside training); each
batch is copied into the bound input arrays in place. More than one
context, ``group2ctxs`` and monitors raise by name.

Data parallel, one process a device (``set_dp_slice``, which ``Module``
calls for a ``'tpu'`` kvstore of more than one rank): the shapes stay the
global batch's, the executor is bound for and given this rank's rows of
it, and outputs and input gradients are gathered over the ranks, as the
JAX group merges its contexts' slices."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..executor import simple_bind
from ..io import DataDesc


def _name_shape(d):
    return (d.name, tuple(d.shape)) if isinstance(d, DataDesc) \
        else (d[0], tuple(d[1]))


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        if len(contexts) != 1:
            raise MXNetError("DataParallelExecutorGroup: %d contexts; more "
                             "than one context is not ported"
                             % len(contexts))
        if group2ctxs is not None and any(g for g in group2ctxs):
            raise MXNetError("DataParallelExecutorGroup: group2ctxs is not "
                             "ported")
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1]
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = set(state_names or [])
        self.logger = logger
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_names = [_name_shape(d)[0] for d in data_shapes]
        self.label_names = [_name_shape(d)[0] for d in label_shapes or []]
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = "null" if (
                    not for_training or name in self.fixed_param_names) \
                    else grad_req
            elif name in self.data_names:
                self.grad_req[name] = grad_req if inputs_need_grad \
                    else "null"
            else:
                self.grad_req[name] = "null"
        self.shared_group = shared_group
        self.execs = []
        self._dp = (0, 1)
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def set_dp_slice(self, rank, n):
        """Bind for rows ``[rank * b, (rank + 1) * b)`` of each global batch
        of ``n * b`` rows, gathering outputs over the ``n`` ranks."""
        self._dp = (int(rank), int(n))
        self.bind_exec(self.data_shapes, self.label_shapes,
                       self.shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self._total_data_shapes = [_name_shape(d) for d in data_shapes]
        self._total_label_shapes = [_name_shape(d) for d in
                                    label_shapes or []]
        self.batch_size = self._total_data_shapes[0][1][0]
        rank, n = self._dp
        if self.batch_size % n:
            raise MXNetError("DataParallelExecutorGroup: batch size %d not "
                             "divisible by %d ranks" % (self.batch_size, n))
        b = self.batch_size // n
        self.slices = [slice(rank * b, (rank + 1) * b)]
        shared = shared_group.execs[0] if shared_group is not None else None
        shapes = {k: (s[0] // n,) + tuple(s[1:]) for k, s in
                  self._total_data_shapes + self._total_label_shapes}
        self.execs = [simple_bind(self.symbol, self.contexts[0],
                                  grad_req=self.grad_req, shared_exec=shared,
                                  **shapes)]
        e = self.execs[0]
        self.param_arrays = [[e.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n)] for n in self.param_names]
        self.data_arrays = [[e.arg_dict[n]] for n in self.data_names]
        self.label_arrays = [[e.arg_dict.get(n)] for n in self.label_names]
        self.aux_arrays = [[e.aux_dict[n]] for n in self.aux_names]
        self.input_grad_arrays = [[e.grad_dict.get(n)]
                                  for n in self.data_names] \
            if self.inputs_need_grad else []

    @property
    def data_shapes(self):
        return [DataDesc(n, s) for n, s in self._total_data_shapes]

    @property
    def label_shapes(self):
        return [DataDesc(n, s) for n, s in self._total_label_shapes]

    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, self.shared_group)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given arrays (in place); data
        parallel, their mean over the ranks (the JAX group's mean over its
        contexts: the moving statistics differ between ranks on the
        per-executor path)."""
        n = self._dp[1]
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if n == 1:
                    block[0].copyto(out[name])
                    continue
                import torch.distributed as dist

                from ..ndarray.ndarray import NDArray
                from ..parallel.mesh import all_reduce_

                total = all_reduce_(block[0].tensor.detach().clone(),
                                    dist.group.WORLD)
                NDArray(total / n).copyto(out[name])

    def _load(self, arrays, targets):
        rows = self.slices[0] if self._dp[1] > 1 else slice(None)
        with torch.no_grad():
            for arr, block in zip(arrays or [], targets):
                if arr is not None and block[0] is not None:
                    block[0].tensor.copy_(arr.tensor[rows])

    def _gather(self, arrays):
        """The ranks' rows of each array, concatenated (a no-op on one
        rank)."""
        if self._dp[1] == 1:
            return list(arrays)
        import torch.distributed as dist

        from ..ndarray.ndarray import NDArray
        from ..parallel.mesh import all_gather_rows

        return [None if a is None else
                NDArray(all_gather_rows(a.tensor.detach(), dist.group.WORLD),
                        a.context) for a in arrays]

    def _load_batch(self, data_batch):
        self._load(data_batch.data, self.data_arrays)
        if data_batch.label is not None and self.label_names:
            self._load(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        self.execs[0].forward(is_train=self.for_training
                              if is_train is None else is_train)

    def forward_backward(self, data_batch):
        """One training forward and backward on one autograd graph."""
        self._load_batch(data_batch)
        self.execs[0].forward_backward()

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self._gather(self.execs[0].outputs)
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        grads = self._gather([self.execs[0].grad_dict.get(n)
                              for n in self.data_names])
        return grads if merge_multi_context else [[g] for g in grads]

    def update_metric(self, eval_metric, labels):
        eval_metric.update_dict(
            dict(zip(self.label_names, labels)),
            dict(zip(self.symbol.list_outputs(), self.get_outputs())))

    def install_monitor(self, mon):
        raise MXNetError("install_monitor: monitors are not ported")
