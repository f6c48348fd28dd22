"""DataParallelExecutorGroup (counterpart of
``mxnet_tpu/module/executor_group.py``): one executor a context, bound by
``simple_bind`` at its slice of the batch with per-argument ``grad_req``
(``null`` for inputs unless ``inputs_need_grad``, for fixed parameters and
outside training) and its ``group2ctxs`` entry (``ctx_group`` placement).
The batch is split by ``work_load_list`` (:func:`_split_input_slice`) and
each slice copied into its executor's bound input arrays in place. Outputs
and input gradients merge along the batch on the first context; ``backward``
splits its output gradients the same way; ``get_params`` averages the
contexts' copies on the host, in context order, as the JAX group does. An
installed ``Monitor`` follows the executors across a rebind
(``set_dp_slice``, ``reshape``).

Data parallel, one process a device (``set_dp_slice``, which ``Module``
calls for a ``'tpu'`` kvstore of more than one rank; one context a rank):
the shapes stay the global batch's, the executor is bound for and given
this rank's rows of it, and outputs and input gradients are gathered over
the ranks, as the JAX group merges its contexts' slices."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..executor import simple_bind
from ..io import DataDesc
from ..ndarray import ndarray as nd


def _name_shape(d):
    return (d.name, tuple(d.shape)) if isinstance(d, DataDesc) \
        else (d[0], tuple(d[1]))


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice for each context, in proportion to its workload;
    the last takes the rest."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise MXNetError("batch size smaller than device count")
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


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = set(state_names or [])
        self.group2ctxs = group2ctxs or [None] * len(contexts)
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
        self._monitors = []
        self._dp = (0, 1)
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def set_dp_slice(self, rank, n):
        """Bind for rows ``[rank * b, (rank + 1) * b)`` of each global batch
        of ``n * b`` rows, gathering outputs over the ``n`` ranks (one
        context a rank)."""
        if len(self.contexts) != 1 and n > 1:
            raise MXNetError("DataParallelExecutorGroup: %d contexts in a "
                             "rank of %d; a rank of a process group holds "
                             "one" % (len(self.contexts), n))
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
        if n > 1:
            if self.batch_size % n:
                raise MXNetError("DataParallelExecutorGroup: batch size %d "
                                 "not divisible by %d ranks"
                                 % (self.batch_size, n))
            b = self.batch_size // n
            self.slices = [slice(rank * b, (rank + 1) * b)]
        else:
            self.slices = _split_input_slice(self.batch_size, self.workload)
        old = self.execs
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            rows = self.slices[i].stop - self.slices[i].start
            shapes = {k: (rows,) + tuple(s[1:]) for k, s in
                      self._total_data_shapes + self._total_label_shapes}
            shared = shared_group.execs[i] if shared_group is not None \
                else None
            self.execs.append(simple_bind(
                self.symbol, ctx, grad_req=self.grad_req, shared_exec=shared,
                group2ctx=self.group2ctxs[i], **shapes))
        for mon in self._monitors:
            mon.exes = [x for x in mon.exes if x not in old]
            for e in self.execs:
                mon.install(e)
        execs = self.execs
        self.param_arrays = [[e.arg_dict[n] for e in execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in execs]
                            for n in self.param_names]
        self.data_arrays = [[e.arg_dict[n] for e in execs]
                            for n in self.data_names]
        self.label_arrays = [[e.arg_dict.get(n) for e in execs]
                             for n in self.label_names]
        self.aux_arrays = [[e.aux_dict[n] for e in execs]
                           for n in self.aux_names]
        self.input_grad_arrays = [[e.grad_dict.get(n) for e in execs]
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
        for e in self.execs:
            e.copy_params_from(arg_params, aux_params,
                               allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given arrays (in place): one
        context's as they are; over contexts their mean, a host sum in
        context order divided by the count (the JAX group's); data
        parallel, their mean over the ranks (the moving statistics differ
        between ranks on the per-executor path)."""
        n = self._dp[1]
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if len(block) > 1:
                    full = sum(w.asnumpy() for w in block) / len(block)
                    nd.array(full, ctx=out[name].context,
                             dtype=out[name].dtype).copyto(out[name])
                    continue
                if n == 1:
                    block[0].copyto(out[name])
                    continue
                import torch.distributed as dist

                from ..parallel.mesh import all_reduce_

                total = all_reduce_(block[0].tensor.detach().clone(),
                                    dist.group.WORLD)
                nd.NDArray(total / n).copyto(out[name])

    def _load(self, arrays, targets):
        """Each context's slice of each batch array into its bound array
        (a rank's rows under ``set_dp_slice``)."""
        with torch.no_grad():
            for arr, block in zip(arrays or [], targets):
                if arr is None:
                    continue
                src = arr.tensor if isinstance(arr, nd.NDArray) else \
                    torch.as_tensor(arr)
                for sl, tgt in zip(self.slices, block):
                    if tgt is None:
                        continue
                    whole = sl.stop - sl.start == src.shape[0]
                    tgt.tensor.copy_(src if whole else src[sl])

    def _load_batch(self, data_batch):
        self._load(data_batch.data, self.data_arrays)
        if data_batch.label is not None and self.label_names:
            self._load(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        for e in self.execs:
            e.forward(is_train=self.for_training
                      if is_train is None else is_train)

    def forward_backward(self, data_batch):
        """One training forward and backward a context, each on one
        autograd graph."""
        self._load_batch(data_batch)
        for e in self.execs:
            e.forward_backward()

    def backward(self, out_grads=None):
        for i, e in enumerate(self.execs):
            og = out_grads
            if out_grads is not None and len(self.execs) > 1:
                og = [None if g is None else g[self.slices[i]]
                      for g in out_grads]
            e.backward(og)

    def _merge(self, per_exec):
        """Each entry's arrays, one a context, as one array along the batch
        on the first context; gathered over the ranks on one rank a
        device (a no-op on one rank)."""
        if len(self.execs) > 1:
            return [None if parts[0] is None else nd.NDArray(torch.cat(
                [p.tensor.to(parts[0].tensor.device) for p in parts]),
                parts[0].context) for parts in per_exec]
        arrays = [parts[0] for parts in per_exec]
        if self._dp[1] == 1:
            return arrays
        import torch.distributed as dist

        from ..parallel.mesh import all_gather_rows

        return [None if a is None else
                nd.NDArray(all_gather_rows(a.tensor.detach(),
                                           dist.group.WORLD), a.context)
                for a in arrays]

    def get_outputs(self, merge_multi_context=True):
        per = [[e.outputs[i] for e in self.execs]
               for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return self._merge(per)
        if len(self.execs) == 1:
            return [[o] for o in self._merge(per)]
        return per

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        per = [[e.grad_dict.get(n) for e in self.execs]
               for n in self.data_names]
        if merge_multi_context:
            return self._merge(per)
        if len(self.execs) == 1:
            return [[g] for g in self._merge(per)]
        return per

    def update_metric(self, eval_metric, labels):
        if len(self.execs) == 1:
            eval_metric.update_dict(
                dict(zip(self.label_names, labels)),
                dict(zip(self.symbol.list_outputs(), self.get_outputs())))
            return
        for sl, e in zip(self.slices, self.execs):
            rows = sl.stop - sl.start
            eval_metric.update_dict(
                dict(zip(self.label_names,
                         [lb if lb.shape[0] == rows else lb[sl]
                          for lb in labels])),
                dict(zip(self.symbol.list_outputs(), e.outputs)))

    def install_monitor(self, mon):
        self._monitors.append(mon)
        for e in self.execs:
            mon.install(e)
