"""Module — a symbol, its executor group and the imperative optimizer
(counterpart of ``mxnet_tpu/module/module.py``) on one context a process.

``bind`` makes a ``DataParallelExecutorGroup``; ``init_params`` fills host
copies of the parameters (in sorted name order, from the initializer's
seeded stream, as the JAX package does) and copies them into the bound
arrays; ``init_optimizer`` makes the kvstore (``model._create_kvstore``)
and the optimizer with ``rescale_grad = 1/batch``; ``update`` writes each
parameter's update into the bound weight in place, through the kvstore
where there is one. Checkpoints and ``.states`` files are the JAX
package's formats.

``kvstore='tpu'`` trains data parallel over the process group, one process
a device, every rank given the global batch: ``forward_backward`` runs the
fused step of ``FusedSPMDGroup`` (forward, backward, the sums and the
update in one ``TrainStep``), ``zero`` (or ``MXNET_TPU_ZERO``) shards its
update. Where the fused step cannot mirror the optimizer or the module
(``parallel.spmd.FusedStepUnsupported``: an ``lr_scheduler``, a
``param_dict``, an optimizer other than SGD and Adam, fixed params,
``inputs_need_grad``), the per-executor path trains instead: each rank's
executor takes its rows, the kvstore sums the gradients over the ranks and
runs the optimizer, and the outputs are gathered over the ranks. Any other
error, such as a failure to build the mesh or a context that is not the
rank's mesh device, raises.

Not ported, raising ``MXNetError`` by name: more than one context in one
process, ``group2ctxs``, ``dist_*`` kvstores, ``compression_params`` and
``install_monitor``.
"""
from __future__ import annotations

import logging
import warnings

from .. import context as ctx_mod
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from ..ndarray import ndarray as nd
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 zero=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        if len(context) != 1:
            raise MXNetError("Module: %d contexts; more than one context is "
                             "not ported" % len(context))
        if group2ctxs is not None:
            raise MXNetError("Module: group2ctxs is not ported")
        if compression_params is not None:
            raise MXNetError("Module: compression_params (gradient "
                             "compression) is not ported")
        self._zero = zero
        context[0].torch_device()      # a missing card raises here
        self._context = list(context)
        self._work_load_list = work_load_list or [1]
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        input_names = data_names + label_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._fused = None
        self._last_fused = False
        self._fused_stale = False

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module of a checkpoint's symbol and parameters (bind it, then
        ``init_params`` is not needed; ``.states`` load at
        ``init_optimizer`` when asked)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._exec_group.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        group = self._exec_group
        _, out_shapes, _ = self._symbol.infer_shape(**dict(
            group._total_data_shapes + group._total_label_shapes))
        return list(zip(self._output_names, [tuple(s) for s in out_shapes]))

    def get_params(self):
        """The host copies of the parameters, refreshed from the card."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        attrs = self._symbol.attr_dict()
        arg_attrs = {n: attrs.get(n, {})
                     for n in self._param_names + self._aux_names}
        host = ctx_mod.cpu()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    cache[name].copyto(arr)
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, arg_attrs.get(name)), arr)

        group = self._exec_group
        if self._arg_params is None:
            self._arg_params = {
                n: nd.zeros(b[0].shape, ctx=host, dtype=b[0].dtype)
                for n, b in zip(self._param_names, group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                n: nd.zeros(b[0].shape, ctx=host, dtype=b[0].dtype)
                for n, b in zip(self._aux_names, group.aux_arrays)}
        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        group.set_params(self._arg_params, self._aux_params,
                         allow_extra=allow_extra)
        if self._fused is not None:
            self._fused.set_params(self._arg_params, self._aux_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
            if self._fused is not None:
                # the fused group holds the optimizer state: a rebind
                # rebuilds it in init_optimizer
                self.optimizer_initialized = False
            self._fused = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training:
            assert not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        shared_group = None
        if shared_module is not None:
            assert shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list, data_shapes,
            label_shapes, self._param_names, for_training, inputs_need_grad,
            shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded
        if self.params_initialized and self._params_dirty:
            self._sync_params_from_devices()
        self._exec_group.reshape(data_shapes, label_shapes)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        group = self._exec_group
        rescale_grad = 1.0 / group.batch_size
        n_ctx = len(self._context)
        if update_on_kvstore:
            idx2name = dict(enumerate(group.param_names))
        else:
            idx2name = {i * n_ctx + k: n for k in range(n_ctx)
                        for i, n in enumerate(group.param_names)}
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        else:
            assert isinstance(optimizer, opt_mod.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size (%s "
                    "vs. %s)" % (optimizer.rescale_grad, rescale_grad))
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        self._fused = None
        if kvstore is not None and kvstore.type == "tpu" and \
                self.for_training:
            from ..parallel.spmd import FusedStepUnsupported
            from .spmd_group import FusedSPMDGroup

            try:
                self._fused = FusedSPMDGroup(
                    self._symbol, self._context, self._optimizer,
                    self._arg_params, self._aux_params, self._data_names,
                    self._label_names,
                    fixed_param_names=self._fixed_param_names,
                    logger=self.logger, batch_size=group.batch_size,
                    inputs_need_grad=self.inputs_need_grad, zero=self._zero)
            except FusedStepUnsupported as e:
                # a feature the fused step cannot mirror: the per-executor
                # path trains instead. Nothing else is caught: a mesh,
                # device or backend failure raises
                self.logger.warning("kvstore=%r: %s; using per-executor "
                                    "update path", kvstore.type, e)
            else:
                kvstore.attach_mesh(self._fused.mesh)
                update_on_kvstore = self._update_on_kvstore = False
        if kvstore is not None and kvstore.num_workers > 1:
            # one rank a device: each executor takes its rows of the batch
            group.set_dp_slice(kvstore.rank, kvstore.num_workers)
            group.set_params(self._arg_params, self._aux_params)
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _check_shapes(self, data_batch):
        """Rebind for a batch whose shapes differ from the bound ones."""
        group = self._exec_group
        new = tuple(d.shape for d in data_batch.data)
        if tuple(s for _n, s in group._total_data_shapes) == new:
            return
        if getattr(data_batch, "provide_data", None):
            dshape = data_batch.provide_data
        else:
            dshape = [DataDesc(d.name, s) for d, s in
                      zip(group.data_shapes, new)]
        if getattr(data_batch, "provide_label", None):
            lshape = data_batch.provide_label
        elif data_batch.label:
            lshape = [DataDesc(d.name, lb.shape) for d, lb in
                      zip(group.label_shapes, data_batch.label)]
        else:
            lshape = None
        self.reshape(dshape, lshape)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if self._fused is not None:
            self._last_fused = False
            if self._params_dirty:
                # evaluation runs on the executors: refresh them (and the
                # host copies) from the fused carry
                self._sync_params_from_devices()
        self._check_shapes(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def forward_backward(self, data_batch):
        """One training forward and backward on one autograd graph; with
        the fused group, one whole step (``update`` is then a no-op)."""
        assert self.binded and self.params_initialized
        if self._fused is not None:
            if self._fused_stale:
                # an explicit forward/backward/update round went through
                # the executors: the carry takes their params
                self._exec_group.get_params(self._arg_params,
                                            self._aux_params)
                self._fused.set_params(self._arg_params, self._aux_params)
                self._fused_stale = False
            self._fused.forward_backward_update(data_batch)
            self._params_dirty = True
            self._last_fused = True
            return
        self._check_shapes(data_batch)
        self._exec_group.forward_backward(data_batch)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Each parameter's optimizer update, written into the bound
        weight: on the kvstore when it runs the optimizer, else pushed and
        pulled through it (when there is one) and updated here."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._fused is not None:
            if self._last_fused:
                return   # the fused step updated already
            self._fused_stale = True
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, group.param_names)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        if self._fused is not None and self._last_fused:
            return self._fused.get_outputs()
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused is not None and self._last_fused:
            self._fused.update_metric(eval_metric, labels)
            return
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        if self._fused is not None:
            if self._fused_stale:
                # the executors' update ran last: they hold the params
                self._exec_group.get_params(self._arg_params,
                                            self._aux_params)
                self._fused.set_params(self._arg_params, self._aux_params)
                self._fused_stale = False
            else:
                self._fused.copy_params_to(self._arg_params,
                                           self._aux_params)
                self._exec_group.set_params(self._arg_params,
                                            self._aux_params)
            self._params_dirty = False
            return
        self._exec_group.get_params(self._arg_params, self._aux_params)
        if self._kvstore and self._update_on_kvstore:
            names = sorted(self._arg_params)
            if names:
                self._kvstore.pull(names,
                                   [self._arg_params[n] for n in names],
                                   priority=0)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """The optimizer's states as the JAX package writes them: the fused
        group's blob, the kvstore's updater's, or the updater's pickle of
        ``{index: numpy}``; written to a temporary file and renamed."""
        import os

        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        data = self._fused.get_states() if self._fused is not None \
            else self._updater.get_states()
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            data = f.read()
        if self._fused is not None:
            self._fused.set_states(data)
        else:
            self._updater.set_states(data)
