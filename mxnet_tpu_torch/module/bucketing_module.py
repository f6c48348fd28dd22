"""BucketingModule — one graph a bucket key, one set of parameters
(counterpart of ``mxnet_tpu/module/bucketing_module.py``).

Variable-length training: ``sym_gen(key)`` gives each bucket's symbol, and
each bucket is a ``Module`` bound with ``shared_module=`` the default
bucket's, so every bucket's executor holds the default bucket's parameter
and gradient arrays themselves (the same NDArrays, so the same storage),
not copies. The first forward in a bucket hands it the default bucket's
optimizer, kvstore and updater (``_share_optimizer``): a step in one bucket
and the next in another move one set of weights and one optimizer state.
A bucket's graph is evaluated eagerly, so a new bucket costs its bind, not
a compile.
"""
from __future__ import annotations

import logging
import warnings

from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        self._context = context
        self._work_load_list = work_load_list
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def _call_sym_gen(self, bucket_key):
        return self._sym_gen(bucket_key)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params, aux_params=aux_params,
            allow_missing=allow_missing, force_init=force_init, allow_extra=allow_extra,
        )
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(
                initializer=None, arg_params=arg_params, aux_params=aux_params,
                allow_missing=allow_missing, force_init=force_init, allow_extra=allow_extra,
            )
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False; "
                          "set_params call ignored.", stacklevel=2)
            return
        self._curr_module.set_params(
            arg_params, aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra,
        )
        self.params_initialized = True
        self._params_dirty = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None, grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert shared_module is None

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req

        symbol, data_names, label_names = self._call_sym_gen(self._default_bucket_key)
        module = Module(
            symbol, data_names, label_names, logger=self.logger, context=self._context,
            work_load_list=self._work_load_list, fixed_param_names=self._fixed_param_names,
            state_names=self._state_names, compression_params=self._compression_params,
            group2ctxs=self._group2ctxs,
        )
        module.bind(
            data_shapes, label_shapes, for_training, inputs_need_grad,
            force_rebind=False, shared_module=None, grad_req=self._grad_req,
        )
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            symbol, data_names, label_names = self._call_sym_gen(bucket_key)
            module = Module(
                symbol, data_names, label_names, logger=self.logger, context=self._context,
                work_load_list=self._work_load_list, fixed_param_names=self._fixed_param_names,
                state_names=self._state_names, compression_params=self._compression_params,
            )
            module.bind(
                data_shapes, label_shapes, self._curr_module.for_training,
                self._curr_module.inputs_need_grad, force_rebind=False,
                shared_module=self._buckets[self._default_bucket_key], grad_req=self._grad_req,
            )
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params, force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data, data_batch.provide_label)
        self._share_optimizer()
        self._curr_module.forward(data_batch, is_train=is_train)

    def _share_optimizer(self):
        """Hand the current bucket the default bucket's optimizer, kvstore
        and updater (the optimizer state lives in the updater)."""
        default = self._buckets[self._default_bucket_key]
        if default.optimizer_initialized and not self._curr_module.optimizer_initialized:
            m = self._curr_module
            m._optimizer = default._optimizer
            m._kvstore = default._kvstore
            m._update_on_kvstore = default._update_on_kvstore
            m._updater = default._updater
            m.optimizer_initialized = True

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data, data_batch.provide_label)
        self._share_optimizer()
        self._curr_module.forward_backward(data_batch)

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)
