"""Gluon's ``Trainer`` (counterpart of ``mxnet_tpu/gluon/trainer.py``).

The kvstore comes from ``model._create_kvstore`` as in ``Module``: none for
``"device"``/``"local"``/``None`` on one context (each parameter is
updated by the local updater), or the given store, which runs the
optimizer when ``update_on_kvstore`` (the single-host server tier's
``ServerKVStore``: one push a parameter, one batched pull). ``step``
rescales the gradients by ``rescale_grad / batch_size``.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params)))
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s."
                                 % (type(param)))
        self._params = list(params)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_initialized = False
        self._kvstore_spec = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore

    def _init_optimizer(self, optimizer, optimizer_params):
        # keyed by index (the local updater's calls) and by name (the
        # kvstore's), so lr_mult and wd_mult resolve either way
        param_dict = dict(enumerate(self._params))
        param_dict.update({param.name: param for param in self._params})
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        arg_arrays = {param.name: param.data() for param in self._params}
        kvstore, update_on_kvstore = _create_kvstore(self._kvstore_spec, 1,
                                                     arg_arrays)
        if self._update_on_kvstore is not None:
            update_on_kvstore = self._update_on_kvstore
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
            for param in self._params:
                kvstore.init(param.name, param.data())
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore if kvstore else False
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _live(self):
        """(index, parameter) of every parameter that takes a gradient."""
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer step from the gradients in the parameters'
        buffers, rescaled by ``rescale_grad / batch_size``."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _allreduce_grads(self):
        # every push before the first pull, so a store can batch them
        if self._kvstore and not self._update_on_kvstore:
            live = self._live()
            for i, param in live:
                self._kvstore.push(param.name, param.list_grad(), priority=-i)
            for i, param in live:
                self._kvstore.pull(param.name, param.list_grad(), priority=-i)

    def _update(self, ignore_stale_grad=False):
        live = self._live()
        if self._kvstore and self._update_on_kvstore:
            # the server tier: each push returns at once, then one batched
            # pull of the updated values
            for i, param in live:
                self._kvstore.push(param.name, param.list_grad(), priority=-i)
            if live:
                self._kvstore.pull([p.name for _, p in live],
                                   [p.data() for _, p in live], priority=0)
            return
        for i, param in live:
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._optimizer
