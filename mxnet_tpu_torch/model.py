"""Checkpoints and the single-context update helpers (counterpart of
``mxnet_tpu/model.py``).

``save_checkpoint``/``load_checkpoint`` keep the JAX package's two files,
``prefix-symbol.json`` and ``prefix-%04d.params`` (``ndarray.save`` with
``arg:``/``aux:`` names), so a checkpoint of either package loads in the
other. ``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore`` and ``_update_params`` are the JAX package's,
over the per-context lists of each parameter's arrays. ``FeedForward`` is
the legacy estimator over ``Module`` (a list of contexts too).
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import chaos
from . import kvstore as kvs
from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu
from .ndarray.utils import load as nd_load, save as nd_save

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` as the JAX package makes them: no
    kvstore for ``None``, and at one context for any type but ``dist*``
    and ``tpu``; over ``num_device`` contexts the store sums their
    gradients; it runs the optimizer unless it is ``local`` with a
    parameter above 16 Mi elements."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore != "tpu":
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values()) \
                    if arg_params else 0
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise MXNetError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Store each parameter's initial value (rank 0's, on the ``tpu``
    tier) on the device of its bound arrays, so that an in-process store
    sums and updates where the module computes, and, when the store runs
    the optimizer, pull it into the bound arrays."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name].as_in_context(
            param_on_devs[0].context))
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push every gradient, then pull every weight: the store sums and
    updates. One call is one worker step of ``MXNET_FAULT_SPEC``; a nan
    rule for it poisons one gradient before its push."""
    poison = chaos.nan_fault()
    chaos.tick_step()
    live = []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        if poison:
            grad_list[0][:] = float("nan")
            poison = False
        kvstore.push(name, grad_list, priority=-index)
        live.append((name, arg_list))
    if live:
        kvstore.pull([name for name, _a in live],
                     [arg_list for _n, arg_list in live], priority=0)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater`` to every parameter with a gradient, by index
    ``i * num_device + k`` (parameter i, device k); with a kvstore, each
    gradient is pushed and the store's value pulled back into it first.
    One call is one worker step of ``MXNET_FAULT_SPEC``, as above."""
    poison = chaos.nan_fault()
    chaos.tick_step()
    live = []
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        if poison:
            grad_list[0][:] = float("nan")
            poison = False
        if kvstore:
            kvstore.push(param_names[i], grad_list, priority=-i)
        live.append((i, arg_list, grad_list))
    for index, arg_list, grad_list in live:
        if kvstore:
            kvstore.pull(param_names[index], grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` and ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``. The params are host copies on
    the CPU, as ``Module`` keeps them: ``set_params``/``bind`` copy them
    into the executor's arrays on its context."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd_load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy estimator: a thin shell over :class:`module.Module`.
    ``fit``/``predict``/``score`` take numpy arrays (batched by
    ``numpy_batch_size``, shuffled by numpy's global generator) or data
    iterators and delegate to the Module loop; ``save``/``load`` are the
    two-file checkpoint; ``create`` makes and trains one."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.optimizer_params = kwargs
        self._module = None

    # -- data normalization --------------------------------------------------
    def _as_iter(self, X, y=None, shuffle=False):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        if y is None:
            y = np.zeros(len(X), dtype=np.float32)
        return NDArrayIter(np.asarray(X, np.float32),
                           np.asarray(y, np.float32),
                           batch_size=min(self.numpy_batch_size, len(X)),
                           shuffle=shuffle, label_name="softmax_label")

    def _get_module(self, data_iter, logger=None, work_load_list=None):
        from .module import Module

        if self._module is None:
            label_names = [d.name if hasattr(d, "name") else d[0]
                           for d in (data_iter.provide_label or [])]
            kw = {}
            if logger is not None:
                kw["logger"] = logger
            if work_load_list is not None:
                kw["work_load_list"] = work_load_list
            self._module = Module(self.symbol,
                                  data_names=[d.name if hasattr(d, "name")
                                              else d[0]
                                              for d in data_iter.provide_data],
                                  label_names=label_names or None,
                                  context=self.ctx, **kw)
        return self._module

    # -- estimator surface ---------------------------------------------------
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        if self.num_epoch is None:
            raise MXNetError("FeedForward.fit: num_epoch was not set "
                             "(pass num_epoch= to the constructor)")
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(*eval_data) \
                if isinstance(eval_data, tuple) else self._as_iter(eval_data)
        mod = self._get_module(train, logger=logger,
                               work_load_list=work_load_list)
        opt_params = dict(self.optimizer_params)
        arg_params = self.arg_params
        if self.allow_extra_params and arg_params:
            known = set(self.symbol.list_arguments())
            arg_params = {k: v for k, v in arg_params.items() if k in known}
        # the data-parallel kvstore tiers get the background input
        # pipeline: batches are placed on the device while a step runs
        kv_type = kvstore if isinstance(kvstore, str) \
            else getattr(kvstore, "type", "")
        pipelined = None
        if kv_type in ("tpu", "dist_sync", "dist_sync_device", "dist_async"):
            from .parallel.feed import DeviceQueueIter

            # close_source=False: the caller owns `train` and may fit()
            # again with it — only the wrapper's worker shuts down here
            train = pipelined = DeviceQueueIter(train, module=mod,
                                                close_source=False)
        try:
            mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                    epoch_end_callback=epoch_end_callback,
                    batch_end_callback=batch_end_callback, kvstore=kvstore,
                    optimizer=self.optimizer, optimizer_params=opt_params,
                    eval_end_callback=eval_end_callback,
                    eval_batch_end_callback=eval_batch_end_callback,
                    initializer=self.initializer, arg_params=arg_params,
                    aux_params=self.aux_params, allow_missing=True,
                    begin_epoch=self.begin_epoch,
                    num_epoch=self.num_epoch, monitor=monitor,
                    force_rebind=True)  # a prior predict/score bound for inference
        finally:
            if pipelined is not None:
                pipelined.close()
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        it = self._as_iter(X)
        mod = self._get_module(it)
        if not mod.binded:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=False)
        if not return_data:
            outs = mod.predict(it, num_batch=num_batch, reset=reset)
            out = outs[0] if isinstance(outs, list) and len(outs) == 1 else outs
            return out.asnumpy() if hasattr(out, "asnumpy") else out
        # reference return_data mode: (outputs, datas, labels)
        if reset:
            it.reset()
        outs, datas, labels = [], [], []
        for i, batch in enumerate(it):
            if num_batch is not None and i >= num_batch:
                break
            mod.forward(batch, is_train=False)
            n = batch.data[0].shape[0] - (batch.pad or 0)
            outs.append(mod.get_outputs()[0].asnumpy()[:n])
            datas.append(batch.data[0].asnumpy()[:n])
            if batch.label:
                labels.append(batch.label[0].asnumpy()[:n])
        cat = np.concatenate
        return (cat(outs), cat(datas), cat(labels) if labels else None)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        from . import metric as metric_mod

        it = self._as_iter(X)
        mod = self._get_module(it)
        if not mod.binded:
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {})
        m = metric_mod.create(eval_metric)
        mod.score(it, m, num_batch=num_batch, reset=reset,
                  batch_end_callback=batch_end_callback)
        # composite metrics return a list of values (ref model.py score)
        _, value = m.get()
        return value

    # -- persistence (two-artifact checkpoint format) ------------------------
    def save(self, prefix, epoch=None):
        epoch = self.num_epoch if epoch is None else epoch
        save_checkpoint(prefix, epoch or 0, self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Train a new model from scratch."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
