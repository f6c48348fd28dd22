"""Checkpoints and the single-context update helpers (counterpart of
``mxnet_tpu/model.py``).

``save_checkpoint``/``load_checkpoint`` keep the JAX package's two files,
``prefix-symbol.json`` and ``prefix-%04d.params`` (``ndarray.save`` with
``arg:``/``aux:`` names), so a checkpoint of either package loads in the
other. ``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore`` and ``_update_params`` are the JAX package's
(one context a process: more than one raises by name). Not ported yet:
``FeedForward``.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

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
    and ``tpu``; the store runs the optimizer unless it is ``local`` with a
    parameter above 16 Mi elements."""
    if num_device != 1:
        raise MXNetError("kvstore: %d contexts; more than one context in "
                         "one process is not ported" % num_device)
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
    updates."""
    live = []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        live.append((name, arg_list))
    if live:
        kvstore.pull([name for name, _a in live],
                     [arg_list for _n, arg_list in live], priority=0)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater`` to every parameter with a gradient, by index
    ``i * num_device + k`` (parameter i, device k); with a kvstore, each
    gradient is pushed and the store's value pulled back into it first."""
    live = []
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
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
