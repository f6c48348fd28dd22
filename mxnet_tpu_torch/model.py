"""Checkpoints and the single-context update helpers (counterpart of
``mxnet_tpu/model.py``).

``save_checkpoint``/``load_checkpoint`` keep the JAX package's two files,
``prefix-symbol.json`` and ``prefix-%04d.params`` (``ndarray.save`` with
``arg:``/``aux:`` names), so a checkpoint of either package loads in the
other. ``_create_kvstore`` accepts what one context needs (``None`` or
``"local"``, which is no kvstore there); any other kvstore raises by name.
Not ported yet: ``FeedForward`` and the kvstore-backed updates.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import symbol as sym_mod
from .base import MXNetError
from .context import cpu
from .ndarray.utils import load as nd_load, save as nd_save

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)``: ``(None, False)`` for one context
    with ``None`` or ``"local"``; anything else is not ported."""
    if num_device != 1:
        raise MXNetError("kvstore: %d contexts; more than one context is "
                         "not ported" % num_device)
    if kvstore is None or kvstore == "local":
        return None, False
    raise MXNetError("kvstore=%r is not ported (one context, None or "
                     "'local')" % (getattr(kvstore, "type", kvstore),))


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater`` to every parameter with a gradient, by index
    ``i * num_device + k`` (parameter i, device k)."""
    if kvstore is not None:
        raise MXNetError("_update_params: a kvstore is not ported")
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(i * num_device + k, g, w)


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
