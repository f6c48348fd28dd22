"""The Python half of the C predict ABI (counterpart of
``mxnet_tpu/c_predict.py``).

The port's C library (``native/c_predict.cc``, built by
:func:`._native.build_predict` into ``_build/libmxtpu_predict-<hash>.so``)
serves ``src/c_predict_api.h``: it embeds CPython, imports this module
and forwards every ABI call into it. This module parses the symbol JSON
and the ``.params`` payload and binds the serving tier's
:class:`~.serving.AOTPredictor` at the exact input shapes (``ladder=None``:
no padding, no buckets, MXNet's fixed-shape ``PredictorHandle``), so a C
program runs the forward the serving tier runs, the fused ResNet's B1 on
the card for ``dev_type`` 2. Inputs and outputs cross the ABI as float32
host buffers.
"""
from __future__ import annotations

import ctypes
import io

import numpy as _np


def _as_ndarray_map(param_bytes):
    """``(arg_params, aux_params)`` of a ``.params`` payload (the dict
    format of ``save_checkpoint``: ``arg:``/``aux:`` prefixes), as
    NDArrays on the CPU."""
    from .context import cpu
    from .ndarray.utils import _from_numpy

    arg_params, aux_params = {}, {}
    with _np.load(io.BytesIO(param_bytes), allow_pickle=False) as npz:
        for k in npz.keys():
            if k.startswith("arg:"):
                arg_params[k[4:]] = _from_numpy(npz[k], cpu())
            elif k.startswith("aux:"):
                aux_params[k[4:]] = _from_numpy(npz[k], cpu())
            else:
                arg_params[k] = _from_numpy(npz[k], cpu())
    return arg_params, aux_params


class CPredictor:
    """One bound inference program (the ``PredictorHandle``'s payload): an
    :class:`~.serving.AOTPredictor` bound at the exact ``input_shapes``."""

    def __init__(self, symbol_json, param_bytes, dev_type, dev_id,
                 input_shapes, output_names=None):
        from . import symbol as sym_mod
        from .serving import AOTPredictor

        sym = sym_mod.load_json(symbol_json)
        # MXNet's enum: 1 the CPU, 2 the card (cuda:<dev_id>)
        device = "cpu" if dev_type == 1 else "cuda:%d" % dev_id
        arg_params, aux_params = _as_ndarray_map(param_bytes)
        self._pred = AOTPredictor(
            sym, arg_params, aux_params, data_shapes=dict(input_shapes),
            ladder=None, device=device,
            output_names=list(output_names) if output_names else None)
        self._input_shapes = {k: tuple(v) for k, v in
                              dict(input_shapes).items()}
        self._inputs = {k: _np.zeros(v, _np.float32)
                        for k, v in self._input_shapes.items()}
        self._outputs = None

    # -- the ABI's backend methods (called from native/c_predict.cc) --------
    def set_input(self, key, ptr, size):
        if key not in self._input_shapes:
            raise ValueError("unknown input %r" % key)
        shape = self._input_shapes[key]
        n = 1
        for s in shape:
            n *= s
        if size != n:
            raise ValueError("input %r: expected %d floats, got %d"
                             % (key, n, size))
        buf = (ctypes.c_float * size).from_address(ptr)
        self._inputs[key] = _np.frombuffer(
            buf, dtype=_np.float32).reshape(shape).copy()
        self._outputs = None  # stale against the new input

    def forward(self):
        self._outputs = [_np.asarray(o, dtype=_np.float32)
                         for o in self._pred.predict(self._inputs)]

    def num_outputs(self):
        return self._pred.num_outputs

    def output_shape(self, index):
        if self._outputs is None:
            self.forward()
        return tuple(int(s) for s in self._outputs[index].shape)

    def get_output(self, index, ptr, size):
        if self._outputs is None:
            raise ValueError("call forward before get_output")
        flat = _np.ascontiguousarray(self._outputs[index]).reshape(-1)
        if size != flat.size:
            raise ValueError("output %d: expected %d floats, got %d"
                             % (index, flat.size, size))
        buf = (ctypes.c_float * size).from_address(ptr)
        _np.frombuffer(buf, dtype=_np.float32)[:] = flat


class NDList:
    """The payload of ``MXNDListCreate``/``MXNDListGet``: a loaded
    ``.params`` blob as float32 arrays, keys without their prefixes."""

    def __init__(self, nd_bytes):
        self.keys = []
        self.arrays = []
        with _np.load(io.BytesIO(nd_bytes), allow_pickle=False) as npz:
            for k in npz.keys():
                name = k.split(":", 1)[1] if ":" in k else k
                self.keys.append(name)
                self.arrays.append(
                    _np.ascontiguousarray(npz[k]).astype(_np.float32))

    def __len__(self):
        return len(self.keys)

    def key(self, i):
        return self.keys[i]

    def shape(self, i):
        return tuple(int(s) for s in self.arrays[i].shape)

    def data_ptr(self, i):
        # the ndarray owns the buffer: valid while this NDList lives
        return self.arrays[i].ctypes.data


def create_predictor(symbol_json, param_bytes, dev_type, dev_id,
                     input_shapes, output_names=None):
    return CPredictor(symbol_json, param_bytes, dev_type, dev_id,
                      input_shapes, output_names)


def create_ndlist(nd_bytes):
    return NDList(nd_bytes)
