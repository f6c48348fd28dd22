"""ResNet v2 (pre-activation) symbolic builder (counterpart of
``mxnet_tpu/models/resnet.py``): the same stage/unit structure, depth
table and parameter names. ``fused=True`` runs the IR ``fusion`` pass,
which rewrites every bottleneck unit into one ``FusedBottleneckUnit``
(kernel B1 in inference).

:func:`init_params` is the seeded numpy weight recipe shared by the tests
and ``chip_smoke.py``; :func:`params_from_jax` carries numpy parameter
dicts (for example the JAX package's) across as tensors after checking
every name and shape against this graph.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from .. import symbol as sym
from ..base import MXNetError, dtype_torch
from ..context import resolve_device


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(data=act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(data=act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(data=bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(data=act3, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data=data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(data=act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn2")
    act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(data=act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(data=act1, num_filter=num_filter,
                                   kernel=(1, 1), stride=stride, no_bias=True,
                                   name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, fused=False):
    if len(units) != num_stages:
        raise MXNetError("resnet: %d unit counts for %d stages"
                         % (len(units), num_stages))
    data = sym.var("data")
    _nchannel, height, _ = image_shape
    body = sym.identity(data=data, name="id")
    if height <= 32:  # cifar
        body = sym.Convolution(data=body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:  # imagenet
        body = sym.Convolution(data=body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(data=bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(data=relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    out = sym.SoftmaxOutput(data=fc1, name="softmax")
    if fused and bottle_neck and config.get_strict_bool("MXNET_IR_FUSE"):
        # the builder emits the unfused graph; the fusion pass rewrites
        # each bottleneck unit and cancels the NHWC brackets between them
        from .. import ir

        out = ir.apply_passes(out, passes=("fusion",))
    return out


_IMAGENET_DEPTHS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
    200: ([3, 24, 36, 3], True),
    269: ([3, 30, 48, 8], True),
}


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               **kwargs):
    """Depth table parity with the reference resnet.py get_symbol."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    if image_shape[1] <= 32:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit, bottle_neck = [(num_layers - 2) // 9], True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit, bottle_neck = [(num_layers - 2) // 6], False
        else:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = per_unit * num_stages
        filter_list = [16, 64, 128, 256] if bottle_neck else [16, 16, 32, 64]
    else:
        num_stages = 4
        if num_layers not in _IMAGENET_DEPTHS:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units, bottle_neck = _IMAGENET_DEPTHS[num_layers]
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck \
            else [64, 64, 128, 256, 512]
    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, **kwargs)


def _param_shapes(symbol, data_shape):
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=tuple(data_shape))
    return (dict(zip(symbol.list_arguments(), arg_shapes)),
            dict(zip(symbol.list_auxiliary_states(), aux_shapes)))


def init_params(symbol, data_shape, seed=0):
    """Seeded random weights as ``{name: float32 numpy}`` dicts ``(args,
    auxs)`` (``data`` and the label excluded), scaled so that the logits
    stay O(1-10) through any depth: He-normal convolutions, BN gammas 1
    except each unit's last (``bn3_gamma`` 0.25, so a branch adds about
    1/16 of the stream's variance), betas 0, moving mean 0 and var 1, and
    an FC layer of std 1/sqrt(fan_in) with zero bias."""
    rng = np.random.RandomState(seed)
    args, auxs = _param_shapes(symbol, data_shape)
    arg_params = {}
    for name, shape in args.items():
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight") and len(shape) == 4:
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            v = rng.standard_normal(shape) * std
        elif name.endswith("_weight"):
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif name.endswith("_gamma"):
            v = np.full(shape, 0.25 if name.endswith("bn3_gamma") else 1.0)
        else:   # betas and biases
            v = np.zeros(shape)
        arg_params[name] = v.astype(np.float32)
    aux_params = {name: (np.ones(shape) if name.endswith("_var")
                         else np.zeros(shape)).astype(np.float32)
                  for name, shape in auxs.items()}
    return arg_params, aux_params


def params_from_jax(arg_params, aux_params, symbol, device=None,
                    dtype="float32", data_shape=(1, 3, 224, 224)):
    """Carry ``{name: array}`` parameter dicts (numpy, or anything
    ``np.asarray`` takes, named as the JAX package names them) across as
    ``dtype`` tensors on ``device`` (default ``cuda``). Every name must be a
    parameter of ``symbol`` and every shape must equal the one this
    package's ``infer_shape`` gives at ``data_shape`` (weights do not
    depend on the batch or image size); anything else raises."""
    dev, dt = resolve_device(device), dtype_torch(dtype)
    args, auxs = _param_shapes(symbol, data_shape)
    out = []
    for given, want, kind in ((arg_params, args, "argument"),
                              (aux_params, auxs, "auxiliary state")):
        moved = {}
        for name, value in (given or {}).items():
            if name not in want:
                raise MXNetError("params_from_jax: %r is not an %s of the "
                                 "graph" % (name, kind))
            v = np.asarray(value, dtype=np.float32)
            if tuple(v.shape) != tuple(want[name]):
                raise MXNetError("params_from_jax: %r has shape %s, the "
                                 "graph needs %s" % (name, tuple(v.shape),
                                                     tuple(want[name])))
            moved[name] = torch.tensor(v, device=dev).to(dt)
        out.append(moved)
    return tuple(out)
