"""Fused-block operator: the whole pre-activation ResNet bottleneck unit as
one op (counterpart of ``FusedBottleneckUnit`` in
``mxnet_tpu/ops/fused.py``).

The IR fusion pass (``ir/rules.py`` ``bottleneck_fuse``) emits it when it
rewrites the unfused builder graph. Parameter names and OIHW weight shapes
match the unfused builder's exactly, so checkpoints load either way. The
inference unit runs on kernel B1, the training unit on B1 forward and B2/B3
backward under one ``torch.autograd.Function`` (``kernels/fused_block.py``).

``_ConvResidualAdd`` is what the ``residual`` pass emits for a convolution
whose output feeds an add: the convolution (cuDNN on the card, as the JAX
package leaves it to XLA) plus the add, the same math as the pair.

Inside ``fused_block.spmd_scope`` (set by a ``TrainStep`` on a mesh) the
training unit runs ``bottleneck_train_spmd`` on the rank's rows: the same
kernels, counted in the same launch counters. Inference is per sample and
needs no collective, so it runs ``bottleneck_infer`` under the scope too.
"""
from __future__ import annotations

from .registry import register


@register(
    name="FusedBottleneckUnit",
    num_outputs=7,
    num_visible_outputs=1,
    aux_state_outputs={
        "bn1_moving_mean": 1, "bn1_moving_var": 2,
        "bn2_moving_mean": 3, "bn2_moving_var": 4,
        "bn3_moving_mean": 5, "bn3_moving_var": 6,
    },
)
def fused_bottleneck_unit(
    data,
    conv1_weight,
    conv2_weight,
    conv3_weight,
    bn1_gamma,
    bn1_beta,
    bn2_gamma,
    bn2_beta,
    bn3_gamma,
    bn3_beta,
    bn1_moving_mean,
    bn1_moving_var,
    bn2_moving_mean,
    bn2_moving_var,
    bn3_moving_mean,
    bn3_moving_var,
    sc_weight=None,
    num_filter=1,
    stride=1,
    dim_match=True,
    eps=2e-5,
    momentum=0.9,
    __is_train__=False,
):
    """Pre-activation bottleneck unit (BN-ReLU-conv x3 + shortcut) in NHWC.

    Outputs ``(out, bn1_mm, bn1_mv, ..., bn3_mv)``: in training the moving
    statistics are mixed with the batch's, ``m * old + (1 - m) * batch`` in
    f32 cast back to each one's dtype, holding no graph; in inference they
    come back unchanged."""
    from ..kernels import fused_block as fb

    def hwio(w):
        return None if w is None else w.permute(2, 3, 1, 0)  # OIHW -> HWIO

    weights = (data, hwio(conv1_weight), hwio(conv2_weight),
               hwio(conv3_weight), hwio(sc_weight), bn1_gamma, bn1_beta,
               bn2_gamma, bn2_beta, bn3_gamma, bn3_beta)
    moving = (bn1_moving_mean, bn1_moving_var, bn2_moving_mean,
              bn2_moving_var, bn3_moving_mean, bn3_moving_var)
    scope = fb.current_spmd_scope()
    if __is_train__:
        if scope is not None:
            out, stats = fb.bottleneck_train_spmd(*weights, int(stride),
                                                  float(eps), *scope)
        else:
            out, stats = fb.bottleneck_train(*weights, int(stride),
                                             float(eps))
        m = float(momentum)
        new = tuple((m * old.float() + (1.0 - m) * st.detach()).to(old.dtype)
                    for old, st in zip(moving, stats))
        return (out,) + new
    # inference is per sample: bottleneck_infer_spmd is this same call
    out = fb.bottleneck_infer(*weights, *moving, stride=int(stride),
                              eps=float(eps))
    return (out,) + moving


@register(name="_ConvResidualAdd")
def _conv_residual_add(data, weight, residual, bias=None, kernel=(),
                       stride=(), dilate=(), pad=(), num_filter=1,
                       num_group=1, workspace=1024, no_bias=False,
                       layout=None):
    """``Convolution(data, weight[, bias]) + residual``: the op the
    ``residual_conv_epilogue`` rule (``ir/rules.py``) emits."""
    from .nn import convolution

    out = convolution(data, weight, bias, kernel=kernel, stride=stride,
                      dilate=dilate, pad=pad, num_filter=num_filter,
                      num_group=num_group, workspace=workspace,
                      no_bias=no_bias, layout=layout)
    return out + residual
