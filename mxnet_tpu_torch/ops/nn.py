"""Neural-net ops of the image and transformer graphs (counterpart of the
matching entries of ``mxnet_tpu/ops/nn.py``): ``Convolution``,
``BatchNorm``, ``LayerNorm``, ``Activation``, ``Pooling``,
``FullyConnected`` and ``SoftmaxOutput``, with MXNet's attribute names and
defaults and NCHW layout.

The convolution goes to ``torch.nn.functional`` (cuDNN on the card), as
the JAX package leaves it to XLA: it is the unfused graph's oracle and
the ResNet stem, not a kernel of the port. ``SoftmaxOutput`` is MXNet's
fused softmax + cross-entropy head: its forward gives the probabilities,
and under autograd its backward is the loss gradient, whatever gradient
reaches its output.

Inside a data-parallel ``spmd_scope`` (``TrainStep`` on a mesh) each rank
holds its rows of the batch, and the two ops of these graphs that reduce
over the batch axis reduce over the mesh's data group: BatchNorm's
training statistics are the global batch's (its sums all-reduced through
an autograd function whose backward all-reduces their cotangents, its
fp32 pivot rank 0's first row), and SoftmaxOutput's ``batch``/``valid``
normalization divides by the global count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


def dp_group():
    """``(group, n)`` of the data-parallel scope the op runs in, else
    ``(None, 1)``."""
    from ..kernels.fused_block import current_spmd_scope

    scope = current_spmd_scope()
    if scope is None:
        return None, 1
    from ..parallel.mesh import data_group

    group, n, _index = data_group(*scope)
    return group, n


def _tuple(x, n):
    if isinstance(x, (int, float)):
        return (int(x),) * n
    t = tuple(int(v) for v in x)
    if len(t) == 0:
        return (1,) * n
    if len(t) == 1:
        return t * n
    return t


@register(name="Convolution", aliases=("convolution", "Convolution_v1"))
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=1, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False,
                layout=None):
    nd = len(kernel) if kernel else data.dim() - 2
    if nd not in (1, 2, 3):
        raise MXNetError("Convolution: %d spatial dims (1, 2 or 3)" % nd)
    conv = getattr(F, "conv%dd" % nd)
    out = conv(data, weight, stride=_tuple(stride, nd),
               padding=_tuple(pad, nd) if pad else 0,
               dilation=_tuple(dilate, nd), groups=int(num_group))
    out = out.to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@register(name="FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=1, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register(name="Pooling", aliases=("pooling", "Pooling_v1"))
def pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=()):
    nd = data.dim() - 2
    if global_pool:
        dims = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=dims, keepdim=True)
        # the reference's mean for every other global pool, sum included
        return data.mean(dim=dims, keepdim=True)
    if pooling_convention != "valid":
        raise MXNetError("Pooling: pooling_convention=%r is not ported yet "
                         "(only 'valid')" % pooling_convention)
    kernel = _tuple(kernel, nd)
    stride = _tuple(stride, nd) if stride else (1,) * nd
    pad = _tuple(pad, nd) if pad else (0,) * nd
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % pool_type)
    # pad explicitly, as the reference's reduce_window does: torch's pools
    # refuse a pad above half the kernel
    if any(pad):
        data = F.pad(data, [p for p in reversed(pad) for _ in (0, 1)],
                     value=float("-inf") if pool_type == "max" else 0.0)
    if pool_type == "max":
        return getattr(F, "max_pool%dd" % nd)(data, kernel, stride)
    # count_include_pad=True semantics (the MXNet default): the padded
    # zeros count in the window
    out = getattr(F, "avg_pool%dd" % nd)(data, kernel, stride)
    if pool_type == "sum":
        for k in kernel:
            out = out * k
    return out


@register(name="Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        # maximum against a 0-d zero: half the gradient at a tie, as the
        # reference's jnp.maximum (clamp_min would pass all of it)
        return torch.maximum(data, data.new_zeros(()))
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise MXNetError("unknown act_type %r" % act_type)


def _softmax_forward(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward: the probabilities. Backward: ``(p - onehot(label)) *
    grad_scale / denom`` in the output's dtype, ignoring the gradient that
    reaches the output (the reference discards out_grad); the label gets a
    zero gradient. The counterpart of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        out = _softmax_forward(data, attrs["multi_output"],
                               attrs["preserve_shape"])
        ctx.attrs = attrs
        ctx.save_for_backward(out, label)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _grad_out):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        alpha, ignore = a["smooth_alpha"], a["ignore_label"]
        if a["multi_output"]:
            # trailing spatial dims flatten against the label (the
            # reference takes label (N, d1*d2...) for data (N, C, d1, ...))
            p = out.reshape(out.shape[0], out.shape[1], -1)
            lab = label.reshape(out.shape[0], -1).long()
            k = p.shape[1]
            onehot = F.one_hot(lab, k).to(out.dtype).movedim(-1, 1)
        else:
            p = out.reshape(out.shape[0], -1)
            lab = label.reshape(-1).long()
            k = p.shape[1]
            onehot = F.one_hot(lab, k).to(out.dtype)
        if alpha:
            onehot = onehot * (1 - alpha) + alpha / (k - 1) * (1 - onehot)
        grad = p - onehot
        if a["use_ignore"]:
            keep = (lab != int(ignore)).to(out.dtype)
            grad = grad * (keep.unsqueeze(1) if a["multi_output"]
                           else keep[:, None])
        denom = 1.0
        group, n = a["dp"]
        if a["normalization"] == "batch":
            denom = out.shape[0] * n
        elif a["normalization"] == "valid" and a["use_ignore"]:
            valid = (label != ignore) if a["multi_output"] else \
                (lab != int(ignore))
            count = valid.sum().to(out.dtype)
            if group is not None:
                from ..parallel.mesh import all_reduce_

                count = all_reduce_(count.float(), group).to(out.dtype)
            denom = torch.clamp_min(count, 1.0)
        grad = (grad * (a["grad_scale"] / denom)).reshape(out.shape)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, dlabel, None


@register(name="SoftmaxOutput", aliases=("softmax_output", "Softmax"))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax probabilities; under autograd the backward is the fused
    cross-entropy gradient (see :class:`_SoftmaxOutput`)."""
    multi_output, preserve_shape = bool(multi_output), bool(preserve_shape)
    if not (torch.is_grad_enabled() and data.requires_grad):
        return _softmax_forward(data, multi_output, preserve_shape)
    attrs = dict(grad_scale=float(grad_scale),
                 ignore_label=float(ignore_label), multi_output=multi_output,
                 use_ignore=bool(use_ignore), preserve_shape=preserve_shape,
                 normalization=normalization,
                 smooth_alpha=float(smooth_alpha), dp=dp_group())
    return _SoftmaxOutput.apply(data, label, attrs)


@register(name="BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
          num_outputs=3, num_visible_outputs=1)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               __is_train__=False):
    """Outputs (out, mean, var). Training uses one-pass batch statistics
    (f32 sum and sum of squares, var = E[x²] - E[x]² clamped at 0, about a
    per-channel pivot for f32 inputs); inference, or
    ``use_global_stats``, the moving ones. (mean, var, gamma, beta) fold
    into one per-channel scale and shift in f32, cast to the data dtype."""
    ax = int(axis) % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.dim()))
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if __is_train__ and not use_global_stats:
        group, n = dp_group()
        for i in red:
            n *= data.shape[i]
        if data.dtype in (torch.bfloat16, torch.float16):
            pivot = None
            xf = data.float()
        else:
            # the pivot carries no gradient, as the JAX package's
            # stop_gradient has it: mean and var stay exact functions of
            # the data in autograd, without two cancelling terms through
            # the pivot sample (the global batch's first row: rank 0's)
            pivot = data[tuple(slice(0, 1) if i in red else slice(None)
                               for i in range(data.dim()))].detach().float()
            if group is not None:
                from ..parallel.mesh import broadcast_

                pivot = broadcast_(pivot.clone(), group)
            xf = data.float() - pivot
        s0, s1 = xf.sum(dim=red), (xf * xf).sum(dim=red)
        if group is not None:
            from ..parallel.mesh import all_reduce_autograd

            s0, s1 = all_reduce_autograd(torch.stack([s0, s1]), group)
        mean_c = s0 / n
        var = s1 / n - mean_c * mean_c
        var = torch.maximum(var, var.new_zeros(()))
        mean = mean_c if pivot is None else mean_c + pivot.reshape(
            mean_c.shape)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var.float() + eps)
    scale = (inv * g.float()).to(data.dtype)
    shift = (beta.float() - mean.float() * inv * g.float()).to(data.dtype)
    out = data * scale.reshape(bshape) + shift.reshape(bshape)
    return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)


@register(name="LayerNorm", aliases=("layer_norm",), num_outputs=3,
          num_visible_outputs=1)
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Outputs (out, mean, var) over ``axis``: ``(x - mean) * rsqrt(var +
    eps) * gamma + beta`` with the biased variance; mean and var have
    ``axis`` squeezed."""
    ax = int(axis)
    var, mean = torch.var_mean(data, dim=ax, correction=0, keepdim=True)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    return out, mean.squeeze(ax), var.squeeze(ax)
