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

import math

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
    if pooling_convention not in ("valid", "full"):
        raise MXNetError("Pooling: unknown pooling_convention %r"
                         % (pooling_convention,))
    kernel = _tuple(kernel, nd)
    stride = _tuple(stride, nd) if stride else (1,) * nd
    pad = _tuple(pad, nd) if pad else (0,) * nd
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %r" % pool_type)
    pads = [(p, p) for p in pad]
    if pooling_convention == "full":
        # ceil-mode output: the high side padded until every input element
        # is covered (the reference's reduce_window pads)
        for i in range(nd):
            size = data.shape[2 + i]
            out_sz = math.ceil((size + 2 * pad[i] - kernel[i])
                               / stride[i]) + 1
            needed = (out_sz - 1) * stride[i] + kernel[i] - size - pad[i]
            pads[i] = (pad[i], max(needed, pad[i]))
    # pad explicitly, as the reference's reduce_window does: torch's pools
    # refuse a pad above half the kernel
    if any(lo or hi for lo, hi in pads):
        data = F.pad(data, [v for lo_hi in reversed(pads) for v in lo_hi],
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
    from .tensor import _norm_axis, _refuse_batch_axis

    ax = int(axis)
    _refuse_batch_axis("LayerNorm", _norm_axis(ax, data.dim()), data.dim())
    var, mean = torch.var_mean(data, dim=ax, correction=0, keepdim=True)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)
    return out, mean.squeeze(ax), var.squeeze(ax)


# ---------------------------------------------------------------------------
# per-sample activations and normalizations
# ---------------------------------------------------------------------------
@register(name="LeakyReLU", aliases=("leaky_relu",), needs_rng=True)
def leaky_relu(gen, data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, __is_train__=False):
    """leaky, prelu (``gamma`` per channel), elu, selu, exact gelu and
    rrelu: a training forward draws each element's slope from
    U[lower_bound, upper_bound), inference uses their mean."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data > 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        lo, hi = float(lower_bound), float(upper_bound)
        if __is_train__:
            s = torch.empty(data.shape, dtype=torch.float32,
                            device=data.device).uniform_(
                                lo, hi, generator=gen).to(data.dtype)
        else:
            s = data.new_full((), (lo + hi) / 2.0)
        return torch.where(data > 0, data, s * data)
    raise MXNetError("unknown act_type %r" % act_type)


@register(name="InstanceNorm", aliases=("instance_norm",))
def instance_norm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register(name="L2Normalization", aliases=("l2_normalization",))
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data**2) + eps)`` over each sample
    (``instance``), each position's channels (``channel``) or each
    channel's positions (``spatial``)."""
    if mode == "instance":
        norm = torch.sqrt(data.reshape(data.shape[0], -1).square()
                          .sum(dim=1) + eps)
        return data / norm.reshape((-1,) + (1,) * (data.dim() - 1))
    if mode == "channel":
        return data / torch.sqrt(data.square().sum(dim=1, keepdim=True)
                                 + eps)
    if mode == "spatial":
        red = tuple(range(2, data.dim()))
        return data / torch.sqrt(data.square().sum(dim=red, keepdim=True)
                                 + eps)
    raise MXNetError("L2Normalization: unknown mode %r" % (mode,))


@register(name="LRN", aliases=("lrn",))
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response norm across channels: the squares summed over a
    window of ``nsize`` channels, ``nsize // 2`` zero channels padded on
    each side (the reference's window, an even ``nsize`` included)."""
    nsize = int(nsize)
    half = nsize // 2
    padded = F.pad(data.square(), (0, 0, 0, 0, half, half))
    window = sum(padded[:, i:i + data.shape[1]] for i in range(nsize))
    return data * torch.pow(knorm + alpha / nsize * window, -beta)


@register(name="SoftmaxActivation", aliases=("softmax_activation",))
def softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register(name="BlockGrad", aliases=("block_grad", "stop_gradient"))
def block_grad(data):
    return data.detach()


@register(name="IdentityAttachKLSparseReg",
          aliases=("identity_attach_kl_sparse_reg",))
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity, as in the reference (its sparseness penalty is not
    applied there either)."""
    return data


@register(name="Dropout", aliases=("dropout",), needs_rng=True,
          num_outputs=2, num_visible_outputs=1)
def dropout(gen, data, p=0.5, mode="training", axes=(),
            __is_train__=False):
    """Outputs (out, mask): in training (or ``mode="always"``) a keep mask
    of probability ``1 - p``, shared along ``axes``, scaled by
    ``1 / (1 - p)``; otherwise the identity and ones. The mask of axis 0
    is the batch's, so ``axes`` holding 0 raises under a data-parallel
    mesh (each rank would draw its own)."""
    if (not __is_train__ and mode != "always") or p <= 0.0:
        return data, torch.ones_like(data)
    shape = list(data.shape)
    for ax in axes or ():
        shape[int(ax)] = 1
    if axes:
        from .tensor import _norm_axis, _refuse_batch_axis

        _refuse_batch_axis("Dropout(axes=%s)" % (tuple(axes),),
                           _norm_axis(tuple(axes), data.dim()), data.dim())
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device) \
        .bernoulli_(keep, generator=gen) / keep
    return data * mask, mask.expand(data.shape)


# ---------------------------------------------------------------------------
# loss heads: forward as given, backward the loss gradient (the reference's
# custom_vjp), whatever gradient reaches the output
# ---------------------------------------------------------------------------
class _MakeLoss(torch.autograd.Function):
    """Forward: the identity (with the count of elements above
    ``valid_thresh`` for ``valid``). Backward: a constant ``grad_scale``,
    divided by the global batch (``batch``) or the global count, at least
    1 (``valid``)."""

    @staticmethod
    def forward(ctx, data, attrs):
        ctx.attrs = attrs
        ctx.valid = None
        if attrs["normalization"] == "valid":
            count = (data > attrs["valid_thresh"]).sum().to(torch.float32)
            group = attrs["dp"][0]
            if group is not None:
                from ..parallel.mesh import all_reduce_

                count = all_reduce_(count, group)
            ctx.valid = torch.clamp_min(count, 1.0)
        return data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a = ctx.attrs
        scale = a["grad_scale"]
        if a["normalization"] == "batch":
            scale = scale / (g.shape[0] * a["dp"][1])
        grad = torch.full(g.shape, scale, dtype=g.dtype, device=g.device)
        if ctx.valid is not None:
            grad = grad / ctx.valid.to(g.dtype)
        return grad, None


@register(name="make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Loss head: forward the identity, backward ``grad_scale`` everywhere,
    divided by the batch (``batch``) or by the count of elements above
    ``valid_thresh`` (``valid``); under a data-parallel mesh the global
    batch and count."""
    if normalization not in ("null", "batch", "valid"):
        raise MXNetError("make_loss: unknown normalization %r"
                         % (normalization,))
    if not (torch.is_grad_enabled() and data.requires_grad):
        return data
    attrs = dict(grad_scale=float(grad_scale),
                 valid_thresh=float(valid_thresh),
                 normalization=normalization, dp=dp_group())
    return _MakeLoss.apply(data, attrs)


class _RegressionOutput(torch.autograd.Function):
    """Forward: ``data`` (``sigmoid(data)`` for logistic). Backward:
    ``(out - label) * grad_scale`` (``sign`` of it for mae) per element;
    the label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        ctx.kind, ctx.grad_scale = kind, grad_scale
        ctx.save_for_backward(data, label)
        return torch.sigmoid(data) if kind == "logistic" \
            else data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _g):
        data, label = ctx.saved_tensors
        lab = label.reshape(data.shape)
        if ctx.kind == "linear":
            grad = data - lab
        elif ctx.kind == "mae":
            grad = torch.sign(data - lab)
        else:
            grad = torch.sigmoid(data) - lab
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad * ctx.grad_scale, dlabel, None, None


def _regression_output(data, label, grad_scale, kind):
    if not (torch.is_grad_enabled() and data.requires_grad):
        return torch.sigmoid(data) if kind == "logistic" else data
    return _RegressionOutput.apply(data, label, kind, float(grad_scale))


@register(name="LinearRegressionOutput",
          aliases=("linear_regression_output",))
def linear_regression_output(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, "linear")


@register(name="MAERegressionOutput", aliases=("mae_regression_output",))
def mae_regression_output(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, "mae")


@register(name="LogisticRegressionOutput",
          aliases=("logistic_regression_output",))
def logistic_regression_output(data, label, grad_scale=1.0):
    return _regression_output(data, label, grad_scale, "logistic")


class _SVMOutput(torch.autograd.Function):
    """Forward: the scores. Backward: the hinge gradient of each wrong
    class whose margin ``margin - (score[label] - score)`` is positive
    (``regularization_coefficient`` for L1, twice it times the margin for
    L2), and minus their sum on the label's class."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.margin, ctx.reg, ctx.use_linear = margin, reg, use_linear
        ctx.save_for_backward(data, label)
        return data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _g):
        d, label = ctx.saved_tensors
        lab = label.long()
        onehot = F.one_hot(lab, d.shape[1]).to(d.dtype)
        gap = ctx.margin - (d.gather(1, lab[:, None]) - d)
        viol = (gap > 0) & (onehot == 0)
        if ctx.use_linear:
            wrong = torch.where(viol, ctx.reg, 0.0).to(d.dtype)
        else:
            wrong = torch.where(viol, 2 * ctx.reg * gap, 0.0).to(d.dtype)
        right = -wrong.sum(dim=1, keepdim=True) * onehot
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return wrong * (1 - onehot) + right, dlabel, None, None, None


@register(name="SVMOutput", aliases=("svm_output",))
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    if not (torch.is_grad_enabled() and data.requires_grad):
        return data
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


@register(name="softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """``-sum(log_softmax(data)[label])`` over the rows: a sum over the
    batch, so it raises under a data-parallel mesh."""
    from .tensor import _refuse_batch_axis

    _refuse_batch_axis("softmax_cross_entropy", (0,), data.dim())
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long()[:, None]).sum()


# ---------------------------------------------------------------------------
# spatial ops
# ---------------------------------------------------------------------------
@register(name="Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=1,
                  num_group=1, workspace=1024, no_bias=True,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution, weight ``(in, out / num_group, *kernel)``:
    the output of the full transposed convolution (no pad) from ``pad``
    on, ``(in - 1) * stride + dilated kernel - 2 * pad + adj`` long, zeros
    past its end (the reference's ``(k - 1 - p, k - 1 - p + a)`` pads of
    the dilated input; ``target_shape`` is accepted and unused there
    too)."""
    nd = len(kernel) if kernel else 2
    stride = _tuple(stride, nd)
    pad = _tuple(pad, nd) if pad else (0,) * nd
    dilate = _tuple(dilate, nd) if dilate else (1,) * nd
    adj = _tuple(adj, nd) if adj else (0,) * nd
    full = getattr(F, "conv_transpose%dd" % nd)(
        data, weight, stride=stride, dilation=dilate,
        groups=int(num_group))
    out = full
    for i in range(nd):
        size = full.shape[2 + i]
        length = size - 2 * pad[i] + adj[i]
        out = out.narrow(2 + i, pad[i], min(length, size - pad[i]))
        if length > size - pad[i]:
            widths = [0, 0] * (nd - 1 - i) + [0, length - (size - pad[i])]
            out = F.pad(out, widths)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@register(name="UpSampling", aliases=("up_sampling",))
def upsampling(*args, scale=1, num_filter=0, sample_type="nearest",
               multi_input_mode="concat", num_args=1, workspace=512):
    """``nearest``: each input repeated to ``scale`` times the largest
    input's height (one input: ``scale`` times its own), then concatenated
    on the channels or summed. ``bilinear``: the data resized ``scale``
    times with half-pixel centres (``jax.image.resize``'s rule); the
    weight input is accepted and unused (its gradient is zero)."""
    s = int(scale)
    if sample_type == "nearest":
        h = max(a.shape[2] for a in args) * s // (s if len(args) == 1
                                                 else 1)
        outs = []
        for a in args:
            factor = s if len(args) == 1 else h // a.shape[2]
            outs.append(a.repeat_interleave(factor, dim=2)
                        .repeat_interleave(factor, dim=3))
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            return sum(outs)
        return torch.cat(outs, dim=1)
    if sample_type == "bilinear":
        data = args[0]
        return F.interpolate(data, size=(data.shape[2] * s,
                                         data.shape[3] * s),
                             mode="bilinear", align_corners=False)
    raise MXNetError("UpSampling: unknown sample_type %r" % (sample_type,))


@register(name="Crop", aliases=("crop",))
def crop(*args, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """A window of ``data``: the second input's height and width, or
    ``h_w``, at ``offset`` or centred."""
    data = args[0]
    if len(args) == 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy, ox = (data.shape[2] - th) // 2, (data.shape[3] - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# ---------------------------------------------------------------------------
# sampling ops (legacy vision)
# ---------------------------------------------------------------------------
@register(name="GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """``affine``: the (x, y) sampling grid in [-1, 1] of the ``(N, 6)``
    affine transforms over ``target_shape``. ``warp``: the flow ``(N, 2,
    H, W)`` added to the pixel grid, normalized to [-1, 1]."""
    if transform_type == "affine":
        th, tw = int(target_shape[0]), int(target_shape[1])
        kw = dict(dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(torch.linspace(-1, 1, th, **kw),
                                torch.linspace(-1, 1, tw, **kw),
                                indexing="ij")
        grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(th * tw, **kw)])
        return torch.matmul(data.reshape(-1, 2, 3), grid) \
            .reshape(-1, 2, th, tw)
    _n, _, h, w = data.shape
    kw = dict(dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(torch.arange(h, **kw), torch.arange(w, **kw),
                            indexing="ij")
    x = (data[:, 0] + gx) * 2 / max(w - 1, 1) - 1
    y = (data[:, 1] + gy) * 2 / max(h - 1, 1) - 1
    return torch.stack([x, y], dim=1)


@register(name="BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid, cudnn_off=False):
    """``data`` sampled at ``grid``'s (x, y) in [-1, 1]: the four
    neighbours' bilinear mix, a neighbour outside the image counting 0."""
    n, _c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    rows = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(xi, yi):
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        valid = (xi >= -0.0001) & (xi <= w - 0.9999) & (yi >= -0.0001) \
            & (yi <= h - 0.9999)
        return data[rows, :, yc, xc] * valid[..., None].to(data.dtype)

    out = gather(x0, y0) * (wx0 * wy0)[..., None] \
        + gather(x1, y0) * (wx1 * wy0)[..., None] \
        + gather(x0, y1) * (wx0 * wy1)[..., None] \
        + gather(x1, y1) * (wx1 * wy1)[..., None]
    return out.permute(0, 3, 1, 2)


@register(name="SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    return bilinear_sampler(data, grid_generator(
        loc, transform_type="affine", target_shape=target_shape))


@register(name="Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """The cost volume: for each displacement (dy, dx) in steps of
    ``stride2`` up to ``max_displacement``, the channel mean of ``data1``
    times (or minus, in absolute value) ``data2`` shifted by it. The shift
    wraps around inside the padded frame (the reference's ``jnp.roll``);
    ``kernel_size`` and ``stride1`` are unused there too."""
    pad, d, s2 = int(pad_size), int(max_displacement), int(stride2)
    a = F.pad(data1, (pad, pad, pad, pad))
    b = F.pad(data2, (pad, pad, pad, pad))
    _n, _c, h, w = data1.shape
    maps = []
    for dy in range(-d, d + 1, s2):
        for dx in range(-d, d + 1, s2):
            shifted = torch.roll(b, shifts=(-dy, -dx), dims=(2, 3))
            prod = a * shifted if is_multiply else (a - shifted).abs()
            maps.append(prod.mean(dim=1)[:, pad:pad + h, pad:pad + w])
    return torch.stack(maps, dim=1)
