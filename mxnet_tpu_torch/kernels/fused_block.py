"""Fused ResNet bottleneck block, inference half (counterpart of
``mxnet_tpu/kernels/fused_block.py``).

:func:`conv_fwd` is B1, the NHWC convolution whose input read applies a
folded BatchNorm and ReLU (the prologue) and whose output write can also
return the per-channel ``[sum, sum of squares]`` of the stored output (the
stats epilogue). On a CUDA tensor it launches the hand-written kernel
``csrc/fused_conv_fwd.cu`` (built at first use, see ``_build``) and adds
one to ``conv_fwd.launches``; on a CPU tensor it runs
:func:`conv_fwd_reference`, the plain PyTorch version. There is no
fallback: a build or launch failure on a CUDA tensor raises. On a ``meta``
tensor (shape inference) it only allocates the outputs.

:func:`bottleneck_infer` composes B1 into the pre-activation bottleneck
unit on the moving statistics. Layout: x NHWC, weights HWIO, as in the JAX
package. The TPU's blocking plan (``_plan_conv``, ``_batch_fold``,
``_chan_block``, ``MXU_WORK_FLOOR``, ``mxu_plan``, the schedule-table
consult and the row-tile knob) has no counterpart: the CUDA kernel takes
its own tiles. The training unit (``bottleneck_train``, kernels B2/B3) is
not ported yet.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, w, stride, prologue):
    if x.dim() != 4 or w.dim() != 4:
        raise MXNetError("conv_fwd: x must be (N, H, W, Ci) and w (k, k, Ci, "
                         "Co), got %s and %s" % (tuple(x.shape),
                                                 tuple(w.shape)))
    k, ci = int(w.shape[0]), int(x.shape[3])
    if k not in (1, 3) or w.shape[1] != k or w.shape[2] != ci:
        raise MXNetError("conv_fwd: w %s does not fit x %s (k in {1, 3}, "
                         "HWIO)" % (tuple(w.shape), tuple(x.shape)))
    if stride not in (1, 2):
        raise MXNetError("conv_fwd: stride must be 1 or 2, got %r" % stride)
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise MXNetError("conv_fwd: x and w must share one dtype of "
                         "float32/bfloat16, got %s and %s" % (x.dtype,
                                                              w.dtype))
    if x.device != w.device:
        raise MXNetError("conv_fwd: x on %s, w on %s" % (x.device, w.device))
    h, wd = int(x.shape[1]), int(x.shape[2])
    if stride == 2 and (h % 2 or wd % 2):
        # the message of the JAX package's conv_fwd
        raise ValueError(
            "fused conv: stride-2 requires even spatial dims, got "
            "(%d, %d)" % (h, wd))
    if prologue is not None:
        scale, bias, _relu = prologue
        for name, v in (("scale", scale), ("bias", bias)):
            if tuple(v.shape) != (ci,) or v.device != x.device:
                raise MXNetError("conv_fwd: prologue %s must be (%d,) on %s, "
                                 "got %s on %s" % (name, ci, x.device,
                                                   tuple(v.shape), v.device))


def _apply_prologue(x, prologue):
    """BN-apply (+ ReLU) in f32, cast to x's dtype (``_apply_prologue``)."""
    if prologue is None:
        return x
    scale, bias, relu = prologue
    h = x.float() * scale.float() + bias.float()
    if relu:
        h = torch.clamp_min(h, 0.0)
    return h.to(x.dtype)


def conv_fwd_reference(x, w, *, stride=1, prologue=None, emit_stats=False):
    """The plain version of :func:`conv_fwd`: the prologue, then a zero pad
    of ``k // 2``, ``F.conv2d``, a cast to x's dtype, and the fp32 sums of
    the cast output. Returns ``(y, stats or None)``."""
    k = int(w.shape[0])
    h = _apply_prologue(x, prologue).permute(0, 3, 1, 2)
    y = F.conv2d(h, w.permute(3, 2, 0, 1), stride=stride, padding=k // 2)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    if not emit_stats:
        return y, None
    yf = y.float()
    return y, torch.stack([yf.sum(dim=(0, 1, 2)),
                           (yf * yf).sum(dim=(0, 1, 2))])


def _launch(x, w, prologue, y, stats, stride):
    from ._build import load

    n, h, wd, ci = x.shape
    k, co = int(w.shape[0]), int(w.shape[3])
    dev = x.device
    lib = load("fused_conv_fwd")
    fn = lib.fused_conv_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p] \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    scale = bias = partial = None
    relu = tiles = 0
    if prologue is not None:
        scale = prologue[0].to(torch.float32).contiguous()
        bias = prologue[1].to(torch.float32).contiguous()
        relu = int(bool(prologue[2]))
    if stats is not None:
        # one partial row per pixel tile; the kernel gives its tile size
        tile_m = lib.fused_conv_fwd_tile_m()
        tiles = -(-(n * (h // stride) * (wd // stride)) // tile_m)
        partial = torch.empty((tiles, 2, co), dtype=torch.float32,
                              device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr(x), ptr(w), ptr(scale), ptr(bias), ptr(y),
                 ptr(partial), tiles, ptr(stats), n, h, wd, ci, co, k,
                 stride, int(prologue is not None), relu, _DTYPES[x.dtype],
                 stream)
    if err != 0:
        raise MXNetError("fused_conv_fwd launch failed: CUDA error %d" % err)


def conv_fwd(x, w, *, stride=1, prologue=None, emit_stats=False):
    """NHWC conv: ``y = conv(act(bn(x)), w)`` (B1).

    x: (N, H, W, Ci); w: (k, k, Ci, Co) HWIO with k in {1, 3} (pad k // 2);
    stride 1 or 2 (2 needs even H and W, else ``ValueError``); prologue:
    None or ``(scale, bias, relu)`` with (Ci,) vectors, the folded BN apply
    (f32 math, cast to x's dtype before the product); emit_stats: also
    return the (2, Co) f32 ``[sum, sum_sq]`` of the stored (dtype-cast)
    output. Returns ``(y, stats or None)``. On a CUDA tensor this launches
    the kernel (float32 or bfloat16) and adds one to ``conv_fwd.launches``;
    a non-contiguous x or w is copied to a contiguous one first."""
    stride = int(stride)
    _check(x, w, stride, prologue)
    if x.device.type == "cpu":
        return conv_fwd_reference(x, w, stride=stride, prologue=prologue,
                                  emit_stats=emit_stats)
    n, h, wd, _ci = x.shape
    co = int(w.shape[3])
    y = torch.empty((n, h // stride, wd // stride, co), dtype=x.dtype,
                    device=x.device)
    stats = torch.empty((2, co), dtype=torch.float32, device=x.device) \
        if emit_stats else None
    if x.device.type == "meta":
        return y, stats
    if x.device.type != "cuda":
        raise MXNetError("conv_fwd: unsupported device %s" % x.device)
    _launch(x.contiguous(), w.contiguous(), prologue, y, stats, stride)
    conv_fwd.launches += 1
    return y, stats


conv_fwd.launches = 0


def _bn_consts(gamma, beta, mean, inv):
    """Fold (gamma, beta, mean, inv_sigma) into apply (scale, bias), f32."""
    scale = gamma.float() * inv
    bias = beta.float() - mean * scale
    return scale, bias


def bottleneck_infer(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
                     mm1, mv1, mm2, mv2, mm3, mv3, *, stride, eps):
    """Inference mode of the pre-activation bottleneck unit: the BN applies
    use the moving statistics. data NHWC, weights HWIO (``wsc`` None for a
    dim-match unit, whose shortcut is ``data``). Three B1 launches, four
    with the downsample shortcut."""
    def consts(gm, bt, mm, mv):
        inv = torch.rsqrt(mv.float() + eps)
        return _bn_consts(gm, bt, mm.float(), inv) + (True,)

    data = data.contiguous()   # read by conv1 and by the shortcut
    p1 = consts(g1, b1, mm1, mv1)
    y1, _ = conv_fwd(data, w1, stride=1, prologue=p1)
    y2, _ = conv_fwd(y1, w2, stride=stride, prologue=consts(g2, b2, mm2, mv2))
    y3, _ = conv_fwd(y2, w3, stride=1, prologue=consts(g3, b3, mm3, mv3))
    if wsc is None:
        shortcut = data
    else:
        shortcut, _ = conv_fwd(data, wsc, stride=stride, prologue=p1)
    return y3 + shortcut


def bottleneck_train(*_args, **_kwargs):
    """The training unit (``_unit_fwd``/``_unit_bwd`` with kernels B2 and
    B3 under a custom VJP) is the next slice of the port."""
    raise MXNetError("fused_block.bottleneck_train is not ported yet "
                     "(training slice: B2 conv_wgrad, B3 conv_dgrad)")
