"""Fused ResNet bottleneck block (counterpart of
``mxnet_tpu/kernels/fused_block.py``).

:func:`conv_fwd` is B1, the NHWC convolution whose input read applies a
folded BatchNorm and ReLU (the prologue) and whose output write can also
return the per-channel ``[sum, sum of squares]`` of the stored output (the
stats epilogue). On a CUDA tensor it launches the hand-written kernel
``csrc/fused_conv_fwd.cu`` (built at first use, see ``_build``) and adds
one to ``conv_fwd.launches``: in bfloat16 on the tensor cores (wgmma fed
by TMA, so x and w must be 16-byte aligned), in float32 on the CUDA
cores. A bfloat16 shape whose rows TMA cannot load (Ci or Co not a
multiple of 8) goes, by that shape, to the CUDA-core kernel and also adds
one to ``conv_fwd.core_route_launches``. On a CPU tensor it runs
:func:`conv_fwd_reference`, the plain PyTorch version. There is no
fallback: a build or launch failure on a CUDA tensor raises. On a ``meta``
tensor (shape inference) it only allocates the outputs.

:func:`bottleneck_infer` composes B1 into the pre-activation bottleneck
unit on the moving statistics. Layout: x NHWC, weights HWIO, as in the JAX
package. The TPU's blocking plan (``_plan_conv``, ``_batch_fold``,
``MXU_WORK_FLOOR``, ``mxu_plan``) has no counterpart: the CUDA kernels
take their own tiles. What the schedule table tunes is each kernel's tile
as a launch parameter, under the JAX package's knob names: ``chan_block``
(B1's output channels and B3's input channels a CTA, 64 or 128 on the
tensor cores) and ``row_tile`` (B2's pixel boxes a chunk on the tensor
cores). The CUDA-core route keeps one tile (``chan_block`` 64). Left
None, ``schedule`` is looked up with ``tune.schedule_for("fused_" + kind,
(n, h, w, ci, co, k, stride), dtype)`` as the JAX ``_schedule_knobs``
does; a table entry that does not fit the shape counts a
``fallback_illegal`` and runs the hand default, and an explicit schedule
that does not fit raises (:func:`schedule_legal`, :func:`default_schedule`).
The plain versions take the same schedule: output-channel blocks (B1),
input-channel blocks (B3) and the pixel chunks' partial sums in chunk
order (B2). The JAX package's row-tile knob (``MXNET_TPU_FUSED_ROW_TILE``,
``set_row_tile``) counts output rows of an image a Pallas grid tile, which
no kernel here has: set, either raises by name (:func:`set_row_tile`),
pointing to ``row_tile`` and the schedule table.

The training half: :func:`conv_wgrad` is B2, the weight gradient with the
forward's prologue recomputed on the x side and the next BatchNorm's
backward rebuilding the g side (``csrc/fused_conv_wgrad.cu``);
:func:`conv_dgrad` is B3, the data gradient with the same g-side rebuild,
the input BatchNorm's relu mask and its (dbeta, dgamma) sums as the
epilogue, and the downsample shortcut's gradient as an optional ``extra``
term (``csrc/fused_conv_dgrad.cu``). They dispatch as :func:`conv_fwd`
does (a CUDA tensor launches and counts, a CPU tensor runs the plain
version, a ``meta`` tensor only allocates), and route by shape the same
way: bfloat16 whose channel counts are multiples of 8 runs on the tensor
cores, other bfloat16 shapes on the CUDA cores, counted also in
``conv_wgrad.core_route_launches`` and ``conv_dgrad.core_route_launches``. :func:`bottleneck_train` is
one ``torch.autograd.Function`` over them.

The data-parallel wrappers (the JAX ``shard_map`` ones, ``spmd_scope``,
``bottleneck_train_spmd``, ``bottleneck_infer_spmd``) run on one rank's
rows of the batch, one process a device (``parallel/mesh.py``): the
training unit all-reduces over the mesh's data axes where the JAX package
psums, the BatchNorm sums in the forward and, in the backward, the three
(dbeta, dgamma) sums and the weight gradients in f32 before their cast, so
its statistics and parameter gradients are the global batch's on every
rank and its data gradient is the rank's rows'. The inference unit needs
no collective.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch
import torch.nn.functional as F

from .. import config
from ..base import MXNetError
from ._build import count as _count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _need(cond, what, *args):
    if not cond:
        raise MXNetError(what % args)


def _check_tensor(fn, name, t, shape, dtype, device):
    _need(tuple(t.shape) == tuple(shape) and t.device == device
          and (dtype is None or t.dtype == dtype),
          "%s: %s must be %s%s on %s, got %s %s on %s", fn, name,
          tuple(shape), "" if dtype is None else " " + str(dtype), device,
          tuple(t.shape), t.dtype, t.device)


def _check_geometry(fn, x_shape, w_shape, stride):
    """The conv's output shape (N, Ho, Wo, Co); raises on a geometry the
    kernels do not take."""
    _need(len(x_shape) == 4 and len(w_shape) == 4,
          "%s: x must be (N, H, W, Ci) and w (k, k, Ci, Co), got %s and %s",
          fn, tuple(x_shape), tuple(w_shape))
    k = int(w_shape[0])
    _need(k in (1, 3) and w_shape[1] == k and w_shape[2] == x_shape[3],
          "%s: w %s does not fit x %s (k in {1, 3}, HWIO)", fn,
          tuple(w_shape), tuple(x_shape))
    _need(stride in (1, 2), "%s: stride must be 1 or 2, got %r", fn, stride)
    n, h, wd, _ci = x_shape
    if stride == 2 and (h % 2 or wd % 2):
        # the message of the JAX package's conv_fwd
        raise ValueError("fused conv: stride-2 requires even spatial dims, "
                         "got (%d, %d)" % (h, wd))
    return (int(n), int(h) // stride, int(wd) // stride, int(w_shape[3]))


def _check_prologue(fn, prologue, x):
    if prologue is not None:
        for name, v in zip(("scale", "bias"), prologue[:2]):
            _check_tensor(fn, "prologue " + name, v, x.shape[3:], None,
                          x.device)


def _check(x, w, stride, prologue):
    _check_geometry("conv_fwd", tuple(x.shape), tuple(w.shape), stride)
    _need(x.dtype == w.dtype and x.dtype in _DTYPES, "conv_fwd: x and w must "
          "share one dtype of float32/bfloat16, got %s and %s", x.dtype,
          w.dtype)
    _need(x.device == w.device, "conv_fwd: x on %s, w on %s", x.device,
          w.device)
    _check_prologue("conv_fwd", prologue, x)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bind(lib, name, argtypes, restype=ctypes.c_int):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = restype
        fn.argtypes = argtypes
    return fn


def _prologue_args(prologue):
    """``(scale, bias, on, relu)`` of a prologue for a kernel's C call."""
    if prologue is None:
        return None, None, 0, 0
    scale, bias = (v.to(torch.float32).contiguous() for v in prologue[:2])
    return scale, bias, 1, int(bool(prologue[2]))


def _apply_prologue(x, prologue):
    """BN-apply (+ ReLU) in f32, cast to x's dtype (``_apply_prologue``)."""
    if prologue is None:
        return x
    scale, bias, relu = prologue
    h = x.float() * scale.float() + bias.float()
    if relu:
        h = torch.clamp_min(h, 0.0)
    return h.to(x.dtype)


def _blocks_of(schedule, name, total):
    """Slices of ``total`` channels in blocks of the schedule's ``name``
    (one slice without it)."""
    step = int((schedule or {}).get(name, 0)) or total
    return [slice(c, min(c + step, total)) for c in range(0, total, step)]


def conv_fwd_reference(x, w, *, stride=1, prologue=None, emit_stats=False,
                       schedule=None):
    """The plain version of :func:`conv_fwd`: the prologue, then a zero pad
    of ``k // 2``, ``F.conv2d``, a cast to x's dtype, and the fp32 sums of
    the cast output. With a ``chan_block`` schedule the products run one
    block of output channels at a time, as the kernel's CTAs do. Returns
    ``(y, stats or None)``."""
    k = int(w.shape[0])
    h = _apply_prologue(x, prologue).permute(0, 3, 1, 2)
    wt = w.permute(3, 2, 0, 1)
    y = torch.cat([F.conv2d(h, wt[c], stride=stride, padding=k // 2)
                   for c in _blocks_of(schedule, "chan_block",
                                       int(w.shape[3]))], dim=1)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    if not emit_stats:
        return y, None
    yf = y.float()
    return y, torch.stack([yf.sum(dim=(0, 1, 2)),
                           (yf * yf).sum(dim=(0, 1, 2))])


def _tensor_cores(x, w):
    """Whether B1 runs on the tensor cores: bfloat16 whose rows TMA can
    load (Ci and Co multiples of 8, 16-byte rows)."""
    return x.dtype == torch.bfloat16 and x.shape[3] % 8 == 0 \
        and w.shape[3] % 8 == 0


def _kind(dtype, tensor_cores):
    """The C entry points' kernel kind: float32, bfloat16 on the CUDA
    cores, bfloat16 on the tensor cores."""
    return 2 if tensor_cores else _DTYPES[dtype]


def _need_aligned(fn, tensors):
    """The tensor-core kernels load their bf16 operands with TMA, which
    needs 16-byte aligned bases: raise on any other."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise MXNetError("%s: bfloat16 operands must start on a 16-byte "
                         "boundary (the tensor-core kernel loads them with "
                         "TMA)" % fn)


# ---------------------------------------------------------------------------
# the kernels' tiles as launch parameters: geometry, legality and the
# schedule-table consult
# ---------------------------------------------------------------------------
FUSED_KINDS = ("fwd", "wgrad", "dgrad")
CHAN_BLOCKS = (64, 128)
_WGRAD_CTAS_PER_SM = 2       # fused_conv_wgrad.cu kTcCtasPerSm
_SMS = 132
_PARTIAL_LIMIT = 256 << 20   # bytes of B2's f32 partials


def _cdiv(a, b):
    return -(-a // b)


def pick_box(n, ho, wo):
    """The pixel box ``(bw, bh, bn)`` of the tensor-core kernels
    (``conv_common.cuh`` ``pick_box``): bw * bh * bn = 64 powers of two,
    the one that pads (n, ho, wo) least, ties to the widest bw."""
    best = None
    for lw in range(6, -1, -1):
        for lh in range(6 - lw, -1, -1):
            a, b, c = 1 << lw, 1 << lh, 64 >> (lw + lh)
            padded = _cdiv(wo, a) * a * _cdiv(ho, b) * b * _cdiv(n, c) * c
            if best is None or padded < best[0]:
                best = (padded, a, b, c)
    return best[1:]


def pixel_boxes(n, ho, wo):
    """The number of pixel boxes over (n, ho, wo) (``box_grid``)."""
    bw, bh, bn = pick_box(n, ho, wo)
    return _cdiv(wo, bw) * _cdiv(ho, bh) * _cdiv(n, bn)


def wgrad_split(n, h, wd, ci, co, k, stride, row_tile=0):
    """``(boxes, row_tile, chunks)`` of B2 on the tensor cores
    (``fused_conv_wgrad.cu`` ``tc_shape``): the output's pixel boxes, the
    boxes a chunk (``row_tile``, or at 0 the hand default: chunks enough
    that the grid covers the SMs twice, the f32 partials under 256 MB)
    and the chunk count; None where the split is out of range."""
    ho, wo = h // stride, wd // stride
    boxes = pixel_boxes(n, ho, wo)
    ctas = _cdiv(ci, 64) * k * _cdiv(co, 64)
    dw_bytes = 4 * k * k * ci * co
    if row_tile < 0 or row_tile > boxes:
        return None
    if row_tile == 0:
        want = _cdiv(_SMS * _WGRAD_CTAS_PER_SM, ctas)
        c = min(want, _PARTIAL_LIMIT // dw_bytes, boxes)
        row_tile = _cdiv(boxes, max(c, 1))
    chunks = _cdiv(boxes, row_tile)
    if chunks > 65535 or (chunks > 1 and chunks * dw_bytes > _PARTIAL_LIMIT):
        return None
    return boxes, row_tile, chunks


def _route_tc(kind, dtype, ci, co, co2=0):
    """Whether the kernel of ``kind`` runs on the tensor cores at these
    channels (bfloat16 with channel counts multiples of 8)."""
    return (dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0
            and co2 % 8 == 0)


def default_schedule(kind, x_shape, w_shape, stride, dtype):
    """The hand default tile of ``kind`` at these shapes, as a schedule:
    ``chan_block`` 128 where it divides the channels on the tensor cores
    (B1: Co, B3: Ci), else 64; B2 on the tensor cores its default
    ``row_tile``, on the CUDA cores ``chan_block`` 64."""
    n, h, wd, ci = (int(v) for v in x_shape)
    k, co = int(w_shape[0]), int(w_shape[3])
    tc = _route_tc(kind, dtype, ci, co)
    if kind == "wgrad":
        if not tc:
            return {"chan_block": 64}
        split = wgrad_split(n, h, wd, ci, co, k, stride)
        if split is None:
            raise MXNetError("fused_wgrad takes no shapes x %s, w %s"
                             % (tuple(x_shape), tuple(w_shape)))
        return {"row_tile": split[1]}
    cdim = co if kind == "fwd" else ci
    return {"chan_block": 128 if tc and cdim % 128 == 0 else 64}


def schedule_legal(kind, x_shape, w_shape, stride, schedule, dtype, co2=0):
    """``(ok, reason)``: whether the kernel of ``kind`` takes ``schedule``
    at these shapes. B1 (``fwd``) and B3 (``dgrad``) take ``chan_block``
    64, or 128 on the tensor cores where the channels (B1: Co, B3: Ci)
    pass 64; B2 (``wgrad``) takes ``row_tile`` on the tensor cores (1 to
    the box count, the chunks within the grid and the partials within
    256 MB) and ``chan_block`` 64 on the CUDA cores. Any other knob is
    not one of these kernels'. ``co2``: B3's extra term's channels (0
    without one), which also route B3."""
    if kind not in FUSED_KINDS:
        raise MXNetError("fused kind must be one of %s, got %r"
                         % (FUSED_KINDS, kind))
    n, h, wd, ci = (int(v) for v in x_shape)
    k, co = int(w_shape[0]), int(w_shape[3])
    tc = _route_tc(kind, dtype, ci, co, co2)
    if not isinstance(schedule, dict) or len(schedule) != 1:
        return False, "a schedule holds one knob, got %r" % (schedule,)
    (knob, value), = schedule.items()
    if kind == "wgrad" and tc:
        if knob != "row_tile":
            return False, "B2 on the tensor cores takes row_tile only"
        if wgrad_split(n, h, wd, ci, co, k, stride, int(value)) is None:
            return False, ("row_tile %r is out of range at these shapes"
                           % (value,))
        return True, ""
    if knob != "chan_block":
        return False, "%s takes chan_block only here, got %r" % (kind, knob)
    cdim = co if kind == "fwd" else ci
    if value == 64 or (tc and kind != "wgrad" and value == 128
                       and cdim > 64):
        return True, ""
    return False, ("chan_block %r does not fit %d channels on the %s"
                   % (value, cdim, "tensor cores" if tc else "CUDA cores"))


_ROW_TILE_MSG = (
    "%s: the JAX package's row tile (output rows of an image a Pallas grid "
    "tile) has no counterpart in the CUDA kernels; B2 takes row_tile (pixel "
    "boxes a chunk) as a launch parameter, from schedule={'row_tile': n} or "
    "the schedule table (mxnet_tpu_torch.tune)")


def set_row_tile(v):
    """The JAX package's module-wide row-tile setter: ``None`` (its
    default) is accepted, any value raises (the tile it sets does not
    exist here)."""
    if v is not None:
        raise MXNetError(_ROW_TILE_MSG % ("set_row_tile(%r)" % (v,)))


def _refuse_row_tile_knob():
    raw = config.get("MXNET_TPU_FUSED_ROW_TILE")
    if raw not in (None, ""):
        raise MXNetError(_ROW_TILE_MSG % ("MXNET_TPU_FUSED_ROW_TILE=%r"
                                          % raw))


def _resolve_schedule(kind, x_shape, w_shape, stride, dtype, device,
                      schedule, co2=0):
    """The schedule one call runs: an explicit ``schedule`` (which must be
    legal: an illegal one raises), else the table's entry for the key
    (illegal: a ``fallback_illegal`` is counted), else None (the kernels'
    hand default). ``MXNET_TPU_FUSED_ROW_TILE`` set raises."""
    _refuse_row_tile_knob()
    if schedule is not None:
        ok, why = schedule_legal(kind, x_shape, w_shape, stride, schedule,
                                 dtype, co2)
        if not ok:
            raise MXNetError("conv_%s schedule %r: %s" % (kind, schedule,
                                                          why))
        return dict(schedule)
    if device.type == "meta":
        return None
    from .. import profiler
    from ..tune import table

    n, h, wd, ci = (int(v) for v in x_shape)
    key_shape = (n, h, wd, ci, int(w_shape[3]), int(w_shape[0]), stride)
    dt, backend = table.dtype_name(dtype), table.backend_of(device)
    sched = table.schedule_for("fused_" + kind, key_shape, dt, backend)
    if sched is None:
        return None
    if not schedule_legal(kind, x_shape, w_shape, stride, sched, dtype,
                          co2)[0]:
        profiler.tuning_record(
            fallbacks=1, kernel=table.make_key("fused_" + kind, key_shape,
                                               dt, backend),
            schedule=None, source="fallback_illegal")
        return None
    return sched


def _knob(schedule, name):
    """A schedule's value of ``name`` for the C launch, 0 (the kernel's
    hand default) when absent."""
    return int((schedule or {}).get(name, 0))


def _launch(x, w, prologue, y, stats, stride, tensor_cores, schedule=None):
    from ._build import load

    n, h, wd, ci = x.shape
    k, co = int(w.shape[0]), int(w.shape[3])
    dev = x.device
    kind = _kind(x.dtype, tensor_cores)
    if tensor_cores:
        _need_aligned("conv_fwd", (x, w))
    lib = load("fused_conv_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _bind(lib, "fused_conv_fwd", [p] * 6 + [i, p] + [i] * 11 + [p])
    scale, bias, pro, relu = _prologue_args(prologue)
    chan_block = _knob(schedule, "chan_block")
    partial, tiles = None, 0
    if stats is not None:
        # one partial row per pixel tile of the kernel's own tiling
        tiles = _bind(lib, "fused_conv_fwd_tiles", [i] * 9,
                      ctypes.c_longlong)(n, h, wd, ci, co, k, stride, kind,
                                         chan_block)
        partial = torch.empty((max(tiles, 0), 2, co), dtype=torch.float32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr(x), _ptr(w), _ptr(scale), _ptr(bias), _ptr(y),
                 _ptr(partial), tiles, _ptr(stats), n, h, wd, ci, co, k,
                 stride, pro, relu, kind, chan_block, stream)
    if err != 0:
        raise MXNetError("fused_conv_fwd launch failed (schedule %s): CUDA "
                         "error %d" % (schedule, err))


def conv_fwd(x, w, *, stride=1, prologue=None, emit_stats=False,
             schedule=None):
    """NHWC conv: ``y = conv(act(bn(x)), w)`` (B1).

    x: (N, H, W, Ci); w: (k, k, Ci, Co) HWIO with k in {1, 3} (pad k // 2);
    stride 1 or 2 (2 needs even H and W, else ``ValueError``); prologue:
    None or ``(scale, bias, relu)`` with (Ci,) vectors, the folded BN apply
    (f32 math, cast to x's dtype before the product); emit_stats: also
    return the (2, Co) f32 ``[sum, sum_sq]`` of the stored (dtype-cast)
    output. Returns ``(y, stats or None)``. On a CUDA tensor this launches
    the kernel and adds one to ``conv_fwd.launches``: bfloat16 on the
    tensor cores, float32 on the CUDA cores, and a bfloat16 Ci or Co that
    is not a multiple of 8 on the CUDA cores too, counted also in
    ``conv_fwd.core_route_launches``. A non-contiguous x or w is copied to a
    contiguous one first. ``schedule``: the tile (``{"chan_block": 64 or
    128}``); None consults the schedule table (module docstring)."""
    stride = int(stride)
    _check(x, w, stride, prologue)
    schedule = _resolve_schedule("fwd", x.shape, w.shape, stride, x.dtype,
                                 x.device, schedule)
    if x.device.type == "cpu":
        return conv_fwd_reference(x, w, stride=stride, prologue=prologue,
                                  emit_stats=emit_stats, schedule=schedule)
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
    tensor_cores = _tensor_cores(x, w)
    _launch(x.contiguous(), w.contiguous(), prologue, y, stats, stride,
            tensor_cores, schedule)
    _count(conv_fwd)
    if x.dtype == torch.bfloat16 and not tensor_cores:
        _count(conv_fwd, "core_route_launches")
    return y, stats


conv_fwd.launches = 0
conv_fwd.core_route_launches = 0


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




# ---------------------------------------------------------------------------
# the training half: B2 conv_wgrad, B3 conv_dgrad and the bottleneck unit's
# forward and backward under one torch.autograd.Function
# ---------------------------------------------------------------------------
def _bnbwd_value(e, y_raw, consts):
    """dL/dy rebuilt from the relu-masked partial ``e`` of the BatchNorm
    after a conv and that conv's raw output ``y_raw``, in f32: with xhat =
    (y - mu) * inv_sigma, ``k * (e - m0 - xhat * m1)``. ``consts`` = (k =
    gamma * inv_sigma, mu, inv_sigma, m0 = mean(e), m1 = mean(e * xhat)),
    (C,) f32 each."""
    k, mu, inv, m0, m1 = consts
    xhat = (y_raw.float() - mu) * inv
    return k * (e.float() - m0 - xhat * m1)


def _g_value(g_parts, g_bnbwd):
    """The conv's output gradient in f32: given whole, or rebuilt."""
    if g_bnbwd is None:
        return g_parts.float()
    return _bnbwd_value(g_parts[0], g_parts[1],
                        [c.float() for c in g_bnbwd])


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _box_chunks(n, ho, wo, row_tile, device):
    """(chunks, n, ho, wo) bool: output pixel (i, y, x) in chunk c, the
    pixel boxes ``c * row_tile`` onward in box order (w fastest, then h,
    then n), as B2 splits them."""
    bw, bh, bn = pick_box(n, ho, wo)
    tw, th = _cdiv(wo, bw), _cdiv(ho, bh)
    box = ((torch.arange(n, device=device) // bn)[:, None, None] * th
           + (torch.arange(ho, device=device) // bh)[None, :, None]) * tw \
        + (torch.arange(wo, device=device) // bw)[None, None, :]
    chunk = box // row_tile
    n_chunks = _cdiv(tw * th * _cdiv(n, bn), row_tile)
    return chunk[None] == torch.arange(n_chunks, device=device)[:, None,
                                                                 None, None]


def conv_wgrad_reference(x, g_parts, w_shape, *, stride=1, x_prologue=None,
                         g_bnbwd=None, schedule=None):
    """The plain version of :func:`conv_wgrad`: the x side through the
    prologue and the g side (whole, or rebuilt) rounded to x's dtype as the
    kernel rounds them, then ``torch.nn.grad.conv2d_weight`` in f32 on those
    rounded operands. With a ``row_tile`` schedule, one such product per
    pixel chunk of B2's split, summed in chunk order as B2 sums its
    partials. Returns dw (k, k, Ci, Co) f32."""
    k = int(w_shape[0])
    h = _apply_prologue(x, x_prologue).float()
    g = _g_value(g_parts, g_bnbwd).to(x.dtype).float()
    size = (int(w_shape[3]), int(w_shape[2]), k, k)
    row_tile = int((schedule or {}).get("row_tile", 0))
    if not row_tile:
        dw = torch.nn.grad.conv2d_weight(_nchw(h), size, _nchw(g),
                                         stride=stride, padding=k // 2)
        return dw.permute(2, 3, 1, 0).contiguous()
    dw = torch.zeros(size, dtype=torch.float32, device=x.device)
    for mask in _box_chunks(*g.shape[:3], row_tile, x.device):
        dw = dw + torch.nn.grad.conv2d_weight(
            _nchw(h), size, _nchw(g * mask[..., None]), stride=stride,
            padding=k // 2)
    return dw.permute(2, 3, 1, 0).contiguous()


def conv_dgrad_reference(g_parts, w, x_shape, *, stride=1, g_bnbwd=None,
                         out_mask=None, extra=None, schedule=None):
    """The plain version of :func:`conv_dgrad`: the g side rounded to w's
    dtype, ``torch.nn.grad.conv2d_input`` in f32 on the rounded operands,
    the extra term likewise, the mask and the f32 sums of the unrounded
    e. With a ``chan_block`` schedule the products run one block of input
    channels at a time, as the kernel's CTAs do. Returns ``(e_out or dx in
    w's dtype, stats or None)``."""
    n, h, wd, ci = (int(v) for v in x_shape)
    k, dtype = int(w.shape[0]), w.dtype
    g = _g_value(g_parts, g_bnbwd).to(dtype).float()
    wt = w.float().permute(3, 2, 0, 1)
    parts = []
    for c in _blocks_of(schedule, "chan_block", ci):
        size = (n, c.stop - c.start, h, wd)
        t = torch.nn.grad.conv2d_input(size, wt[:, c], _nchw(g),
                                       stride=stride, padding=k // 2)
        if extra is not None:
            g2, w2, s2 = extra
            t = t + torch.nn.grad.conv2d_input(
                size, w2.to(dtype).float().permute(3, 2, 0, 1)[:, c],
                _nchw(g2.to(dtype).float()), stride=int(s2))
        parts.append(t)
    t = torch.cat(parts, dim=1).permute(0, 2, 3, 1)
    if out_mask is None:
        return t.to(dtype).contiguous(), None
    y_in, gamma, beta, mu, inv = out_mask
    xhat = (y_in.float() - mu.float()) * inv.float()
    e = torch.where(gamma.float() * xhat + beta.float() > 0, t, 0.0)
    stats = torch.stack([e.sum(dim=(0, 1, 2)), (e * xhat).sum(dim=(0, 1, 2))])
    return e.to(dtype).contiguous(), stats


def _check_grad_side(fn, g_parts, g_bnbwd, shape, dtype, device):
    parts = (("g", g_parts),) if g_bnbwd is None else \
        (("e", g_parts[0]), ("y_raw", g_parts[1]))
    for name, t in parts:
        _check_tensor(fn, name, t, shape, dtype, device)
    if g_bnbwd is not None:
        _need(len(g_bnbwd) == 5, "%s: g_bnbwd takes 5 constants, got %d", fn,
              len(g_bnbwd))
        for c in g_bnbwd:
            _check_tensor(fn, "a g_bnbwd constant", c, shape[3:], None,
                          device)


def _f32_rows(vectors):
    return torch.stack([v.to(torch.float32) for v in vectors]).contiguous()


def _wgrad_tensor_cores(x, w_shape):
    """Whether B2 runs on the tensor cores: bfloat16 whose rows TMA can
    load (Ci and Co multiples of 8)."""
    return x.dtype == torch.bfloat16 and x.shape[3] % 8 == 0 \
        and w_shape[3] % 8 == 0


def _launch_wgrad(x, g_parts, dw, stride, x_prologue, g_bnbwd,
                  tensor_cores, schedule=None):
    from ._build import load

    n, h, wd, ci = x.shape
    k, co = int(dw.shape[0]), int(dw.shape[3])
    kind = _kind(x.dtype, tensor_cores)
    g = e = y = consts = None
    if g_bnbwd is None:
        g = g_parts.contiguous()
    else:
        e, y = (t.contiguous() for t in g_parts)
        consts = _f32_rows(g_bnbwd)
    if tensor_cores:
        _need_aligned("conv_wgrad", (x, g, e, y))
    lib = load("fused_conv_wgrad")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _bind(lib, "fused_conv_wgrad", [p] * 9 + [i] * 12 + [p])
    row_tile = _knob(schedule, "row_tile")
    chunks = _bind(lib, "fused_conv_wgrad_chunks", [i] * 9)(
        n, h, wd, ci, co, k, stride, kind, row_tile)
    if chunks < 1:
        raise MXNetError("fused_conv_wgrad takes no shapes x %s, dw %s at "
                         "schedule %s" % (tuple(x.shape), tuple(dw.shape),
                                          schedule))
    partial = None
    if chunks > 1:
        partial = torch.empty((chunks,) + tuple(dw.shape),
                              dtype=torch.float32, device=x.device)
    scale, bias, pro, relu = _prologue_args(x_prologue)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr(x), _ptr(g), _ptr(e), _ptr(y), _ptr(scale), _ptr(bias),
                 _ptr(consts), _ptr(dw), _ptr(partial), chunks, n, h, wd, ci,
                 co, k, stride, pro, relu, kind, row_tile, stream)
    if err != 0:
        raise MXNetError("fused_conv_wgrad launch failed (schedule %s): CUDA "
                         "error %d" % (schedule, err))


def conv_wgrad(x, g_parts, w_shape, *, stride=1, x_prologue=None,
               g_bnbwd=None, schedule=None):
    """dw of :func:`conv_fwd`, accumulated in f32 (B2).

    x: (N, H, W, Ci) raw input; g_parts: the complete output gradient (N,
    Ho, Wo, Co) when ``g_bnbwd`` is None, else ``(e, y_raw)`` from which
    dL/dy is rebuilt (:func:`_bnbwd_value`; ``g_bnbwd`` its 5 (Co,)
    constants); w_shape: (k, k, Ci, Co); x_prologue: None or ``(scale,
    bias, relu)``, the forward's BN-apply, recomputed on the read. Both
    sides are rounded to x's dtype before the product. Returns dw (k, k,
    Ci, Co) f32. On a CUDA tensor this launches the kernel and adds one to
    ``conv_wgrad.launches``: bfloat16 on the tensor cores, float32 on the
    CUDA cores, and a bfloat16 Ci or Co that is not a multiple of 8 on the
    CUDA cores too, counted also in ``conv_wgrad.core_route_launches``. On
    a CPU tensor it runs :func:`conv_wgrad_reference`; on a ``meta`` tensor
    it only allocates. ``schedule``: the tile (``{"row_tile": boxes a
    chunk}`` on the tensor cores, ``{"chan_block": 64}`` on the CUDA
    cores); None consults the schedule table (module docstring)."""
    stride = int(stride)
    g_shape = _check_geometry("conv_wgrad", tuple(x.shape), tuple(w_shape),
                              stride)
    _need(x.dtype in _DTYPES, "conv_wgrad: x must be float32 or bfloat16, "
          "got %s", x.dtype)
    _check_grad_side("conv_wgrad", g_parts, g_bnbwd, g_shape, x.dtype,
                     x.device)
    _check_prologue("conv_wgrad", x_prologue, x)
    schedule = _resolve_schedule("wgrad", x.shape, w_shape, stride,
                                 x.dtype, x.device, schedule)
    if x.device.type == "cpu":
        return conv_wgrad_reference(x, g_parts, w_shape, stride=stride,
                                    x_prologue=x_prologue, g_bnbwd=g_bnbwd,
                                    schedule=schedule)
    dw = torch.empty(tuple(int(v) for v in w_shape), dtype=torch.float32,
                     device=x.device)
    if x.device.type == "meta":
        return dw
    if x.device.type != "cuda":
        raise MXNetError("conv_wgrad: unsupported device %s" % x.device)
    tensor_cores = _wgrad_tensor_cores(x, w_shape)
    _launch_wgrad(x.contiguous(), g_parts, dw, stride, x_prologue, g_bnbwd,
                  tensor_cores, schedule)
    _count(conv_wgrad)
    if x.dtype == torch.bfloat16 and not tensor_cores:
        _count(conv_wgrad, "core_route_launches")
    return dw


conv_wgrad.launches = 0
conv_wgrad.core_route_launches = 0


def _dgrad_tensor_cores(w, extra):
    """Whether B3 runs on the tensor cores: bfloat16 whose rows TMA can
    load (Ci, Co and the extra term's Co2 multiples of 8)."""
    return w.dtype == torch.bfloat16 and w.shape[2] % 8 == 0 \
        and w.shape[3] % 8 == 0 \
        and (extra is None or extra[1].shape[3] % 8 == 0)


def _launch_dgrad(g_parts, w, out, stats, stride, g_bnbwd, out_mask, extra,
                  tensor_cores, schedule=None):
    from ._build import load

    n, h, wd, ci = out.shape
    k, co = int(w.shape[0]), int(w.shape[3])
    kind = _kind(w.dtype, tensor_cores)
    g = e = y = gconsts = g2 = w2 = yin = mconsts = partial = None
    co2 = s2 = 0
    if g_bnbwd is None:
        g = g_parts.contiguous()
    else:
        e, y = (t.contiguous() for t in g_parts)
        gconsts = _f32_rows(g_bnbwd)
    if extra is not None:
        g2, w2 = (t.contiguous() for t in extra[:2])
        co2, s2 = int(w2.shape[3]), int(extra[2])
    if out_mask is not None:
        yin = out_mask[0].contiguous()
        mconsts = _f32_rows(out_mask[1:])
    if tensor_cores:
        _need_aligned("conv_dgrad", (g, e, y, w, g2, w2, yin, out))
    lib = load("fused_conv_dgrad")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _bind(lib, "fused_conv_dgrad",
               [p] * 7 + [i] * 2 + [p] * 4 + [i, p] + [i] * 9 + [p])
    chan_block = _knob(schedule, "chan_block")
    tiles = 0
    if out_mask is not None:
        tiles = _bind(lib, "fused_conv_dgrad_tiles", [i] * 7)(
            n, h, wd, stride, s2, kind, chan_block)
        partial = torch.empty((tiles, 2, ci), dtype=torch.float32,
                              device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_ptr(g), _ptr(e), _ptr(y), _ptr(gconsts), _ptr(w), _ptr(g2),
                 _ptr(w2), co2, s2, _ptr(yin), _ptr(mconsts), _ptr(out),
                 _ptr(partial), tiles, _ptr(stats), n, h, wd, ci, co, k,
                 stride, kind, chan_block, stream)
    if err != 0:
        raise MXNetError("fused_conv_dgrad launch failed (schedule %s): CUDA "
                         "error %d" % (schedule, err))


def conv_dgrad(g_parts, w, x_shape, *, stride=1, g_bnbwd=None, out_mask=None,
               extra=None, schedule=None):
    """Input gradient of :func:`conv_fwd` with its fused epilogue (B3).

    g_parts: the complete output gradient (N, Ho, Wo, Co), or ``(e,
    y_raw)`` with ``g_bnbwd`` constants (rebuilt as in :func:`conv_wgrad`);
    w: (k, k, Ci, Co); x_shape: (N, H, W, Ci). out_mask: None returns ``(dx,
    None)``; or ``(y_in, gamma, beta, mu, inv_sigma)``, the conv input's own
    BatchNorm, returns ``(e_out, stats)`` with e_out = dx where gamma * xhat
    + beta > 0 (else 0) and stats (2, Ci) f32 = [sum e_out, sum e_out *
    xhat] over the unrounded e_out. extra: optional ``(g2, w2, stride2)``,
    a 1x1 conv's complete gradient added before the mask (the downsample
    shortcut's join at act1). Outputs are in w's dtype. On a CUDA tensor
    this launches the kernel and adds one to ``conv_dgrad.launches``:
    bfloat16 on the tensor cores, float32 on the CUDA cores, and a bfloat16
    Ci, Co or Co2 that is not a multiple of 8 on the CUDA cores too, counted
    also in ``conv_dgrad.core_route_launches``. On a CPU tensor it runs
    :func:`conv_dgrad_reference`; on a ``meta`` tensor it only
    allocates. ``schedule``: the tile (``{"chan_block": 64 or 128}``);
    None consults the schedule table (module docstring)."""
    stride = int(stride)
    x_shape = tuple(int(v) for v in x_shape)
    g_shape = _check_geometry("conv_dgrad", x_shape, tuple(w.shape), stride)
    dtype, dev = w.dtype, w.device
    _need(dtype in _DTYPES, "conv_dgrad: w must be float32 or bfloat16, got "
          "%s", dtype)
    _check_grad_side("conv_dgrad", g_parts, g_bnbwd, g_shape, dtype, dev)
    n, h, wd, ci = x_shape
    if out_mask is not None:
        _check_tensor("conv_dgrad", "y_in", out_mask[0], x_shape, dtype, dev)
        for v in out_mask[1:]:
            _check_tensor("conv_dgrad", "an out_mask vector", v, (ci,), None,
                          dev)
    if extra is not None:
        g2, w2, s2 = extra
        s2 = int(s2)
        _need(s2 in (1, 2) and not (s2 == 2 and (h % 2 or wd % 2)),
              "conv_dgrad: extra stride %r does not fit x %s", s2, x_shape)
        _check_tensor("conv_dgrad", "extra w2", w2, (1, 1, ci, w2.shape[3]),
                      dtype, dev)
        _check_tensor("conv_dgrad", "extra g2", g2,
                      (n, h // s2, wd // s2, w2.shape[3]), dtype, dev)
    schedule = _resolve_schedule(
        "dgrad", x_shape, w.shape, stride, dtype, dev, schedule,
        0 if extra is None else int(extra[1].shape[3]))
    if dev.type == "cpu":
        return conv_dgrad_reference(g_parts, w, x_shape, stride=stride,
                                    g_bnbwd=g_bnbwd, out_mask=out_mask,
                                    extra=extra, schedule=schedule)
    out = torch.empty(x_shape, dtype=dtype, device=dev)
    stats = None if out_mask is None else torch.empty(
        (2, ci), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out, stats
    if dev.type != "cuda":
        raise MXNetError("conv_dgrad: unsupported device %s" % dev)
    tensor_cores = _dgrad_tensor_cores(w, extra)
    _launch_dgrad(g_parts, w.contiguous(), out, stats, stride, g_bnbwd,
                  out_mask, extra, tensor_cores, schedule)
    _count(conv_dgrad)
    if dtype == torch.bfloat16 and not tensor_cores:
        _count(conv_dgrad, "core_route_launches")
    return out, stats


conv_dgrad.launches = 0
conv_dgrad.core_route_launches = 0


def _finalize_stats(stats, count, eps):
    """(mean, var, inv_sigma) from the (2, C) f32 [sum, sum of squares]."""
    mean = stats[0] / count
    var = torch.clamp_min(stats[1] / count - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def _all_reduce(t, group):
    """A sum over the data group (``group`` None: one device, no
    collective)."""
    from ..parallel import mesh

    return mesh.all_reduce_(t, group)


def _reduce_weight_grads(dws, group):
    """The unit's weight gradients summed over the data group in f32, one
    collective for the three or four of them."""
    from ..parallel import mesh

    return mesh.all_reduce_flat_([d for d in dws if d is not None], group)


def _unit_fwd(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3, stride, eps,
              group=None, axis_size=1):
    """Training forward of the unit: out, the batch statistics (mean, var
    per BN) and the residuals the backward needs. With a data ``group``
    the BatchNorm sums are summed over it and the counts are the local
    ones times ``axis_size``: global-batch statistics."""
    data = data.contiguous()   # read by conv1, the shortcut and bn1's sums
    n, h, wd, _ci = data.shape
    n1 = n * h * wd * axis_size
    xf = data.float()
    s01 = _all_reduce(torch.stack([xf.sum(dim=(0, 1, 2)),
                                   (xf * xf).sum(dim=(0, 1, 2))]), group)
    mean1, var1, inv1 = _finalize_stats(s01, n1, eps)
    sc1, bi1 = _bn_consts(g1, b1, mean1, inv1)

    y1, st1 = conv_fwd(data, w1, stride=1, prologue=(sc1, bi1, True),
                       emit_stats=True)
    mean2, var2, inv2 = _finalize_stats(_all_reduce(st1, group), n1, eps)
    sc2, bi2 = _bn_consts(g2, b2, mean2, inv2)

    y2, st2 = conv_fwd(y1, w2, stride=stride, prologue=(sc2, bi2, True),
                       emit_stats=True)
    n2 = n * (h // stride) * (wd // stride) * axis_size
    mean3, var3, inv3 = _finalize_stats(_all_reduce(st2, group), n2, eps)
    sc3, bi3 = _bn_consts(g3, b3, mean3, inv3)

    y3, _ = conv_fwd(y2, w3, stride=1, prologue=(sc3, bi3, True))
    if wsc is None:
        shortcut = data
    else:
        shortcut, _ = conv_fwd(data, wsc, stride=stride,
                               prologue=(sc1, bi1, True))
    out = y3 + shortcut
    stats = (mean1, var1, mean2, var2, mean3, var3)
    res = (data, y1, y2, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
           mean1, inv1, mean2, inv2, mean3, inv3)
    return out, stats, res


def _unit_bwd(stride, res, g, group=None, axis_size=1):
    """The unit's backward from its residuals and the output gradient ``g``:
    3 B3 and 3 B2 launches, a fourth B2 for the downsample shortcut, whose
    data gradient rides conv1's B3 as its ``extra`` term. Gradients come
    back in the dtypes of the inputs. With a data ``group`` the (dbeta,
    dgamma) sums and the weight gradients (f32, before the cast) are summed
    over it, as the JAX package psums them."""
    (data, y1, y2, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
     mean1, inv1, mean2, inv2, mean3, inv3) = res
    g = g.contiguous()
    n, h, wd, _ci = data.shape
    n1 = float(n * h * wd * axis_size)
    n2 = float(n * (h // stride) * (wd // stride) * axis_size)
    sc1, bi1 = _bn_consts(g1, b1, mean1, inv1)
    sc2, bi2 = _bn_consts(g2, b2, mean2, inv2)
    sc3, bi3 = _bn_consts(g3, b3, mean3, inv3)

    # conv3 (1x1 s1): dgrad emits e2 = mask3 * dact3 and (dbeta3, dgamma3)
    e2, st3 = conv_dgrad(g, w3, y2.shape, stride=1,
                         out_mask=(y2, g3, b3, mean3, inv3))
    dbeta3, dgamma3 = _all_reduce(st3, group)
    dw3 = conv_wgrad(y2, g, w3.shape, stride=1, x_prologue=(sc3, bi3, True))
    cb2 = (g3.float() * inv3, mean3, inv3, dbeta3 / n2, dgamma3 / n2)

    # conv2 (3x3, stride): the g side rebuilt from (e2, y2) by bn3's backward
    dw2 = conv_wgrad(y1, (e2, y2), w2.shape, stride=stride,
                     x_prologue=(sc2, bi2, True), g_bnbwd=cb2)
    e1, st2 = conv_dgrad((e2, y2), w2, y1.shape, stride=stride, g_bnbwd=cb2,
                         out_mask=(y1, g2, b2, mean2, inv2))
    dbeta2, dgamma2 = _all_reduce(st2, group)
    cb1 = (g2.float() * inv2, mean2, inv2, dbeta2 / n1, dgamma2 / n1)

    # conv1 (1x1 s1): the downsample shortcut joins at act1 (extra term)
    dw1 = conv_wgrad(data, (e1, y1), w1.shape, stride=1,
                     x_prologue=(sc1, bi1, True), g_bnbwd=cb1)
    extra = None if wsc is None else (g, wsc, stride)
    e0, st1 = conv_dgrad((e1, y1), w1, data.shape, stride=1, g_bnbwd=cb1,
                         out_mask=(data, g1, b1, mean1, inv1), extra=extra)
    dbeta1, dgamma1 = _all_reduce(st1, group)
    dwsc = None
    if wsc is not None:
        dwsc = conv_wgrad(data, g, wsc.shape, stride=stride,
                          x_prologue=(sc1, bi1, True))
    if group is not None:
        _reduce_weight_grads((dw1, dw2, dw3, dwsc), group)
    if dwsc is not None:
        dwsc = dwsc.to(wsc.dtype)

    # bn1's backward to the unit input (elementwise), plus the dim-match
    # shortcut
    xhat0 = (data.float() - mean1) * inv1
    ddata = (g1.float() * inv1) * (
        e0.float() - dbeta1 / n1 - xhat0 * (dgamma1 / n1))
    if wsc is None:
        ddata = ddata + g.float()
    return (ddata.to(data.dtype), dw1.to(w1.dtype), dw2.to(w2.dtype),
            dw3.to(w3.dtype), dwsc, dgamma1.to(g1.dtype), dbeta1.to(b1.dtype),
            dgamma2.to(g2.dtype), dbeta2.to(b2.dtype), dgamma3.to(g3.dtype),
            dbeta3.to(b3.dtype))


class _BottleneckTrain(torch.autograd.Function):
    """The unit's forward (B1 with the stats epilogue) and its backward (B2,
    B3): the counterpart of the JAX ``custom_vjp``. The forward keeps what
    the JAX residuals keep (data, y1, y2, weights, gammas, betas, means and
    inverse sigmas), not y3. The batch statistics are outputs without a
    gradient: their cotangent is ignored. With a data ``group`` (of
    ``axis_size`` ranks) it runs the reductions of ``_unit_fwd`` and
    ``_unit_bwd``: its parameter gradients come back summed over the group
    (the JAX wrapper's replicated out_specs), the data gradient is the
    rank's rows'."""

    @staticmethod
    def forward(ctx, data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3, stride,
                eps, group, axis_size):
        out, stats, res = _unit_fwd(data, w1, w2, w3, wsc, g1, b1, g2, b2,
                                    g3, b3, stride, eps, group, axis_size)
        ctx.stride, ctx.group, ctx.axis_size = stride, group, axis_size
        ctx.save_for_backward(*res)
        ctx.mark_non_differentiable(*stats)
        return (out,) + stats

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, *_gstats):
        return _unit_bwd(ctx.stride, ctx.saved_tensors, g, ctx.group,
                         ctx.axis_size) + (None,) * 4


def bottleneck_train(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3, stride,
                     eps):
    """Training mode of the pre-activation bottleneck unit: BN on the batch
    statistics, which come from B1's stats epilogue. data NHWC, weights HWIO
    (``wsc`` None for a dim-match unit). Returns ``(out, (mean1, var1,
    mean2, var2, mean3, var3))``; the statistics feed the caller's
    moving-statistics update and carry no gradient. Through autograd the
    backward launches B3 three times and B2 three times (four with the
    downsample shortcut)."""
    out, *stats = _BottleneckTrain.apply(data, w1, w2, w3, wsc, g1, b1, g2,
                                         b2, g3, b3, int(stride), float(eps),
                                         None, 1)
    return out, tuple(stats)


# ---------------------------------------------------------------------------
# data parallelism: the unit on one rank's rows, its reductions over the
# mesh's data axes (the JAX package's shard_map wrappers)
# ---------------------------------------------------------------------------
_SPMD_SCOPE = threading.local()


@contextlib.contextmanager
def spmd_scope(mesh, axes, batch_names=None):
    """Marks the fused ops run inside it as data parallel over ``mesh``'s
    ``axes``: ``ops/fused.py`` then calls ``bottleneck_train_spmd``, and the
    batch-reducing ops of ``ops/nn.py`` reduce over the data group.
    ``TrainStep`` sets it around each step. ``batch_names`` are the graph
    inputs the mesh shards by rows (the data and labels): the executor
    marks them and what keeps their axis 0 first as batch-leading
    (:func:`batch_operands`); None counts every graph input as one."""
    prev = (getattr(_SPMD_SCOPE, "value", None),
            getattr(_SPMD_SCOPE, "batch_names", None))
    _SPMD_SCOPE.value = (mesh, tuple(axes))
    _SPMD_SCOPE.batch_names = (None if batch_names is None
                               else frozenset(batch_names))
    try:
        yield
    finally:
        _SPMD_SCOPE.value, _SPMD_SCOPE.batch_names = prev


def current_spmd_scope():
    """``(mesh, axes)`` of the innermost :func:`spmd_scope`, else None."""
    return getattr(_SPMD_SCOPE, "value", None)


def scope_batch_names():
    """The batch-leading graph inputs of the innermost :func:`spmd_scope`
    (None: every input)."""
    return getattr(_SPMD_SCOPE, "batch_names", None)


@contextlib.contextmanager
def batch_operands(flags):
    """Set by the executor around an op it runs under :func:`spmd_scope`:
    ``flags[i]`` says whether the op's input ``i`` is batch-leading (its
    axis 0 is the rank's rows of the batch). An op called outside an
    executor sees None, and counts every operand as batch-leading."""
    prev = getattr(_SPMD_SCOPE, "operands", None)
    _SPMD_SCOPE.operands = tuple(flags)
    try:
        yield
    finally:
        _SPMD_SCOPE.operands = prev


def current_batch_operands():
    """The flags of :func:`batch_operands` for the op running, else None."""
    return getattr(_SPMD_SCOPE, "operands", None)


def bottleneck_train_spmd(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
                          stride, eps, mesh, axes):
    """:func:`bottleneck_train` on this rank's rows ``data`` of a batch
    sharded over ``mesh``'s ``axes``: BatchNorm on the global batch's
    statistics, returned on every rank; ``out`` is the rank's rows. Through
    autograd the weight, gamma and beta gradients are the global batch's
    (summed over the ranks once, here: a caller must not sum them again)."""
    from ..parallel.mesh import data_group

    group, n, _index = data_group(mesh, axes)
    out, *stats = _BottleneckTrain.apply(
        data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3, int(stride),
        float(eps), group, n)
    return out, tuple(stats)


def bottleneck_infer_spmd(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
                          mm1, mv1, mm2, mv2, mm3, mv3, *, stride, eps, mesh,
                          axes):
    """:func:`bottleneck_infer` on this rank's rows: the moving statistics
    make it per sample, so no collective runs (``mesh`` and ``axes`` are
    the JAX signature's)."""
    del mesh, axes
    return bottleneck_infer(data, w1, w2, w3, wsc, g1, b1, g2, b2, g3, b3,
                            mm1, mv1, mm2, mv2, mm3, mv3, stride=stride,
                            eps=eps)
