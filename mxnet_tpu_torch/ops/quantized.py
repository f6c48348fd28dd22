"""Int8 inference ops of the post-training-quantized serving path
(counterpart of ``mxnet_tpu/ops/quantized.py``).

Emitted only by the quantize pass (``ir/quantize.py``), never by user
graphs:

- ``_quantize_int8``: symmetric per-tensor activation quantization with a
  calibrated ``scale`` attribute, ``clip(round(x / scale), -127, 127)``;
- ``_quantize_rows_int8``: per-output-channel weight quantization, a graph
  node over the weight variable, so the bind-time fold (``ir/fold.py``)
  evaluates it once per parameter set and a hot swap requantizes;
- ``_int8_fully_connected`` / ``_int8_convolution``: int8 x int8 products
  accumulated exactly, dequantized by ``scale * wscale`` (+ float bias)
  into float32 outputs.

All four are inference-only (``nondiff``).

On a CPU tensor the port keeps the JAX package's CPU rule: the quantized
activations stay int8-valued float32 (the "carrier") and the products run
in float32, exact while the sums stay below 2**24. On a CUDA tensor
``_quantize_int8`` returns a real ``torch.int8`` tensor and the products
accumulate in int32 through ``torch._int_mm`` (cuBLASLt's int8 GEMM, the
counterpart of the JAX package's ``preferred_element_type=int32`` products,
which it leaves to XLA). ``_int_mm`` takes M > 16 rows and K and N
multiples of 8, so its operands are zero-padded to that and the result is
sliced back; a convolution is an int8 im2col (``F.pad`` and
``Tensor.unfold`` views, one copy into the GEMM's row-major operand) and
one such product. A grouped convolution does not fit one GEMM: it runs as
a batched float32 product of the same int8 operands, which is exact while
each output sums ``K_per_group * 127**2 < 2**24`` (``F32_EXACT_K``), and
raises past that. The route is chosen by shape only; ``routes`` counts the
card's products by route (``int_mm``, ``f32_exact``). A failure on the card
raises.

Divisions by a scale divide by a 0-dim tensor on the data's device: on the
card, dividing by a Python float is a multiply by its reciprocal, which
can move ``round`` across a k + 0.5 boundary against the JAX package's
``x / scale``. The tensor is filled on the device (``torch.full``): one
made by ``torch.tensor`` is copied from the host, and that copy waits for
the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register

_SCALE_FLOOR = 1e-12
# a float32 sum of int8 x int8 products is exact while K * 127**2 < 2**24
F32_EXACT_K = ((1 << 24) - 1) // (127 * 127)

# products on the card, by route
routes = {"int_mm": 0, "f32_exact": 0}


def _on_card(t):
    return t.device.type == "cuda"


def _div(x, scale):
    """``x / scale`` as a true division (see the module docstring)."""
    if not isinstance(scale, torch.Tensor):
        scale = torch.full((), float(scale), dtype=torch.float32,
                           device=x.device)
    return x / scale


def _int8(t):
    """An int8 operand on the card: the tensor itself, or int8-valued
    float32 (the carrier) converted."""
    return t if t.dtype == torch.int8 else t.to(torch.int8)


@register(name="_quantize_int8", nondiff=True)
def _quantize_int8(data, scale=1.0):
    """``clip(round(data / scale), -127, 127)`` (round half to even, as
    ``jnp.round``): a ``torch.int8`` tensor on the card, the int8-valued
    float32 carrier elsewhere."""
    q = torch.clamp(torch.round(_div(data.float(), scale)), -127.0, 127.0)
    return q.to(torch.int8) if _on_card(q) else q


@register(name="_quantize_rows_int8", nondiff=True, num_outputs=2)
def _quantize_rows_int8(data):
    """Per-output-channel (axis 0) symmetric int8 quantization: ``(int8
    weight, float32 per-row scale)``, the scale ``max(absmax / 127,
    1e-12)``."""
    x = data.float()
    absmax = x.abs().amax(dim=tuple(range(1, x.dim()))) if x.dim() > 1 \
        else x.abs()
    scale = torch.clamp_min(_div(absmax, 127.0), _SCALE_FLOOR)
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    q = torch.clamp(torch.round(x / scale.reshape(bshape)), -127.0, 127.0)
    return q.to(torch.int8), scale


def _up8(n):
    return -(-n // 8) * 8


def _gemm_buffer(m, k, device):
    """The row-major int8 (M', K') operand of ``torch._int_mm`` for an
    (m, k) product: M' > 16 and K' a multiple of 8, zero in the padding."""
    mp, kp = max(m, 17), _up8(k)
    if (mp, kp) == (m, k):
        return torch.empty((m, k), dtype=torch.int8, device=device)
    return torch.zeros((mp, kp), dtype=torch.int8, device=device)


def _int_mm(buf, m, k, w):
    """int32 (m, O) = ``buf[:m, :k] . w^T`` for an int8 (O, k) weight,
    through ``torch._int_mm``; ``buf`` from :func:`_gemm_buffer`."""
    o = w.shape[0]
    kp, op = buf.shape[1], _up8(o)
    w = _int8(w).reshape(o, k)
    if (op, kp) != (o, k):
        wp = torch.zeros((op, kp), dtype=torch.int8, device=w.device)
        wp[:o, :k] = w
        w = wp
    acc = torch._int_mm(buf, w.contiguous().t())
    routes["int_mm"] += 1
    return acc[:m, :o]


def int8_linear_acc(x, w):
    """The exact accumulation ``x . w^T`` of int8 operands over the last
    dim, before the epilogue: int32 on the card, float32 of the carrier on
    the CPU."""
    if not _on_card(x):
        return torch.matmul(x.float(), w.float().t())
    k = x.shape[-1]
    rows = x.reshape(-1, k)
    m = rows.shape[0]
    buf = _gemm_buffer(m, k, x.device)
    buf[:m, :k] = _int8(rows)
    return _int_mm(buf, m, k, w).reshape(*x.shape[:-1], w.shape[0])


def _patches(x, kernel, stride, pad, dilate):
    """(N, C, OH, OW, kh, kw) int8 views of the padded input."""
    if any(pad):
        x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
    for dim, (k, s, d) in enumerate(zip(kernel, stride, dilate)):
        x = x.unfold(2 + dim, d * (k - 1) + 1, s)
    if any(d > 1 for d in dilate):
        x = x[..., ::dilate[0], ::dilate[1]]
    return x


def int8_conv_acc(x, w, stride, pad, dilate, groups):
    """The exact accumulation of a 2-D NCHW x OIHW convolution of int8
    operands, before the epilogue: on the card int32 (one group, the
    ``int_mm`` route) or exact integers in float32 (grouped, the
    ``f32_exact`` route); float32 of the carrier on the CPU."""
    nd = w.dim() - 2
    if not _on_card(x):
        conv = getattr(F, "conv%dd" % nd)
        return conv(x.float(), w.float(), stride=stride, padding=pad,
                    dilation=dilate, groups=groups)
    if nd != 2:
        raise MXNetError("_int8_convolution: %d spatial dims on the card "
                         "(2 only)" % nd)
    x = _int8(x)
    n, c = x.shape[:2]
    o, cg, kh, kw = w.shape
    p = _patches(x, (kh, kw), stride, pad, dilate)
    oh, ow = p.shape[2:4]
    m = n * oh * ow
    if groups == 1:
        k = c * kh * kw
        buf = _gemm_buffer(m, k, x.device)
        buf[:m, :k].view(n, oh, ow, c, kh, kw).copy_(
            p.permute(0, 2, 3, 1, 4, 5))
        acc = _int_mm(buf, m, k, w)
    else:
        kg = cg * kh * kw
        if kg > F32_EXACT_K:
            raise MXNetError(
                "_int8_convolution: a grouped convolution sums %d int8 "
                "products an output; the float32 route is exact up to %d"
                % (kg, F32_EXACT_K))
        cols = p.reshape(n, groups, cg, oh, ow, kh, kw).permute(
            1, 0, 3, 4, 2, 5, 6).reshape(groups, m, kg).float()
        wg = w.reshape(groups, o // groups, kg).float().transpose(1, 2)
        acc = torch.bmm(cols, wg).permute(1, 0, 2)
        routes["f32_exact"] += 1
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def _epilogue(acc, scale, wscale, bias, no_bias, bshape):
    # an int32 acc is converted to float32 inside the product, as the
    # JAX package's acc.astype(float32) * (scale * wscale)
    out = acc * (wscale * scale).reshape(bshape)
    if bias is not None and not no_bias:
        out = out + bias.float().reshape(bshape)
    return out


@register(name="_int8_fully_connected", nondiff=True)
def _int8_fully_connected(data, weight, wscale, bias=None, num_hidden=1,
                          no_bias=False, flatten=True, scale=1.0):
    """FullyConnected on int8 operands, a float32 output: ``data`` (n, i),
    ``weight`` int8 (o, i), ``wscale`` float32 (o,); ``(data . weight^T) *
    scale * wscale [+ bias]``."""
    if flatten:
        data = data.reshape(data.shape[0], -1)
    return _epilogue(int8_linear_acc(data, weight), scale, wscale, bias,
                     no_bias, (-1,))


@register(name="_int8_convolution", nondiff=True)
def _int8_convolution(data, weight, wscale, bias=None, kernel=(),
                      stride=(), dilate=(), pad=(), num_filter=1,
                      num_group=1, no_bias=False, scale=1.0):
    """Convolution (NCHW x OIHW) on int8 operands; a float32 output with
    the per-output-channel weight scales in the epilogue."""
    nd = len(kernel) if kernel else data.dim() - 2
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    acc = int8_conv_acc(data, weight, stride, pad, dilate, int(num_group))
    return _epilogue(acc, scale, wscale, bias, no_bias,
                     (1, -1) + (1,) * nd)
