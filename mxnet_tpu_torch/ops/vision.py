"""Region-based vision ops (counterpart of ``mxnet_tpu/ops/vision.py``,
every name of it): ``ROIPooling``, ``PSROIPooling``, the RPN's
``Proposal``/``MultiProposal``, ``DeformableConvolution`` and
``DeformablePSROIPooling``, with the JAX package's names, aliases,
attributes, rounding (``torch.round`` is half to even, as ``jnp.round``)
and output counts. None is a Pallas kernel there: these are torch ops.

``ROIPooling`` takes each bin's maximum without the JAX package's
(R, C, PH, PW, H, W) masked tensor (43 GB at a Faster R-CNN size): the
RoIs go in chunks, and a chunk's maxima are separable (over each bin row's
H, then each bin's W). Its gradient is a function of its own that splits
a bin's cotangent evenly among the positions holding the bin's maximum, as
``jnp.max``'s does (``torch.amax``'s rule), one bin at a time.

``Proposal`` keeps its proposals by the greedy NMS of ``MultiBoxDetection``
(``contrib.greedy_nms_indices``: the fixed point over the candidates'
suppression matrix, one image at a time, with the +1 pixel convention and
no classes), truncated to ``rpn_post_nms_top_n``: over candidates sorted
by a stable sort, that is the set the JAX package's ``rpn_post_nms_top_n``
argmax rounds keep.

Under a data-parallel mesh the ops whose ``rois`` batch-index column
addresses axis 0 of ``data`` (``ROIPooling``, ``PSROIPooling``,
``DeformablePSROIPooling``), and the proposal ops that write that column,
raise by name when an operand is batch-leading.
"""
from __future__ import annotations

import numpy as np
import torch

from .contrib import greedy_nms_indices
from .registry import register
from .tensor import _refuse_batch_axis

# elements of a chunk's gathered (rois, C, H, W) images
_CHUNK_ELEMS = 1 << 24


def _chunks(n_rois, per_roi):
    step = max(1, _CHUNK_ELEMS // max(per_roi, 1))
    return [slice(r, min(r + step, n_rois)) for r in range(0, n_rois, step)]


def _bilinear_sample(img, y, x):
    """img (B, C, H, W) sampled at fractional (y, x) of shape (B, *grid):
    (B, C, *grid); a corner outside the image contributes zero (the
    reference's deformable_im2col rule)."""
    B, C, H, W = img.shape
    grid = y.shape[1:]
    y, x = y.reshape(B, -1), x.reshape(B, -1)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    flat = img.reshape(B, C, H * W)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            yy = torch.clamp(y0 + dy, 0, H - 1).long()
            xx = torch.clamp(x0 + dx, 0, W - 1).long()
            w = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx)
            inb = (y0 + dy >= 0) & (y0 + dy <= H - 1) & (x0 + dx >= 0) & \
                (x0 + dx <= W - 1)
            v = flat.gather(2, (yy * W + xx)[:, None, :].expand(B, C, -1))
            term = torch.where(inb, w, w.new_zeros(()))[:, None, :] * v
            out = term if out is None else out + term
    return out.reshape((B, C) + tuple(grid))


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------
def _roi_max(data, bidx, hmask, wmask):
    """Each bin's maximum, (R, C, PH, PW), masked positions at the dtype's
    least value; hmask (R, PH, H), wmask (R, PW, W)."""
    R, (_, C, H, W) = bidx.shape[0], data.shape
    PH, PW = hmask.shape[1], wmask.shape[1]
    neg = torch.finfo(data.dtype).min
    out = data.new_empty((R, C, PH, PW))
    for r in _chunks(R, C * H * W):
        img = data[bidx[r]]
        for ph in range(PH):
            rows = img.masked_fill(~hmask[r, ph][:, None, :, None], neg) \
                .amax(dim=2)                                   # (r, C, W)
            for pw in range(PW):
                out[r, :, ph, pw] = rows.masked_fill(
                    ~wmask[r, pw][:, None, :], neg).amax(dim=2)
    return out


class _RoiPool(torch.autograd.Function):
    """Bin maxima; the backward spreads a bin's cotangent evenly over the
    positions that hold its maximum (none for an empty bin, whose output
    is 0)."""

    @staticmethod
    def forward(ctx, data, bidx, hmask, wmask, empty):
        out = _roi_max(data, bidx, hmask, wmask)
        out = torch.where(empty[:, None], out.new_zeros(()), out)
        ctx.save_for_backward(data, bidx, hmask, wmask, empty, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, bidx, hmask, wmask, empty, out = ctx.saved_tensors
        R, (_, C, H, W) = bidx.shape[0], data.shape
        PH, PW = hmask.shape[1], wmask.shape[1]
        g = torch.where(empty[:, None], g.new_zeros(()), g)
        grad = torch.zeros_like(data)
        for r in _chunks(R, C * H * W):
            img = data[bidx[r]]
            gimg = torch.zeros_like(img)
            for ph in range(PH):
                for pw in range(PW):
                    m = hmask[r, ph][:, None, :, None] & \
                        wmask[r, pw][:, None, None, :]
                    eq = (img == out[r, :, ph, pw, None, None]) & m
                    cnt = eq.sum(dim=(2, 3)).clamp_min(1)
                    gimg += eq * (g[r, :, ph, pw] / cnt)[..., None, None]
            grad.index_add_(0, bidx[r], gimg)
        return grad, None, None, None, None


@register(name="ROIPooling")
def roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max pooling of each RoI's bins: data (N, C, H, W), rois (R, 5) rows
    [batch index, x1, y1, x2, y2]; returns (R, C, PH, PW), 0 in an empty
    bin."""
    _refuse_batch_axis("ROIPooling", (0,), data.dim())
    N, C, H, W = data.shape
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    dt, dev = data.dtype, data.device
    rois = rois.detach()
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale).to(dt)
                      for k in range(1, 5))
    rh = torch.clamp_min(y2 - y1 + 1.0, 1.0)
    rw = torch.clamp_min(x2 - x1 + 1.0, 1.0)
    bin_h, bin_w = rh / PH, rw / PW
    ph = torch.arange(PH, dtype=dt, device=dev)
    pw = torch.arange(PW, dtype=dt, device=dev)
    hstart = torch.clamp(torch.floor(ph * bin_h[:, None]) + y1[:, None], 0, H)
    hend = torch.clamp(torch.ceil((ph + 1.0) * bin_h[:, None]) + y1[:, None],
                       0, H)
    wstart = torch.clamp(torch.floor(pw * bin_w[:, None]) + x1[:, None], 0, W)
    wend = torch.clamp(torch.ceil((pw + 1.0) * bin_w[:, None]) + x1[:, None],
                       0, W)
    hs = torch.arange(H, dtype=dt, device=dev)
    ws = torch.arange(W, dtype=dt, device=dev)
    hmask = (hs >= hstart[..., None]) & (hs < hend[..., None])  # (R, PH, H)
    wmask = (ws >= wstart[..., None]) & (ws < wend[..., None])  # (R, PW, W)
    empty = (hend <= hstart)[:, :, None] | (wend <= wstart)[:, None, :]
    return _RoiPool.apply(data, bidx, hmask, wmask, empty)


@register(name="_contrib_PSROIPooling", aliases=("PSROIPooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1, pooled_size=1,
                  group_size=0):
    """Position-sensitive RoI average pooling: bin (ph, pw) of output
    channel d averages input channel d*P*P + ph*P + pw inside the bin;
    returns (R, output_dim, P, P)."""
    _refuse_batch_axis("PSROIPooling", (0,), data.dim())
    N, C, H, W = data.shape
    P, D = int(pooled_size), int(output_dim)
    dt, dev = data.dtype, data.device
    rois = rois.detach()
    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale - 0.5
    rh = torch.clamp_min(y2 - y1, 0.1)
    rw = torch.clamp_min(x2 - x1, 0.1)
    bin_h, bin_w = (rh / P)[:, None], (rw / P)[:, None]
    ph = torch.arange(P, dtype=dt, device=dev)
    hstart = torch.clamp(torch.floor(ph * bin_h + y1[:, None]), 0, H)
    hend = torch.clamp(torch.ceil((ph + 1.0) * bin_h + y1[:, None]), 0, H)
    wstart = torch.clamp(torch.floor(ph * bin_w + x1[:, None]), 0, W)
    wend = torch.clamp(torch.ceil((ph + 1.0) * bin_w + x1[:, None]), 0, W)
    hs = torch.arange(H, dtype=dt, device=dev)
    ws = torch.arange(W, dtype=dt, device=dev)
    hmask = ((hs >= hstart[..., None]) & (hs < hend[..., None])).to(dt)
    wmask = ((ws >= wstart[..., None]) & (ws < wend[..., None])).to(dt)
    cnt = hmask.sum(-1)[:, :, None] * wmask.sum(-1)[:, None, :]  # (R, P, P)
    outs = []
    for r in _chunks(len(bidx), C * H * W):
        img = data[bidx[r]].reshape(-1, D, P, P, H, W)
        s = torch.einsum("rdpqhw,rqw->rdpqh", img, wmask[r])
        outs.append(torch.einsum("rdpqh,rph->rdpq", s, hmask[r]))
    s = torch.cat(outs) if outs else data.new_zeros((0, D, P, P))
    return (s / torch.clamp_min(cnt, 1.0)[:, None]).to(dt)


# ---------------------------------------------------------------------------
# RPN proposals
# ---------------------------------------------------------------------------
def _make_anchors(ratios, scales, stride):
    """Base anchors centred on one stride cell (the reference's
    GenerateAnchors)."""
    base = np.array([0, 0, stride - 1.0, stride - 1.0])
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size_r = w * h / r
        ws = np.round(np.sqrt(size_r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors, dtype=np.float32)


def _bbox_transform(anchors, deltas):
    """Regression deltas (N, K, 4) applied to anchors (K, 4)."""
    w = anchors[:, 2] - anchors[:, 0] + 1.0
    h = anchors[:, 3] - anchors[:, 1] + 1.0
    cx = anchors[:, 0] + 0.5 * (w - 1.0)
    cy = anchors[:, 1] + 0.5 * (h - 1.0)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def _proposal(name, cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
              rpn_post_nms_top_n, threshold, rpn_min_size, scales, ratios,
              feature_stride, output_score):
    _refuse_batch_axis(name, (0,), cls_prob.dim())
    dev = cls_prob.device
    anchors = torch.tensor(_make_anchors(ratios, scales, feature_stride),
                           device=dev)
    A = anchors.shape[0]
    N, _, Hf, Wf = cls_prob.shape
    post = int(rpn_post_nms_top_n)
    sx, sy = torch.meshgrid(torch.arange(Wf, device=dev) * feature_stride,
                            torch.arange(Hf, device=dev) * feature_stride,
                            indexing="xy")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1)
    all_anchors = (anchors[None] + shifts[:, None].to(torch.float32)) \
        .reshape(-1, 4)
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(N, -1, 4)
    props = _bbox_transform(all_anchors, deltas)
    zero = props.new_zeros(())
    hi_x = (im_info[:, 1] - 1.0)[:, None]
    hi_y = (im_info[:, 0] - 1.0)[:, None]
    props = torch.stack([
        torch.minimum(torch.maximum(props[..., 0], zero), hi_x),
        torch.minimum(torch.maximum(props[..., 1], zero), hi_y),
        torch.minimum(torch.maximum(props[..., 2], zero), hi_x),
        torch.minimum(torch.maximum(props[..., 3], zero), hi_y)], dim=-1)
    ws = props[..., 2] - props[..., 0] + 1.0
    hs = props[..., 3] - props[..., 1] + 1.0
    min_size = (rpn_min_size * im_info[:, 2])[:, None]
    valid = (ws >= min_size) & (hs >= min_size)
    fg = torch.where(valid, fg, fg.new_full((), -float("inf")))
    K = fg.shape[1]
    pre_n = min(int(rpn_pre_nms_top_n), K) if rpn_pre_nms_top_n > 0 else K
    top_s, top_i = torch.sort(fg, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :pre_n], top_i[:, :pre_n]
    cand = props.gather(1, top_i[..., None].expand(N, pre_n, 4))
    live = top_s > -float("inf")
    if dev.type == "meta" or not N:         # shape inference
        keep = torch.full((N, post), -1, dtype=torch.int64, device=dev)
    else:
        keep = torch.stack([greedy_nms_indices(cand[n], live[n],
                                               float(threshold), post,
                                               offset=1.0)
                            for n in range(N)])
    ok = keep >= 0
    idx = keep.clamp_min(0)
    boxes = torch.where(ok[..., None],
                        cand.gather(1, idx[..., None].expand(N, post, 4)),
                        zero)
    scores = torch.where(ok, top_s.gather(1, idx), zero)
    bcol = torch.arange(N, dtype=boxes.dtype, device=dev)[:, None, None] \
        .expand(N, post, 1)
    out = torch.cat([bcol, boxes], dim=-1).reshape(-1, 5)
    if output_score:
        return out, scores.reshape(-1, 1)
    return out


@register(name="_contrib_Proposal", aliases=("Proposal",), nondiff=True,
          num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals of each image: (N * rpn_post_nms_top_n, 5) rows
    [image index, x1, y1, x2, y2] (zero boxes past the kept ones), and
    with ``output_score`` their scores; ``iou_loss`` is ignored."""
    return _proposal("Proposal", cls_prob, bbox_pred, im_info,
                     rpn_pre_nms_top_n, rpn_post_nms_top_n, threshold,
                     rpn_min_size, scales, ratios, feature_stride,
                     output_score)


@register(name="_contrib_MultiProposal", aliases=("MultiProposal",),
          nondiff=True,
          num_outputs=lambda attrs: 2 if attrs.get("output_score") else 1)
def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                   feature_stride=16, output_score=False, iou_loss=False):
    """``Proposal`` over the batch (the same computation)."""
    return _proposal("MultiProposal", cls_prob, bbox_pred, im_info,
                     rpn_pre_nms_top_n, rpn_post_nms_top_n, threshold,
                     rpn_min_size, scales, ratios, feature_stride,
                     output_score)


# ---------------------------------------------------------------------------
# deformable convolution and PS RoI pooling
# ---------------------------------------------------------------------------
@register(name="_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=1, num_group=1, num_deformable_group=1,
                           workspace=1024, no_bias=False, layout=None):
    """Deformable convolution v1: each tap sampled bilinearly at its
    learned offset (offset (N, 2*G*KH*KW, OH, OW), per deformable group G
    [kh, kw, (y, x)]), then one product with the weights."""
    N, C, H, W = data.shape
    KH, KW = int(kernel[0]), int(kernel[1])
    SH, SW = int(stride[0]), int(stride[1])
    DH, DW = int(dilate[0]), int(dilate[1])
    PH, PW = int(pad[0]), int(pad[1])
    OH = (H + 2 * PH - DH * (KH - 1) - 1) // SH + 1
    OW = (W + 2 * PW - DW * (KW - 1) - 1) // SW + 1
    G = int(num_deformable_group)
    Cg = C // G
    dev = data.device
    oy = torch.arange(OH, device=dev) * SH - PH
    ox = torch.arange(OW, device=dev) * SW - PW
    ky = torch.arange(KH, device=dev) * DH
    kx = torch.arange(KW, device=dev) * DW
    base_y = oy[:, None, None, None] + ky[None, None, :, None]
    base_x = ox[None, :, None, None] + kx[None, None, None, :]
    off = offset.reshape(N, G, KH, KW, 2, OH, OW)
    y = base_y + off[:, :, :, :, 0].permute(0, 1, 4, 5, 2, 3)
    x = base_x + off[:, :, :, :, 1].permute(0, 1, 4, 5, 2, 3)
    cols = _bilinear_sample(data.reshape(N * G, Cg, H, W),
                            y.reshape(N * G, OH, OW, KH, KW),
                            x.reshape(N * G, OH, OW, KH, KW))
    cols = cols.reshape(N, C, OH, OW, KH, KW).permute(0, 2, 3, 1, 4, 5) \
        .reshape(N * OH * OW, C * KH * KW)
    F_ = int(num_filter)
    wmat = weight.reshape(F_, -1)
    ng = int(num_group)
    if ng > 1:
        Fg, Ckk = F_ // ng, (C // ng) * KH * KW
        out = torch.cat([cols[:, g * Ckk:(g + 1) * Ckk]
                         @ wmat[g * Fg:(g + 1) * Fg].t() for g in range(ng)],
                        dim=1)
    else:
        out = cols @ wmat.t()
    out = out.reshape(N, OH, OW, F_).permute(0, 3, 1, 2)
    if bias is not None and not no_bias:
        out = out + bias[None, :, None, None]
    return out


@register(name="_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), num_outputs=2,
          num_visible_outputs=1)
def deformable_psroi_pooling(data, rois, trans, spatial_scale=1.0,
                             output_dim=1, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """Deformable position-sensitive RoI pooling: each bin the mean of its
    ``sample_per_part``² bilinear samples, shifted by the learned part
    offsets ``trans`` (R, 2, PS, PS) times ``trans_std`` and the RoI's
    size; output d of bin (ph, pw) reads channel (d*G + gh)*G + gw.
    Returns (pooled (R, output_dim, P, P), zeros of its shape)."""
    _refuse_batch_axis("DeformablePSROIPooling", (0,), data.dim())
    N, C, H, W = data.shape
    P, D, G = int(pooled_size), int(output_dim), int(group_size)
    PS = int(part_size) or P
    SPP = int(sample_per_part)
    dev = data.device
    rois = rois.detach()
    R = rois.shape[0]
    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale - 0.5
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bin_w, bin_h = rw / P, rh / P
    sub_w, sub_h = bin_w / SPP, bin_h / SPP
    ph = torch.arange(P, device=dev)
    part = torch.clamp((ph.to(torch.float32) / P * PS).to(torch.int64), 0,
                       PS - 1)
    if no_trans:
        dy = data.new_zeros((R, P, P))
        dx = data.new_zeros((R, P, P))
    else:
        tr = trans[:, :, part[:, None], part[None, :]]      # (R, 2?, P, P)
        dy = tr[:, 0] * trans_std * rh[:, None, None]
        dx = tr[:, 1] * trans_std * rw[:, None, None]
    sy = torch.arange(SPP, device=dev) + 0.5
    r4 = (slice(None),) + (None,) * 4
    Y = y1[r4] + ph[None, :, None, None, None] * bin_h[r4] \
        + sy[None, None, None, :, None] * sub_h[r4] + dy[..., None, None]
    X = x1[r4] + ph[None, None, :, None, None] * bin_w[r4] \
        + sy[None, None, None, None, :] * sub_w[r4] + dx[..., None, None]
    grid = (R, P, P, SPP, SPP)
    gh = torch.clamp((ph.to(torch.float32) * G / P).to(torch.int64), 0, G - 1)
    chan = gh[:, None] * G + gh[None, :]                       # (P, P)
    outs = []
    for r in _chunks(R, C * H * W):
        vals = _bilinear_sample(data[bidx[r]], Y[r].expand((-1,) + grid[1:]),
                                X[r].expand((-1,) + grid[1:]))
        vals = vals.mean(dim=(-2, -1)).reshape(-1, D, G * G, P, P)
        idx = chan[None, None, None].expand(vals.shape[0], D, 1, P, P)
        outs.append(vals.gather(2, idx)[:, :, 0])
    pooled = torch.cat(outs) if outs else data.new_zeros((0, D, P, P))
    pooled = pooled.to(data.dtype)
    return pooled, torch.zeros_like(pooled)
