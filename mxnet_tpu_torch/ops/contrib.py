"""Contrib ops (counterpart of ``mxnet_tpu/ops/contrib.py``, every name of
it): CTC loss, the SSD MultiBox ops, quantization, count sketch, FFT and
the 2-bit gradient compression, with the JAX package's names, aliases,
attributes and ``nondiff`` flags. None is a Pallas kernel there: these are
torch ops (cuFFT through ``torch.fft`` on the card).

Where the JAX package's behaviour is not MXNet's, the port follows it
(ROADMAP.md Queue C lists each):

- ``ctc_loss`` counts a label where ``0 <= lab < C`` (after the shift of
  ``blank_label="first"``), wherever it sits in the row, and floors the
  log-semiring at -1e30; it is differentiable through autograd;
- ``MultiBoxTarget`` accepts ``negative_mining_ratio``,
  ``negative_mining_thresh`` and ``minimum_negative_samples`` and ignores
  them (every unmatched anchor is class 0, none is ``ignore_label``); its
  ``argmax`` ties take the first index; the forced match of each label row
  to its best anchor is a scatter whose duplicate indices keep the last
  row's write (a padded row, whose best anchor is anchor 0, cancels an
  earlier real box's forced match there);
- ``MultiBoxDetection`` ignores ``nms_topk``; it orders boxes by a stable
  sort of ``-score`` and keeps box ``i`` when it passes ``threshold`` and
  no earlier kept box of its class (any class with ``force_suppress``)
  overlaps it by more than ``nms_threshold``.

``MultiBoxDetection`` reaches that greedy result without a loop over the
boxes: with ``sup[i, j]`` "j is earlier than i and would suppress it",
the kept set is the fixed point of ``kept = keep & ~any(sup & kept)``,
which is unique (``sup`` is strictly lower triangular) and which the
iteration from ``kept = keep`` reaches after as many rounds as the
longest suppression chain (at most the box count). It runs one image at
a time, so the (A, A) matrix (76 M entries at SSD300's 8732 anchors) is
never held for the whole batch; :data:`nms_rounds` counts the rounds.

Under a data-parallel mesh these ops are per row (per image, per
sequence: ``ctc_loss``'s batch is axis 1 of ``data``) and give the rank's
rows of the batch's result; ``MultiBoxPrior``'s anchors depend on its
input's shape only and are no batch rows (registered ``batch_free``).
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import alias, register

_NEG_INF = -1e30


@register(name="_contrib_ctc_loss", aliases=("ctc_loss", "CTCLoss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="last"):
    """CTC negative log-likelihood a sequence by the log-semiring forward
    recursion. data: (T, N, C) activations (log-softmax applied here);
    label: (N, L) class indices, padded; returns (N,)."""
    T, N, C = data.shape
    L = label.shape[1]
    logp = torch.log_softmax(data, dim=-1)
    dev = data.device
    blank = C - 1 if blank_label == "last" else 0
    lab = label.to(torch.int32)
    if blank_label == "first":
        lab = lab - 1
    if use_label_lengths and label_lengths is not None:
        lab_len = torch.as_tensor(label_lengths, device=dev).to(torch.int64)
    else:
        lab_len = ((lab >= 0) & (lab < C)).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        seq_len = torch.as_tensor(data_lengths, device=dev).to(torch.int64)
    else:
        seq_len = torch.full((N,), T, dtype=torch.int64, device=dev)
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab.clamp(0, C - 1).long()
    pos = torch.arange(S, device=dev)[None, :]
    valid_ext = pos < (2 * lab_len[:, None] + 1)
    ext_prev2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                      device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_prev2)
    neg = logp.new_full((), _NEG_INF)
    emit0 = logp[0].gather(1, ext)                       # (N, S)
    init = logp.new_full((N, S), _NEG_INF)
    init = torch.cat([emit0[:, :1],
                      torch.where(lab_len > 0, emit0[:, 1], neg)[:, None],
                      init[:, 2:]], dim=1)
    pad1 = logp.new_full((N, 1), _NEG_INF)
    pad2 = logp.new_full((N, 2), _NEG_INF)
    alpha = init
    for t in range(1, T):
        a_new = torch.logaddexp(alpha,
                                torch.cat([pad1, alpha[:, :-1]], dim=1))
        a_new = torch.where(can_skip, torch.logaddexp(
            a_new, torch.cat([pad2, alpha[:, :-2]], dim=1)), a_new)
        a_new = a_new + logp[t].gather(1, ext)
        a_new = torch.where(valid_ext, a_new, neg)
        alpha = torch.where((t < seq_len)[:, None], a_new, alpha)
    end1 = (2 * lab_len)[:, None]
    end2 = torch.clamp_min(2 * lab_len - 1, 0)[:, None]
    ll = torch.logaddexp(alpha.gather(1, end1)[:, 0],
                         torch.where(lab_len > 0,
                                     alpha.gather(1, end2)[:, 0], neg))
    return -ll


# ---------------------------------------------------------------------------
# SSD MultiBox ops
# ---------------------------------------------------------------------------
def _floats(v):
    return tuple(float(s) for s in (v if isinstance(v, (tuple, list))
                                    else (v,)))


@register(name="_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          nondiff=True, batch_free=True)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes (1, H*W*A, 4) as [xmin, ymin, xmax, ymax] of ``data``'s
    feature map: at each centre, sizes[0] with every ratio, then the other
    sizes at ratios[0]; A = len(sizes) + len(ratios) - 1."""
    h, w = data.shape[2], data.shape[3]
    sizes, ratios = _floats(sizes), _floats(ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, device=dev, dtype=torch.float32) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, device=dev, dtype=torch.float32) + offsets[1]) \
        * step_x
    cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), dim=-1) \
        .reshape(-1, 2)
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    whs = torch.tensor(np.asarray(whs, np.float32), device=dev)
    centers = cyx.repeat_interleave(len(whs), dim=0)
    dims = whs.repeat(h * w, 1)
    out = torch.stack([centers[:, 1] - dims[:, 0] / 2,
                       centers[:, 0] - dims[:, 1] / 2,
                       centers[:, 1] + dims[:, 0] / 2,
                       centers[:, 0] + dims[:, 1] / 2], dim=1)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out[None]


def _iou(a, b):
    """IoU of boxes a (..., A, 4) against b (..., M, 4): (..., A, M)."""
    ax1, ay1, ax2, ay2 = (a[..., k:k + 1] for k in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, k] for k in range(4))
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         0)
    inter = iw * ih
    area_a = torch.clamp_min((ax2 - ax1) * (ay2 - ay1), 0)
    area_b = torch.clamp_min((bx2 - bx1) * (by2 - by1), 0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, inter.new_zeros(()))


def _encode(anc, gt, variances):
    """Centre-size targets of gt boxes (N, A, 4) on anchors (A, 4)."""
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    aw8, ah8 = torch.clamp_min(aw, 1e-8), torch.clamp_min(ah, 1e-8)
    tx = (gcx - acx) / aw8 / variances[0]
    ty = (gcy - acy) / ah8 / variances[1]
    tw = torch.log(torch.clamp_min(gw / aw8, 1e-8)) / variances[2]
    th = torch.log(torch.clamp_min(gh / ah8, 1e-8)) / variances[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


@register(name="_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3, nondiff=True)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Anchor-to-label matching and box-target encoding. anchor (1, A, 4);
    label (N, M, 5) rows [cls, xmin, ymin, xmax, ymax], cls < 0 a pad;
    cls_pred (N, C, A), read for nothing. Returns box_target (N, A*4),
    box_mask (N, A*4) and cls_target (N, A) (matched class + 1, else 0).
    An anchor matches the label row of its best IoU when that reaches
    ``overlap_threshold``; each real row also claims its best anchor (the
    last row to claim an anchor wins it, a pad claiming nothing)."""
    anc = anchor[0]
    A = anc.shape[0]
    N, M, _ = label.shape
    valid = label[..., 0] >= 0                                   # (N, M)
    ious = _iou(anc.expand(N, A, 4), label[..., 1:5]) * valid[:, None, :]
    best_iou = ious.amax(dim=2)
    best_gt = ious.argmax(dim=2)
    matched = best_iou >= overlap_threshold
    best_anchor = ious.argmax(dim=1)                             # (N, M)
    rows = torch.arange(M, device=label.device).expand(N, M)
    last = torch.full((N, A), -1, dtype=torch.int64, device=label.device)
    last.scatter_reduce_(1, best_anchor, rows, reduce="amax")
    claimed = last >= 0
    last0 = last.clamp_min(0)
    forced = claimed & valid.gather(1, last0)
    use_gt = torch.where(forced, last0, best_gt)
    pos = matched | forced
    lab = label.gather(1, use_gt[..., None].expand(N, A, 5))
    targets = _encode(anc, lab[..., 1:5], variances)
    cls_t = torch.where(pos, lab[..., 0] + 1.0, label.new_zeros(()))
    box_t = torch.where(pos[..., None], targets, targets.new_zeros(()))
    box_m = pos[..., None].to(label.dtype).expand(N, A, 4)
    return box_t.reshape(N, -1), box_m.reshape(N, -1), cls_t


# NMS rounds of the last MultiBoxDetection and Proposal calls (the fixed
# point's iterations, summed over the images); read and reset by callers
nms_rounds = [0]
# rows of the (A, A) suppression matrix built at a time
_SUP_ROWS = 1024
# rounds between two checks of the fixed point (each check reads one
# flag back to the host)
_CHECK_EVERY = 4


def _box_areas(boxes, offset):
    x1, y1, x2, y2 = boxes.unbind(1)
    return (torch.clamp_min(x2 - x1 + offset, 0)
            * torch.clamp_min(y2 - y1 + offset, 0))


def _suppression(boxes, nms_threshold, cls=None, offset=0.0):
    """sup[i, j]: box j is earlier than box i (both sorted by score), of
    its class (any when ``cls`` is None), and overlaps it by more than
    ``nms_threshold`` (boxes (A, 4), one image). ``offset`` is 1.0 for
    the pixel convention of Proposal (a box's width is x2 - x1 + 1)."""
    A = boxes.shape[0]
    x1, y1, x2, y2 = boxes.unbind(1)
    area = _box_areas(boxes, offset)
    sup = torch.empty((A, A), dtype=torch.bool, device=boxes.device)
    cols = torch.arange(A, device=boxes.device)
    for r0 in range(0, A, _SUP_ROWS):
        r = slice(r0, min(r0 + _SUP_ROWS, A))
        ix1 = torch.maximum(x1[r, None], x1[None, :])
        iy1 = torch.maximum(y1[r, None], y1[None, :])
        ix2 = torch.minimum(x2[r, None], x2[None, :])
        iy2 = torch.minimum(y2[r, None], y2[None, :])
        inter = (torch.clamp_min(ix2 - ix1 + offset, 0)
                 * torch.clamp_min(iy2 - iy1 + offset, 0))
        union = area[r, None] + area[None, :] - inter
        iou = torch.where(union > 0, inter / union, inter.new_zeros(()))
        s = (iou > nms_threshold) & (cols[None, :] < cols[r, None])
        if cls is not None:
            s &= cls[r, None] == cls[None, :]
        sup[r] = s
    return sup


def _greedy_keep(keep, sup):
    """The greedy NMS's kept set: the fixed point of ``kept = keep &
    ~any(sup & kept)`` from ``kept = keep``."""
    kept = keep
    while True:
        for _ in range(_CHECK_EVERY):
            prev, kept = kept, keep & ~(sup & kept[None, :]).any(dim=1)
        nms_rounds[0] += _CHECK_EVERY
        if torch.equal(prev, kept):
            return kept


def greedy_nms_indices(boxes, keep, nms_threshold, max_out, offset=0.0):
    """Proposal's NMS of one image's candidates (boxes (n, 4) sorted by
    score, ``keep`` the live ones): the first ``max_out`` kept indices,
    -1 past the last, as the JAX package's ``max_out`` argmax rounds give
    them. A kept box that does not suppress itself (zero area, or
    ``nms_threshold >= 1``) stays the argmax there, so it fills the
    rounds after it."""
    if max_out == 0:
        return torch.empty((0,), dtype=torch.int64, device=boxes.device)
    kept = _greedy_keep(keep, _suppression(boxes, nms_threshold,
                                           offset=offset))
    n = kept.shape[0]
    pos = torch.cumsum(kept, 0) - 1
    take = kept & (pos < max_out)
    out = torch.full((max_out + 1,), -1, dtype=torch.int64,
                     device=boxes.device)
    out.index_put_((torch.where(take, pos, max_out),),
                   torch.arange(n, device=boxes.device))
    out = out[:max_out]
    area = _box_areas(boxes, offset)
    self_sup = (area > 0) & (1.0 > nms_threshold)
    stuck = (out >= 0) & ~self_sup[out.clamp_min(0)]
    first = torch.where(stuck.any(), stuck.to(torch.int8).argmax(),
                        out.new_full((), max_out))
    rounds = torch.arange(max_out, device=boxes.device)
    return torch.where(rounds > first, out[first.clamp_max(max_out - 1)],
                       out)


@register(name="_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          nondiff=True)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decoding and greedy NMS: (N, A, 6) rows [class, score, xmin, ymin,
    xmax, ymax] sorted by score, class -1 for a box not kept. cls_prob
    (N, C, A), loc_pred (N, A*4), anchor (1, A, 4)."""
    N, C, A = cls_prob.shape
    anc = anchor[0]
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    score = fg.amax(dim=1)
    cls_id = fg.argmax(dim=1).to(torch.float32)
    order = torch.argsort(-score, dim=1, stable=True)
    boxes_s = boxes.gather(1, order[..., None].expand(N, A, 4))
    score_s = score.gather(1, order)
    cls_s = cls_id.gather(1, order)
    keep_s = score_s > threshold
    if cls_prob.device.type == "meta":      # shape inference
        return torch.cat([cls_s[..., None], score_s[..., None], boxes_s],
                         dim=-1)
    outs = []
    for n in range(N):
        sup = _suppression(boxes_s[n], nms_threshold,
                           None if force_suppress else cls_s[n])
        kept = _greedy_keep(keep_s[n], sup)
        del sup
        outs.append(torch.where(kept, cls_s[n], cls_s.new_full((), -1.0)))
    out_cls = torch.stack(outs) if outs else cls_s
    return torch.cat([out_cls[..., None], score_s[..., None], boxes_s],
                     dim=-1)


# ---------------------------------------------------------------------------
# quantization, count sketch, FFT, 2-bit compression
# ---------------------------------------------------------------------------
@register(name="_contrib_quantize", num_outputs=3, nondiff=True)
def quantize(data, min_range, max_range, out_type="uint8"):
    r_min = min_range.reshape(())
    r_max = max_range.reshape(())
    if out_type == "uint8":
        scale = 255.0 / torch.clamp_min(r_max - r_min, 1e-8)
        q = torch.clamp(torch.round((data - r_min) * scale), 0, 255) \
            .to(torch.uint8)
    else:
        scale = 127.0 / torch.clamp_min(torch.maximum(r_min.abs(),
                                                      r_max.abs()), 1e-8)
        q = torch.clamp(torch.round(data * scale), -127, 127).to(torch.int8)
    return q, r_min.reshape(1), r_max.reshape(1)


@register(name="_contrib_dequantize", nondiff=True)
def dequantize(data, min_range, max_range, out_type="float32"):
    r_min = min_range.reshape(())
    r_max = max_range.reshape(())
    if data.dtype == torch.uint8:
        scale = (r_max - r_min) / 255.0
        return data.to(torch.float32) * scale + r_min
    scale = torch.maximum(r_min.abs(), r_max.abs()) / 127.0
    return data.to(torch.float32) * scale


@register(name="_contrib_count_sketch", nondiff=True)
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """out[:, h[i] % out_dim] += data[:, i] * s[i]; duplicate ``h``
    accumulate."""
    n = data.shape[0]
    od = int(out_dim)
    hh = h.reshape(-1).to(torch.int64).remainder(od)
    out = data.new_zeros((n, od))
    return out.index_add_(1, hh, data * s.reshape(-1)[None, :])


@register(name="_contrib_fft", nondiff=True)
def fft(data, compute_size=128):
    """FFT over the last axis, real and imaginary parts interleaved."""
    out = torch.fft.fft(data, dim=-1)
    return torch.stack([out.real, out.imag], dim=-1) \
        .reshape(data.shape[:-1] + (-1,)).to(torch.float32)


@register(name="_contrib_ifft", nondiff=True)
def ifft(data, compute_size=128):
    """Inverse FFT of interleaved (real, imaginary) pairs, real part, times
    the length (the reference's unnormalised inverse)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (n, 2)).to(torch.float32)
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32) * n


@register(name="_contrib_quantize_2bit", nondiff=True, num_outputs=2)
def quantize_2bit(grad, residual, threshold=0.5):
    g = grad + residual
    zero = g.new_zeros(())
    q = torch.where(g >= threshold, g.new_full((), threshold),
                    torch.where(g <= -threshold, g.new_full((), -threshold),
                                zero))
    return q.to(grad.dtype), (g - q).to(grad.dtype)


@register(name="_contrib_dequantize_2bit", nondiff=True)
def dequantize_2bit(data, threshold=0.5):
    return data


alias("_contrib_CTCLoss", "_contrib_ctc_loss")
