"""Detection mAP metrics (counterpart of
``mxnet_tpu/contrib/eval_metric.py``, after
``example/ssd/evaluate/eval_metric.py``): ``MApMetric`` (area under the
precision envelope) and ``VOC07MApMetric`` (PASCAL VOC 2007's 11-point
interpolation), numpy only.

- labels: (B, N, 5) or (B, N, 6) ground truths an image, rows ``[cls,
  xmin, ymin, xmax, ymax, (difficult)]``; cls < 0 is a pad;
- preds[pred_idx]: (B, M, 6) detections (``MultiBoxDetection``'s output),
  rows ``[cls, score, xmin, ymin, xmax, ymax]``; cls < 0 is suppressed.

Each (image, class) takes one IoU matrix and a greedy assignment in score
order; the per-class score and true-positive rows fold into AP at
:meth:`MApMetric.get`.
"""
from __future__ import annotations

import numpy as np

from ..metric import EvalMetric, register


def _iou_matrix(dets, gts):
    """IoU of every det box against every gt box: (D, G)."""
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:4], gts[None, :, 2:4])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.prod(np.clip(dets[:, 2:4] - dets[:, :2], 0.0, None), axis=1)
    area_g = np.prod(np.clip(gts[:, 2:4] - gts[:, :2], 0.0, None), axis=1)
    union = area_d[:, None] + area_g[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 1e-12, inter / union, 0.0)
    return iou


@register("m_ap", "mAP")
class MApMetric(EvalMetric):
    """Mean average precision over detection classes.

    Parameters mirror the reference: ``ovp_thresh`` IoU for a true
    positive, ``use_difficult`` counts difficult ground truths,
    ``class_names`` reports per-class AP rows plus the mean,
    ``pred_idx`` selects the detection output.
    """

    def __init__(self, ovp_thresh=0.5, use_difficult=False,
                 class_names=None, pred_idx=0, name="mAP", **kwargs):
        self.ovp_thresh = float(ovp_thresh)
        self.use_difficult = bool(use_difficult)
        self.class_names = list(class_names) if class_names else None
        self.pred_idx = int(pred_idx)
        super().__init__(name, **kwargs)

    def reset(self):
        # per-class: list of (score, is_tp) rows + total gt count
        self._scores = {}
        self._gt_counts = {}

    def _to_np(self, x):
        return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)

    def update(self, labels, preds):
        labels = self._to_np(labels[0])
        preds = self._to_np(preds[self.pred_idx])
        for img_label, img_pred in zip(labels, preds):
            self._update_image(np.asarray(img_label, np.float64),
                               np.asarray(img_pred, np.float64))

    def _update_image(self, gts, dets):
        gts = gts[gts[:, 0] >= 0]
        if len(gts) == 0:
            # ref parity: images with no (non-pad) ground truth are
            # skipped entirely — their detections are NOT false
            # positives (eval_metric.py "if np.sum(label[:, 0] >= 0)
            # < 1: continue"); counting them would depress mAP vs the
            # 77.8 VOC07 baseline on datasets with empty images
            return
        dets = dets[dets[:, 0] >= 0]
        difficult = (gts[:, 5] > 0 if gts.shape[1] >= 6 and
                     not self.use_difficult
                     else np.zeros(len(gts), dtype=bool))
        classes = set(gts[:, 0].astype(int)) | set(dets[:, 0].astype(int))
        for cid in classes:
            g = gts[gts[:, 0].astype(int) == cid]
            g_diff = difficult[gts[:, 0].astype(int) == cid]
            d = dets[dets[:, 0].astype(int) == cid]
            d = d[np.argsort(-d[:, 1])]  # score descending
            n_gt = int((~g_diff).sum())
            rows = []
            if len(d):
                if len(g):
                    iou = _iou_matrix(d[:, 2:6], g[:, 1:5])
                    taken = np.zeros(len(g), dtype=bool)
                    for j in range(len(d)):
                        best = int(np.argmax(iou[j]))
                        if iou[j, best] > self.ovp_thresh:
                            if g_diff[best]:
                                continue  # matched difficult: uncounted
                            if not taken[best]:
                                taken[best] = True
                                rows.append((d[j, 1], 1))
                            else:
                                rows.append((d[j, 1], 0))  # duplicate: fp
                        else:
                            rows.append((d[j, 1], 0))
                else:
                    rows = [(s, 0) for s in d[:, 1]]
            self._scores.setdefault(cid, []).extend(rows)
            self._gt_counts[cid] = self._gt_counts.get(cid, 0) + n_gt

    def _class_ap(self, cid):
        rows = np.asarray(self._scores.get(cid, ()), np.float64)
        n_gt = self._gt_counts.get(cid, 0)
        if rows.size == 0:
            return 0.0 if n_gt > 0 else float("nan")
        order = np.argsort(-rows[:, 0])
        tp = np.cumsum(rows[order, 1])
        fp = np.cumsum(1.0 - rows[order, 1])
        recall = tp / n_gt if n_gt > 0 else tp * 0.0
        precision = tp / np.maximum(tp + fp, 1e-12)
        return self._average_precision(recall, precision)

    @staticmethod
    def _average_precision(recall, precision):
        """Area under the monotone precision envelope."""
        r = np.concatenate(([0.0], recall, [1.0]))
        p = np.concatenate(([0.0], precision, [0.0]))
        p = np.maximum.accumulate(p[::-1])[::-1]
        steps = np.nonzero(r[1:] != r[:-1])[0]
        return float(np.sum((r[steps + 1] - r[steps]) * p[steps + 1]))

    def get(self):
        cids = sorted(set(self._scores) | set(self._gt_counts))
        aps = {cid: self._class_ap(cid) for cid in cids}
        valid = [v for v in aps.values() if not np.isnan(v)]
        mean = float(np.mean(valid)) if valid else float("nan")
        if self.class_names is None:
            return (self.name, mean)
        names = list(self.class_names) + [self.name]
        values = [aps.get(i, float("nan"))
                  for i in range(len(self.class_names))] + [mean]
        return (names, values)


@register("voc07_m_ap", "VOC07MApMetric")
class VOC07MApMetric(MApMetric):
    """PASCAL VOC 2007 11-point interpolated AP."""

    @staticmethod
    def _average_precision(recall, precision):
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            best = float(np.max(precision[mask])) if mask.any() else 0.0
            ap += best / 11.0
        return ap
