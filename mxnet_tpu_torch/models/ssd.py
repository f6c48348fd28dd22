"""SSD300 detector, VGG16-reduced backbone (counterpart of
``mxnet_tpu/models/ssd.py``, after ``example/ssd/symbol/symbol_builder.py``
and ``vgg16_reduced.py``): the same graphs, node names and Symbol JSON.

The multi-scale feature maps feed one multibox head; training assigns
anchors with ``MultiBoxTarget`` and takes a softmax class loss and a
smooth-L1 box loss, inference decodes and suppresses with
``MultiBoxDetection`` (``ops/contrib.py``). At 300x300 the pyramid gives
8732 anchors. The tiny detector runs the same chain on a 3-stage backbone
with one anchor layer.
"""
from .. import symbol as sym

# per-layer anchor config for 300x300 (example/ssd/symbol/symbol_factory.py)
_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79), (0.88, 0.961)]
_RATIOS = [(1, 2, 0.5), (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
           (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5), (1, 2, 0.5)]


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1)):
    c = sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                        num_filter=num_filter, name=name)
    return sym.Activation(data=c, act_type="relu", name=name + "_relu")


def _backbone(data):
    """VGG16-reduced: conv stages + dilated fc6/fc7 convs; returns the
    multi-scale feature pyramid."""
    from .vgg import _CFGS

    feats = []
    x = data
    for i, (reps, filters) in enumerate(_CFGS[16], 1):
        for j in range(1, reps + 1):
            x = _conv_act(x, "conv%d_%d" % (i, j), filters)
        if i == 4:
            feats.append(x)  # conv4_3 → 38x38 head (L2-normalized below)
        if i < 5:
            # pooling_convention="full" (ceil) keeps conv4_3 at 38x38 and
            # fc7 at 19x19 for 300x300 input (ref vgg16_reduced.py)
            x = sym.Pooling(data=x, kernel=(2, 2), stride=(2, 2),
                            pool_type="max", pooling_convention="full",
                            name="pool%d" % i)
        else:
            x = sym.Pooling(data=x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="max", name="pool%d" % i)
    x = sym.Convolution(data=x, kernel=(3, 3), pad=(6, 6), dilate=(6, 6),
                        num_filter=1024, name="fc6")
    x = sym.Activation(data=x, act_type="relu")
    x = _conv_act(x, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    feats.append(x)  # 19x19
    for k, (f1, f2, s) in enumerate(
            [(256, 512, 2), (128, 256, 2), (128, 256, 2), (128, 256, 2)], 8):
        x = _conv_act(x, "conv%d_1" % k, f1, kernel=(1, 1), pad=(0, 0))
        pad = (1, 1) if s == 2 and k < 10 else (0, 0)
        kernel = (3, 3)
        x = _conv_act(x, "conv%d_2" % k, f2, kernel=kernel, pad=pad,
                      stride=(s, s) if k < 10 else (1, 1))
        feats.append(x)
    return feats


def _multibox_head(feats, num_classes, sizes=None, ratios=None,
                   l2norm_first=True, prefix=""):
    """Shared per-feature-map loc/cls/anchor assembly; the layout
    contract (transpose/Flatten/Reshape ordering) consumed by
    MultiBoxTarget/Detection lives only here."""
    sizes = _SIZES if sizes is None else sizes
    ratios = _RATIOS if ratios is None else ratios
    loc_preds, cls_preds, anchors = [], [], []
    for i, feat in enumerate(feats):
        if i == 0 and l2norm_first:
            feat = sym.L2Normalization(data=feat, mode="channel",
                                       name="conv4_3_norm")
        n_anchor = len(sizes[i]) + len(ratios[i]) - 1
        loc = sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=n_anchor * 4,
                              name="%sloc_pred%d" % (prefix, i))
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(data=loc))
        cls = sym.Convolution(data=feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=n_anchor * (num_classes + 1),
                              name="%scls_pred%d" % (prefix, i))
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Reshape(data=cls, shape=(0, -1, num_classes + 1))
        cls_preds.append(cls)
        anchors.append(sym.contrib.MultiBoxPrior(
            feat, sizes=sizes[i], ratios=ratios[i], clip=True,
            name="%sanchor%d" % (prefix, i)))
    loc_pred = sym.Concat(*loc_preds, dim=1, name=prefix + "multibox_loc_pred")
    cls_pred = sym.Concat(*cls_preds, dim=1,
                          name=prefix + "multibox_cls_concat")
    cls_pred = sym.transpose(cls_pred, axes=(0, 2, 1))  # (N, C+1, A)
    anchor = sym.Concat(*anchors, dim=1, name=prefix + "multibox_anchors")
    return loc_pred, cls_pred, anchor


def _assemble_train(loc_pred, cls_pred, anchor):
    """Training tail: MultiBoxTarget + softmax cls + smooth-L1 loc
    (ref symbol_builder.py:get_symbol_train)."""
    label = sym.var("label")
    box_target, box_mask, cls_target = sym.contrib.MultiBoxTarget(
        anchor, label, cls_pred, overlap_threshold=0.5,
        ignore_label=-1.0, negative_mining_ratio=3.0,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    cls_prob = sym.SoftmaxOutput(data=cls_pred, label=cls_target,
                                 ignore_label=-1.0, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_pred - box_target
    masked = box_mask * loc_diff
    loc_loss = sym.MakeLoss(sym.smooth_l1(masked, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0.0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def _assemble_detect(loc_pred, cls_pred, anchor, nms_thresh, force_suppress,
                     nms_topk):
    """Inference tail: MultiBoxDetection output (N, A, 6)
    [cls, score, xmin, ymin, xmax, ymax] (ref get_symbol)."""
    cls_prob = sym.softmax(cls_pred, axis=1, name="cls_prob")
    return sym.contrib.MultiBoxDetection(
        cls_prob, loc_pred, anchor, nms_threshold=nms_thresh,
        force_suppress=force_suppress, nms_topk=nms_topk,
        variances=(0.1, 0.1, 0.2, 0.2), name="detection")


def get_symbol_train(num_classes=20, nms_thresh=0.5, force_suppress=False,
                     nms_topk=400, **kwargs):
    """Training symbol: outputs [cls_prob, loc_loss, cls_label]."""
    data = sym.var("data")
    loc_pred, cls_pred, anchor = _multibox_head(_backbone(data), num_classes)
    return _assemble_train(loc_pred, cls_pred, anchor)


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """Inference symbol over the full VGG16-reduced backbone."""
    data = sym.var("data")
    loc_pred, cls_pred, anchor = _multibox_head(_backbone(data), num_classes)
    return _assemble_detect(loc_pred, cls_pred, anchor, nms_thresh,
                            force_suppress, nms_topk)


# ---------------------------------------------------------------------------
# Tiny detector: the same target-assign → detect → NMS chain on a
# 3-stage backbone with one anchor layer. CPU-affordable, so the
# end-to-end mAP evidence (train → MultiBoxDetection → VOC07MApMetric)
# can run in CI; the full-size config above is the benchmark path.
# ---------------------------------------------------------------------------
def _tiny_head(data, num_classes):
    x = data
    for i, f in enumerate((16, 32, 64), 1):
        x = _conv_act(x, "tconv%d" % i, f)
        x = sym.Pooling(data=x, kernel=(2, 2), stride=(2, 2),
                        pool_type="max", name="tpool%d" % i)
    return _multibox_head([x], num_classes, sizes=[(0.35, 0.6)],
                          ratios=[(1.0, 2.0, 0.5)], l2norm_first=False,
                          prefix="t")


def get_tiny_symbol_train(num_classes=2, **kwargs):
    data = sym.var("data")
    loc_pred, cls_pred, anchor = _tiny_head(data, num_classes)
    return _assemble_train(loc_pred, cls_pred, anchor)


def get_tiny_symbol(num_classes=2, nms_thresh=0.45, force_suppress=False,
                    nms_topk=100, **kwargs):
    data = sym.var("data")
    loc_pred, cls_pred, anchor = _tiny_head(data, num_classes)
    return _assemble_detect(loc_pred, cls_pred, anchor, nms_thresh,
                            force_suppress, nms_topk)
