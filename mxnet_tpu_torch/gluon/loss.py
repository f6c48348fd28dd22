"""Gluon's losses (counterpart of ``mxnet_tpu/gluon/loss.py``): L2, L1,
sigmoid binary cross-entropy, softmax cross-entropy, KL divergence, Huber,
hinge, squared hinge, logistic, triplet and CTC, each a HybridBlock whose
forward returns one loss a sample.
"""
from __future__ import annotations

from ..ndarray.ndarray import invoke
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        assert isinstance(weight, (float, int)), "weight must be a number"
        loss = loss * weight
    return loss


def _per_sample(loss):
    """The mean over every axis but the first (the batch's)."""
    if loss.ndim > 1:
        return loss.mean(axis=tuple(range(1, loss.ndim)))
    return loss


def _softplus_form(pred, label):
    """``max(x, 0) - x z + log(1 + exp(-|x|))``, the logistic loss in a
    form that does not overflow."""
    return invoke("relu", [pred], {}) - pred * label + invoke(
        "Activation", [-pred.abs()], {"act_type": "softrelu"})


def _reshape_like(pred, label):
    if pred.shape != label.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        s = "{name}(batch_axis={_batch_axis}, w={_weight})"
        return s.format(name=self.__class__.__name__, **self.__dict__)

    def _call_cached(self, args):
        # a loss's forward reads its inputs' shapes (the label's reshape,
        # the mean a sample), which a traced Symbol does not carry: it runs
        # eagerly, hybridized or not
        return self.forward(*args)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (pred - label).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _per_sample(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (pred - label).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            loss = _softplus_form(pred, label)
        else:
            eps = 1e-12
            loss = -((pred + eps).log() * label
                     + (1.0 - pred + eps).log() * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = pred.log_softmax(axis=self._axis)
        if self._sparse_label:
            loss = -invoke("pick", [pred, label], {"axis": self._axis,
                                                   "keepdims": True})
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(axis=self._axis, keepdims=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = pred.log_softmax(axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (pred - label).abs()
        small = loss < self._rho
        loss = small * (loss.square() / (2 * self._rho)) \
            + (1 - small) * (loss - self._rho / 2)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = invoke("relu", [self._margin - pred * label], {})
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = invoke("relu", [self._margin - pred * label], {}).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _per_sample(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if self._label_format not in ["signed", "binary"]:
            raise ValueError("label_format can only be signed or binary, "
                             "received %s" % label_format)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = _apply_weighting(_softplus_form(pred, label), self._weight,
                                sample_weight)
        return _per_sample(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = (
            (pred - positive).square() - (pred - negative).square()
        ).sum(axis=tuple(range(1, pred.ndim))) + self._margin
        loss = invoke("relu", [loss], {})
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """CTC loss over the registered ``_contrib_ctc_loss`` op, the blank
    label last."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None, **kwargs):
        assert layout in ["NTC", "TNC"]
        assert label_layout in ["NT", "TN"]
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._batch_axis == 1:
            label = label.swapaxes(0, 1)
        loss = invoke(
            "_contrib_ctc_loss",
            [pred, label, pred_lengths, label_lengths],
            {
                "use_data_lengths": pred_lengths is not None,
                "use_label_lengths": label_lengths is not None,
                "blank_label": "last",
            },
        )
        return _apply_weighting(loss, self._weight, sample_weight)
