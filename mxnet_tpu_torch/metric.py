"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

``EvalMetric`` with ``update``/``update_dict``/``get``/``reset``, the
registry (``create``: a name, a list of them, a callable or an instance),
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``,
``Perplexity``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``PearsonCorrelation``, ``Loss``,
``CustomMetric`` and ``np``. The sums run in numpy on the host, as in the
JAX package: labels and predictions (NDArrays or tensors) are copied off
the card once per ``update_dict``. Module(kvstore='tpu')'s fused group
can attach device sources to a metric instead (``_attach_device_source``):
the step's sums stay on the card until ``get`` reads them.
"""
from __future__ import annotations

import numpy
import torch

from .base import MXNetError

_METRIC_REGISTRY = {}


def register(*names):
    def deco(klass):
        for n in names or (klass.__name__.lower(),):
            _METRIC_REGISTRY[n] = klass
        return klass

    return deco


def _materialize_dicts(label, pred):
    """Both name -> array dicts with every value as host numpy."""
    return ({k: _as_numpy(v) for k, v in label.items()},
            {k: _as_numpy(v) for k, v in pred.items()})


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape[0], preds.shape[0]
    if label_shape != pred_shape:
        raise MXNetError(
            "Shape of labels %d does not match shape of predictions %d" % (label_shape, pred_shape)
        )


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update(
            {"metric": self.__class__.__name__, "name": self.name,
             "output_names": self.output_names, "label_names": self.label_names}
        )
        return config

    def update_dict(self, label, pred):
        label, pred = _materialize_dicts(label, pred)
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    # -- sums kept on the card (Module(kvstore='tpu')'s fused group) ---------
    def _attach_device_source(self, source):
        """Register a device accumulator whose (sum, count) stays on the
        card until :meth:`get` folds it in: one host sync per read."""
        srcs = self.__dict__.setdefault("_device_sources", [])
        if source not in srcs:
            srcs.append(source)

    def _fold_device_sources(self):
        for src in self.__dict__.get("_device_sources", ()):
            s, n = src.drain()
            if n:
                self.sum_metric += s
                self.num_inst += n

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        for src in self.__dict__.get("_device_sources", ()):
            src.clear()

    def get(self):
        self._fold_device_sources()
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        # copied to the host once for all children
        labels, preds = _materialize_dicts(labels, preds)
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


def _as_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return numpy.asarray(x)


@register("acc", "accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, axis=axis, output_names=output_names, label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred_label in zip(labels, preds):
            label, pred_label = _as_numpy(label), _as_numpy(pred_label)
            if pred_label.shape != label.shape:
                pred_label = numpy.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


@register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None, label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names, label_names=label_names)
        self.top_k = top_k
        if self.top_k <= 1:
            raise MXNetError("Please use Accuracy if top_k is no more than 1")
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred_label in zip(labels, preds):
            label, pred_label = _as_numpy(label), _as_numpy(pred_label)
            if len(pred_label.shape) > 2:
                pred_label = pred_label.reshape(pred_label.shape[0], -1)
            pred_label = numpy.argsort(pred_label.astype("float32"), axis=1)
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.ravel() == label).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred_label[:, num_classes - 1 - j].ravel() == label).sum()
            self.num_inst += num_samples


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names=output_names, label_names=label_names)
        self.average = average
        self.metrics = _BinaryClassMetrics()

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_as_numpy(label), _as_numpy(pred))
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


class _BinaryClassMetrics:
    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0

    def update_binary_stats(self, label, pred):
        pred_label = numpy.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if len(numpy.unique(label)) > 2:
            raise MXNetError("%s currently only supports binary classification." % self.__class__.__name__)
        for y_pred, y_true in zip(pred_label.ravel(), label.ravel()):
            if y_pred == 1 and y_true == 1:
                self.true_positives += 1
            elif y_pred == 1 and y_true == 0:
                self.false_positives += 1
            elif y_pred == 0 and y_true == 1:
                self.false_negatives += 1
            else:
                self.true_negatives += 1

    @property
    def precision(self):
        tot = self.true_positives + self.false_positives
        return self.true_positives / tot if tot > 0 else 0.0

    @property
    def recall(self):
        tot = self.true_positives + self.false_negatives
        return self.true_positives / tot if tot > 0 else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision + self.recall)
        return 0.0

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives + self.true_negatives + self.true_positives)


@register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            label = label.reshape(-1).astype("int32")
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[numpy.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += probs.shape[0]
        self.sum_metric += numpy.exp(loss / num) * num if num > 0 else 0.0
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register("rmse")
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register("ce", "cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names, label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names, label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, (label.shape[0], num_examples)
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label, pred = _as_numpy(label), _as_numpy(pred)
            check_label_shapes(label, pred)
            self.sum_metric += numpy.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, _, preds):
        for pred in preds:
            loss = _as_numpy(pred).sum()
            self.sum_metric += loss
            self.num_inst += _as_numpy(pred).size


@register("custom")
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False, output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval, allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds, shape=True)
        for pred, label in zip(preds, labels):
            label, pred = _as_numpy(label), _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        klass = _METRIC_REGISTRY.get(metric.lower())
        if klass is None:
            raise MXNetError("unknown metric %r" % metric)
        return klass(*args, **kwargs)
    raise MXNetError("cannot create metric from %r" % (metric,))
