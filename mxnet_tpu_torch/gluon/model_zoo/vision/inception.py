"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``), for 299x299 inputs,
built from HybridSequential and HybridConcurrent, so that the whole
network traces to one graph under ``hybridize``."""
from __future__ import annotations

from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ...nn.basic_layers import HybridBlock
from ..custom_layers import HybridConcurrent
from ..model_store import load_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    out = HybridSequential()
    out.add(Conv2D(channels, kernel_size, strides=strides, padding=padding,
                   use_bias=False),
            BatchNorm(epsilon=0.001),
            Activation("relu"))
    return out


def _branch(use_pool, *conv_settings):
    out = HybridSequential()
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    for channels, kernel, stride, pad in conv_settings:
        out.add(_conv(channels, kernel, stride, pad))
    return out


def _make_A(pool_features):
    out = HybridConcurrent(concat_dim=1)
    out.add(_branch(None, (64, 1, 1, 0)))
    out.add(_branch(None, (48, 1, 1, 0), (64, 5, 1, 2)))
    out.add(_branch(None, (64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)))
    out.add(_branch("avg", (pool_features, 1, 1, 0)))
    return out


def _make_B():
    out = HybridConcurrent(concat_dim=1)
    out.add(_branch(None, (384, 3, 2, 0)))
    out.add(_branch(None, (64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)))
    out.add(_branch("max"))
    return out


def _make_C(channels_7x7):
    c7 = channels_7x7
    out = HybridConcurrent(concat_dim=1)
    out.add(_branch(None, (192, 1, 1, 0)))
    out.add(_branch(None, (c7, 1, 1, 0), (c7, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0))))
    out.add(_branch(None, (c7, 1, 1, 0), (c7, (7, 1), 1, (3, 0)),
                    (c7, (1, 7), 1, (0, 3)), (c7, (7, 1), 1, (3, 0)),
                    (192, (1, 7), 1, (0, 3))))
    out.add(_branch("avg", (192, 1, 1, 0)))
    return out


def _make_D():
    out = HybridConcurrent(concat_dim=1)
    out.add(_branch(None, (192, 1, 1, 0), (320, 3, 2, 0)))
    out.add(_branch(None, (192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)))
    out.add(_branch("max"))
    return out


class _SplitConv(HybridBlock):
    """A conv trunk whose output forks into parallel 1x3 / 3x1 convs
    (the expanded-filter-bank E block)."""

    def __init__(self, trunk_settings, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        trunk = HybridSequential()
        for channels, kernel, stride, pad in trunk_settings:
            trunk.add(_conv(channels, kernel, stride, pad))
        self.trunk = trunk
        self.register_child(trunk)
        fork = HybridConcurrent(concat_dim=1)
        fork.add(_conv(384, (1, 3), 1, (0, 1)))
        fork.add(_conv(384, (3, 1), 1, (1, 0)))
        self.fork = fork
        self.register_child(fork)

    def forward(self, x):
        return self.fork(self.trunk(x))


def _make_E():
    out = HybridConcurrent(concat_dim=1)
    out.add(_branch(None, (320, 1, 1, 0)))
    out.add(_SplitConv([(384, 1, 1, 0)]))
    out.add(_SplitConv([(448, 1, 1, 0), (384, 3, 1, 1)]))
    out.add(_branch("avg", (192, 1, 1, 0)))
    return out


class Inception3(HybridBlock):
    """Inception v3 for 299x299 inputs."""

    def __init__(self, classes=1000, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            features = HybridSequential()
            features.add(_conv(32, 3, 2, 0),
                         _conv(32, 3, 1, 0),
                         _conv(64, 3, 1, 1),
                         MaxPool2D(pool_size=3, strides=2),
                         _conv(80, 1, 1, 0),
                         _conv(192, 3, 1, 0),
                         MaxPool2D(pool_size=3, strides=2),
                         _make_A(32), _make_A(64), _make_A(64),
                         _make_B(),
                         _make_C(128), _make_C(160), _make_C(160),
                         _make_C(192),
                         _make_D(),
                         _make_E(), _make_E())
            self.features = features
            self.register_child(features)
            classifier = HybridSequential()
            classifier.add(GlobalAvgPool2D(),
                           Dropout(0.5),
                           Flatten(),
                           Dense(classes))
            self.classifier = classifier
            self.register_child(classifier)

    def forward(self, x):
        return self.classifier(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Inception v3; ``pretrained`` loads the model store's local file."""
    return load_pretrained(Inception3(**kwargs), "inceptionv3", pretrained,
                           ctx, root)
