"""Functional optimizers (counterpart of ``mxnet_tpu/parallel/spmd.py``'s
``FunctionalOptimizer`` and ``functional_optimizer``).

The same names, arguments and update arithmetic as the JAX package, on
dicts of tensors: ``init(params) -> state`` and ``apply(params, grads,
state, step) -> (params, state)``. Unlike the JAX functions, which return
new arrays (the JAX train step donates its carry), ``apply`` updates the
params and the state in place under ``torch.no_grad()`` and returns the
same dicts, so a train step holds one copy of each. ``step`` is the
number of updates made before this one (an int).

Not ported yet: ``TrainStep`` and ``functional_from_optimizer``
(ROADMAP.md Queue A item 6).
"""
from __future__ import annotations

import math
import re

import torch

from ..base import MXNetError

__all__ = ["FunctionalOptimizer", "functional_optimizer"]


class FunctionalOptimizer:
    """init(params)->state dict; apply(params, grads, state, step)->new."""

    def __init__(self, init, apply, hyper=None):
        self.init = init
        self.apply = apply
        self.hyper = dict(hyper or {})


def functional_optimizer(name="sgd", learning_rate=0.01, momentum=0.0, wd=0.0,
                         beta1=0.9, beta2=0.999, epsilon=1e-8,
                         rescale_grad=1.0, clip_gradient=None,
                         lr_scheduler=None, wd_pattern=r".*(weight|gamma)$",
                         lr_mult=None, wd_mult=None):
    """Build an optimizer (``sgd``, with or without momentum, or ``adam``).
    ``wd_pattern``: params whose name matches get weight decay, others
    (bias/beta/moving stats) get 0 — set_wd_mult parity
    (python/mxnet/optimizer.py set_wd_mult). Explicit per-name ``lr_mult``
    / ``wd_mult`` dicts (default multiplier 1.0) override the pattern,
    mirroring Optimizer.set_lr_mult/set_wd_mult exactly. Gradients are
    taken in fp32, times ``rescale_grad``, clipped to ``clip_gradient``
    when it is > 0; ``lr_scheduler(step)`` replaces ``learning_rate``."""
    name = name.lower()
    wd_re = re.compile(wd_pattern)

    def lr_at(step):
        if lr_scheduler is not None:
            return lr_scheduler(step)
        return learning_rate

    def mults(k):
        lm = 1.0 if lr_mult is None else float(lr_mult.get(k, 1.0))
        if wd_mult is not None:
            wm = wd * float(wd_mult.get(k, 1.0))
        else:
            wm = wd if wd_re.match(k) else 0.0
        return lm, wm

    def prepared(k, grads, w):
        g = grads[k].float() * rescale_grad
        if clip_gradient is not None and clip_gradient > 0:
            g = g.clamp(-clip_gradient, clip_gradient)
        lm, this_wd = mults(k)
        return g + this_wd * w, lm

    if name == "sgd":
        def init(params):
            if momentum == 0.0:
                return {}
            return {k: torch.zeros_like(v) for k, v in params.items()}

        @torch.no_grad()
        def apply(params, grads, state, step):
            lr = lr_at(step)
            for k, w in params.items():
                g, lm = prepared(k, grads, w)
                if momentum == 0.0:
                    w.sub_((lr * lm) * g)
                else:
                    m = state[k]
                    m.mul_(momentum).sub_((lr * lm) * g)
                    w.add_(m)
            return params, state

        return FunctionalOptimizer(init, apply, dict(lr=learning_rate,
                                                     momentum=momentum, wd=wd))

    if name == "adam":
        def init(params):
            return {k: (torch.zeros_like(v), torch.zeros_like(v))
                    for k, v in params.items()}

        @torch.no_grad()
        def apply(params, grads, state, step):
            lr = lr_at(step)
            t = float(step) + 1.0
            lr_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
            for k, w in params.items():
                g, lm = prepared(k, grads, w)
                m, v = state[k]
                m.mul_(beta1).add_((1 - beta1) * g)
                v.mul_(beta2).add_((1 - beta2) * g * g)
                w.sub_((lr_t * lm) * m / (v.sqrt() + epsilon))
            return params, state

        return FunctionalOptimizer(init, apply, dict(lr=learning_rate, wd=wd))

    raise MXNetError("functional_optimizer: unknown optimizer %r" % name)
