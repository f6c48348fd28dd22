"""Optimizer update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``):
``sgd_update``, ``sgd_mom_update``, ``mp_sgd_update``,
``mp_sgd_mom_update``, ``adam_update``, ``rmsprop_update``,
``rmspropalex_update``, ``ftrl_update``, ``signsgd_update`` and
``signum_update``.

The JAX ops return new values and the invoke layer rebinds the handles.
Here each op updates its weight and state tensors in place, under
``torch.no_grad()``, and returns the weight, as the reference's mutating
ops do: an executor's own weight tensor is the one that changes. The
arithmetic is the JAX package's, in the same order: the gradient times
``rescale_grad``, clipped to ``clip_gradient`` when that is >= 0, then the
weight decay, then the momentum or moment updates.
"""
from __future__ import annotations

import torch

from .registry import register


def _grad(grad, rescale_grad, clip_gradient, dtype=None):
    g = (grad if dtype is None else grad.to(dtype)) * rescale_grad
    if clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


@register(name="sgd_update")
@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _grad(grad, rescale_grad, clip_gradient)
    return weight.sub_(lr * (g + wd * weight))


@register(name="sgd_mom_update")
@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _grad(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(lr * (g + wd * weight))
    return weight.add_(mom)


@register(name="mp_sgd_update")
@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD: the fp32 master ``weight32`` takes the update,
    ``weight`` gets it rounded to its own dtype."""
    g = _grad(grad, rescale_grad, clip_gradient, torch.float32)
    weight32.sub_(lr * (g + wd * weight32))
    return weight.copy_(weight32)


@register(name="mp_sgd_mom_update")
@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _grad(grad, rescale_grad, clip_gradient, torch.float32)
    mom.mul_(momentum).sub_(lr * (g + wd * weight32))
    weight32.add_(mom)
    return weight.copy_(weight32)


@register(name="adam_update")
@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _grad(grad, rescale_grad, clip_gradient) + wd * weight
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * g.square())
    return weight.sub_(lr * mean / (var.sqrt() + epsilon))


@register(name="rmsprop_update")
@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    weight.sub_(lr * g / (n + epsilon).sqrt())
    if clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)
    return weight


@register(name="rmspropalex_update")
@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * g.square())
    g_state.mul_(gamma1).add_((1 - gamma1) * g)
    delta.mul_(gamma2).sub_(
        lr * g / (n - g_state.square() + epsilon).sqrt())
    weight.add_(delta)
    if clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)
    return weight


@register(name="ftrl_update")
@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    sqrt_n = n.sqrt()
    n.add_(g.square())
    sigma = (n.sqrt() - sqrt_n) / lr
    z.add_(g).sub_(sigma * weight)
    w = torch.where(
        z.abs() > lamda1,
        -(z - z.sign() * lamda1) / ((beta + n.sqrt()) / lr + wd),
        torch.zeros((), dtype=z.dtype, device=z.device))
    return weight.copy_(w)


@register(name="signsgd_update")
@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    return weight.sub_(lr * (g.sign() + wd * weight))


@register(name="signum_update")
@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_((1 - momentum) * (g + wd * weight))
    return weight.mul_(1 - lr * wd_lh).add_(lr * mom.sign())
