"""Random sampling ops (counterpart of ``mxnet_tpu/ops/random_ops.py``,
every name of it): the ``_random_*`` samplers of scalar parameters and the
``_sample_*`` samplers of per-element parameter tensors, with the JAX
package's names, aliases, attributes and parametrisations: gamma scaled
by ``beta``, exponential divided by ``lam``, the negative binomials as
gamma-Poisson mixtures (``k`` successes and ``(1-p)/p``; ``r = 1/alpha``
and ``p = r/(r+mu)``), ``randint``'s ``high`` exclusive, the ``_sample_*``
outputs the parameter's shape followed by ``shape``, and
``_sample_multinomial`` drawing from ``log(max(data, 1e-37))`` (with
``get_prob`` also the log-softmax probability of each draw).

Each takes a ``torch.Generator`` first (``needs_rng``): the executor's
per-node generator, or the context's stream in the imperative invoke. The
draws are torch's, not threefry's: the two packages agree by
distribution, and one seed reruns bit for bit. ``gen`` is None on
``meta`` tensors (shape inference), where only the output is allocated.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import register


def _shape(shape):
    if shape is None or shape == "None":
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _new(shape, dtype=torch.float32, like=None):
    """An empty float tensor on ``like``'s device (else the current one)."""
    if like is not None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    return torch.empty(shape, dtype=dtype)


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (a tensor)."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


@register(name="_random_uniform", aliases=("uniform", "random_uniform"),
          needs_rng=True, nondiff=True)
def _random_uniform(gen, low=0.0, high=1.0, shape=(), ctx=None,
                    dtype="float32"):
    out = _new(_shape(shape))
    if gen is not None:
        out.uniform_(float(low), float(high), generator=gen)
    return out.to(dtype_torch(dtype))


@register(name="_random_normal", aliases=("normal", "random_normal"),
          needs_rng=True, nondiff=True)
def _random_normal(gen, loc=0.0, scale=1.0, shape=(), ctx=None,
                   dtype="float32"):
    out = _new(_shape(shape))
    if gen is not None:
        out.normal_(generator=gen)
    return (out * scale + loc).to(dtype_torch(dtype))


@register(name="_random_gamma", aliases=("random_gamma",), needs_rng=True,
          nondiff=True)
def _random_gamma(gen, alpha=1.0, beta=1.0, shape=(), ctx=None,
                  dtype="float32"):
    a = torch.full(_shape(shape), float(alpha))
    out = _gamma(gen, a) if gen is not None else a
    return (out * beta).to(dtype_torch(dtype))


@register(name="_random_exponential", aliases=("random_exponential",),
          needs_rng=True, nondiff=True)
def _random_exponential(gen, lam=1.0, shape=(), ctx=None, dtype="float32"):
    out = _new(_shape(shape))
    if gen is not None:
        out.exponential_(1.0, generator=gen)
    return (out / lam).to(dtype_torch(dtype))


@register(name="_random_poisson", aliases=("random_poisson",),
          needs_rng=True, nondiff=True)
def _random_poisson(gen, lam=1.0, shape=(), ctx=None, dtype="float32"):
    out = torch.full(_shape(shape), float(lam))
    if gen is not None:
        out = _poisson(gen, out)
    return out.to(dtype_torch(dtype))


def _gamma_poisson(gen, r, scale, shape, dtype):
    """Poisson draws of Gamma(r, 1) * scale rates."""
    lam = torch.full(_shape(shape), float(r))
    if gen is not None:
        lam = _poisson(gen, _gamma(gen, lam) * scale)
    return lam.to(dtype_torch(dtype))


@register(name="_random_negative_binomial",
          aliases=("random_negative_binomial",), needs_rng=True,
          nondiff=True)
def _random_negative_binomial(gen, k=1, p=1.0, shape=(), ctx=None,
                              dtype="float32"):
    return _gamma_poisson(gen, float(k), (1 - p) / p, shape, dtype)


@register(name="_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",),
          needs_rng=True, nondiff=True)
def _random_gen_neg_binomial(gen, mu=1.0, alpha=1.0, shape=(), ctx=None,
                             dtype="float32"):
    r = 1.0 / alpha
    p = r / (r + mu)
    return _gamma_poisson(gen, r, (1 - p) / p, shape, dtype)


@register(name="_random_randint", aliases=("random_randint",),
          needs_rng=True, nondiff=True)
def _random_randint(gen, low=0, high=1, shape=(), ctx=None, dtype="int32"):
    if gen is None:
        return torch.empty(_shape(shape), dtype=dtype_torch(dtype))
    out = torch.randint(int(low), int(high), _shape(shape), generator=gen,
                        device=gen.device)
    return out.to(dtype_torch(dtype))


# --- the _sample_* ops: one draw per parameter element and ``shape`` ---
def _expand(param, extra):
    """``param`` with ``len(extra)`` trailing axes of 1."""
    return param.reshape(param.shape + (1,) * len(extra))


@register(name="_sample_uniform", aliases=("sample_uniform",),
          needs_rng=True, nondiff=True)
def _sample_uniform(gen, low, high, shape=(), dtype="float32"):
    extra = _shape(shape)
    u = _new(low.shape + extra, like=low)
    if gen is not None:
        u.uniform_(generator=gen)
    low_b, high_b = _expand(low, extra), _expand(high, extra)
    return (low_b + u * (high_b - low_b)).to(dtype_torch(dtype))


@register(name="_sample_normal", aliases=("sample_normal",),
          needs_rng=True, nondiff=True)
def _sample_normal(gen, mu, sigma, shape=(), dtype="float32"):
    extra = _shape(shape)
    z = _new(mu.shape + extra, like=mu)
    if gen is not None:
        z.normal_(generator=gen)
    return (_expand(mu, extra) + z * _expand(sigma, extra)).to(
        dtype_torch(dtype))


@register(name="_sample_gamma", aliases=("sample_gamma",), needs_rng=True,
          nondiff=True)
def _sample_gamma(gen, alpha, beta, shape=(), dtype="float32"):
    extra = _shape(shape)
    a = _expand(alpha, extra).expand(alpha.shape + extra).float()
    g = _gamma(gen, a.contiguous()) if gen is not None else a
    return (g * _expand(beta, extra)).to(dtype_torch(dtype))


@register(name="_sample_exponential", aliases=("sample_exponential",),
          needs_rng=True, nondiff=True)
def _sample_exponential(gen, lam, shape=(), dtype="float32"):
    extra = _shape(shape)
    e = _new(lam.shape + extra, like=lam)
    if gen is not None:
        e.exponential_(1.0, generator=gen)
    return (e / _expand(lam, extra)).to(dtype_torch(dtype))


@register(name="_sample_poisson", aliases=("sample_poisson",),
          needs_rng=True, nondiff=True)
def _sample_poisson(gen, lam, shape=(), dtype="float32"):
    extra = _shape(shape)
    rate = _expand(lam, extra).expand(lam.shape + extra).float().contiguous()
    out = _poisson(gen, rate) if gen is not None else rate
    return out.to(dtype_torch(dtype))


@register(name="_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True, nondiff=True)
def _sample_multinomial(gen, data, shape=(), get_prob=False, dtype="int32"):
    """Draws from the categorical rows of ``data`` (its last axis),
    ``prod(shape)`` of them a row, as ``data.shape[:-1] + shape``."""
    extra = _shape(shape)
    n = 1
    for e in extra:
        n *= e
    out_shape = data.shape[:-1] + extra
    logits = torch.log(torch.clamp_min(data, 1e-37))
    rows = logits.reshape(-1, data.shape[-1])
    if gen is None:
        samples = torch.empty((rows.shape[0], n), dtype=torch.long,
                              device=data.device)
    else:
        probs = torch.softmax(rows.float(), dim=-1)
        samples = torch.multinomial(probs, n, replacement=True,
                                    generator=gen)
    out = samples.reshape(out_shape).to(dtype_torch(dtype))
    if get_prob:
        logp = torch.log_softmax(rows, dim=-1).gather(1, samples)
        return out, logp.reshape(out_shape)
    return out
