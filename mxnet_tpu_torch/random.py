"""Random number streams (counterpart of ``mxnet_tpu/random.py``).

Two kinds of stream, both reseeded by :func:`seed`:

- the initializers' host stream, a ``numpy.random.RandomState`` that
  :func:`seed` replaces by ``RandomState(s & 0x7FFFFFFF)`` exactly as the
  JAX package does, so a seeded ``Module.init_params`` gives bit-identical
  parameters in both packages;
- one explicit ``torch.Generator`` per device for the imperative samplers
  (:func:`uniform`, :func:`normal`), seeded from ``s``. These are NOT
  bit-identical to the JAX package's streams (threefry keys split per
  context): the two packages draw different numbers from one seed.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

_STATE = threading.local()
_DEFAULT_SEED = 0
_INIT_RNG = None


def _generators():
    if not hasattr(_STATE, "gens"):
        _STATE.gens = {}
    return _STATE.gens


def seed(seed_state, ctx=None):
    """Reseed the streams. With ``ctx`` None: the initializers' host
    stream and every device stream (each device's generator restarts from
    ``seed_state`` at its next use); with a context, that device's stream
    only."""
    global _DEFAULT_SEED, _INIT_RNG
    if ctx is None:
        _DEFAULT_SEED = int(seed_state)
        _generators().clear()
        _INIT_RNG = np.random.RandomState(int(seed_state) & 0x7FFFFFFF)
    else:
        gen = torch.Generator(device=_device(ctx))
        gen.manual_seed(int(seed_state))
        _generators()[_device(ctx)] = gen


def initializer_rng():
    """The ``RandomState`` behind the initializers. Unseeded runs draw
    fresh entropy; :func:`seed` reseeds it."""
    global _INIT_RNG
    if _INIT_RNG is None:
        _INIT_RNG = np.random.RandomState()
    return _INIT_RNG


def set_initializer_rng(rng):
    """Install ``rng`` as the initializers' stream; returns the previous
    one (``initializer.seeded`` restores it)."""
    global _INIT_RNG
    prev, _INIT_RNG = _INIT_RNG, rng
    return prev


def _device(ctx):
    from .context import Context, current_context

    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return torch.device(ctx)


def generator(ctx=None):
    """The device's ``torch.Generator`` (default: the current context's),
    made from the last :func:`seed` at its first use."""
    dev = _device(ctx)
    gens = _generators()
    gen = gens.get(dev)
    if gen is None:
        gen = gens[dev] = torch.Generator(device=dev)
        gen.manual_seed(_DEFAULT_SEED)
    return gen


def _sample(fill, shape, ctx, dtype):
    from .base import dtype_torch
    from .context import Context, current_context
    from .ndarray.ndarray import NDArray

    ctx = ctx or current_context()
    ctx = ctx if isinstance(ctx, Context) else Context.from_device(ctx)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    t = torch.empty(shape, dtype=dtype_torch(dtype),
                    device=ctx.torch_device())
    fill(t, generator(ctx))
    return NDArray(t, ctx)


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype=None):
    """Samples of U[low, high) from the device's stream."""
    return _sample(lambda t, g: t.uniform_(low, high, generator=g), shape,
                   ctx, dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype=None):
    """Samples of N(loc, scale**2) from the device's stream."""
    return _sample(lambda t, g: t.normal_(loc, scale, generator=g), shape,
                   ctx, dtype)
