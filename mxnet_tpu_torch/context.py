"""Device contexts and device resolution (counterpart of
``mxnet_tpu/context.py``).

The default device is ``cuda``: an entry point that is given no device
runs on the card, and raises when there is none rather than carrying on
on the CPU. The CPU is used only when a caller asks for it (the tests do).

:class:`Context` is the front end's name for a device: ``gpu(i)`` is
``cuda:i`` and ``cpu()`` the host (``cpu_pinned()`` too: its arrays live on
the host as the CPU's do). The default context is ``gpu(0)``;
``with mx.cpu(): ...`` makes the CPU the default inside the block.
"""
from __future__ import annotations

import re
import threading

import torch

from .base import MXNetError


def resolve_device(device=None):
    """``None`` -> ``cuda``; a string, ``torch.device`` or :class:`Context`
    passes through. A CUDA device that does not exist raises
    :class:`MXNetError`."""
    if isinstance(device, Context):
        device = device._name()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(
                "device %s requested (the default) but no CUDA device is "
                "available; pass device='cpu' to run on the CPU" % dev)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise MXNetError("device %s does not exist (%d CUDA device(s))"
                             % (dev, torch.cuda.device_count()))
    elif dev.type != "cpu":
        raise MXNetError("unsupported device %s (cuda or cpu)" % dev)
    return dev


class Context:
    """A device context: ``cpu`` or ``gpu``, with an index. Hashable,
    comparable, and a ``with`` scope that makes it the default."""

    _default_ctx = threading.local()
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    __slots__ = ("device_type", "device_id", "_old_ctx")

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, int):
            device_type = self.devtype2str.get(device_type, device_type)
        if device_type not in self.devstr2type:
            raise MXNetError("unknown device type %r (cpu, gpu or "
                             "cpu_pinned)"
                             % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = None

    @classmethod
    def from_device(cls, device):
        """The context of a ``torch.device`` (``cuda`` is ``gpu``)."""
        device = torch.device(device)
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)

    @classmethod
    def parse(cls, ctx):
        """A context from a Context or its text (``"gpu(0)"``, ``"cpu"``:
        an op's ``ctx`` attribute as symbol JSON holds it)."""
        if isinstance(ctx, Context):
            return ctx
        m = re.fullmatch(r"\s*(cpu_pinned|cpu|gpu)\s*(?:\(\s*(\d+)\s*\))?\s*",
                         str(ctx))
        if m is None:
            raise MXNetError("cannot parse %r as a context" % (ctx,))
        return cls(m.group(1), int(m.group(2) or 0))

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def _name(self):
        return "cuda:%d" % self.device_id if self.device_type == "gpu" \
            else "cpu"

    def torch_device(self):
        """The ``torch.device``; ``gpu(i)`` raises without a card ``i``."""
        return resolve_device(self._name())

    def empty_cache(self):
        """Release the card's cached, unused memory to CUDA (a no-op
        for the host)."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()

    def __eq__(self, other):
        return isinstance(other, Context) and \
            (self.device_type, self.device_id) == \
            (other.device_type, other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx
        return False

    @classmethod
    def default_ctx(cls):
        ctx = getattr(cls._default_ctx, "value", None)
        return ctx if ctx is not None else gpu(0)


def cpu(device_id=0):
    """The host."""
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    """The host, under the reference's name for page-locked memory."""
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """CUDA device ``device_id``."""
    return Context("gpu", device_id)


def num_gpus():
    """The number of CUDA devices (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with`` context, else ``gpu(0)``."""
    return Context.default_ctx()
