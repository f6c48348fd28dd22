"""Automatic naming of symbols (counterpart of ``mxnet_tpu/name.py``).

A :class:`NameManager` hands out ``convolution0``-style names per prefix
inside its ``with`` block; :class:`Prefix` also puts a prefix in front.
Outside any block, :func:`~.base.auto_name` uses the package's global
per-prefix counter.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_TLS = threading.local()


def _stack():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


def current():
    """The innermost active NameManager, or None."""
    st = _stack()
    return st[-1] if st else None


class NameManager:
    """Per-prefix sequential names; an explicit name wins."""

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return "%s%d" % (hint, idx)

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, ptype, value, trace):
        _stack().pop()
        return False


class Prefix(NameManager):
    """Puts ``prefix`` in front of every automatic name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return name if name else self._prefix + super().get(None, hint)
