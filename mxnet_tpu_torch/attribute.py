"""Attribute scopes for symbols (counterpart of
``mxnet_tpu/attribute.py``): ``with AttrScope(lr_mult="0.1"): ...``
stamps its attributes on every symbol created inside the block; an
explicit attribute wins over the scope's, an inner scope over an outer.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_TLS = threading.local()


def _stack():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


def current_attrs():
    """Merged attributes of all active scopes (inner wins)."""
    out = {}
    for scope in _stack():
        out.update(scope._attrs)
    return out


class AttrScope:
    """Attributes (stored as strings) for the symbols of a block."""

    def __init__(self, **kwargs):
        self._attrs = {k: v if isinstance(v, str) else str(v)
                       for k, v in kwargs.items()}

    def get(self, attr):
        """The scopes' attributes merged with ``attr`` (``attr`` wins)."""
        out = current_attrs()
        out.update(self._attrs)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, ptype, value, trace):
        _stack().pop()
        return False
