"""Gluon modules of the JAX package that are not ported yet: importing
one works, using any of its names raises ``MXNetError`` by name."""
from __future__ import annotations

import types

from ..base import MXNetError


def not_ported_module(name, what):
    """A module ``name`` whose every attribute raises, naming ``what`` and
    ROADMAP.md Queue A item 9's second part."""
    module = types.ModuleType(name)

    def refuse(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise MXNetError("%s.%s: %s is not ported yet (ROADMAP.md Queue A "
                         "item 9, second part)" % (name, attr, what))

    module.__getattr__ = refuse
    return module
