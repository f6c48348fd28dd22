"""Pattern matcher over the Symbol/_Node graph (counterpart of
``mxnet_tpu/ir/match.py``, the same matcher).

A pattern is a small tree of :class:`Pat` nodes matched structurally
against graph entries ``(node, out_index)``:

- ``Pat(op="Convolution", inputs=[...], attrs={...})`` matches an op
  application by canonical op name, exact input arity and attr
  constraints (a literal compared against the node's parsed attr, falling
  back to the op's registered default, or a ``callable(value) -> bool``).
- ``Pat()`` (no op) is a wildcard: it matches any entry and marks a
  subgraph boundary.
- ``Pat.var(...)`` matches a variable (leaf) node.
- The same ``Pat`` object appearing twice in one pattern must bind to the
  same graph entry.

Matching never mutates the graph; a match carries the capture bindings
and the interior op nodes a rewrite would consume.
"""
from __future__ import annotations

from ..base import MXNetError

_VAR_OP = "__var__"


class Pat:
    """One pattern node (see module docstring)."""

    __slots__ = ("op", "inputs", "attrs", "where", "name")

    def __init__(self, op=None, inputs=None, attrs=None, where=None,
                 name=None):
        self.op = op            # op name | None (wildcard) | _VAR_OP
        self.inputs = inputs    # list[Pat] (exact arity) or None (any)
        self.attrs = dict(attrs or {})
        self.where = where      # callable(node) -> bool, extra predicate
        self.name = name        # capture name (optional)
        if op is None and (inputs is not None or self.attrs or where):
            raise MXNetError(
                "Pat: a wildcard (op=None) is a boundary — it cannot "
                "constrain inputs/attrs; name the op instead")

    @classmethod
    def var(cls, name=None, where=None):
        """Match a variable (leaf) node."""
        p = cls(op=_VAR_OP, name=name)
        p.where = where
        return p

    def is_wildcard(self):
        return self.op is None

    def is_var_pat(self):
        return self.op == _VAR_OP

    def __repr__(self):
        return "Pat(%s%s)" % (self.op or "*",
                              ", name=%r" % self.name if self.name else "")


class Match:
    """A successful pattern match.

    ``entries`` maps capture name -> the bound graph entry
    ``(node, out_index)``; ``interior`` is the set of op-node ids the
    pattern consumed (everything matched by a named-op Pat except the
    root — the nodes a rewrite replaces); ``root`` is the matched root
    entry."""

    __slots__ = ("root", "entries", "interior", "_by_pat")

    def __init__(self, root):
        self.root = root
        self.entries = {}
        self.interior = set()
        self._by_pat = {}

    def __getitem__(self, name):
        return self.entries[name]

    def __contains__(self, name):
        return name in self.entries

    def node(self, name):
        return self.entries[name][0]

    def attr(self, name, key):
        """Parsed attr of a captured op node, falling back to the op's
        registered default."""
        node = self.node(name)
        if key in node.attrs:
            return node.attrs[key]
        return node.op.attr_defaults.get(key)


def node_attr(node, key):
    """A node's parsed attr with the registered default as fallback."""
    if key in node.attrs:
        return node.attrs[key]
    return node.op.attr_defaults.get(key)


def _attrs_ok(pat, node):
    for key, want in pat.attrs.items():
        have = node_attr(node, key)
        if callable(want):
            if not want(have):
                return False
        elif have != want:
            return False
    return True


def _match_entry(pat, entry, m):
    node, idx = entry
    bound = m._by_pat.get(id(pat))
    if bound is not None:
        # identity-shared Pat: must re-bind to the same entry
        return bound[0] is node and bound[1] == idx
    if pat.is_wildcard():
        pass  # boundary: matches anything
    elif pat.is_var_pat():
        if not node.is_variable():
            return False
        if pat.where is not None and not pat.where(node):
            return False
    else:
        if node.is_variable() or node.op.name != pat.op or idx != 0:
            return False
        if not _attrs_ok(pat, node):
            return False
        if pat.where is not None and not pat.where(node):
            return False
        if pat.inputs is not None:
            if len(node.inputs) != len(pat.inputs):
                return False
            for sub, sub_entry in zip(pat.inputs, node.inputs):
                if not _match_entry(sub, sub_entry, m):
                    return False
        m.interior.add(id(node))
    m._by_pat[id(pat)] = entry
    if pat.name is not None:
        m.entries[pat.name] = entry
    return True


def match(pattern, entry):
    """Match ``pattern`` against graph entry ``(node, out_index)``.
    Returns a :class:`Match` (root excluded from ``interior``) or
    None."""
    m = Match(entry)
    if not _match_entry(pattern, entry, m):
        return None
    m.interior.discard(id(entry[0]))
    return m
