"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

An op is a plain function on torch tensors plus metadata; the same
:class:`OpDef` backs the symbolic path (a Symbol node stores ``(op,
attrs)`` and the executor calls ``op.fn``) and shape inference, which
calls ``op.fn`` on ``device="meta"`` tensors (shapes without compute).
Attribute defaults come from the function's signature (the
dmlc::Parameter equivalent), and string attributes from symbol JSON are
coerced to them as the JAX package does.

An op registered with ``needs_rng=True`` takes a ``torch.Generator`` as
its leading argument (``gen``, not an input or an attribute): the
executor seeds one for each node from its step seed and the node's salt
(``executor.eval_node``), the imperative invoke passes the context's
stream (``random.generator``). ``gen`` is None on ``meta`` tensors
(shape inference), where nothing is drawn.
"""
from __future__ import annotations

import inspect

from ..base import MXNetError

_OPS: dict[str, "OpDef"] = {}
_ALIASES: dict[str, str] = {}


class OpDef:
    """A registered operator.

    name: canonical op name (``Convolution``, ``broadcast_add``, ...);
    fn: ``fn(*tensors, **attrs) -> tensor | tuple``; num_outputs: static
    count or ``attrs -> int``; num_visible_outputs: outputs a symbol
    exposes (BatchNorm hides its batch mean/var); aux_state_outputs:
    ``{input name: output index}`` whose value replaces that aux state in
    training; needs_rng: ``fn`` takes a generator first; attr_defaults:
    keyword defaults from the signature.
    """

    __slots__ = ("name", "fn", "num_outputs", "num_visible_outputs",
                 "aux_state_outputs", "needs_rng", "doc", "attr_defaults",
                 "input_names", "var_inputs", "optional_inputs")

    def __init__(self, name, fn, num_outputs=1, num_visible_outputs=None,
                 aux_state_outputs=None, needs_rng=False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.num_visible_outputs = num_visible_outputs
        self.aux_state_outputs = dict(aux_state_outputs or {})
        self.needs_rng = bool(needs_rng)
        self.doc = fn.__doc__ or ""
        self.attr_defaults = _kwarg_defaults(fn, self.needs_rng)
        self.input_names, self.var_inputs, self.optional_inputs = (
            _input_names(fn, self.needs_rng))
        for n in self.input_names:
            self.attr_defaults.pop(n, None)

    def n_outputs(self, attrs) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def n_visible_outputs(self, attrs) -> int:
        if self.num_visible_outputs is None:
            return self.n_outputs(attrs)
        if callable(self.num_visible_outputs):
            return self.num_visible_outputs(attrs)
        return self.num_visible_outputs

    def parse_attrs(self, kwargs) -> dict:
        """Coerce string-typed attrs (symbol JSON) to python values."""
        out = {}
        for k, v in kwargs.items():
            if k not in self.attr_defaults:
                raise MXNetError("op %s: unknown attribute %r (known: %s)"
                                 % (self.name, k, sorted(self.attr_defaults)))
            out[k] = _coerce(v, self.attr_defaults[k])
        return out

    def __repr__(self):
        return "OpDef(%s)" % self.name


# None-default params with these names are optional tensor inputs; any
# other defaulted param ends the input list (it is an attribute)
_OPTIONAL_TENSOR_NAMES = {"bias", "gamma", "state_cell", "weight",
                          "sc_weight"}


def _params(fn, needs_rng):
    """``fn``'s parameters, without the leading generator of an rng op."""
    params = list(inspect.signature(fn).parameters.values())
    return params[1:] if needs_rng else params


def _input_names(fn, needs_rng=False):
    """Tensor-input names: the leading params with no default, plus
    contiguous None-default params named as optional tensors. A ``*args``
    parameter means a variable input count."""
    names, optional, var = [], [], False
    for p in _params(fn, needs_rng):
        if p.kind is p.VAR_POSITIONAL:
            var = True
            break
        if p.kind not in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY):
            break
        if p.default is p.empty:
            names.append(p.name)
        elif p.default is None and p.name in _OPTIONAL_TENSOR_NAMES:
            names.append(p.name)
            optional.append(p.name)
        else:
            break
    return tuple(names), var, frozenset(optional)


def _kwarg_defaults(fn, needs_rng=False):
    defaults = {}
    for p in _params(fn, needs_rng):
        if p.kind is p.KEYWORD_ONLY or (p.kind is p.POSITIONAL_OR_KEYWORD
                                        and p.default is not p.empty):
            defaults[p.name] = None if p.default is p.empty else p.default
    return defaults


_BOOL_STRS = {"true": True, "false": False, "1": True, "0": False,
              "none": None}


def _coerce(value, default):
    """String -> typed coercion mirroring dmlc::Parameter string kwargs."""
    if isinstance(value, list):
        return tuple(value)
    if not isinstance(value, str):
        return value
    low = value.strip().lower()
    if isinstance(default, bool):
        if low in _BOOL_STRS:
            return bool(_BOOL_STRS[low])
        raise MXNetError("cannot parse %r as bool" % (value,))
    if low == "none":
        return None
    if isinstance(default, int) and not isinstance(default, bool):
        try:
            return int(value)
        except ValueError:
            return int(float(value))
    if isinstance(default, float):
        return float(value)
    if isinstance(default, (tuple, list)):
        return _parse_tuple(value)
    if value.startswith("(") or value.startswith("["):
        return _parse_tuple(value)
    return value


def _parse_tuple(value):
    s = value.strip().lstrip("([").rstrip(")]")
    if not s:
        return ()
    items, depth, cur = [], 0, ""
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    out = []
    for it in items:
        it = it.strip()
        if it.startswith("(") or it.startswith("["):
            out.append(_parse_tuple(it))
            continue
        try:
            out.append(int(it))
        except ValueError:
            try:
                out.append(float(it))
            except ValueError:
                low = it.lower()
                out.append(_BOOL_STRS[low] if low in _BOOL_STRS else it)
    return tuple(out)


def register(name=None, aliases=(), num_outputs=1, num_visible_outputs=None,
             aux_state_outputs=None, needs_rng=False):
    """Decorator registering a function on tensors as an operator."""

    def deco(fn):
        opname = name or fn.__name__
        if opname in _OPS:
            raise MXNetError("duplicate op registration: %s" % opname)
        _OPS[opname] = OpDef(opname, fn, num_outputs=num_outputs,
                             num_visible_outputs=num_visible_outputs,
                             aux_state_outputs=aux_state_outputs,
                             needs_rng=needs_rng)
        for a in aliases:
            _ALIASES[a] = opname
        return fn

    return deco


def alias(extra_name, canonical):
    _ALIASES[extra_name] = canonical


def get(name) -> OpDef:
    op = _OPS.get(name) or _OPS.get(_ALIASES.get(name, ""))
    if op is None:
        raise MXNetError("operator %r is not registered" % (name,))
    return op


def list_ops():
    return sorted(set(_OPS) | set(_ALIASES))
