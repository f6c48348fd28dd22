"""The ``layout`` pass: whole-graph NCHW<->NHWC placement (counterpart of
``mxnet_tpu/ir/layout.py``).

The fusion pass leaves the fused units' NHWC region bracketed by
transposes, and ``transpose_cancel`` erases a bracket only where two
transposes meet. This pass moves transposes toward the outputs so that
they meet:

- **compose**: adjacent transposes merge into one (``transpose_compose``;
  the identity case is the registered ``transpose_cancel`` rule);
- **sink**: a transpose feeding an elementwise op moves below it
  (``transpose_sink_<op>``); a binary op takes it when both operands carry
  the same permutation (two transposes become one);
- **BatchNorm sink**: ``BN_axis=a(T_p(x)) == T_p(BN_axis=p[a](x))``, the
  channel axis remapped through the permutation
  (``transpose_sink_batchnorm``), so a BatchNorm after the fused units
  runs on NHWC with ``axis=3``.

Transposes only move toward the outputs and their count never grows, so
the fixpoint ends. Rewrites keep shapes and values (a sunk BatchNorm sums
in another order: equal up to rounding, not bit for bit). A clone keeps
its node's name, so a remat plan made after the pass finds its nodes.
``MXNET_IR_LAYOUT=0`` runs the pass with no rules.
"""
from __future__ import annotations

from ..base import auto_name
from ..symbol.symbol import Symbol, _Node
from .match import Pat, node_attr
from .rules import Rule

# elementwise single-input ops a permutation commutes with; axis-sensitive
# ops (pad, Pooling, slice, ...) are absent on purpose
SINK_UNARY_OPS = (
    "Activation",
    "LeakyReLU",
    "Cast",
    "clip",
    "_mul_scalar",
    "_plus_scalar",
    "_minus_scalar",
    "_div_scalar",
    "relu",
)

# elementwise binary ops; both inputs must carry the same permutation
SINK_BINARY_OPS = (
    "broadcast_add",
    "broadcast_sub",
    "broadcast_mul",
    "broadcast_div",
    "broadcast_maximum",
    "broadcast_minimum",
)


def _perm(node):
    axes = node_attr(node, "axes")
    return tuple(int(a) for a in axes) if axes else ()


def _is_identity(perm):
    return all(p == i for i, p in enumerate(perm))


def _sym(entry):
    return Symbol([entry])


def _clone_op(node, new_inputs, attrs=None):
    """The matched op on new inputs: same op, name and attributes."""
    return _Node(node.op, dict(attrs if attrs is not None else node.attrs),
                 list(new_inputs), node.name, dict(node.attr_dict),
                 node._arity)


def _transpose_of(entry, axes, prefix):
    from .. import symbol as sym

    return sym.transpose(_sym(entry), axes=tuple(axes),
                         name=auto_name(prefix + "_t"))


class TransposeComposeRule(Rule):
    """transpose(transpose(x, i), o) -> transpose(x, i∘o) when the
    composition is not the identity."""

    name = "transpose_compose"

    def __init__(self):
        inner = Pat("transpose", inputs=[Pat(name="x")], name="inner")
        self.pattern = Pat("transpose", inputs=[inner], name="outer")

    def where(self, m):
        o = _perm(m.node("outer"))
        i = _perm(m.node("inner"))
        if not o or not i or len(o) != len(i):
            return False
        return not _is_identity(tuple(i[o[b]] for b in range(len(o))))

    def rewrite(self, m):
        o = _perm(m.node("outer"))
        i = _perm(m.node("inner"))
        comp = tuple(i[o[b]] for b in range(len(o)))
        return _transpose_of(m["x"], comp, m.node("outer").name)


class TransposeSinkUnaryRule(Rule):
    """op(transpose(x, p)) -> transpose(op(x), p), one instance per op."""

    def __init__(self, op_name):
        self.name = "transpose_sink_%s" % op_name.lower().lstrip("_")
        self.op_name = op_name
        t = Pat("transpose", inputs=[Pat(name="x")], name="t")
        self.pattern = Pat(op_name, inputs=[t], name="root")

    def where(self, m):
        return bool(_perm(m.node("t")))

    def rewrite(self, m):
        root = m.node("root")
        inner = _clone_op(root, [m["x"]])
        return _transpose_of((inner, 0), _perm(m.node("t")), root.name)


class TransposeSinkBinaryRule(Rule):
    """op(transpose(x, p), transpose(y, p)) -> transpose(op(x, y), p)."""

    def __init__(self, op_name):
        self.name = "transpose_sink_%s" % op_name.lower().lstrip("_")
        self.op_name = op_name
        t1 = Pat("transpose", inputs=[Pat(name="x")], name="t1")
        t2 = Pat("transpose", inputs=[Pat(name="y")], name="t2")
        self.pattern = Pat(op_name, inputs=[t1, t2], name="root")

    def where(self, m):
        p = _perm(m.node("t1"))
        return bool(p) and p == _perm(m.node("t2"))

    def rewrite(self, m):
        root = m.node("root")
        inner = _clone_op(root, [m["x"], m["y"]])
        return _transpose_of((inner, 0), _perm(m.node("t1")), root.name)


class TransposeSinkBatchNormRule(Rule):
    """BatchNorm(transpose(x, p), ..., axis=a) -> transpose(BatchNorm(x,
    ..., axis=p[a]), p). The moving statistics are keyed on their variable
    names, which the clone keeps."""

    name = "transpose_sink_batchnorm"

    def __init__(self):
        t = Pat("transpose", inputs=[Pat(name="x")], name="t")
        self.pattern = Pat(
            "BatchNorm",
            inputs=[t, Pat.var("gamma"), Pat.var("beta"),
                    Pat.var("mm"), Pat.var("mv")],
            name="bn")

    def where(self, m):
        p = _perm(m.node("t"))
        if not p:
            return False
        a = node_attr(m.node("bn"), "axis")
        a = 1 if a is None else int(a)
        return 0 <= a < len(p)

    def rewrite(self, m):
        bn = m.node("bn")
        p = _perm(m.node("t"))
        a = node_attr(bn, "axis")
        a = 1 if a is None else int(a)
        attrs = dict(bn.attrs)
        attrs["axis"] = int(p[a])
        inner = _clone_op(
            bn, [m["x"], m["gamma"], m["beta"], m["mm"], m["mv"]],
            attrs=attrs)
        return _transpose_of((inner, 0), p, bn.name)


def layout_rules():
    """The ``layout`` pass's rule list: cancel first (identity pairs
    vanish), compose second (chains collapse), sinks last."""
    from .rules import get_rule

    rules = [get_rule("transpose_cancel"), TransposeComposeRule(),
             TransposeSinkBatchNormRule()]
    rules += [TransposeSinkUnaryRule(op) for op in SINK_UNARY_OPS]
    rules += [TransposeSinkBinaryRule(op) for op in SINK_BINARY_OPS]
    return rules
