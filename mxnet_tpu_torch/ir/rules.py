"""Rewrite rules: the fusion decisions, stated as patterns (counterpart
of ``mxnet_tpu/ir/rules.py``).

- :class:`BottleneckFusionRule` rewrites the unfused pre-activation
  bottleneck unit (BN-ReLU-conv x3 + shortcut, ``models/resnet.py``) into
  one ``FusedBottleneckUnit`` op bracketed by NCHW<->NHWC transposes.
- :class:`TransposeCancelRule` cancels adjacent transposes that compose to
  the identity; between consecutive fused units this erases the per-unit
  NHWC brackets, leaving one transpose pair around the residual stack.
- :class:`ResidualConvEpilogueRule` folds a residual add into the
  convolution that feeds it (``_ConvResidualAdd``, the ``residual`` pass).

Rules are registered by name (:func:`register_rule`, :func:`get_rule`,
:func:`list_rules`); the passes take their rule lists from the registry.
The JAX package's per-rule kernel names feed its autotuner, which the port
does not have yet.
"""
from __future__ import annotations

from ..base import MXNetError, auto_name
from ..symbol.symbol import Symbol
from .match import Pat, node_attr


class Rule:
    """One rewrite rule: pattern(s) + a rewrite callback.

    ``patterns`` are tried in order per node; ``where(match)`` (optional)
    vets a structural match before the rewrite runs."""

    name = None
    pattern = None
    where = None

    @property
    def patterns(self):
        return (self.pattern,)

    def rewrite(self, m):
        raise NotImplementedError


_RULES = {}


def register_rule(rule):
    """Register a rule instance by its name (a duplicate raises)."""
    if not rule.name:
        raise MXNetError("register_rule: rule needs a name")
    if rule.name in _RULES:
        raise MXNetError("duplicate rule registration: %s" % rule.name)
    _RULES[rule.name] = rule
    return rule


def get_rule(name):
    if name not in _RULES:
        raise MXNetError("unknown rule %r (registered: %s)"
                         % (name, sorted(_RULES)))
    return _RULES[name]


def list_rules():
    return sorted(_RULES)


def _sym(entry):
    return Symbol([entry])


# ---------------------------------------------------------------------------
# bottleneck fusion
# ---------------------------------------------------------------------------
def _bn(data_pat, prefix):
    return Pat("BatchNorm",
               inputs=[data_pat,
                       Pat.var(prefix + "_gamma"),
                       Pat.var(prefix + "_beta"),
                       Pat.var(prefix + "_mm"),
                       Pat.var(prefix + "_mv")],
               attrs={"fix_gamma": False, "use_global_stats": False,
                      "output_mean_var": False, "axis": 1},
               name=prefix)


def _relu(data_pat, name=None):
    return Pat("Activation", inputs=[data_pat],
               attrs={"act_type": "relu"}, name=name)


def _conv(data_pat, wname, name, kernel, any_stride=False):
    def _stride_ok(s):
        s = tuple(s or (1, 1))
        if any_stride:
            return len(s) == 2 and s[0] == s[1] and s[0] in (1, 2)
        return s == (1, 1)

    def _pad_ok(p):
        p = tuple(p or ())
        return p in ((), (0, 0)) if kernel == (1, 1) else p == (1, 1)

    return Pat("Convolution",
               inputs=[data_pat, Pat.var(wname)],
               attrs={"kernel": kernel, "no_bias": True,
                      "num_group": 1, "stride": _stride_ok,
                      "pad": _pad_ok,
                      "dilate": lambda d: tuple(d or ()) in ((), (1, 1))},
               name=name)


def _build_bottleneck_patterns():
    data = Pat(name="data")
    bn1 = _bn(data, "bn1")
    act1 = _relu(bn1, "act1")
    conv1 = _conv(act1, "w1", "conv1", (1, 1))
    bn2 = _bn(conv1, "bn2")
    act2 = _relu(bn2)
    conv2 = _conv(act2, "w2", "conv2", (3, 3), any_stride=True)
    bn3 = _bn(conv2, "bn3")
    act3 = _relu(bn3)
    conv3 = _conv(act3, "w3", "conv3", (1, 1))
    # downsample unit: the shortcut is a 1x1 conv of act1 (the SAME
    # act1 Pat object — identity-shared binding)
    sc = Pat("Convolution", inputs=[act1, Pat.var("wsc")],
             attrs={"kernel": (1, 1), "no_bias": True, "num_group": 1,
                    "stride": lambda s: tuple(s or (1, 1))[0]
                    == tuple(s or (1, 1))[1],
                    "pad": lambda p: tuple(p or ()) in ((), (0, 0))},
             name="sc")
    downsample = Pat("broadcast_add", inputs=[conv3, sc])
    # dim-match unit: the shortcut IS the unit input (same data Pat)
    dim_match = Pat("broadcast_add", inputs=[conv3, data])
    return (downsample, dim_match)


class BottleneckFusionRule(Rule):
    name = "bottleneck_fuse"

    def __init__(self):
        self._patterns = _build_bottleneck_patterns()

    @property
    def pattern(self):
        return self._patterns[0]

    @property
    def patterns(self):
        return self._patterns

    def where(self, m):
        bn1, bn2, bn3 = (m.node(k) for k in ("bn1", "bn2", "bn3"))
        eps = node_attr(bn1, "eps")
        mom = node_attr(bn1, "momentum")
        for bn in (bn2, bn3):
            if node_attr(bn, "eps") != eps \
                    or node_attr(bn, "momentum") != mom:
                return False
        nf = int(node_attr(m.node("conv3"), "num_filter"))
        c = int(nf * 0.25)
        if int(node_attr(m.node("conv1"), "num_filter")) != c \
                or int(node_attr(m.node("conv2"), "num_filter")) != c:
            return False
        if "sc" in m:
            if int(node_attr(m.node("sc"), "num_filter")) != nf:
                return False
            s_sc = tuple(node_attr(m.node("sc"), "stride") or (1, 1))
            s_c2 = tuple(node_attr(m.node("conv2"), "stride") or (1, 1))
            if s_sc != s_c2:
                return False
        return True

    def rewrite(self, m):
        from .. import symbol as sym

        conv1 = m.node("conv1")
        unit = conv1.name[:-len("_conv1")] \
            if conv1.name.endswith("_conv1") else auto_name("fusedunit")
        stride = tuple(node_attr(m.node("conv2"), "stride") or (1, 1))[0]
        kwargs = dict(
            data=sym.transpose(_sym(m["data"]), axes=(0, 2, 3, 1),
                               name=unit + "_to_nhwc"),
            conv1_weight=_sym(m["w1"]),
            conv2_weight=_sym(m["w2"]),
            conv3_weight=_sym(m["w3"]),
            bn1_gamma=_sym(m["bn1_gamma"]), bn1_beta=_sym(m["bn1_beta"]),
            bn2_gamma=_sym(m["bn2_gamma"]), bn2_beta=_sym(m["bn2_beta"]),
            bn3_gamma=_sym(m["bn3_gamma"]), bn3_beta=_sym(m["bn3_beta"]),
            bn1_moving_mean=_sym(m["bn1_mm"]),
            bn1_moving_var=_sym(m["bn1_mv"]),
            bn2_moving_mean=_sym(m["bn2_mm"]),
            bn2_moving_var=_sym(m["bn2_mv"]),
            bn3_moving_mean=_sym(m["bn3_mm"]),
            bn3_moving_var=_sym(m["bn3_mv"]),
            num_filter=int(node_attr(m.node("conv3"), "num_filter")),
            stride=int(stride),
            dim_match="sc" not in m,
            eps=float(node_attr(m.node("bn1"), "eps")),
            momentum=float(node_attr(m.node("bn1"), "momentum")),
            name=unit,
        )
        if "sc" in m:
            kwargs["sc_weight"] = _sym(m["wsc"])
        fused = sym.FusedBottleneckUnit(**kwargs)
        return sym.transpose(fused, axes=(0, 3, 1, 2),
                             name=unit + "_to_nchw")


class TransposeCancelRule(Rule):
    """transpose(transpose(x, i), o) with i∘o == identity -> x."""

    name = "transpose_cancel"

    def __init__(self):
        inner = Pat("transpose", inputs=[Pat(name="x")], name="inner")
        self.pattern = Pat("transpose", inputs=[inner], name="outer")

    def where(self, m):
        o = tuple(node_attr(m.node("outer"), "axes") or ())
        i = tuple(node_attr(m.node("inner"), "axes") or ())
        if not o or not i or len(o) != len(i):
            return False
        return all(i[o[b]] == b for b in range(len(o)))

    def rewrite(self, m):
        return _sym(m["x"])


class ResidualConvEpilogueRule(Rule):
    """``Convolution(x, w[, b]) + residual`` -> ``_ConvResidualAdd``: the
    residual add rides the convolution instead of a separate pass over
    memory."""

    name = "residual_conv_epilogue"

    def __init__(self):
        def conv(with_bias):
            ins = [Pat(name="x"), Pat.var("w")]
            if with_bias:
                ins.append(Pat.var("b"))
            return Pat("Convolution", inputs=ins, name="conv")

        self._patterns = (
            Pat("broadcast_add", inputs=[conv(False), Pat(name="res")]),
            Pat("broadcast_add", inputs=[conv(True), Pat(name="res")]),
        )

    @property
    def pattern(self):
        return self._patterns[0]

    @property
    def patterns(self):
        return self._patterns

    def rewrite(self, m):
        from .. import symbol as sym

        conv = m.node("conv")
        attrs = {k: node_attr(conv, k)
                 for k in ("kernel", "stride", "dilate", "pad",
                           "num_filter", "num_group", "no_bias")}
        kwargs = dict(data=_sym(m["x"]), weight=_sym(m["w"]),
                      residual=_sym(m["res"]),
                      name=conv.name + "_resadd", **attrs)
        if "b" in m:
            kwargs["bias"] = _sym(m["b"])
        return sym._ConvResidualAdd(**kwargs)


register_rule(BottleneckFusionRule())
register_rule(TransposeCancelRule())
register_rule(ResidualConvEpilogueRule())


def fusion_rules():
    """The 'fusion' pass's rule list (order matters: fuse units first,
    then cancel the per-unit layout brackets)."""
    return [get_rule("bottleneck_fuse"), get_rule("transpose_cancel")]


def residual_rules():
    """The 'residual' pass's rule list."""
    return [get_rule("residual_conv_epilogue")]
