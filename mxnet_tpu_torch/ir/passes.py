"""Pattern-rule passes over the Symbol graph (counterpart of
``mxnet_tpu/ir/passes.py``).

The IR is the ``Symbol``/``_Node`` graph itself; a :class:`Pass` is
``Symbol -> (Symbol, provenance)``, and :class:`RulePass` runs pattern
rules (:mod:`.match`, :mod:`.rules`) to a fixpoint, one rewrite at a time,
in topo order: a given graph and rule list always give the same output
graph and the same provenance. :class:`PassManager` composes registered
passes.

Safety contract: a rewrite replaces exactly the matched root entry;
matches whose interior nodes are used outside the pattern (or are graph
outputs) are skipped; a rewrite with the wrong entry count or missing
required inputs raises :class:`PassError` naming the rule and node; with
``data_shapes``, a pass that changes the graph's output shapes raises.

Registered: ``fusion``, ``residual``, ``layout`` (whose kill switch is
``MXNET_IR_LAYOUT``) and ``quantize``, which needs its calibration context
(:func:`.quantize.quantize_for_serving` or ``AOTPredictor(quant="int8",
calib_data=...)``) and raises from a bare pipeline. Every rewrite lands in
``profiler.pass_stats`` (rule hits, nodes rewritten, transposes cancelled,
quantized ops) and in the provenance dict each pass returns.
"""
from __future__ import annotations

from .. import config
from ..base import MXNetError
from ..symbol.symbol import Symbol
from .match import match

MAX_REWRITES = 10000


class PassError(MXNetError):
    """A pass misbehaved: a rule matched but its rewrite produced an
    arity/shape mismatch (the error names the rule and node), or the
    pass pipeline itself is misconfigured."""


class Pass:
    """One Symbol -> Symbol transformation."""

    name = None

    def apply(self, symbol):
        """Returns ``(new_symbol, provenance_dict)``."""
        raise NotImplementedError


def _consumer_map(nodes):
    """id(node) -> list of (consumer_node, out_index_consumed)."""
    consumers = {}
    for node in nodes:
        for inp, idx in node.inputs:
            consumers.setdefault(id(inp), []).append((node, idx))
    return consumers


def _match_is_safe(m, symbol, consumers):
    """Reject matches the splice cannot honor: an interior node
    referenced from outside the pattern (or exported as a graph
    output), or a multi-output root consumed at out_index != 0."""
    root = m.root[0]
    interior = m.interior
    for node, idx in symbol._entries:
        if id(node) in interior:
            return False
        if node is root and idx != 0:
            return False
    for node, idx in consumers.get(id(root), ()):
        if idx != 0:
            return False
    for nid in interior:
        for cons, _idx in consumers.get(nid, ()):
            if id(cons) not in interior and cons is not root:
                return False
    return True


def _validate_replacement(rule, m, repl):
    root = m.root[0]
    if not isinstance(repl, Symbol) or len(repl._entries) != 1:
        raise PassError(
            "rule %r at node %r: rewrite must return a single-output "
            "Symbol, got %r" % (rule.name, root.name, repl))
    node, idx = repl._entries[0]
    if node.is_variable():
        return
    op = node.op
    if idx >= node.n_outputs():
        raise PassError(
            "rule %r at node %r: rewrite entry index %d out of range "
            "for op %s (%d outputs)"
            % (rule.name, root.name, idx, op.name, node.n_outputs()))
    if not op.var_inputs:
        needed = 0
        for i, pname in enumerate(op.input_names):
            if pname not in op.optional_inputs:
                needed = i + 1
        if len(node.inputs) < needed or \
                len(node.inputs) > len(op.input_names):
            raise PassError(
                "rule %r at node %r: rewrite applied op %s with %d "
                "inputs; it needs %d..%d (%s)"
                % (rule.name, root.name, op.name, len(node.inputs),
                   needed, len(op.input_names), list(op.input_names)))


def splice(symbol, root, new_entry):
    """Rebuild ``symbol`` with every reference to ``(root, 0)``
    redirected to ``new_entry``; untouched subgraphs keep node identity."""
    memo = {id(root): new_entry}

    def rebuild(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.is_variable():
            ent = (node, 0)
            memo[id(node)] = ent
            return ent
        new_inputs = []
        changed = False
        for inp, idx in node.inputs:
            rn, ri = rebuild(inp)
            if rn is inp:
                new_inputs.append((inp, idx))
                continue
            changed = True
            # a consumer of the replaced root (guarded to idx == 0)
            # takes the replacement entry verbatim; any other rebuilt
            # node keeps the same output count, so idx is preserved
            new_inputs.append((rn, ri) if inp is root else (rn, idx))
        if not changed:
            ent = (node, 0)
            memo[id(node)] = ent
            return ent
        from ..symbol.symbol import _Node

        new_node = _Node(node.op, node.attrs, new_inputs, node.name,
                         dict(node.attr_dict), node._arity)
        ent = (new_node, 0)
        memo[id(node)] = ent
        return ent

    entries = []
    for node, idx in symbol._entries:
        rn, ri = rebuild(node)
        if node is root:
            entries.append((rn, ri))
        else:
            entries.append((rn, idx))
    return Symbol(entries)


class RulePass(Pass):
    """Run pattern rules to a fixpoint, one rewrite at a time.

    Deterministic by construction: each round scans the current graph
    in topo order and rules in list order, applies the FIRST safe
    match, and repeats — so a given (graph, rule list) always produces
    the same output graph and the same provenance."""

    def __init__(self, name, rules):
        self.name = name
        self.rules = list(rules)

    def _find(self, symbol):
        nodes = symbol._topo()
        consumers = _consumer_map(nodes)
        for node in nodes:
            if node.is_variable():
                continue
            for rule in self.rules:
                for pattern in rule.patterns:
                    m = match(pattern, (node, 0))
                    if m is None:
                        continue
                    if rule.where is not None and not rule.where(m):
                        continue
                    if not _match_is_safe(m, symbol, consumers):
                        continue
                    return rule, m
        return None

    def apply(self, symbol):
        from .. import profiler

        applied = []
        before = len(symbol._topo())
        while True:
            found = self._find(symbol)
            if found is None:
                break
            rule, m = found
            repl = rule.rewrite(m)
            _validate_replacement(rule, m, repl)
            symbol = splice(symbol, m.root[0], repl._entries[0])
            applied.append(rule.name)
            profiler.pass_record(self.name, rule=rule.name, hits=1)
            if len(applied) > MAX_REWRITES:
                raise PassError(
                    "pass %r exceeded %d rewrites (a rule pair is "
                    "oscillating; last: %s)"
                    % (self.name, MAX_REWRITES, applied[-4:]))
        after = len(symbol._topo())
        if applied:
            profiler.pass_record(self.name,
                                 rewritten=max(before - after, 0))
        prov = {"pass": self.name, "rewrites": len(applied),
                "applied": applied, "nodes_before": before,
                "nodes_after": after}
        return symbol, prov


class LayoutPass(RulePass):
    """The ``layout`` rule pass; the drop in transpose nodes rides the
    provenance and ``profiler.pass_stats`` as ``transposes_cancelled``."""

    @staticmethod
    def _n_transposes(symbol):
        return sum(1 for n in symbol._topo()
                   if not n.is_variable() and n.op.name == "transpose")

    def apply(self, symbol):
        from .. import profiler

        before = self._n_transposes(symbol)
        symbol, prov = RulePass.apply(self, symbol)
        cancelled = max(before - self._n_transposes(symbol), 0)
        prov["transposes_cancelled"] = cancelled
        if cancelled:
            profiler.pass_record(self.name,
                                 transposes_cancelled=cancelled)
        return symbol, prov


# ---------------------------------------------------------------------------
# registry + pipeline
# ---------------------------------------------------------------------------
def _make_fusion():
    from .rules import fusion_rules

    return RulePass("fusion", fusion_rules())


def _make_residual():
    from .rules import residual_rules

    return RulePass("residual", residual_rules())


def _make_layout():
    from .layout import layout_rules

    if not config.get_strict_bool("MXNET_IR_LAYOUT"):
        # kill switch: the pass runs with no rules and returns the graph
        return LayoutPass("layout", [])
    return LayoutPass("layout", layout_rules())


def _make_quantize(**kwargs):
    if not kwargs:
        raise PassError(
            "the 'quantize' pass needs calibration context (params + "
            "calib batches); bind through AOTPredictor(quant='int8', "
            "calib_data=...) or call ir.quantize.quantize_for_serving "
            "directly — it cannot run from a bare MXNET_IR_PASSES "
            "pipeline")
    from .quantize import QuantizePass

    return QuantizePass(**kwargs)


PASSES = {
    "fusion": _make_fusion,
    "residual": _make_residual,
    "layout": _make_layout,
    "quantize": _make_quantize,
}


def _pipeline_names(passes):
    """The pass names of ``passes`` (a list or comma string), or of the
    ``MXNET_IR_PASSES`` knob when it is None; an unknown name raises,
    naming where it came from."""
    if passes is None:
        raw = config.get("MXNET_IR_PASSES")
        names = tuple(p.strip() for p in str(raw).split(",") if p.strip())
        source = "MXNET_IR_PASSES=%r" % raw
    else:
        if isinstance(passes, str):
            passes = passes.split(",")
        names = tuple(str(p).strip() for p in passes if str(p).strip())
        source = "passes=%r" % (passes,)
    for name in names:
        if name not in PASSES:
            raise MXNetError("%s: unknown pass %r (registered: %s)"
                             % (source, name, sorted(PASSES)))
    return names


class PassManager:
    """Compose registered passes; with ``data_shapes`` (``{input name:
    shape}``) a pass that changes the graph's output shapes raises."""

    def __init__(self, passes=None, data_shapes=None):
        self.names = _pipeline_names(passes)
        self.data_shapes = dict(data_shapes or {})

    def _out_shapes(self, symbol):
        if not self.data_shapes:
            return None
        return symbol.infer_shape(**self.data_shapes)[1]

    def apply(self, symbol):
        """Run the pipeline; returns ``(symbol, provenance_list)``."""
        provenance = []
        want = self._out_shapes(symbol)
        for name in self.names:
            symbol, prov = PASSES[name]().apply(symbol)
            provenance.append(prov)
            have = self._out_shapes(symbol)
            if have != want:
                raise PassError(
                    "pass %r changed the graph's output shapes (%s -> %s); "
                    "rewrites must be shape-preserving" % (name, want, have))
        return symbol, provenance


def apply_passes(symbol, passes=None, data_shapes=None):
    """Run a pass pipeline over ``symbol`` and return the rewritten
    Symbol. ``passes`` is a name list or comma string (default: the
    ``MXNET_IR_PASSES`` knob)."""
    return PassManager(passes, data_shapes).apply(symbol)[0]
