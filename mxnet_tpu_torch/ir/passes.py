"""Pattern-rule passes over the Symbol graph (counterpart of
``mxnet_tpu/ir/passes.py``).

The IR is the ``Symbol``/``_Node`` graph itself; a pass is ``Symbol ->
Symbol``, and :class:`RulePass` runs pattern rules (:mod:`.match`,
:mod:`.rules`) to a fixpoint, one rewrite at a time, in topo order: a
given graph and rule list always give the same output graph.

Safety contract: a rewrite replaces exactly the matched root entry;
matches whose interior nodes are used outside the pattern (or are graph
outputs) are skipped; a rewrite with the wrong entry count or missing
required inputs raises :class:`PassError` naming the rule and node; with
``data_shapes``, :func:`apply_passes` checks that each pass keeps the
graph's output shapes.

Only the ``fusion`` pass is ported; ``residual``, ``layout`` and
``quantize`` are registered names that raise "not ported". The JAX
package's provenance records and per-pass profiler counters have no
reader in the port yet and are not carried over.
"""
from __future__ import annotations

from ..base import MXNetError
from ..symbol.symbol import Symbol
from .match import match

MAX_REWRITES = 10000


class PassError(MXNetError):
    """A pass misbehaved: a rule matched but its rewrite produced an
    arity/shape mismatch (the error names the rule and node), or the
    pass pipeline itself is misconfigured."""


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


class RulePass:
    """Run pattern rules to a fixpoint, one rewrite at a time.

    Deterministic by construction: each round scans the current graph
    in topo order and rules in list order, applies the FIRST safe
    match, and repeats — so a given (graph, rule list) always produces
    the same output graph."""

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
        """Returns the rewritten Symbol."""
        rewrites = 0
        while True:
            found = self._find(symbol)
            if found is None:
                return symbol
            rule, m = found
            repl = rule.rewrite(m)
            _validate_replacement(rule, m, repl)
            symbol = splice(symbol, m.root[0], repl._entries[0])
            rewrites += 1
            if rewrites > MAX_REWRITES:
                raise PassError(
                    "pass %r exceeded %d rewrites (a rule pair is "
                    "oscillating; last rule: %s)"
                    % (self.name, MAX_REWRITES, rule.name))


# ---------------------------------------------------------------------------
# registry + pipeline
# ---------------------------------------------------------------------------
def _make_fusion():
    from .rules import fusion_rules

    return RulePass("fusion", fusion_rules())


def _not_ported(name):
    def make():
        raise PassError("the %r pass is not ported yet (only 'fusion' is)"
                        % name)
    return make


PASSES = {
    "fusion": _make_fusion,
    "residual": _not_ported("residual"),
    "layout": _not_ported("layout"),
    "quantize": _not_ported("quantize"),
}


def _pipeline_names(passes):
    if isinstance(passes, str):
        passes = passes.split(",")
    names = tuple(str(p).strip() for p in passes if str(p).strip())
    for name in names:
        if name not in PASSES:
            raise MXNetError("passes=%r: unknown pass %r (registered: %s)"
                             % (passes, name, sorted(PASSES)))
    return names


def apply_passes(symbol, passes, data_shapes=None):
    """Run a pass pipeline over ``symbol`` and return the rewritten
    Symbol. ``passes`` is a name list or comma string; with
    ``data_shapes`` (``{input name: shape}``) a pass that changes the
    graph's output shapes raises :class:`PassError`."""
    names = _pipeline_names(passes)
    data_shapes = dict(data_shapes or {})

    def out_shapes(sym):
        return sym.infer_shape(**data_shapes)[1] if data_shapes else None

    want = out_shapes(symbol)
    for name in names:
        symbol = PASSES[name]().apply(symbol)
        have = out_shapes(symbol)
        if have != want:
            raise PassError(
                "pass %r changed the graph's output shapes (%s -> %s); "
                "rewrites must be shape-preserving" % (name, want, have))
    return symbol
