"""Bind-time constant folding: the split every binder shares (counterpart
of ``mxnet_tpu/ir/fold.py``).

:class:`FoldPlan` partitions the graph on data dependence
(``Symbol.data_dependent_nodes``): every node that is a pure function of
the weights is evaluated once per parameter set by the fold function, and
its outputs enter the per-request program as plain tensors
(``const_specs``), so a request runs only the data-dependent suffix.
PyTorch runs eagerly, so the fold function is a plain loop (the JAX
package jits it).
"""
from __future__ import annotations


class FoldPlan:
    """The bind-time fold/dynamic split of one symbol graph.

    ``dynamic_names``: variable names whose values change per request
    (data inputs and zero-filled extras); every other variable is a
    weight, and nodes untouched by dynamic variables fold."""

    def __init__(self, symbol, dynamic_names):
        self.symbol = symbol
        self.nodes = symbol._topo()
        self.node_ids = {id(n): i for i, n in enumerate(self.nodes)}
        self.entries = list(symbol._entries)
        self.dynamic_names = set(dynamic_names)
        self.dyn = symbol.data_dependent_nodes(self.dynamic_names)
        self.const_specs, self.const_index = self._collect_const_specs()
        self.fold_order = self._collect_fold_order()

    @property
    def folded_nodes(self):
        return len(self.fold_order)

    @property
    def dynamic_nodes(self):
        return len([i for i in self.dyn if not self.nodes[i].is_variable()])

    def _collect_const_specs(self):
        """Ordered, deduplicated values that cross from the fold side into
        the per-request program: ``("var", name)`` for weights consumed
        directly, ``("node", i, idx)`` for folded node outputs."""
        specs, index = [], {}

        def classify(inp, idx):
            if inp.is_variable():
                spec = None if inp.name in self.dynamic_names \
                    else ("var", inp.name)
            else:
                nid = self.node_ids[id(inp)]
                spec = None if nid in self.dyn else ("node", nid, idx)
            if spec is not None and spec not in index:
                index[spec] = len(specs)
                specs.append(spec)

        for i, node in enumerate(self.nodes):
            if node.is_variable() or i not in self.dyn:
                continue
            for inp, idx in node.inputs:
                classify(inp, idx)
        for node, idx in self.entries:
            classify(node, idx)
        return specs, index

    def _collect_fold_order(self):
        """Topo-ordered indices of the non-dynamic op nodes the fold must
        evaluate (the backward closure of the node const specs)."""
        needed = set()
        stack = [s[1] for s in self.const_specs if s[0] == "node"]
        while stack:
            i = stack.pop()
            if i in needed:
                continue
            needed.add(i)
            for inp, _ in self.nodes[i].inputs:
                if not inp.is_variable():
                    stack.append(self.node_ids[id(inp)])
        return sorted(needed)

    def make_fold_fn(self):
        """The fold function: ``params dict -> tuple`` of const values in
        ``const_specs`` order; a random node draws from
        ``executor.INFERENCE_SEED``."""
        from ..executor import INFERENCE_SEED, _values_device, eval_node

        specs, order = self.const_specs, self.fold_order
        nodes, node_ids = self.nodes, self.node_ids

        def fold(params):
            results = {}
            for i in order:
                ins = [params[inp.name] if inp.is_variable()
                       else results[node_ids[id(inp)]][idx]
                       for inp, idx in nodes[i].inputs]
                results[i] = eval_node(nodes[i], ins, False,
                                       INFERENCE_SEED, i,
                                       _values_device(params))
            return tuple(params[s[1]] if s[0] == "var"
                         else results[s[1]][s[2]] for s in specs)

        return fold
