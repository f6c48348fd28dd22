"""Network visualization (``mx.viz``; counterpart of
``mxnet_tpu/visualization.py``): ``print_summary``, a layer table with
parameter counts whose text is the JAX package's character for character,
and ``plot_network``, the same ``graphviz.Digraph`` where the ``graphviz``
package is installed (it raises by name where it is not). Only shape
inference runs: nothing is computed."""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a layer-by-layer summary and return the total count of the
    parameters (inputs named ``weight``, ``bias``, ``gamma`` or
    ``beta``)."""
    arg_shape_map = {}
    internal_shape_map = {}
    if shape is not None:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        arg_shape_map = dict(zip(symbol.list_arguments(), arg_shapes))
        internals = symbol.get_internals()
        _, int_out_shapes, _ = internals.infer_shape(**shape)
        internal_shape_map = dict(zip(internals.list_outputs(),
                                      int_out_shapes))
    positions = [int(line_length * p) for p in positions]
    headers = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(fields):
        line = ""
        for f, pos in zip(fields, positions):
            line += str(f)
            line = line[:pos - 1]
            line += " " * (pos - len(line))
        print(line.rstrip())

    print("_" * line_length)
    print_row(headers)
    print("=" * line_length)
    total = 0
    for node in symbol._topo():
        if node.op is None:
            continue
        n_params = 0
        for inp, _ in node.inputs:
            if inp.op is None and inp.name in arg_shape_map and any(
                t in inp.name for t in ("weight", "bias", "gamma", "beta")
            ):
                n_params += int(np.prod(arg_shape_map[inp.name]))
        total += n_params
        out_shape = internal_shape_map.get(
            "%s_output" % node.name,
            internal_shape_map.get(node.name, ""))
        prev = ",".join(inp.name for inp, _ in node.inputs
                        if inp.op is not None)
        print_row(["%s (%s)" % (node.name, node.op.name), out_shape,
                   n_params, prev])
    print("=" * line_length)
    print("Total params: %d" % total)
    print("_" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A ``graphviz.Digraph`` of the symbol; raises by name without the
    ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError(
            "plot_network requires the 'graphviz' package "
            "(pip install graphviz) — use print_summary for a text view")
    node_attrs = dict(node_attrs or {})
    dot = Digraph(name=title, format=save_format)
    base_attr = dict(shape="box", fixedsize="false", style="filled")
    base_attr.update(node_attrs)
    palette = {"Convolution": "#fb8072", "FullyConnected": "#fb8072",
               "BatchNorm": "#bebada", "Activation": "#ffffb3",
               "Pooling": "#80b1d3", "Concat": "#fdb462",
               "SoftmaxOutput": "#b3de69"}
    for node in symbol._topo():
        if node.op is None:
            if hide_weights and node.name != "data":
                continue
            dot.node(node.name, node.name,
                     dict(base_attr, fillcolor="#8dd3c7", shape="oval"))
            continue
        color = palette.get(node.op.name, "#d9d9d9")
        label = "%s\n%s" % (node.op.name, node.name)
        dot.node(node.name, label, dict(base_attr, fillcolor=color))
        for inp, _ in node.inputs:
            if inp.op is None and hide_weights and inp.name != "data":
                continue
            dot.edge(inp.name, node.name)
    return dot
