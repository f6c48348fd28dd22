"""Graph evaluation and shape inference (counterpart of parts of
``mxnet_tpu/executor.py``).

:func:`eval_node` is the op-invocation contract every binder shares (the
serving predictor's fold and per-request programs, the training closure):
``__is_train__`` is threaded into train/infer-polymorphic ops, and outputs
always come back as a tuple. :func:`_graph_closure` evaluates a whole graph
and collects the auxiliary-state updates of a training step; gradients come
from autograd through the ops. Shape inference propagates shapes by running
each op on ``device="meta"`` tensors (shapes without compute), after the
parameterized layers' weight shapes are deduced from their data shapes
(:func:`_param_shape_hints`, the backward-direction rules).

Not ported yet: ``Executor``, ``bind``/``simple_bind``, ``ctx_group``
placement (a graph that carries one raises), selective remat names and the
RNG salt of stochastic ops (the port registers none).
"""
from __future__ import annotations

import torch

from .base import MXNetError, dtype_torch
from .symbol.symbol import _AUX_PARAMS


def eval_node(node, ins, is_train):
    """Evaluate one op node on its input tensors; returns a tuple."""
    attrs = dict(node.attrs)
    if "__is_train__" in node.op.attr_defaults:
        attrs["__is_train__"] = is_train
    out = node.op.fn(*ins, **attrs)
    return out if isinstance(out, tuple) else (out,)


def _graph_closure(symbol, is_train):
    """A function evaluating the graph: ``fn(values) -> (outputs,
    aux_updates)``, with ``values`` every variable's tensor by name and
    ``aux_updates`` the new value of each auxiliary state of a training
    step, by name, detached. Two contracts give them: an op's
    ``aux_state_outputs`` (the fused unit returns its moving statistics
    mixed), and BatchNorm's ``momentum * old + (1 - momentum) * batch``."""
    nodes = symbol._topo()
    node_ids = {id(n): i for i, n in enumerate(nodes)}
    for node in nodes:
        if "ctx_group" in node.attr_dict:
            raise MXNetError("%s: ctx_group placement is not ported"
                             % node.name)

    def fn(values):
        results = {}   # node index -> tuple of outputs
        aux_updates = {}
        for i, node in enumerate(nodes):
            if node.is_variable():
                if node.name not in values:
                    raise MXNetError("unbound variable %r" % node.name)
                results[i] = (values[node.name],)
                continue
            ins = [results[node_ids[id(inp)]][idx] for inp, idx in node.inputs]
            out = eval_node(node, ins, is_train)
            results[i] = out
            if not (is_train and node._arity):
                continue
            aux_out = node.op.aux_state_outputs
            for pname, (inode, _) in zip(node._arity, node.inputs):
                if not inode.is_variable():
                    continue
                if aux_out:
                    idx = aux_out.get(pname)
                    if idx is not None:
                        aux_updates[inode.name] = out[idx].detach()
                elif node.op.name in _AUX_PARAMS and pname in (
                        "moving_mean", "moving_var"):
                    m = node.attrs.get("momentum", 0.9)
                    batch = out[1 if pname == "moving_mean" else 2]
                    aux_updates[inode.name] = (
                        m * values[inode.name] + (1 - m) * batch).detach()
        outs = [results[node_ids[id(n)]][idx] for n, idx in symbol._entries]
        return outs, aux_updates

    return fn


def infer_graph_shapes(symbol, kwargs):
    """``(arg_shapes, out_shapes, aux_shapes)`` of ``symbol`` from the
    input shapes in ``kwargs``; an unresolved shape raises."""
    known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    shapes = _solve_shapes(symbol, known)
    arg_shapes = [shapes.get(n) for n in symbol.list_arguments()]
    aux_shapes = [shapes.get(n) for n in symbol.list_auxiliary_states()]
    return arg_shapes, shapes["__outputs__"], aux_shapes


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _solve_shapes(symbol, known_shapes):
    """Infer every variable's shape by constraint propagation: per-op
    weight-shape rules, then each op run on meta tensors, to a fixpoint.
    Returns the shapes by variable name, with the output shapes under
    ``"__outputs__"``. A variable's dtype is float32 unless its
    ``__dtype__`` attribute says otherwise."""
    nodes = symbol._topo()
    node_ids = {id(n): i for i, n in enumerate(nodes)}
    shapes = dict(known_shapes)
    dtypes = {}
    node_out = {}      # node index -> [(shape, dtype)] per output
    node_errors = {}   # node name -> last error (diagnostics)

    def in_structs(node):
        ins = []
        for inp, idx in node.inputs:
            if inp.is_variable():
                s = shapes.get(inp.name)
                ins.append(None if s is None else
                           (s, dtypes.get(inp.name, torch.float32)))
            else:
                outs = node_out.get(node_ids[id(inp)])
                ins.append(outs[idx] if outs else None)
        return ins

    progress, rounds = True, 0
    while progress and rounds < len(nodes) + 2:
        progress = False
        rounds += 1
        for i, node in enumerate(nodes):
            if node.is_variable():
                if node.name not in shapes and "__shape__" in node.attr_dict:
                    sh = node.attr_dict["__shape__"]
                    if isinstance(sh, str):
                        from .ops.registry import _parse_tuple

                        sh = _parse_tuple(sh)
                    shapes[node.name] = tuple(sh)
                    progress = True
                if node.name not in dtypes and "__dtype__" in node.attr_dict:
                    dtypes[node.name] = dtype_torch(
                        node.attr_dict["__dtype__"])
                continue
            if i in node_out:
                continue
            structs = in_structs(node)
            hints = _param_shape_hints(node, [s[0] if s else None
                                              for s in structs])
            for pname, shape in hints.items():
                for an, (inode, _) in zip(node._arity or (), node.inputs):
                    if an == pname and inode.is_variable() \
                            and inode.name not in shapes:
                        shapes[inode.name] = shape
                        progress = True
            structs = in_structs(node)
            if any(s is None for s in structs):
                continue
            try:
                out = eval_node(node, [_meta(s, d) for s, d in structs],
                                False)
                node_out[i] = [(tuple(o.shape), o.dtype) for o in out]
                node_errors.pop(node.name, None)
                progress = True
            except Exception as e:  # unresolved mid-fixpoint is normal
                lines = str(e).strip().splitlines()
                node_errors[node.name] = "%s(%s): %s" % (
                    node.op.name, node.name,
                    lines[-1][:200] if lines else type(e).__name__)

    out_shapes = []
    for n, idx in symbol._entries:
        if n.is_variable():
            out_shapes.append(shapes.get(n.name))
        else:
            outs = node_out.get(node_ids[id(n)])
            out_shapes.append(outs[idx][0] if outs else None)
    if any(s is None for s in out_shapes):
        missing = [v.name for v in nodes
                   if v.is_variable() and v.name not in shapes]
        detail = "; ".join(list(node_errors.values())[:3])
        raise MXNetError("infer_shape failed; unresolved variables: %s%s"
                         % (missing, (" — node errors: " + detail)
                            if detail else ""))
    shapes["__outputs__"] = out_shapes
    return shapes


def _param_shape_hints(node, in_shapes):
    """Parameter shapes deduced from the data shape for the parameterized
    layers of the image-serving path."""
    op, attrs = node.op.name, node.attrs
    data = in_shapes[0] if in_shapes else None
    if data is None:
        return {}
    hints = {}
    if op in ("Convolution", "Convolution_v1"):
        kernel = tuple(int(k) for k in attrs.get("kernel", ()))
        nf = int(attrs.get("num_filter", 1))
        ng = int(attrs.get("num_group", 1))
        hints["weight"] = (nf, data[1] // ng) + kernel
        if not attrs.get("no_bias"):
            hints["bias"] = (nf,)
    elif op == "FusedBottleneckUnit":
        # data is NHWC; weights keep the unfused OIHW checkpoint shapes
        nf = int(attrs.get("num_filter", 1))
        c, ci = nf // 4, data[3]
        hints["conv1_weight"] = (c, ci, 1, 1)
        hints["conv2_weight"] = (c, c, 3, 3)
        hints["conv3_weight"] = (nf, c, 1, 1)
        hints["sc_weight"] = (nf, ci, 1, 1)
        for i, ch in (("1", ci), ("2", c), ("3", c)):
            for p in ("gamma", "beta", "moving_mean", "moving_var"):
                hints["bn%s_%s" % (i, p)] = (ch,)
    elif op == "FullyConnected":
        nh = int(attrs.get("num_hidden", 1))
        in_dim = 1
        if attrs.get("flatten", True):
            for d in data[1:]:
                in_dim *= d
        else:
            in_dim = data[-1]
        hints["weight"] = (nh, in_dim)
        if not attrs.get("no_bias"):
            hints["bias"] = (nh,)
    elif op in ("BatchNorm", "BatchNorm_v1", "batch_norm"):
        c = data[int(attrs.get("axis", 1)) % len(data)]
        hints.update({"gamma": (c,), "beta": (c,), "moving_mean": (c,),
                      "moving_var": (c,)})
    elif op == "SoftmaxOutput":
        if attrs.get("multi_output"):
            hints["label"] = (data[0],) + tuple(data[2:])
        else:
            hints["label"] = (data[0],)
    return hints
