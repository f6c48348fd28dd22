"""Graph evaluation, shape inference and the bound executor (counterpart
of ``mxnet_tpu/executor.py``).

:func:`eval_node` is the op-invocation contract every binder shares (the
serving predictor's fold and per-request programs, the training closure):
``__is_train__`` is threaded into train/infer-polymorphic ops, and outputs
always come back as a tuple. :func:`_graph_closure` evaluates a whole graph
and collects the auxiliary-state updates of a training step; gradients come
from autograd through the ops. Shape inference propagates shapes by running
each op on ``device="meta"`` tensors (shapes without compute), after the
parameterized layers' weight shapes are deduced from their data shapes
(:func:`_param_shape_hints`, the backward-direction rules).


:class:`Executor` binds a graph to NDArrays (``Symbol.bind``,
:func:`simple_bind`): a training forward runs the closure with autograd
on, from leaves that share the argument arrays' memory, applies the aux
updates once, and keeps the graph for :meth:`Executor.backward`, which
frees it; ``forward_backward`` does both on one graph.

Not ported yet: ``ctx_group`` placement and ``group2ctx`` (both raise),
``MXNET_BACKWARD_DO_MIRROR``, selective remat names, monitor callbacks
and the RNG salt of stochastic ops (the port registers none).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, dtype_name, dtype_torch
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


def infer_graph_types(symbol, kwargs):
    """``(arg_types, out_types, aux_types)`` as numpy types (bfloat16 as
    ``torch.bfloat16``): each variable's from ``kwargs``, its ``__dtype__``
    attribute or float32; the outputs' by evaluating the graph on meta
    tensors where the variables' ``__shape__`` attributes allow it, else
    float32 (the JAX package's fallback)."""
    from .ndarray.ndarray import _NP_TYPES

    types = {k: dtype_torch(v) for k, v in kwargs.items() if v is not None}
    try:
        shapes = _solve_shapes(symbol, {}, types)
        outs = shapes["__out_dtypes__"]
    except MXNetError:
        outs = [torch.float32] * len(symbol._entries)
    attrs = {n.name: n.attr_dict for n in symbol._var_nodes()}

    def var_type(name):
        t = types.get(name)
        if t is None and "__dtype__" in attrs.get(name, {}):
            t = dtype_torch(attrs[name]["__dtype__"])
        return _NP_TYPES.get(t or torch.float32, t)

    return ([var_type(n) for n in symbol.list_arguments()],
            [_NP_TYPES.get(t, t) for t in outs],
            [var_type(n) for n in symbol.list_auxiliary_states()])


def _solve_shapes(symbol, known_shapes, type_dict=None):
    """Infer every variable's shape by constraint propagation: per-op
    weight-shape rules, then each op run on meta tensors, to a fixpoint.
    Returns the shapes by variable name, with the output shapes under
    ``"__outputs__"`` and their dtypes under ``"__out_dtypes__"``. A
    variable's dtype is ``type_dict``'s, else its ``__dtype__``
    attribute's, else float32."""
    nodes = symbol._topo()
    node_ids = {id(n): i for i, n in enumerate(nodes)}
    shapes = dict(known_shapes)
    dtypes = dict(type_dict or {})
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

    out_shapes, out_dtypes = [], []
    for n, idx in symbol._entries:
        if n.is_variable():
            out_shapes.append(shapes.get(n.name))
            out_dtypes.append(dtypes.get(n.name, torch.float32))
        else:
            outs = node_out.get(node_ids[id(n)])
            out_shapes.append(outs[idx][0] if outs else None)
            out_dtypes.append(outs[idx][1] if outs else None)
    if any(s is None for s in out_shapes):
        missing = [v.name for v in nodes
                   if v.is_variable() and v.name not in shapes]
        detail = "; ".join(list(node_errors.values())[:3])
        raise MXNetError("infer_shape failed; unresolved variables: %s%s"
                         % (missing, (" — node errors: " + detail)
                            if detail else ""))
    shapes["__outputs__"] = out_shapes
    shapes["__out_dtypes__"] = out_dtypes
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


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
def _by_name(kind, given, names):
    if isinstance(given, dict):
        return dict(given)
    given = list(given or [])
    if len(given) != len(names):
        raise MXNetError("bind: expected %d %s, got %d"
                         % (len(names), kind, len(given)))
    return dict(zip(names, given))


class Executor:
    """A graph bound to NDArrays on one context.

    ``arg_dict``/``aux_dict`` hold the bound arrays themselves: a forward
    reads their tensors as they are then, the aux updates of a training
    forward are written into ``aux_dict``'s tensors, and the gradients
    into ``grad_dict``'s, per argument by ``grad_req`` (``write``,
    ``add`` or ``null``). ``outputs`` keeps the same NDArray handles from
    call to call."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None):
        from .context import Context

        if group2ctx:
            raise MXNetError("bind: group2ctx (ctx_group placement) is not "
                             "ported")
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_dict = _by_name("arguments", args, self._arg_names)
        missing = [n for n in self._arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        self.aux_dict = _by_name(
            "auxiliary states", {} if aux_states is None else aux_states,
            self._aux_names)
        missing = [n for n in self._aux_names if n not in self.aux_dict]
        if missing:
            raise MXNetError("bind: missing auxiliary states %s" % missing)
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self._arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self._arg_names}
        bad = {r for r in self.grad_req.values()} - {"write", "add", "null"}
        if bad:
            raise MXNetError("bind: grad_req must be write, add or null, "
                             "got %s" % sorted(bad))
        self.grad_dict = {} if args_grad is None else \
            _by_name("gradients", args_grad, self._arg_names)
        self._grad_names = [n for n in self._arg_names
                            if self.grad_req.get(n) != "null"
                            and self.grad_dict.get(n) is not None]
        self._graphs = {}
        self._pending = None       # (leaves, graph outputs) of a forward
        self._aux_applied = False
        self.outputs = []

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def _graph(self, is_train):
        fn = self._graphs.get(is_train)
        if fn is None:
            fn = self._graphs[is_train] = _graph_closure(self._symbol,
                                                         is_train)
        return fn

    def _load_inputs(self, kwargs):
        with torch.no_grad():
            for name, v in kwargs.items():
                if name not in self.arg_dict:
                    continue
                src = v.tensor if hasattr(v, "tensor") else \
                    torch.from_numpy(np.array(v))
                self.arg_dict[name].tensor.copy_(src)

    def _run(self, is_train, with_grad):
        """Evaluate the graph; returns (leaves, outputs, aux_updates)."""
        values = {n: self.arg_dict[n].tensor for n in self._arg_names}
        leaves = {}
        if with_grad:
            for n in self._grad_names:
                leaves[n] = values[n] = values[n].detach().requires_grad_()
        for n in self._aux_names:
            values[n] = self.aux_dict[n].tensor
        with torch.set_grad_enabled(with_grad):
            outs, aux_updates = self._graph(is_train)(values)
        return leaves, outs, aux_updates

    def _apply_aux(self, aux_updates):
        with torch.no_grad():
            for name, val in aux_updates.items():
                self.aux_dict[name].tensor.copy_(val)
        self._aux_applied = True

    def _set_outputs(self, outs):
        from .ndarray.ndarray import NDArray

        if len(self.outputs) != len(outs):
            self.outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        else:
            for arr, o in zip(self.outputs, outs):
                arr._t = o.detach()

    def forward(self, is_train=False, **kwargs):
        """Copy ``kwargs`` into the bound arguments and evaluate. A
        training forward applies the aux updates and keeps the graph for
        :meth:`backward` when some argument takes a gradient."""
        self._load_inputs(kwargs)
        self._pending = None
        with_grad = bool(is_train and self._grad_names)
        leaves, outs, aux_updates = self._run(bool(is_train), with_grad)
        self._aux_applied = False
        if is_train:
            self._apply_aux(aux_updates)
        if with_grad:
            self._pending = (leaves, outs)
        self._set_outputs(outs)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients into ``grad_dict`` from the last training forward's
        graph, which is then freed. Without one (a second backward, or
        after an inference forward) the training forward runs again, and
        applies the aux updates if no forward since the last has."""
        if self._pending is None:
            leaves, outs, aux_updates = self._run(True, True)
            if not self._aux_applied:
                self._apply_aux(aux_updates)
            self._set_outputs(outs)
        else:
            leaves, outs = self._pending
        self._pending = None
        self._aux_applied = False
        self._write_grads(leaves, outs, out_grads)

    def forward_backward(self, out_grads=None, **kwargs):
        """One training forward and its backward on one graph; the aux
        updates are applied once."""
        self._load_inputs(kwargs)
        self._pending = None
        leaves, outs, aux_updates = self._run(True, bool(self._grad_names))
        self._apply_aux(aux_updates)
        self._aux_applied = False
        self._set_outputs(outs)
        if self._grad_names:
            self._write_grads(leaves, outs, out_grads)
        return self.outputs

    def _write_grads(self, leaves, outs, out_grads):
        if out_grads is None:
            out_grads = []
        elif not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        heads, cts = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            g = out_grads[i] if i < len(out_grads) else None
            g = g.tensor if hasattr(g, "tensor") else g
            heads.append(o)
            cts.append(torch.ones_like(o) if g is None else
                       torch.as_tensor(g, dtype=o.dtype, device=o.device))
        names = list(leaves)
        got = torch.autograd.grad(heads, [leaves[n] for n in names], cts,
                                  allow_unused=True) if heads else \
            [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, got):
                buf = self.grad_dict[n].tensor
                if self.grad_req[n] == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for params, target, kind in ((arg_params, self.arg_dict, "argument"),
                                     (aux_params, self.aux_dict,
                                      "aux state")):
            for name, arr in (params or {}).items():
                if name in target:
                    arr.copyto(target[name])
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %r" % (kind, name))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for other input shapes, sharing every array whose
        shape stays."""
        from .ndarray.ndarray import zeros

        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def resized(arr, shape):
            if arr is None or tuple(arr.shape) == tuple(shape):
                return arr
            return zeros(shape, ctx=self._ctx, dtype=arr.dtype)

        args = {n: resized(self.arg_dict[n], s)
                for n, s in zip(self._arg_names, arg_shapes)}
        grads = {n: resized(self.grad_dict.get(n), s)
                 for n, s in zip(self._arg_names, arg_shapes)
                 if self.grad_dict.get(n) is not None}
        aux = {n: resized(self.aux_dict[n], s)
               for n, s in zip(self._aux_names, aux_shapes)}
        return Executor(self._symbol, self._ctx, args, grads, self.grad_req,
                        aux)

    def set_monitor_callback(self, callback, monitor_all=False):
        raise MXNetError("Executor.set_monitor_callback: monitors are not "
                         "ported")


def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                shared_exec=None, group2ctx=None, **kwargs):
    """Allocate zeroed argument, gradient and aux arrays on ``ctx`` from
    the shapes inferred from ``kwargs`` and bind them; arrays of
    ``shared_exec`` with the same name and shape are shared."""
    from .ndarray.ndarray import zeros

    arg_shapes, _, aux_shapes = symbol.infer_shape(**{
        k: v for k, v in kwargs.items() if isinstance(v, (list, tuple))})
    arg_names = symbol.list_arguments()
    type_dict = type_dict or {}
    reqs = {n: grad_req for n in arg_names} if isinstance(grad_req, str) \
        else dict(grad_req)

    def alloc(name, shape, shared):
        if shared is not None and name in shared and \
                shared[name] is not None and \
                tuple(shared[name].shape) == tuple(shape):
            return shared[name]
        return zeros(shape, ctx=ctx,
                     dtype=dtype_name(type_dict.get(name, np.float32)))

    sh = shared_exec
    args = {n: alloc(n, s, sh and sh.arg_dict)
            for n, s in zip(arg_names, arg_shapes)}
    grads = {n: alloc(n, args[n].shape, sh and sh.grad_dict)
             for n in arg_names if reqs.get(n, "null") != "null"}
    aux = {n: alloc(n, s, sh and sh.aux_dict)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    return Executor(symbol, ctx, args, grads, reqs, aux, group2ctx=group2ctx)
