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

:func:`_graph_closure` with ``remat_names`` lowers a selective-remat plan
(:class:`_Remat`), and :func:`residual_probe` counts what a forward keeps
for its backward (``TrainStep.residual_stats``).

Random ops (``needs_rng``: Dropout, LeakyReLU's rrelu, RNN's dropout)
draw from a generator of their own node: :func:`eval_node` seeds it from
the call's step seed and the node's salt (its index in the graph), so a
graph run twice from one step seed draws bit for bit the same, a remat
recompute replays its forward's draws and the backward of a training
forward uses that forward's masks (the autograd graph holds them).

``MXNET_BACKWARD_DO_MIRROR=1`` makes a bound executor's training graph
recompute in the backward, as the JAX package wraps its bound program in
``jax.checkpoint``: the graph runs under :class:`_Remat` with an empty
save set, so only the variables are kept and every op node reruns in the
backward. ``MXNET_INFER_DEBUG`` prints each failing node's traceback
during shape inference, as in the JAX package.

A monitor callback (:meth:`Executor.set_monitor_callback`, which
``Monitor.install`` sets) is called on each output, by name, after every
forward: ``forward``'s and ``forward_backward``'s. The JAX package's
``forward_backward`` calls none (its fused program has no hook); the port
calls it there too, as MXNet does, so ``fit(monitor=)`` sees the outputs.
``forward``, ``backward`` and ``forward_backward`` record profiler events
of those categories while the profiler runs (``profiler.maybe_scope``,
host time, no synchronization); ``forward_backward`` records its forward
and its backward as events of their own inside its own.

Not ported yet: ``ctx_group`` placement and ``group2ctx`` (both raise).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import traceback
import weakref

import numpy as np
import torch

from . import config
from . import profiler as _profiler
from . import random as _random
from .base import MXNetError, dtype_name, dtype_torch
from .symbol.symbol import _AUX_PARAMS

_RNG_SALT = 0x5EED
# the step seed of the random ops that draw in inference (Dropout with
# mode="always") when serving: fixed, as the JAX package's PRNGKey(0)
INFERENCE_SEED = 0


def eval_node(node, ins, is_train, seed=None, salt=0, device=None,
              batch=None):
    """Evaluate one op node on its input tensors; returns a tuple. A
    random op gets a generator on its data's device seeded from ``seed``
    (the step seed, None only on ``meta`` tensors) and ``salt +
    _RNG_SALT``. A node with no input (``_zeros``, ``_arange``,
    ``_random_uniform``, ...) creates its output on ``device`` (the
    graph's). ``batch`` (under a data-parallel scope) flags which inputs
    are batch-leading; the op reads them through
    ``fused_block.batch_operands``."""
    if batch is not None:
        from .kernels.fused_block import batch_operands

        with batch_operands(batch):
            return eval_node(node, ins, is_train, seed, salt, device)
    attrs = dict(node.attrs)
    if "__is_train__" in node.op.attr_defaults:
        attrs["__is_train__"] = is_train
    gen = ()
    if node.op.needs_rng:
        dev = ins[0].device if ins else device
        gen = (_random.node_generator(seed, salt + _RNG_SALT, dev),)
    if not ins and device is not None:
        with torch.device(device):
            out = node.op.fn(*gen, **attrs)
    else:
        out = node.op.fn(*gen, *ins, **attrs)
    return out if isinstance(out, tuple) else (out,)


def _batch_marks(nodes, node_ids):
    """Under a data-parallel scope: for each op node's index, the flags of
    its inputs' being batch-leading (the scope's batch inputs, and every
    op output with a batch-leading input but those of a ``batch_free``
    op); None outside a scope."""
    from .kernels.fused_block import current_spmd_scope, scope_batch_names

    if current_spmd_scope() is None:
        return None
    names = scope_batch_names()
    leading, marks = {}, {}
    for i, node in enumerate(nodes):
        if node.is_variable():
            leading[i] = names is None or node.name in names
            continue
        flags = tuple(leading[node_ids[id(inp)]] for inp, _ in node.inputs)
        marks[i] = flags
        leading[i] = any(flags) and not node.op.batch_free
    return marks


def _values_device(values):
    """The device of a graph's bound values (None when there are none)."""
    return next(iter(values.values())).device if values else None


def has_rng(symbol):
    """True when a node of ``symbol`` draws random numbers."""
    return any(n.op is not None and n.op.needs_rng for n in symbol._topo())


def _graph_closure(symbol, is_train, remat_names=None, shard_plan=None):
    """A function evaluating the graph: ``fn(values, seed=None) ->
    (outputs, aux_updates)``, with ``values`` every variable's tensor by
    name, ``seed`` the step seed of the random ops (None draws one from
    the device's chain when the graph has a random op) and
    ``aux_updates`` the new value of each auxiliary state of a training
    step, by name, detached. Two contracts give them: an op's
    ``aux_state_outputs`` (the fused unit returns its moving statistics
    mixed), and BatchNorm's ``momentum * old + (1 - momentum) * batch``.
    A node's outputs are dropped after their last consumer ran.

    ``remat_names`` (a set of node names, or None) is the selective-remat
    save set: the outputs of the nodes named there are kept for the
    backward, and every other computing node is recomputed in the backward
    (:class:`_Remat`). None evaluates the graph plainly.

    ``shard_plan`` (a ``parallel.symbol_mp.ShardPlan``, or None) runs the
    graph with the parameters it shards bound to this rank's blocks: each
    node through :meth:`ShardPlan.run_node`, the outputs made whole."""
    if shard_plan is not None and remat_names is not None:
        raise MXNetError("selective remat of a graph whose parameters are "
                         "sharded over the mp axis is not ported")
    nodes = symbol._topo()
    node_ids = {id(n): i for i, n in enumerate(nodes)}
    for node in nodes:
        if "ctx_group" in node.attr_dict:
            raise MXNetError("%s: ctx_group placement is not ported"
                             % node.name)
    last_use = {}
    for i, node in enumerate(nodes):
        for inp, _ in node.inputs:
            last_use[node_ids[id(inp)]] = i
    for n, _ in symbol._entries:
        last_use[node_ids[id(n)]] = len(nodes)
    dead_after = {}
    for j, i in last_use.items():
        dead_after.setdefault(i, []).append(j)
    recompute = None
    if remat_names is not None:
        keep = frozenset(remat_names)
        recompute = frozenset(i for i, n in enumerate(nodes)
                              if not n.is_variable() and n.name not in keep)

    rng = has_rng(symbol)

    def run(values, remat, seed, marks):
        results = {}   # node index -> tuple of outputs
        layouts = {}   # node index -> its outputs' layouts (a shard plan)
        aux_updates = {}
        device = _values_device(values)
        for i, node in enumerate(nodes):
            if node.is_variable():
                if node.name not in values:
                    raise MXNetError("unbound variable %r" % node.name)
                out = (values[node.name],)
                if shard_plan is not None:
                    layouts[i] = (shard_plan.var_layout(node.name),)
            else:
                ins = [results[node_ids[id(inp)]][idx]
                       for inp, idx in node.inputs]
                if remat is not None and i in recompute:
                    out = remat.run(i, ins)
                elif shard_plan is not None:
                    out, layouts[i] = shard_plan.run_node(
                        node, ins, [layouts[node_ids[id(inp)]][idx]
                                    for inp, idx in node.inputs],
                        lambda xs, node=node, i=i: eval_node(
                            node, xs, is_train, seed, i, device,
                            marks and marks[i]))
                else:
                    out = eval_node(node, ins, is_train, seed, i, device,
                                    marks and marks[i])
            results[i] = out
            if remat is not None:
                remat.own(i, out)
            if is_train and node._arity:
                _aux_updates(node, out, values, aux_updates)
            for j in dead_after.get(i, ()):
                del results[j]
                layouts.pop(j, None)
        outs = [results[node_ids[id(n)]][idx] for n, idx in symbol._entries]
        if shard_plan is not None:
            outs = [shard_plan.whole(o, layouts[node_ids[id(n)]][idx])
                    for o, (n, idx) in zip(outs, symbol._entries)]
        return outs, aux_updates

    def fn(values, seed=None):
        if rng and seed is None:
            seed = _random.next_seed(next(iter(values.values())).device)
        marks = _batch_marks(nodes, node_ids)
        if recompute is None:
            return run(values, None, seed, marks)
        remat = _Remat(nodes, node_ids, recompute, is_train, seed, marks)
        with torch.autograd.graph.saved_tensors_hooks(remat.pack,
                                                      remat.unpack):
            return run(values, remat, seed, marks)

    return fn


def _aux_updates(node, out, values, aux_updates):
    """Record a training node's new auxiliary states into ``aux_updates``."""
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


class _Owner:
    """The node output that first held a storage, and the live tensors
    known to view that storage (weak references)."""

    __slots__ = ("node", "out", "dtype", "offset", "nbytes", "refs")

    def __init__(self, node, out, t):
        self.node, self.out, self.dtype = node, out, t.dtype
        self.offset = t.storage_offset()
        self.nbytes = t.untyped_storage().nbytes()
        self.refs = [weakref.ref(t)]

    def alive(self):
        return any(r() is not None for r in self.refs)


class _Recipe:
    """What the backward keeps in place of a recompute node's output: the
    node, the output index and the saved tensor's view of its storage."""

    __slots__ = ("node", "out", "size", "stride", "offset")

    def __init__(self, node, out, t):
        self.node, self.out = node, out
        self.size, self.stride = tuple(t.shape), t.stride()
        self.offset = t.storage_offset()


class _Remat:
    """Selective remat of one forward: the outputs of recompute nodes are
    not kept for the backward.

    - A recompute node runs under its own non-reentrant checkpoint, so
      what its ops would keep (their inputs, their internals) is not kept:
      the checkpoint keeps the node's inputs and reruns the node in the
      backward.
    - A tensor kept for the backward (by a saved node's ops, or as a
      checkpoint's input) whose storage a recompute node's output owns is
      packed as a :class:`_Recipe`; unpacking it recomputes that output
      without autograd, from the kept outputs and the variables, through
      any chain of recompute nodes. A recomputed output is cached while
      recipes for it wait to be unpacked.
    - What it keeps it keeps detached: a kept tensor that held its
      ``grad_fn`` would close a reference cycle through the graph (a node
      saving its own output, or these hooks holding the graph's tensors)
      that outlives a forward whose backward never runs.
    - Storage ownership: every node output registers its storage; the
      first node whose output lives there owns it while any tensor known
      to view it is alive (a later owner of a reused address replaces a
      dead one). A tensor whose storage no live recompute output owns is
      kept as it is.

    A random op draws from a generator seeded from the step seed and its
    node (:func:`eval_node`), so a recompute draws what the forward drew
    and the checkpoints need not carry RNG state."""

    def __init__(self, nodes, node_ids, recompute, is_train, seed=None,
                 marks=None):
        self.nodes, self.node_ids = nodes, node_ids
        self.recompute, self.is_train = recompute, is_train
        self.seed, self.marks = seed, marks
        self.feeds = {node_ids[id(inp)] for i in recompute
                      for inp, _ in nodes[i].inputs} - recompute
        self.owners = {}   # storage address -> _Owner
        self.kept = {}     # node index -> outputs kept for recomputing
        self.pending = {}  # node index -> recipes not yet unpacked
        self.cache = {}    # node index -> recomputed outputs
        self.layouts = {}  # (node, output) -> (storage offset, bytes)
        self.probe = getattr(_PROBE, "active", None)

    def run(self, i, ins):
        from torch.utils.checkpoint import checkpoint

        node, is_train, seed = self.nodes[i], self.is_train, self.seed
        batch = self.marks and self.marks[i]

        def node_fn(*xs):
            return eval_node(node, list(xs), is_train, seed, i, batch=batch)

        return checkpoint(node_fn, *ins, use_reentrant=False,
                          preserve_rng_state=False)

    def own(self, i, out):
        for k, t in enumerate(out):
            ptr = t.untyped_storage().data_ptr()
            if not ptr:
                continue
            ent = self.owners.get(ptr)
            if ent is not None and ent.alive():
                ent.refs.append(weakref.ref(t))
            else:
                ent = self.owners[ptr] = _Owner(i, k, t)
                self.layouts[(i, k)] = (ent.offset, ent.nbytes)
        if i in self.feeds:
            self.kept[i] = tuple(t.detach() for t in out)
            if self.probe is not None:
                for t in out:
                    self.probe.note(t)

    def pack(self, t):
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            return t
        ent = self.owners.get(t.untyped_storage().data_ptr())
        if ent is None or ent.node not in self.recompute \
                or ent.dtype != t.dtype or not ent.alive():
            if self.probe is not None:
                self.probe.note(t)
            return t.detach()
        self.pending[ent.node] = self.pending.get(ent.node, 0) + 1
        return _Recipe(ent.node, ent.out, t)

    def unpack(self, r):
        if not isinstance(r, _Recipe):
            return r
        out = self._value(r.node)[r.out]
        self.pending[r.node] -= 1
        if self.pending[r.node] <= 0:
            self.cache.pop(r.node, None)
        return out.as_strided(r.size, r.stride, r.offset)

    def _value(self, i):
        out = self.cache.get(i)
        if out is not None:
            return out
        node = self.nodes[i]
        ins = []
        for inp, idx in node.inputs:
            j = self.node_ids[id(inp)]
            if j in self.kept:
                ins.append(self.kept[j][idx])
            else:
                ins.append(self._value(j)[idx])
        with torch.no_grad():
            out = eval_node(node, ins, self.is_train, self.seed, i,
                            batch=self.marks and self.marks[i])
        for k, t in enumerate(out):
            want = self.layouts.get((i, k))
            if want is not None and want != (t.storage_offset(),
                                             t.untyped_storage().nbytes()):
                raise MXNetError(
                    "remat: %s's recomputed output %d is laid out in memory "
                    "unlike the first run's" % (node.name, k))
        if self.pending.get(i, 0) > 0:
            self.cache[i] = out
        return out


class _ResidualProbe:
    """The storages kept for the backward while it is active, each once."""

    def __init__(self):
        self.storages = {}

    def note(self, t):
        st = t.untyped_storage()
        if st.data_ptr():
            self.storages.setdefault(st.data_ptr(), st.nbytes())

    def stats(self):
        return {"residual_bytes": int(sum(self.storages.values())),
                "n_residuals": len(self.storages)}


_PROBE = threading.local()


@contextlib.contextmanager
def residual_probe():
    """Count the storages autograd keeps for the backward of what runs
    inside: tensors packed by the saved-tensor hooks (outside a remat
    closure) and what a remat closure keeps. Yields the probe; read
    ``probe.stats()``."""
    probe = _ResidualProbe()

    def pack(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.layout == torch.strided:
            probe.note(t)
        return t.detach()   # the tensor itself could close a cycle

    prev = getattr(_PROBE, "active", None)
    _PROBE.active = probe
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield probe
    finally:
        _PROBE.active = prev


def infer_graph_shapes(symbol, kwargs, partial=False):
    """``(arg_shapes, out_shapes, aux_shapes)`` of ``symbol`` from the
    input shapes in ``kwargs``; an unresolved shape raises, or with
    ``partial`` comes back as None."""
    known = {k: tuple(v) for k, v in kwargs.items() if v is not None}
    shapes = _solve_shapes(symbol, known, partial=partial)
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


def _solve_shapes(symbol, known_shapes, type_dict=None, partial=False):
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
                    if an != pname:
                        continue
                    # the int8 serving graph routes a weight through an
                    # in-graph _quantize_rows_int8 node (shape-preserving
                    # on output 0): the hint lands on the variable behind
                    if not inode.is_variable() \
                            and inode.op.name == "_quantize_rows_int8" \
                            and inode.inputs[0][0].is_variable():
                        inode = inode.inputs[0][0]
                    if inode.is_variable() and inode.name not in shapes:
                        shapes[inode.name] = shape
                        progress = True
            structs = in_structs(node)
            if any(s is None for s in structs):
                continue
            try:
                out = eval_node(node, [_meta(s, d) for s, d in structs],
                                False, device="meta")
                node_out[i] = [(tuple(o.shape), o.dtype) for o in out]
                node_errors.pop(node.name, None)
                progress = True
            except Exception as e:  # unresolved mid-fixpoint is normal
                lines = str(e).strip().splitlines()
                node_errors[node.name] = "%s(%s): %s" % (
                    node.op.name, node.name,
                    lines[-1][:200] if lines else type(e).__name__)
                if os.environ.get("MXNET_INFER_DEBUG"):
                    print("[infer_shape] node %r (%s) failed:\n%s"
                          % (node.name, node.op.name,
                             traceback.format_exc()), file=sys.stderr)

    out_shapes, out_dtypes = [], []
    for n, idx in symbol._entries:
        if n.is_variable():
            out_shapes.append(shapes.get(n.name))
            out_dtypes.append(dtypes.get(n.name, torch.float32))
        else:
            outs = node_out.get(node_ids[id(n)])
            out_shapes.append(outs[idx][0] if outs else None)
            out_dtypes.append(outs[idx][1] if outs else None)
    if any(s is None for s in out_shapes) and not partial:
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
    layers (and the label shapes of the loss heads), as the JAX package's
    rules give them."""
    op, attrs = node.op.name, node.attrs
    data = in_shapes[0] if in_shapes else None
    if data is None:
        return {}
    hints = {}
    if op in ("Convolution", "Convolution_v1", "_ConvResidualAdd",
              "_int8_convolution"):
        # the residual and int8 rewrites keep Convolution's weight contract
        kernel = tuple(int(k) for k in attrs.get("kernel", ()))
        nf = int(attrs.get("num_filter", 1))
        ng = int(attrs.get("num_group", 1))
        hints["weight"] = (nf, data[1] // ng) + kernel
        if not attrs.get("no_bias"):
            hints["bias"] = (nf,)
        if op == "_int8_convolution":
            hints["wscale"] = (nf,)
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
    elif op in ("FullyConnected", "_int8_fully_connected"):
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
        if op == "_int8_fully_connected":
            hints["wscale"] = (nh,)
    elif op in ("BatchNorm", "BatchNorm_v1", "batch_norm"):
        c = data[int(attrs.get("axis", 1)) % len(data)]
        hints.update({"gamma": (c,), "beta": (c,), "moving_mean": (c,),
                      "moving_var": (c,)})
    elif op == "Deconvolution":
        kernel = tuple(int(k) for k in attrs.get("kernel", ()))
        nf = int(attrs.get("num_filter", 1))
        ng = int(attrs.get("num_group", 1))
        hints["weight"] = (data[1], nf // ng) + kernel
        if not attrs.get("no_bias", True):
            hints["bias"] = (nf,)
    elif op == "LayerNorm":
        c = data[int(attrs.get("axis", -1)) % len(data)]
        hints.update({"gamma": (c,), "beta": (c,)})
    elif op == "InstanceNorm":
        hints.update({"gamma": (data[1],), "beta": (data[1],)})
    elif op == "LeakyReLU" and attrs.get("act_type") == "prelu":
        hints["gamma"] = (data[1] if len(data) > 1 else 1,)
    elif op == "Embedding":
        hints["weight"] = (int(attrs.get("input_dim") or 0),
                           int(attrs.get("output_dim") or 0))
    elif op in ("SoftmaxOutput", "SVMOutput"):
        if op == "SoftmaxOutput" and attrs.get("multi_output"):
            hints["label"] = (data[0],) + tuple(data[2:])
        else:
            hints["label"] = (data[0],)
    elif op in ("LinearRegressionOutput", "MAERegressionOutput",
                "LogisticRegressionOutput"):
        hints["label"] = tuple(data)
    elif op == "RNN":
        from .ops.rnn import param_size

        h = int(attrs.get("state_size", 0))
        layers = int(attrs.get("num_layers", 1))
        d = 2 if attrs.get("bidirectional") else 1
        mode = attrs.get("mode", "lstm")
        hints["parameters"] = (param_size(mode, h, layers, d == 2,
                                          data[2]),)
        hints["state"] = (layers * d, data[1], h)
        if mode == "lstm":
            hints["state_cell"] = (layers * d, data[1], h)
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
        self._rng = has_rng(symbol)
        self._last_seed = None     # the last forward's step seed
        self._monitor_callback = None
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

    def _graph(self, is_train, mirror=False):
        """The graph's closure; ``mirror`` (``MXNET_BACKWARD_DO_MIRROR``
        on a forward kept for the backward) keeps only the variables and
        recomputes every op node in the backward."""
        fn = self._graphs.get((is_train, mirror))
        if fn is None:
            fn = self._graphs[(is_train, mirror)] = _graph_closure(
                self._symbol, is_train,
                remat_names=frozenset() if mirror else None)
        return fn

    def _load_inputs(self, kwargs):
        with torch.no_grad():
            for name, v in kwargs.items():
                if name not in self.arg_dict:
                    continue
                src = v.tensor if hasattr(v, "tensor") else \
                    torch.from_numpy(np.array(v))
                self.arg_dict[name].tensor.copy_(src)

    def _run(self, is_train, with_grad, seed=None):
        """Evaluate the graph from step seed ``seed`` (a fresh one from
        the context's chain when None and the graph draws); returns
        (leaves, outputs, aux_updates)."""
        if self._rng and seed is None:
            seed = _random.next_seed(self._ctx)
        self._last_seed = seed
        values = {n: self.arg_dict[n].tensor for n in self._arg_names}
        leaves = {}
        if with_grad:
            for n in self._grad_names:
                leaves[n] = values[n] = values[n].detach().requires_grad_()
        for n in self._aux_names:
            values[n] = self.aux_dict[n].tensor
        mirror = with_grad and config.get_strict_bool(
            "MXNET_BACKWARD_DO_MIRROR")
        with torch.set_grad_enabled(with_grad):
            outs, aux_updates = self._graph(is_train, mirror)(values, seed)
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
        with _profiler.maybe_scope(self._event_name(), "forward"):
            leaves, outs, aux_updates = self._run(bool(is_train), with_grad)
        self._aux_applied = False
        if is_train:
            self._apply_aux(aux_updates)
        if with_grad:
            self._pending = (leaves, outs)
        self._set_outputs(outs)
        self._monitor_outputs()
        return self.outputs

    def _event_name(self):
        return self._symbol.name or "executor"

    def _monitor_outputs(self):
        if self._monitor_callback is not None:
            for name, val in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, val)

    def backward(self, out_grads=None, is_train=True):
        """Gradients into ``grad_dict`` from the last training forward's
        graph, which is then freed. Without one (a second backward, or
        after an inference forward) the training forward runs again from
        the last forward's step seed (its random ops draw what that
        forward drew), and applies the aux updates if no forward since the
        last has."""
        with _profiler.maybe_scope(self._event_name(), "backward"):
            if self._pending is None:
                leaves, outs, aux_updates = self._run(True, True,
                                                      self._last_seed)
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
        name = self._event_name()
        with _profiler.maybe_scope(name, "forward_backward"):
            with _profiler.maybe_scope(name, "forward"):
                leaves, outs, aux_updates = self._run(
                    True, bool(self._grad_names))
            self._apply_aux(aux_updates)
            self._aux_applied = False
            self._set_outputs(outs)
            self._monitor_outputs()
            if self._grad_names:
                with _profiler.maybe_scope(name, "backward"):
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

    def debug_str(self):
        """The bound graph, one node a line (``Symbol.debug_str``)."""
        return self._symbol.debug_str()

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on each output after every
        forward (``monitor_all`` is accepted, as in the JAX package: the
        outputs are what a forward exposes)."""
        self._monitor_callback = callback


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
