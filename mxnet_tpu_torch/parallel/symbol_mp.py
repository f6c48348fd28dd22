"""Tensor parallelism of a symbol's graph: the port's counterpart of the
partitioning XLA does for the JAX package once ``param_rules`` shard a
symbol's parameters over the ``mp`` (or ``tp``) mesh axis.

The port has no partitioner. A :class:`ShardPlan` says which dim of each
parameter the rules shard over the rank's mp group; every rank of the group
holds its block of that dim (block ``i`` of ``n`` on the group's rank
``i``) and computes the same replicated loss from the same activations,
Megatron's convention (:mod:`.tensor_parallel`). The graph runs node by
node (``executor._graph_closure``, ``serving.predictor.AOTPredictor``) and
:meth:`ShardPlan.run_node` keeps a layout for every output: whole, or
sharded on its last dim over the group (a column-parallel product's).

- **The Megatron pair.** A ``FullyConnected`` whose weight ``(out, in)``
  is sharded on ``out`` computes its own output columns from its input
  taken through ``copy_to_mp``; its bias is its block when a rule shards
  it the same way, else the rank's slice of the whole bias
  (``scatter_to_mp``). ``Activation`` and the elementwise unary ops keep
  that layout. A ``FullyConnected`` whose weight is sharded on ``in`` and
  whose input carries that layout computes a partial product, sums it
  over the group (``reduce_from_mp``) and adds its bias once, after the
  sum.
- **Every other use of a sharded parameter is gathered at use**
  (``gather_from_mp`` along the rule's dim: the backward keeps the rank's
  slice), and every other reader of a sharded activation gathers it: a
  ``Convolution``'s weight, a ``FusedBottleneckUnit``'s (whose Hopper
  kernels then see whole weights, as GSPMD gives a Pallas call), a lone
  sharded FC, the graph's outputs.

Every collective goes through :mod:`.tensor_parallel`, so ``counts()`` and
``wire_bytes()`` count them.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import tensor_parallel as tpl

__all__ = ["ShardPlan", "COLS"]

# an activation sharded on its last dim over the mp group
COLS = "cols"

# ops that map each element of their one input to one of their output:
# they keep a column-sharded layout
_ELEMENTWISE = frozenset((
    "Activation", "relu", "sigmoid", "tanh", "softsign", "negative", "abs",
    "square", "sqrt", "exp", "log", "_copy", "identity", "erf"))
_LEAKY_ELEMENTWISE = frozenset(("leaky", "elu", "selu", "gelu"))


class ShardPlan:
    """Which dim of each parameter is sharded over this rank's mp group,
    and how the graph runs under it.

    ``dims`` is ``{name: dim}``; ``tp`` the ``(group, n, index)`` of
    ``mesh.model_group``. Build one with :meth:`from_shardings`, which
    gives None when nothing is sharded (no mp axis, one rank on it, or no
    rule that shards), so such a mesh runs the plain graph."""

    def __init__(self, mesh, dims, tp):
        self.mesh = mesh
        self.dims = dict(dims)
        self.tp = tp

    @classmethod
    def from_shardings(cls, mesh, shardings):
        """The plan of ``shardings`` (``{name: Sharding}``, as
        ``spmd.param_shardings`` gives them) on ``mesh``. A spec that shards
        more than one dim, or over another axis than the mesh's mp (or tp)
        axis, raises by name; one over an axis the mesh lacks is left to
        ``param_shardings``' check of the shapes."""
        from .mesh import _mp_axis, mesh_shape, model_group

        sizes = mesh_shape(mesh)
        axis = _mp_axis(sizes)
        dims = {}
        for name, sh in shardings.items():
            sharded = [(d, ax) for d, ax in enumerate(sh.spec)
                       if ax is not None]
            if len(sharded) > 1:
                raise MXNetError(
                    "param_rules: spec %s shards %d dims of %r; sharding "
                    "more than one dim of a parameter is not ported"
                    % (tuple(sh.spec), len(sharded), name))
            if not sharded:
                continue
            dim, ax = sharded[0]
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            if any(a not in sizes for a in axes):
                continue
            if axes != (axis,):
                raise MXNetError(
                    "param_rules: %r sharded over %s: sharding a parameter "
                    "over a data axis is not ported (only the mp axis)"
                    % (name, axes))
            dims[name] = dim
        tp = model_group(mesh)
        if not dims or tp[1] == 1:
            return None
        return cls(mesh, dims, tp)

    @property
    def n(self):
        return self.tp[1]

    @property
    def index(self):
        return self.tp[2]

    # -- whole tensors and shards ---------------------------------------------
    def shard_shape(self, name, shape):
        shape = list(shape)
        dim = self.dims.get(name)
        if dim is not None:
            shape[dim] //= self.n
        return tuple(shape)

    def shard(self, name, t):
        """This rank's block of a whole tensor of parameter ``name`` (a
        copy), or ``t`` itself when the rules do not shard it."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        width = t.shape[dim] // self.n
        return t.narrow(dim, self.index * width, width).contiguous()

    def unshard(self, name, t):
        """The whole tensor of parameter ``name`` from this rank's block: a
        collective over the mp group (every rank calls it), no autograd."""
        dim = self.dims.get(name)
        if dim is None:
            return t
        with torch.no_grad():
            return tpl._all_gather(t.detach(), self.tp[0], self.n, dim)

    def var_layout(self, name):
        """The layout of a graph variable: ``("param", dim)`` for a sharded
        parameter, else None (whole)."""
        dim = self.dims.get(name)
        return None if dim is None else ("param", dim)

    def whole(self, t, layout):
        """``t`` made whole from its layout (a gather, or ``t``)."""
        if layout is None:
            return t
        if layout == COLS:
            return tpl.gather_from_mp(t, self.tp, dim=-1)
        return tpl.gather_from_mp(t, self.tp, dim=layout[1])

    # -- one node ------------------------------------------------------------
    def run_node(self, node, ins, layouts, call):
        """``(outputs, layouts)`` of one op node, given its inputs and
        their layouts; ``call(ins)`` runs the op itself (its tuple of
        outputs)."""
        op = node.op.name
        if op == "FullyConnected":
            got = self._fully_connected(node, ins, layouts, call)
            if got is not None:
                return got
        if len(ins) == 1 and layouts[0] == COLS and self._elementwise(node):
            out = call(ins)
            return out, (COLS,) * len(out)
        out = call([self.whole(x, lay) for x, lay in zip(ins, layouts)])
        return out, (None,) * len(out)

    @staticmethod
    def _elementwise(node):
        op = node.op.name
        if op == "LeakyReLU":
            return node.attrs.get("act_type", "leaky") in _LEAKY_ELEMENTWISE
        return op in _ELEMENTWISE

    def _fully_connected(self, node, ins, layouts, call):
        """The Megatron pair, or None for the gathered route."""
        attrs = node.attrs
        if len(ins) < 2:
            return None
        has_bias = len(ins) > 2 and not _truthy(attrs.get("no_bias", False))
        wlay = layouts[1]
        if wlay == ("param", 0):
            # column parallel: this rank's output columns
            x = tpl.copy_to_mp(self.whole(ins[0], layouts[0]), self.tp)
            args = [x, ins[1]]
            if has_bias:
                blay = layouts[2]
                b = ins[2] if blay == ("param", 0) else \
                    tpl.scatter_to_mp(self.whole(ins[2], blay), self.tp,
                                      dim=0)
                args.append(b)
            out = call(args)
            return out, (COLS,) * len(out)
        flat = _truthy(attrs.get("flatten", True))
        x = ins[0]
        if wlay == ("param", 1) and layouts[0] == COLS \
                and (x.dim() == 2 or not flat) \
                and x.shape[-1] == ins[1].shape[1]:
            # row parallel: the partial product summed, the bias after
            part = call([x, ins[1]])[0]
            out = tpl.reduce_from_mp(part, self.tp)
            if has_bias:
                out = out + self.whole(ins[2], layouts[2])
            return (out,), (None,)
        return None


def _truthy(v):
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true")
    return bool(v)
