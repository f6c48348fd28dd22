"""Megatron's conjugate collectives over a tensor-parallel (``mp``) group,
as ``torch.autograd.Function``s.

Every rank of an mp group holds a shard of the transformer's weights and
computes the same replicated loss from the same activations. Three
functions keep the gradients right under that convention:

- :func:`copy_to_mp` at the input of a column-parallel product (the qkv
  input, the ffn-up input, the tied logits head's input): the identity
  forward; backward, the sum over the group of each rank's partial
  cotangent, since each rank's shard of the product saw the input.
- :func:`reduce_from_mp` after a row-parallel product (the attention
  out-projection, ffn-down) and the vocab-sharded embedding: the sum over
  the group forward; the identity backward, since the sum's cotangent is
  every term's.
- :func:`gather_from_mp`: the shards of one dim (the last by default)
  concatenated in rank order forward; backward, the rank's own slice of
  the cotangent. A symbol's sharded parameter is gathered so at each use
  that is not half of a Megatron pair (``parallel/symbol_mp.py``): every
  rank computes the same replicated value from the whole tensor, so the
  slice of its cotangent is the shard's gradient.
- :func:`scatter_to_mp`: the conjugate of the gather, the rank's slice of
  a replicated tensor forward; backward, the slices' cotangents gathered,
  so a replicated parameter read by a column-parallel product (a bias
  that no rule shards) gets its whole gradient on every rank.

:func:`reduce_from_data` is the sum of the loss's partial sum and count
over the data axes, with the identity backward: each data rank's gradient
is then its share, and the train step sums the shares over the data
group.

The conjugate pair is not tied to ``mp``: it serves every axis whose ranks
compute one replicated value from their shards. The MoE's experts sharded
over ``ep`` take it around the gated sum and its gate
(``models/transformer.py``), and the pipeline's outputs are summed over
``pp`` by :func:`reduce_from_mp` (:mod:`.pipeline`).

Three more collectives move shards whose ranks compute different values
(the sequence chunks of an ``sp`` axis, the stages of a ``pp`` axis):

- :func:`ppermute`: each rank's tensor to the rank ``shift`` after it in
  the group (``lax.ppermute`` over a ring); backward, the cotangent the
  reverse way.
- :func:`all_to_all`: the tiled ``lax.all_to_all``: block ``j`` of
  ``split_dim`` to rank ``j``, the blocks received concatenated along
  ``concat_dim`` in rank order; backward, the inverse all-to-all.
- :func:`all_gather`: the group's tensors concatenated along ``dim``;
  backward, the reduce-scatter (each rank's cotangent differs, so its
  slice is summed over the group).

All three run as one collective a call on every backend: ``ppermute`` is
an ``all_to_all_single`` whose splits send the whole tensor to one rank
and nothing to the others, as gloo refuses ``send``/``recv`` of a CUDA
tensor (it reads the device pointer on the host) but takes
``all_to_all_single``; a collective also cannot deadlock a ring, as a
blocking send that waits for its receive can.

The JAX package reaches the same numbers by another convention (its
``shard_map`` transpose divides the cotangent of an unmapped output and
transposes ``psum`` to ``psum``). ``all_reduce_autograd`` (sums both ways)
is right for a batch statistic, where each rank's loss differs, and wrong
here: the column-parallel gradients would come out ``mp`` times too large.

``tp`` is ``None`` (no mp axis: each function is the identity and counts
nothing) or the ``(group, n, index)`` of :func:`.mesh.model_group`. Each
function adds one to its ``calls`` whenever ``tp`` is given, also for a
group of one rank, as a JAX psum over a size-1 axis is still a psum in the
jaxpr (``block_collective_counts`` reads the counts). On a ``meta`` tensor
nothing is sent: the result has the shape alone. :func:`wire_bytes` counts
the bytes each function's collectives send from this rank, forward and
backward (the buffer's bytes a call).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import all_reduce_

__all__ = ["copy_to_mp", "reduce_from_mp", "gather_from_mp",
           "scatter_to_mp", "reduce_from_data", "ppermute", "all_to_all",
           "all_gather"]

_BYTES = {}


def _sent(name, t):
    _BYTES[name] = _BYTES.get(name, 0) + t.numel() * t.element_size()


def _dense(t):
    """A contiguous copy of ``t`` (a collective's buffer)."""
    return t.clone(memory_format=torch.contiguous_format)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        _sent("copy_to_mp", g)
        return all_reduce_(_dense(g), ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, name):
        _sent(name, t)
        return all_reduce_(_dense(t), group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_gather(t, group, n, dim):
    """The group's tensors concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, index, dim):
        ctx.index, ctx.width, ctx.dim = index, t.shape[dim], dim
        _sent("gather_from_mp", t)
        return _all_gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, \
            None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, index, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        width = t.shape[dim] // n
        return t.narrow(dim, index * width, width).contiguous()

    @staticmethod
    def backward(ctx, g):
        _sent("scatter_to_mp", g)
        return _all_gather(g, ctx.group, ctx.n, ctx.dim), None, None, None, \
            None


def _permute(t, group, n, index, shift):
    """``t`` sent to group rank ``index + shift``, the tensor of rank
    ``index - shift`` received (mod ``n``): one ``all_to_all_single`` whose
    splits are the whole tensor for that pair and empty for the rest."""
    flat = _dense(t).reshape(-1)
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(index + shift) % n] = recv[(index - shift) % n] = flat.numel()
    dist.all_to_all_single(out, flat, recv, send, group=group)
    return out.view(t.shape)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, index, shift):
        ctx.args = (group, n, index, -shift)
        _sent("ppermute", t)
        return _permute(t, group, n, index, shift)

    @staticmethod
    def backward(ctx, g):
        _sent("ppermute", g)
        return _permute(g, *ctx.args), None, None, None, None


def _a2a(t, group, n, split_dim, concat_dim):
    """Block ``j`` of ``split_dim`` to group rank ``j``; the blocks
    received, concatenated along ``concat_dim`` in rank order."""
    inp = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        _sent("all_to_all", t)
        return _a2a(t, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        _sent("all_to_all", g)
        return _a2a(g, *ctx.args), None, None, None, None


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        _sent("all_gather", t)
        return _all_gather(t, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        parts = [c.contiguous() for c in g.chunk(ctx.n, dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        _sent("all_gather", g)
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None, None


def _live(t, group):
    """True when a collective must run: a group of more than one rank and
    a tensor that holds data."""
    return group is not None and t.device.type != "meta"


def copy_to_mp(t, tp):
    """The identity; its backward sums the cotangent over the mp group."""
    if tp is None:
        return t
    copy_to_mp.calls += 1
    return _Copy.apply(t, tp[0]) if _live(t, tp[0]) else t


def reduce_from_mp(t, tp):
    """The sum over the mp group; the identity backward."""
    if tp is None:
        return t
    reduce_from_mp.calls += 1
    return _Sum.apply(t, tp[0], "reduce_from_mp") if _live(t, tp[0]) else t


def gather_from_mp(t, tp, dim=-1):
    """The mp group's shards of ``dim`` (the last by default), concatenated
    in rank order; backward keeps this rank's slice of the cotangent."""
    if tp is None:
        return t
    gather_from_mp.calls += 1
    group, n, index = tp
    dim = dim % t.dim()
    if not _live(t, group):
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)
    return _Gather.apply(t, group, n, index, dim)


def scatter_to_mp(t, tp, dim=-1):
    """This rank's slice of ``dim`` of a replicated tensor; backward
    gathers the slices' cotangents over the mp group."""
    if tp is None:
        return t
    scatter_to_mp.calls += 1
    group, n, index = tp
    dim = dim % t.dim()
    if n == 1:
        return t
    if not _live(t, group):
        width = t.shape[dim] // n
        return t.narrow(dim, index * width, width)
    return _Scatter.apply(t, group, n, index, dim)


def reduce_from_data(t, group):
    """The sum over the data group (``None``: one rank); the identity
    backward."""
    reduce_from_data.calls += 1
    return _Sum.apply(t, group, "reduce_from_data") if _live(t, group) \
        else t


def ppermute(t, axis, shift=1):
    """This rank's ``t`` sent to the rank ``shift`` after it in the axis's
    group, and the tensor of the rank ``shift`` before it returned (a
    ring: ``lax.ppermute`` with the permutation ``i -> i + shift``);
    backward, the cotangent sent the reverse way. ``axis`` is ``None`` (the
    identity, counting nothing) or the ``(group, n, index)`` of
    :func:`.mesh.axis_group`."""
    if axis is None:
        return t
    ppermute.calls += 1
    group, n, index = axis
    if not _live(t, group) or shift % n == 0:
        return t
    return _Permute.apply(t, group, n, index, shift)


def all_to_all(t, axis, split_dim, concat_dim):
    """The tiled all-to-all over the axis's group: ``t`` cut into ``n``
    blocks along ``split_dim``, block ``j`` sent to rank ``j``, the blocks
    received concatenated along ``concat_dim`` in rank order; backward,
    the inverse all-to-all. ``axis`` as in :func:`ppermute`."""
    if axis is None:
        return t
    all_to_all.calls += 1
    group, n, _index = axis
    split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
    if t.shape[split_dim] % n:
        raise ValueError("all_to_all: dim %d of size %d does not divide "
                         "over %d ranks" % (split_dim, t.shape[split_dim], n))
    if n == 1:
        return t
    if not _live(t, group):
        shape = list(t.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return t.new_empty(shape)
    return _AllToAll.apply(t, group, n, split_dim, concat_dim)


def all_gather(t, axis, dim=-1):
    """The axis's group's tensors concatenated along ``dim`` in rank order;
    backward, this rank's slice of the cotangent summed over the group (a
    reduce-scatter: each rank's cotangent differs). ``axis`` as in
    :func:`ppermute`."""
    if axis is None:
        return t
    all_gather.calls += 1
    group, n, _index = axis
    dim = dim % t.dim()
    if n == 1:
        return t
    if not _live(t, group):
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)
    return _GatherScatter.apply(t, group, n, dim)


_FUNCTIONS = (copy_to_mp, reduce_from_mp, gather_from_mp, scatter_to_mp,
              reduce_from_data, ppermute, all_to_all, all_gather)


def counts():
    """``{name: calls}`` of the eight functions."""
    return {f.__name__: f.calls for f in _FUNCTIONS}


def wire_bytes():
    """``{name: bytes}`` this rank's collectives sent, by function, since
    :func:`reset_counts`: the forward's buffer for ``reduce_from_mp``,
    ``reduce_from_data`` and ``gather_from_mp``, the backward's for
    ``copy_to_mp`` and ``scatter_to_mp``, both for ``ppermute``,
    ``all_to_all`` and ``all_gather``."""
    return {f.__name__: _BYTES.get(f.__name__, 0) for f in _FUNCTIONS}


def reset_counts():
    for f in _FUNCTIONS:
        f.calls = 0
    _BYTES.clear()


reset_counts()
