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
- :func:`gather_from_mp`: the shards of the last dim concatenated in rank
  order forward; backward, the rank's own slice of the cotangent.

:func:`reduce_from_data` is the sum of the loss's partial sum and count
over the data axes, with the identity backward: each data rank's gradient
is then its share, and the train step sums the shares over the data
group.

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
nothing is sent: the result has the shape alone.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import all_reduce_

__all__ = ["copy_to_mp", "reduce_from_mp", "gather_from_mp",
           "reduce_from_data"]


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
        return all_reduce_(_dense(g), ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(_dense(t), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, n, index):
        ctx.index, ctx.width = index, t.shape[-1]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width, ctx.width), None, None, \
            None


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
    return _Sum.apply(t, tp[0]) if _live(t, tp[0]) else t


def gather_from_mp(t, tp):
    """The mp group's shards of the last dim, concatenated in rank order;
    backward keeps this rank's slice of the cotangent."""
    if tp is None:
        return t
    gather_from_mp.calls += 1
    group, n, index = tp
    if not _live(t, group):
        return t if n == 1 else t.new_empty(*t.shape[:-1], t.shape[-1] * n)
    return _Gather.apply(t, group, n, index)


def reduce_from_data(t, group):
    """The sum over the data group (``None``: one rank); the identity
    backward."""
    reduce_from_data.calls += 1
    return _Sum.apply(t, group) if _live(t, group) else t


def counts():
    """``{name: calls}`` of the four functions."""
    return {f.__name__: f.calls for f in (copy_to_mp, reduce_from_mp,
                                          gather_from_mp, reduce_from_data)}


def reset_counts():
    for f in (copy_to_mp, reduce_from_mp, gather_from_mp, reduce_from_data):
        f.calls = 0


reset_counts()
