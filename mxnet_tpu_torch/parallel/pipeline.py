"""Pipeline parallelism (the GPipe schedule) over a ``pp`` axis of ranks
(counterpart of ``mxnet_tpu/parallel/pipeline.py``).

Each rank of the ``pp`` axis holds one stage; activations go to the next
stage by :func:`~.tensor_parallel.ppermute`; microbatches fill the pipe
GPipe-style. The backward is autograd through the schedule: a ppermute's
backward is the reverse permute, which gives the reverse pipe.

Schedule: ``n_micro + n_stages - 1`` ticks; at tick t stage 0 takes
microbatch t (clamped: the ticks past the last microbatch push it again
through the drain), stage s computes microbatch ``t - s``, and the last
stage retires microbatch ``t - (n_stages - 1)``. Every stage computes at
every tick, and after each tick one ppermute passes every stage's output
on. Bubble fraction ``(n_stages - 1) / (n_micro + n_stages - 1)``: pick
``n_micro >= 4 * n_stages``.

Every rank builds the same graph: which input a stage takes and which
outputs it retires are masks by stage (``torch.where``), not branches that
differ by rank, so the backward's collectives run in the same order on
every rank. The retired outputs are summed over the axis by
:func:`~.tensor_parallel.reduce_from_mp`, whose backward is the identity:
every rank returns the same outputs, computes the same loss from them,
and its gradient is its share (its stage's parameters; the input's on
stage 0), not ``n_stages`` times it.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .tensor_parallel import ppermute, reduce_from_mp

__all__ = ["pipeline_apply", "pipeline"]


def pipeline_apply(stage_fn, stage_params, x, *, axis=None,
                   n_microbatches=None):
    """Run ``stage_fn(stage_params, act) -> act`` as a GPipe pipeline.

    ``stage_params``: this rank's stage. ``x``: the (n_micro, mb, ...)
    microbatched input, the same on every rank of the axis. ``axis``: the
    ``(group, n, index)`` of the ``pp`` axis (:func:`.mesh.axis_group`;
    None runs the microbatches through one stage). Returns the (n_micro,
    mb, ...) outputs in x's dtype, the same on every rank (the last
    stage's, summed over the axis with the others' zeros).
    """
    _group, n_stages, stage = axis if axis is not None else (None, 1, 0)
    n_micro = x.shape[0] if n_microbatches is None else int(n_microbatches)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    zero = torch.zeros_like(x[0])
    state = zero
    ys = [zero] * x.shape[0]
    for t in range(n_micro + n_stages - 1):
        x_t = x[min(t, n_micro - 1)]
        out = stage_fn(stage_params, torch.where(first, x_t, state))
        mi = t - (n_stages - 1)
        if mi >= 0:
            ys[mi] = torch.where(last, out.to(x.dtype), zero)
        state = ppermute(out, axis)
    return reduce_from_mp(torch.stack(ys), axis)


def pipeline(stage_fn, stacked_params, x, mesh, *, axis_name="pp",
             n_microbatches=None):
    """Standalone GPipe over ``axis_name`` of ``mesh``: ``stacked_params``
    is a tensor or a dict, list or tuple of them, each with a leading
    ``n_stages`` dim, and ``x`` the global (n_micro, mb, ...) input, both
    the same on every rank; the rank at index ``s`` of the axis runs stage
    ``s`` (``stacked[s]``). Returns the outputs, the same on every rank.
    A rank's gradient in ``stacked_params`` lies in its stage's row (and
    in ``x`` on stage 0): the rows summed over the ranks are the gradient
    of the one loss every rank computes."""
    from .mesh import axis_group

    axis = axis_group(mesh, (axis_name,))
    local = tree_map(lambda a: a[axis[2]], stacked_params)
    return pipeline_apply(stage_fn, local, x, axis=axis,
                          n_microbatches=n_microbatches)
