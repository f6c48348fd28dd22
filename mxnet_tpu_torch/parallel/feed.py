"""Placing a batch on a data-parallel mesh (counterpart of the parts of
``mxnet_tpu/parallel/feed.py`` that ``FusedSPMDGroup`` calls:
``is_preplaced`` and ``place_batch_array``).

A placed array is this rank's rows of the global batch, on the rank's
device, tagged with the :class:`~.spmd.Sharding` it was placed for, as a
JAX array carries its sharding; ``TrainStep`` takes such an array as it is.
``DeviceQueueIter`` (the background feed) is not ported.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import profiler
from ..base import MXNetError


def expected_sharding(mesh, data_axes):
    """The sharding of a batch array on this mesh's data axes: the step's
    own (``spmd.data_sharding``)."""
    from .spmd import data_sharding

    return data_sharding(mesh, data_axes)


def is_preplaced(value, sharding):
    """True when ``value`` was placed for ``sharding`` already."""
    return getattr(value, "_mx_sharding", None) == sharding


def rank_rows(value, n, index, name, what):
    """Rows ``[index * B / n, (index + 1) * B / n)`` of a global batch
    array of ``B`` rows (a view); ``what`` names the caller in the error
    when ``n`` does not divide ``B``."""
    rows = int(value.shape[0])
    if rows % n:
        raise MXNetError("%s: batch dim %d of %r not divisible by %d "
                         "data-parallel ranks" % (what, rows, name, n))
    b = rows // n
    return value[index * b:(index + 1) * b]


def place_batch_array(mesh, data_axes, distributed, name, value,
                      sharding=None):
    """A host batch array (numpy or a tensor) of the global batch -> this
    rank's rows on its device, tagged with ``sharding``. Arrays placed
    already pass through. Records bytes and time in the profiler's
    pipeline counters. ``distributed`` (the multi-host tier) must be
    False."""
    from .mesh import data_group, mesh_device

    if distributed:
        raise MXNetError("place_batch_array: distributed=True (the "
                         "multi-host tier) is not ported")
    sharding = sharding or expected_sharding(mesh, data_axes)
    if is_preplaced(value, sharding):
        profiler.h2d_record(preplaced=1)
        return value
    t0 = time.perf_counter()
    _group, n, index = data_group(mesh, data_axes)
    rows = rank_rows(value, n, index, name, "async feed")
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    out = rows.to(mesh_device(mesh))   # a new tensor object (a slice)
    out._mx_sharding = sharding
    profiler.h2d_record(nbytes=out.numel() * out.element_size(), puts=1,
                        seconds=time.perf_counter() - t0)
    return out
