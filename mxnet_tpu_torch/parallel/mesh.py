"""Device meshes over ``torch.distributed`` (counterpart of
``mxnet_tpu/parallel/mesh.py``) and the collectives the data-parallel path
runs on them.

The JAX mesh is a set of devices in one process. The port follows
PyTorch's idiom instead: one process a device, joined by a default process
group. A port mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, built over that group; rank ``r`` holds one device,
``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to the rank),
or the CPU when the caller asks for it. Axis names keep the JAX package's
convention: ``dp`` (and ``dcn``, the multi-host data axis) shard the batch;
``mp`` (``tp`` is its legacy alias) shards the transformer's weights,
Megatron's way (:mod:`.tensor_parallel`). :func:`train_mesh` puts ``mp``
innermost, so the ranks of one mp group are adjacent.

A data-parallel step keeps rows ``[i * B / N, (i + 1) * B / N)`` of a
global batch of ``B`` rows on the rank whose index along the data axes is
``i`` (``data_sharding``'s layout in the JAX package): :func:`data_group`
gives the group, ``N`` and ``i``. Data axes of one rank in all give no
group: every collective is then the identity, as a JAX psum over a size-1
axis is, so a one-rank mesh computes what ``mesh=None`` does.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..base import MXNetError

def _mp_axis(axes):
    """The tensor-parallel axis among ``axes``: ``mp``, else the legacy
    ``tp``; None when there is neither."""
    if "mp" in axes:
        return "mp"
    if "tp" in axes:
        return "tp"
    return None


def _device_type(device):
    """``cuda`` or ``cpu`` for a device spec (None is the card)."""
    from ..context import resolve_device

    return resolve_device(device).type


def _init_default_group(backend, device_type):
    """Join the launcher's process group (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment), or make a group of
    this process alone when there is no launcher."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                              "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def rank_device(device_type):
    """This rank's device: the CPU, or ``cuda:(LOCAL_RANK %
    device_count)``."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_device(mesh):
    """The device this rank holds on ``mesh``."""
    return rank_device(mesh.device_type)


def _join_group(devices, device, backend, what):
    """Join (or make) the default process group; returns the device type
    ``device`` names. ``devices`` (a device list) must be None."""
    if devices is not None:
        raise MXNetError("%s: a device list in one process is not ported "
                         "(one process a device: start one rank a device)"
                         % what)
    device_type = _device_type(device)
    if not dist.is_initialized():
        _init_default_group(backend, device_type)
    elif backend is not None and dist.get_backend() != backend:
        raise MXNetError("%s: backend=%r but the process group runs %r"
                         % (what, backend, dist.get_backend()))
    return device_type


def make_mesh(axes=None, devices=None, *, device=None, backend=None):
    """A ``DeviceMesh`` from an axis spec ``{name: size}`` (-1 means the
    rest) over the default process group, which is initialised from the
    launcher's environment when none exists (``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU; ``backend="gloo"`` lets
    several ranks share one card). The sizes must multiply to the world
    size. ``device`` is ``None`` (the card) or ``"cpu"``. ``devices`` (the
    JAX package's device list) must be None: a process holds one device."""
    device_type = _join_group(devices, device, backend, "make_mesh")
    world = dist.get_world_size()
    axes = dict(axes or {"dp": world})
    sizes = list(axes.values())
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise MXNetError("make_mesh: axes %r need %d ranks, the process "
                         "group has %d" % (axes, int(np.prod(sizes)), world))
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(axes))


def mesh_shape(mesh):
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_group(mesh, axes=("dp",)):
    """``(group, n, index)``: the process group over the mesh's data axes
    among ``axes``, its size and this rank's index in it (the rank's shard
    of the batch); ``(None, 1, 0)`` when the mesh's data axes among
    ``axes`` hold one rank in all (none of them is one rank too). All the
    mesh's axes of size > 1, or one axis, are supported."""
    sizes = mesh_shape(mesh)
    names = [a for a in axes if a in sizes]
    n = int(np.prod([sizes[a] for a in names]))
    if n == 1:
        return None, 1, 0
    if all(a in names for a, s in sizes.items() if s > 1):
        group = dist.group.WORLD
    elif len(names) == 1:
        group = mesh.get_group(names[0])
    else:
        raise MXNetError("data axes %r: a subset of more than one mesh axis "
                         "is not ported" % (tuple(names),))
    return group, n, dist.get_rank(group)


def model_group(mesh):
    """``(group, n, index)``: the process group of this rank's
    tensor-parallel group (the ranks that differ only in their ``mp``, or
    ``tp``, coordinate), its size and this rank's index in it, which is
    the rank's shard of the weights; ``(None, 1, 0)`` when the mesh has no
    such axis or it holds one rank."""
    axis = _mp_axis(mesh.mesh_dim_names)
    n = mesh_shape(mesh)[axis] if axis else 1
    if n == 1:
        return None, 1, 0
    group = mesh.get_group(axis)
    return group, n, dist.get_rank(group)


def mp_size():
    """The strictly validated ``MXNET_MP_SIZE`` knob (an integer >= 1)."""
    from .. import config

    return config.get_positive_int("MXNET_MP_SIZE")


def train_mesh(devices=None, mp=None, *, device=None, backend=None):
    """The 2-D training and serving mesh ``{"dp": world // mp, "mp": mp}``,
    ``mp`` innermost so an mp group is adjacent ranks; ``{"dp": world}``
    for ``mp=1`` (``None`` reads ``MXNET_MP_SIZE``). ``mp`` must divide
    the world size."""
    mp = mp_size() if mp is None else int(mp)
    if mp < 1:
        raise MXNetError("train_mesh: mp=%r must be >= 1" % (mp,))
    _join_group(devices, device, backend, "train_mesh")
    world = dist.get_world_size()
    if world % mp:
        raise MXNetError("train_mesh: MXNET_MP_SIZE=%d must divide the world "
                         "size %d" % (mp, world))
    axes = None if mp == 1 else {"dp": world // mp, "mp": mp}
    return make_mesh(axes, devices, device=device, backend=backend)


_DEFAULT_MESH = None


def default_mesh():
    """The process's default mesh, ``make_mesh()`` at first use."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = make_mesh()
    return _DEFAULT_MESH


def set_default_mesh(mesh):
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


# ---------------------------------------------------------------------------
# collectives on a data group (None: no mesh, every one an identity)
# ---------------------------------------------------------------------------
def all_reduce_(t, group):
    """Sum ``t`` over the group, in place, in its own dtype."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _flat_(op, tensors, group):
    """``op(buffer, group)`` on each dtype's tensors flattened into one
    buffer, copied back into them in place: one collective a dtype."""
    if group is None or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = op(torch.cat([t.reshape(-1) for t in ts]), group)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
    return tensors


def all_reduce_flat_(tensors, group):
    """Sum each tensor over the group in place, one collective a dtype (the
    sums are elementwise, so the values are those of one collective a
    tensor)."""
    return _flat_(all_reduce_, tensors, group)


def broadcast_(t, group, src=0):
    """Overwrite ``t`` with group rank ``src``'s, in place (bit for bit: a
    broadcast copies)."""
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def broadcast_flat_(tensors, group, src=0):
    """:func:`broadcast_` of each tensor, one collective a dtype."""
    return _flat_(lambda t, g: broadcast_(t, g, src), tensors, group)


def all_gather_rows(t, group):
    """The group's tensors concatenated along dim 0, in group-rank order."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter_rows(t, group):
    """Row ``i`` of the group's summed ``(N, chunk)`` tensors on group rank
    ``i``, as ``(1, chunk)``."""
    if group is None:
        return t
    out = torch.empty_like(t[:1])
    dist.reduce_scatter(out, list(t.contiguous().split(1)), group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the cotangent over the
    group: the local sums of a batch statistic feed every rank's global
    statistic, so each rank's cotangent reaches every rank's sums."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_autograd(t, group):
    """:class:`_AllReduceSum` (the identity without a group)."""
    return t if group is None else _AllReduceSum.apply(t, group)
