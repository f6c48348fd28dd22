"""Rank processes for the port's sequence, expert and pipeline parallel
tests (imported by the spawned ranks, so it imports neither JAX nor
``mxnet_tpu``).

The ranks are started by ``torch_dp_workers.start_ranks`` with a function
name ``"torch_sp_workers:<name>"``; each joins a gloo group on the CPU
and returns its results, which the parent holds against the JAX package's
functions on CPU device meshes of the same shapes. Every input is made
from a numpy seed, so the parent makes the same ones.

A rank's result names its coordinates on each mesh (``coords``): the
parent assembles the output shards and sums the gradient shares of the
ranks it needs from them.
"""
import numpy as np
import torch

# tests/test_transformer.py's tiny model (max_len 16, the batch's S)
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=16,
           dtype="float32")
MOE_CFG = dict(CFG, n_experts=4)
BATCH = (4, 17)
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9)
STEPS = 3
# tests/test_attention.py's inputs: (B, H, S, D), H = 8 for Ulysses
ATTN = dict(B=2, H=4, S=64, D=16)
ULYSSES_H = 8
# tests/test_transformer.py's pipeline: a tanh MLP of width 16, 8
# microbatches of 4 rows
PIPE_D, PIPE_MICRO, PIPE_MB = 16, 8, 4

SP2 = {"sp": 2}
SP_MODES = ("ring", "ulysses", "full")
SP4 = {"sp": 4}
DP_SP = {"dp": 2, "sp": 2}
MP_SP = {"mp": 2, "sp": 2}
EP2 = {"ep": 2}
EP_MP = {"ep": 2, "mp": 2}


def tokens(seed=0, shape=BATCH):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], shape).astype(np.int32)


def qkv(seed=0, **kw):
    a = dict(ATTN, **kw)
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(a["B"], a["H"], a["S"], a["D"]).astype(np.float32)
                 for _ in range(3))


def pipe_inputs(n_stages, seed=0):
    """The JAX test's stacked params and microbatched input."""
    rng = np.random.RandomState(seed)
    d = PIPE_D
    params = {"w": (rng.randn(n_stages, d, d) * 0.3).astype(np.float32),
              "b": (rng.randn(n_stages, d) * 0.1).astype(np.float32)}
    x = rng.randn(PIPE_MICRO, PIPE_MB, d).astype(np.float32)
    return params, x


def pipe_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _tfm():
    from mxnet_tpu_torch.models import transformer as tfm

    return tfm


def _mesh(axes):
    from mxnet_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


def _coords(mesh):
    from mxnet_tpu_torch.parallel import axis_group

    return {a: axis_group(mesh, (a,))[2] for a in mesh.mesh_dim_names}


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _counts_of(fn):
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl

    tpl.reset_counts()
    out = fn()
    return out, tpl.counts()


def loss_and_grads(cfg, mesh, params, toks, moe=None):
    """The loss, this rank's gradient share unsharded, and the collective
    counts of the loss forward. ``moe`` replaces the MoE branch (a
    planted fault)."""
    tfm = _tfm()
    real = tfm._moe
    if moe is not None:
        tfm._moe = moe
    try:
        loss_fn, _specs = tfm.make_loss_fn(cfg, mesh, device="cpu")
        p = {k: v.requires_grad_() for k, v in
             tfm.shard_params(params, cfg, mesh).items()}
        loss, counts = _counts_of(lambda: loss_fn(p, toks))
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    finally:
        tfm._moe = real
    full = tfm.unshard(grads, cfg, mesh)
    return {"loss": loss.item(), "grads": _np(full), "forward": counts,
            "gate": grads["moe_gate_weight"].numpy().copy()
            if "moe_gate_weight" in grads else None}


def train_steps(cfg, mesh, params):
    """``STEPS`` train steps; the losses, params and momentum unsharded."""
    tfm = _tfm()
    step, place = tfm.make_train_step(cfg, mesh, optimizer=dict(OPT),
                                      device="cpu")
    carry = place(params)
    losses = []
    for i in range(STEPS):
        carry, loss = step(carry, tokens(10 + i))
        losses.append(float(loss))
    return {"losses": losses,
            "params": _np(tfm.unshard({k: v.detach() for k, v in
                                       carry[0].items()}, cfg, mesh)),
            "momentum": _np(tfm.unshard(carry[1], cfg, mesh))}


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------
def _attention_out(mesh, fn, seed, batch_axis=None, grad=False, **kw):
    """This rank's return of the standalone ``fn`` on the global inputs
    (the global output) and, with ``grad``, its share of the gradient of
    the output's sum in q, k, v."""
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl

    ts = [torch.from_numpy(a).requires_grad_(grad) for a in
          qkv(seed, **({"H": ULYSSES_H} if fn.__name__.startswith("ulysses")
                       else {}))]
    tpl.reset_counts()
    out = fn(*ts, mesh, batch_axis=batch_axis, **kw)
    res = {"out": out.detach().numpy().copy(), "counts": tpl.counts()}
    if grad:
        res["grads"] = [g.numpy() for g in torch.autograd.grad(out.sum(), ts)]
    return res


def _inner_shard(mesh, inner, seed, **kw):
    """This rank's output shard of ``inner`` (``*_attention_inner``) on its
    sequence chunk of the global inputs."""
    from mxnet_tpu_torch.parallel import axis_group

    axis = axis_group(mesh, ("sp",))
    _g, n, i = axis
    ts = [torch.from_numpy(a) for a in
          qkv(seed, **({"H": ULYSSES_H} if inner.__name__.startswith(
              "ulysses") else {}))]
    chunk = ts[0].shape[2] // n
    ts = [t.narrow(2, i * chunk, chunk) for t in ts]
    return {"out": inner(*ts, axis=axis, **kw).numpy().copy()}


def _wrong_k_offset():
    """A ring whose chunks are masked as if each were the rank's own (the
    k offset of the rank, not of the chunk's source): the fault the
    parity test must catch."""
    from mxnet_tpu_torch.parallel import ring

    real = ring._attend_chunk

    def attend(*a, q_offset, k_offset, **kw):
        return real(*a, q_offset=q_offset, k_offset=q_offset, **kw)

    return ring, real, attend


def sp2_worker(rank, world):
    """On ``{"sp": 2}``: the transformer's loss, gradients and counts under
    each of ring, ulysses and full, and ``attn="flash"``'s error."""
    tfm = _tfm()
    mesh = _mesh(SP2)
    out = {"coords": _coords(mesh), "modes": {}, "counts": {}}
    params = tfm.init_params(tfm.TransformerConfig(**CFG), seed=0)
    for mode in SP_MODES:
        cfg = tfm.TransformerConfig(**dict(CFG, attn=mode))
        out["modes"][mode] = loss_and_grads(cfg, mesh, params, tokens())
        out["counts"][mode] = tfm.block_collective_counts(cfg, mesh)
    cfg = tfm.TransformerConfig(**dict(CFG, attn="flash"))
    loss_fn, _ = tfm.make_loss_fn(cfg, mesh, device="cpu")
    try:
        loss_fn(tfm.shard_params(params, cfg, mesh), tokens())
        out["flash_error"] = None
    except ValueError as e:
        out["flash_error"] = str(e)
    return out


def _group_sums(mesh):
    """For each set of axes, ``axis_group``'s size and index and the sum
    of the global ranks over its group; the same through ``_subgroup``
    (the path a group over two axes, not all the mesh's, takes), which
    must agree with the mesh's own one-axis groups."""
    import torch.distributed as dist

    from mxnet_tpu_torch.parallel.mesh import _subgroup, axis_group

    def summed(group):
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t, group=group)
        return t.item()

    out = {}
    for axes in (("dp",), ("sp",), ("dp", "sp")):
        group, n, index = axis_group(mesh, axes)
        out[axes] = (n, index, summed(group))
    for axes in (("dp",), ("sp",)):
        group = _subgroup(mesh, axes)
        out["sub", axes] = (dist.get_world_size(group),
                            dist.get_rank(group), summed(group))
    return out


def sp4_worker(rank, world):
    """On 4 ranks: ring and Ulysses attention on ``{"sp": 4}`` (causal and
    not, and the ring with the planted wrong k offset), the ring on
    ``{"dp": 2, "sp": 2}`` with its gradient, the transformer's loss and
    gradients on ``{"dp": 2, "sp": 2}``, and on ``{"mp": 2, "sp": 2}`` the
    loss, gradients, counts and ``STEPS`` train steps."""
    from mxnet_tpu_torch.parallel import (ring_attention,
                                          ring_attention_inner,
                                          ulysses_attention,
                                          ulysses_attention_inner)

    tfm = _tfm()
    out = {}
    mesh = _mesh(SP4)
    out["sp4"] = {"coords": _coords(mesh)}
    for causal in (False, True):
        out["sp4"]["ring", causal] = _attention_out(
            mesh, ring_attention, 0, causal=causal)
        out["sp4"]["ulysses", causal] = _attention_out(
            mesh, ulysses_attention, 0, causal=causal)
        out["sp4"]["ring_inner", causal] = _inner_shard(
            mesh, ring_attention_inner, 0, causal=causal)
        out["sp4"]["ulysses_inner", causal] = _inner_shard(
            mesh, ulysses_attention_inner, 0, causal=causal)
    ring, real, attend = _wrong_k_offset()
    ring._attend_chunk = attend
    try:
        out["sp4"]["fault"] = _attention_out(mesh, ring_attention, 0,
                                             causal=True)
    finally:
        ring._attend_chunk = real

    mesh = _mesh(DP_SP)
    out["groups"] = _group_sums(mesh)
    out["dp_sp"] = {"coords": _coords(mesh),
                    "ring": _attention_out(mesh, ring_attention, 0,
                                           batch_axis="dp", grad=True,
                                           causal=True)}
    cfg = tfm.TransformerConfig(**CFG)
    params = tfm.init_params(cfg, seed=0)
    out["dp_sp"]["tfm"] = loss_and_grads(cfg, mesh, params, tokens())
    out["dp_sp"]["counts"] = tfm.block_collective_counts(cfg, mesh)

    mesh = _mesh(MP_SP)
    out["mp_sp"] = {"coords": _coords(mesh),
                    "tfm": loss_and_grads(cfg, mesh, params, tokens()),
                    "counts": tfm.block_collective_counts(cfg, mesh),
                    "steps": train_steps(cfg, mesh, params)}
    sharded = {k for k, spec in tfm.param_specs(cfg, mesh).items()
               if "mp" in spec}
    out["mp_sp"]["replicated"] = {
        k: v for k, v in out["mp_sp"]["steps"]["params"].items()
        if k not in sharded}
    return out


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def moe_without_ep_gate_sum(ln, h, lp, cdt, tp=None, ep=None):
    """The MoE branch with the gate's conjugate pair over the ep group
    taken out: each rank's gate cotangent stays partial (its experts'
    columns), the fault the parity test must catch."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.parallel.tensor_parallel import (copy_to_mp,
                                                          reduce_from_mp)

    gate = torch.softmax(torch.einsum("bsd,de->bse", ln.float(),
                                      lp["moe_gate_weight"].float()), dim=-1)
    e_loc = lp["ffn_up_weight"].shape[0]
    gate = gate.narrow(-1, ep[2] * e_loc, e_loc)
    gate = copy_to_mp(gate.to(cdt), tp)
    h = copy_to_mp(h, ep)
    up = F.relu(torch.einsum("bsd,edf->besf", h, lp["ffn_up_weight"].to(cdt)))
    down = torch.einsum("besf,efd->besd", up, lp["ffn_down_weight"].to(cdt))
    return reduce_from_mp(torch.einsum("besd,bse->bsd", down, gate), ep)


def _ep_run(mesh, fault=False):
    tfm = _tfm()
    cfg = tfm.TransformerConfig(**MOE_CFG)
    params = tfm.init_params(cfg, seed=0)
    shards = tfm.shard_params(params, cfg, mesh)
    out = {"coords": _coords(mesh),
           "specs": tfm.param_specs(cfg, mesh),
           "shard_shapes": {k: tuple(v.shape) for k, v in shards.items()},
           "roundtrip": all(torch.equal(tfm.unshard(shards, cfg, mesh)[k],
                                        params[k]) for k in params),
           "run": loss_and_grads(cfg, mesh, params, tokens()),
           "counts": tfm.block_collective_counts(cfg, mesh),
           "steps": train_steps(cfg, mesh, params)}
    if fault:
        out["fault"] = loss_and_grads(cfg, mesh, params, tokens(),
                                      moe=moe_without_ep_gate_sum)
    return out


def ep2_worker(rank, world):
    """On ``{"ep": 2}``: the MoE's specs, shards, loss, gradients, counts
    and train steps, and the planted gate fault; the dense model's counts
    on the same mesh (ep leaves it replicated)."""
    mesh = _mesh(EP2)
    out = _ep_run(mesh, fault=True)
    tfm = _tfm()
    out["dense_counts"] = tfm.block_collective_counts(
        tfm.TransformerConfig(**CFG), mesh)
    return out


def ep_mp_worker(rank, world):
    """On ``{"ep": 2, "mp": 2}``: as :func:`ep2_worker` without the
    fault."""
    return _ep_run(_mesh(EP_MP))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
def _pipe_run(mesh, world):
    from mxnet_tpu_torch.parallel import pipeline

    params, x = pipe_inputs(world)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, counts = _counts_of(lambda: pipeline(pipe_stage, p, xt, mesh))
    grads = torch.autograd.grad((out ** 2).sum(), [*p.values(), xt])
    return {"coords": _coords(mesh), "out": out.detach().numpy().copy(),
            "counts": counts,
            "grads": {k: g.numpy() for k, g in zip([*p, "x"], grads)}}


def pipe_worker(rank, world):
    """The tanh MLP of ``world`` stages over ``{"pp": world}``: the
    outputs, this rank's gradient share of ``(out ** 2).sum()`` in the
    stacked params and x, and the collective counts of the forward; on 2
    ranks also the planted fault, the outputs' sum over the stages with a
    backward that sums too (``all_reduce_autograd``), which gives each
    share ``n_stages`` times over."""
    import importlib

    from mxnet_tpu_torch.parallel.mesh import all_reduce_autograd

    # the package binds ``pipeline`` to the function, not the module
    pipe_mod = importlib.import_module("mxnet_tpu_torch.parallel.pipeline")

    mesh = _mesh({"pp": world})
    out = _pipe_run(mesh, world)
    if world == 2:
        real = pipe_mod.reduce_from_mp
        pipe_mod.reduce_from_mp = lambda t, axis: all_reduce_autograd(
            t, axis[0])
        try:
            out["fault"] = _pipe_run(mesh, world)
        finally:
            pipe_mod.reduce_from_mp = real
    return out
