"""Decoder-only transformer LM for training and generative serving, in
PyTorch (counterpart of ``mxnet_tpu/models/transformer.py``), on one
device or sharded Megatron's way over a mesh's ``mp`` axis.

The functions keep the JAX package's parameter names, shapes and layouts
(the stacked ``(L, d, 3, H, Dh)`` QKV and ``(L, H, Dh, d)`` out-projection,
the ``(L, 2, P+1, page, H, Dh)`` paged KV cache), so weights and caches
compare one to one with the reference:

- :func:`make_loss_fn`     mean next-token cross-entropy of ``(B, S+1)``
                           tokens, differentiable in the params.
- :func:`make_train_step`  forward, backward and a functional optimizer
                           update as one ``step(carry, tokens)``.
- :func:`make_forward_fn`  one-shot logits ``(B, S, V)``: the numerical
                           reference the serving path must match per token.
- :func:`init_kv_cache`    the cache buffer. Page 0 is the SCRATCH page,
                           never handed out by the allocator; inactive
                           slots and padded prompt tails write there.
- :func:`make_prefill_fn`  causal forward over one padded prompt that
                           scatters every position's K/V into its page and
                           returns the last valid position's logits.
- :func:`make_decode_fn`   one token per batch slot: write its K/V at
                           (page, offset) from its position, attend over
                           the pages the slot's block table names.
- :func:`make_extend_fn`   T tokens per batch slot in one call, each row
                           under its own causal mask: the shared-prefix
                           tail prefill and the speculative verify step.
                           Decode is its T = 1 case.
- :func:`draft_from_layers` the self-draft: the target's first n layers,
                           sharing its tensors.

Attention in the causal forward is the flash-attention kernel
(:mod:`..kernels.flash_attention`) on a CUDA tensor and its plain version
on the CPU; its gradient is the two backward kernels. The products
around it (QKV, out-projection, FFN, logits) are ``torch.einsum``, as the
JAX package leaves them to XLA. Parameters stay fp32; each product casts
its weight to the compute dtype, layernorm runs in fp32 and casts back,
and logits come back in fp32.

JAX's functions are pure and donate the cache buffer and the train
carry; here the cache and the train step's params and optimizer state
are updated in place and the same tensors are returned.

Tensor parallelism over a mesh's ``mp`` (or legacy ``tp``) axis, one
process a device: :func:`param_specs` and :func:`shard_params` give a
rank its shards (the embedding's vocab rows, the qkv and out-projection
heads, ffn-up's columns and ffn-down's rows; the rest replicated), and
the forward on a shard runs Megatron's collectives
(:mod:`..parallel.tensor_parallel`): a vocab-sharded embedding summed
over the group, attention on the rank's ``H / mp`` heads, one sum after
the row-parallel out-projection and one after ffn-down (two a block),
and the logits' vocab shards gathered. The batch is split over the data
axes. :func:`make_loss_fn`, :func:`make_train_step`,
:func:`make_prefill_fn`, :func:`make_decode_fn` and :func:`make_extend_fn`
take ``mesh=``.

``n_experts > 0`` swaps each block's ffn for the JAX package's dense
soft-gated mixture: an fp32 softmax gate over every expert, each expert's
``relu(h Wup_e) Wdown_e`` (``torch.einsum``), summed with the gate's
weights. Under mp each expert's d_ff is sharded as the dense ffn's, the
expert axis stays whole, and the gated sum takes the block's one sum after
the ffn.

Training also runs over a mesh's ``sp`` and ``ep`` axes, as the JAX
package's ``shard_map`` does:

- ``sp`` shards the sequence: a rank takes the tokens of its chunk (and
  the next one, the +1 target overlap), the position rows from ``idx_sp *
  S_loc``, and attends by ``config.attn``: ``auto`` and ``ring`` go round
  the ring (:func:`~..parallel.ring.ring_attention_inner`), ``ulysses``
  all-to-alls heads and sequence, ``full`` all-gathers K and V; ``flash``
  attends within the shard and raises. The loss's sum and count are
  summed over ``dp`` with ``sp``, and so are the gradients.
- ``ep`` shards the MoE's experts: a rank holds ``n_experts / ep`` of
  them, takes its slice of the gate at ``idx_ep * e_loc``, and the gated
  sum is summed over the ``ep`` group before the mp sum, with the
  conjugate pair (:mod:`..parallel.tensor_parallel`) around the experts'
  input and the gate, so each rank's gate gradient is whole.

The serving functions take no ``sp`` or ``ep`` axis (the JAX package's
take no mesh at all) and refuse one by name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError
from ..context import resolve_device
from ..kernels.flash_attention import flash_attention
from ..parallel.feed import rank_rows
from ..parallel.mesh import (_mp_axis, all_gather_rows, all_reduce_flat_,
                             axis_group, data_group, mesh_device,
                             model_group)
from ..parallel.ring import (full_attention, ring_attention_inner,
                             ulysses_attention_inner)
from ..parallel.spmd import (FunctionalOptimizer, ShardingRuleError,
                             functional_optimizer)
from ..parallel import tensor_parallel as tpl
from ..parallel.tensor_parallel import (all_gather, copy_to_mp,
                                        gather_from_mp, reduce_from_data,
                                        reduce_from_mp)

__all__ = ["TransformerConfig", "init_params", "params_from_jax",
           "param_specs", "kv_cache_spec", "shard_params", "unshard",
           "make_loss_fn", "make_train_step", "block_collective_counts",
           "make_forward_fn", "init_kv_cache", "make_prefill_fn",
           "make_decode_fn", "make_extend_fn", "draft_from_layers",
           "decode_schedule_shape", "torch_dtype"]

_NEG_INF = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_GLOBAL = ("embed_weight", "pos_embed_weight", "final_ln_gamma",
           "final_ln_beta")


@dataclasses.dataclass
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2048
    n_experts: int = 0          # 0 -> dense ffn; >0 -> MoE every layer
    dtype: str = "bfloat16"     # compute dtype (params stay fp32)
    attn: str = "auto"          # auto|flash|ring|ulysses|full
    remat: bool = False         # recompute each layer in the backward
    # the flash kernels' tile: None consults the schedule table
    # (tune.schedule_for) and falls back to the hand default; a value pins
    # the block
    attn_block_q: int | None = None
    attn_block_k: int | None = None


def torch_dtype(name):
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError("unknown compute dtype %r (one of %s)"
                         % (name, "|".join(_DTYPES)))


def _param_shapes(c):
    """Each param's shape, in ``init_params``' order of draws."""
    d, L, E = c.d_model, c.n_layers, c.n_experts
    shapes = {"embed_weight": (c.vocab, d), "pos_embed_weight": (c.max_len, d),
              "final_ln_gamma": (d,), "final_ln_beta": (d,),
              "ln1_gamma": (L, d), "ln1_beta": (L, d),
              "ln2_gamma": (L, d), "ln2_beta": (L, d),
              "attn_qkv_weight": (L, d, 3, c.n_heads, d // c.n_heads),
              "attn_out_weight": (L, c.n_heads, d // c.n_heads, d)}
    if E:
        shapes.update(moe_gate_weight=(L, d, E), ffn_up_weight=(L, E, d,
                                                                c.d_ff),
                      ffn_down_weight=(L, E, c.d_ff, d))
    else:
        shapes.update(ffn_up_weight=(L, d, c.d_ff),
                      ffn_down_weight=(L, c.d_ff, d))
    return shapes


def init_params(config, seed=0):
    """Flat fp32 param dict of CPU tensors; layer params stacked on a
    leading L dim. The same ``np.random.RandomState`` recipe as the JAX
    package (normal(0, 0.02) weights drawn in order, unit gammas, zero
    betas; the MoE's gate, then ffn-up, then ffn-down), so one seed gives
    bit-identical weights in both."""
    rng = np.random.RandomState(seed)
    p = {}
    for k, shape in _param_shapes(config).items():
        if k.endswith("_weight"):
            p[k] = rng.normal(0.0, 0.02, shape).astype(np.float32)
        else:
            p[k] = (np.ones if k.endswith("_gamma") else np.zeros)(
                shape, np.float32)
    return {k: torch.from_numpy(v) for k, v in p.items()}


def params_from_jax(np_params, device=None):
    """Carry a JAX-package param dict (numpy or jax arrays, same names and
    shapes) across as fp32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in np_params.items()}


def param_specs(config, mesh):
    """Each param's spec, a tuple naming the mesh axis of each dim (None:
    whole), as the JAX package's ``PartitionSpec``s: Megatron's column
    (qkv heads, ffn-up's output) and row (out-projection heads, ffn-down's
    input) sharding and the vocab-sharded embedding over the mesh's
    ``mp`` (or ``tp``) axis; the rest replicated. The MoE's expert axis
    is sharded over the mesh's ``ep`` axis (whole without one) and each
    expert's d_ff over mp (ffn-up's last dim, ffn-down's middle one); its
    gate is replicated."""
    tp = _mp_axis(mesh.mesh_dim_names)
    ep = "ep" if "ep" in mesh.mesh_dim_names else None
    rep = ()
    specs = {"embed_weight": (tp, None), "pos_embed_weight": rep,
             "final_ln_gamma": rep, "final_ln_beta": rep,
             "ln1_gamma": rep, "ln1_beta": rep, "ln2_gamma": rep,
             "ln2_beta": rep,
             "attn_qkv_weight": (None, None, None, tp, None),
             "attn_out_weight": (None, tp, None, None)}
    if config.n_experts:
        specs.update(moe_gate_weight=rep, ffn_up_weight=(None, ep, None, tp),
                     ffn_down_weight=(None, ep, tp, None))
    else:
        specs.update(ffn_up_weight=(None, None, tp),
                     ffn_down_weight=(None, tp, None))
    return specs


def kv_cache_spec(mesh):
    """The paged KV cache's spec, ``(L, 2, P+1, page, H, Dh)``: heads
    sharded over the mp axis, so each rank holds 1/mp of every page."""
    return (None, None, None, None, _mp_axis(mesh.mesh_dim_names), None)


def _sharded_dims(config, mesh):
    """``{name: ((dim, axis), ...)}`` of the params sharded over mesh
    axes."""
    return {k: tuple((d, a) for d, a in enumerate(spec) if a is not None)
            for k, spec in param_specs(config, mesh).items()
            if any(a is not None for a in spec)}


def _shard_group(mesh, axis):
    """The ``(group, n, index)`` a param dim sharded over ``axis`` is cut
    by: :func:`model_group` for the mp (or tp) axis, :func:`axis_group`
    for the others."""
    if axis == _mp_axis(mesh.mesh_dim_names):
        return model_group(mesh)
    return axis_group(mesh, (axis,))


def shard_params(params, config, mesh, device=None):
    """This rank's shards of a whole param dict (the JAX ``init_params``
    layout, numpy or tensors) as fp32 tensors on ``device`` (default the
    rank's mesh device): the rank at index ``i`` of an axis of ``n`` ranks
    holds block ``i`` of each dim sharded over that axis
    (:func:`param_specs`); the rest are whole copies. Raises
    ``ShardingRuleError`` when a sharded dim does not divide by ``n``."""
    dims = _sharded_dims(config, mesh)
    dev = mesh_device(mesh) if device is None else torch.device(device)
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v) if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v))
        for dim, axis in dims.get(k, ()):
            _group, n, index = _shard_group(mesh, axis)
            if v.shape[dim] % n:
                raise ShardingRuleError(
                    "shard_params: %s dim %d of size %d does not divide over "
                    "%d %s ranks" % (k, dim, v.shape[dim], n, axis))
            w = v.shape[dim] // n
            v = v.narrow(dim, index * w, w)
        out[k] = v.detach().to(dev, torch.float32, copy=True)
    return out


def unshard(shards, config, mesh):
    """The inverse of :func:`shard_params`, a collective over the rank's
    group along each sharding axis: each sharded tensor's blocks gathered
    in rank order, the replicated ones as they are."""
    dims = _sharded_dims(config, mesh)
    out = {}
    for k, v in shards.items():
        for dim, axis in dims.get(k, ()):
            group = _shard_group(mesh, axis)[0]
            if group is not None:
                v = all_gather_rows(v.detach().movedim(dim, 0).contiguous(),
                                    group).movedim(0, dim).contiguous()
        out[k] = v
    return out


def _mp_context(mesh):
    """``None`` (no mesh, or no mp axis) or :func:`model_group`'s
    ``(group, n, index)``."""
    if mesh is None:
        return None
    return model_group(mesh) if _mp_axis(mesh.mesh_dim_names) else None


def _axis_context(mesh, axis):
    """``None`` (no mesh, or no such axis) or the axis's ``(group, n,
    index)`` (:func:`~..parallel.mesh.axis_group`; a one-rank axis is
    ``(None, 1, 0)``, as a JAX axis of size 1 is still an axis)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return None
    return axis_group(mesh, (axis,))


def _serving_context(mesh, what):
    """:func:`_mp_context` for a serving function, which takes no ``sp`` or
    ``ep`` axis (the JAX package serves on one device)."""
    for axis in ("sp", "ep"):
        if mesh is not None and axis in mesh.mesh_dim_names:
            raise MXNetError("%s: a mesh axis %r shards training only; "
                             "serve on a mesh of dp and mp" % (what, axis))
    return _mp_context(mesh)


def _run_device(mesh, device, what):
    """The device a function runs on: ``device`` (default ``cuda``), or
    the rank's mesh device, which ``device``, when given, must name."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh_device(mesh)
    if device is not None:
        want = resolve_device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise MXNetError("%s: device=%r but this rank's mesh device is %s"
                             % (what, device, dev))
    return dev


def _check_on(dev, **tensors):
    """Raise unless every named tensor lives on ``dev``: a step runs where
    its function was made for, and never moves weights or caches."""
    for name, t in tensors.items():
        got = t.device
        if got.type != dev.type or (dev.index is not None
                                    and got.index != dev.index):
            raise MXNetError("%s is on %s, but this function runs on %s; "
                             "move it there or make the function with "
                             "device=%r" % (name, got, dev, str(got)))


def _layer(params, i):
    return {k: v[i] for k, v in params.items() if k not in _GLOBAL}


def _layernorm(x, gamma, beta, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


ATTN_MODES = ("auto", "flash", "full", "ring", "ulysses")


def _attention(q, k, v, causal=True, *, sp=None, attn="auto", blocks=None):
    """(B, H_loc, S_loc, D) in, same out, by ``attn`` mode, as the JAX
    package's. Without an sp axis (``sp`` None): ``auto`` and ``flash``
    run the flash kernel at the tile ``blocks`` (``(block_q, block_k)``;
    None entries consult the schedule table), ``full``, ``ring`` and
    ``ulysses`` (and any other mode) plain attention. On an sp axis (its
    ``(group, n, index)``): ``auto`` and ``ring`` the ring, ``ulysses``
    the all-to-alls, ``full`` K and V all-gathered; ``flash`` and an
    unknown mode raise."""
    if sp is None:
        if attn in ("auto", "flash"):
            bq, bk = blocks or (None, None)
            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   block_q=bq, block_k=bk)
        return full_attention(q, k, v, causal=causal)
    if attn not in ATTN_MODES:
        raise ValueError("unknown attn mode %r" % (attn,))
    if attn == "full":
        # every shard attends the whole gathered sequence; q keeps its shard
        kg, vg = all_gather(k, sp, dim=2), all_gather(v, sp, dim=2)
        return full_attention(q, kg, vg, causal=causal,
                              q_offset=sp[2] * q.shape[2])
    if attn in ("auto", "ring"):
        return ring_attention_inner(q, k, v, axis=sp, causal=causal)
    if attn == "ulysses":
        return ulysses_attention_inner(q, k, v, axis=sp, causal=causal)
    raise ValueError(
        "attn='flash' attends only within the local shard and is "
        "incompatible with a sequence-parallel (sp) mesh axis; use "
        "'ring' or 'ulysses' (both use flash-style online softmax)")


def _qkv(h, lp, cdt, tp=None):
    """(B, S, d) -> q, k, v each (B, H, S, Dh) (this rank's heads under
    mp: a column-parallel product)."""
    qkv = torch.einsum("bsd,dthe->tbhse", copy_to_mp(h, tp),
                       lp["attn_qkv_weight"].to(cdt))
    return qkv[0], qkv[1], qkv[2]


def _out_proj(o, lp, cdt, tp=None):
    """The out-projection of the rank's heads, summed over the mp group (a
    row-parallel product)."""
    return reduce_from_mp(torch.einsum("bhse,hed->bsd", o,
                                       lp["attn_out_weight"].to(cdt)), tp)


def _block(x, lp, cdt, tp=None, *, sp=None, ep=None, attn="auto",
           blocks=None):
    """One transformer block; lp: this layer's params (shards under mp and
    ep); ``sp``/``ep`` the ``(group, n, index)`` of those axes (None:
    absent); ``attn``/``blocks`` as :func:`_attention`'s."""
    h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
    q, k, v = _qkv(h, lp, cdt, tp)
    o = _attention(q, k, v, sp=sp, attn=attn, blocks=blocks)
    return _ffn(x + _out_proj(o, lp, cdt, tp), lp, cdt, tp, ep)


def _ffn(x, lp, cdt, tp=None, ep=None):
    """The ffn half of a block (post-attention residual included), shared
    by the one-shot forward, prefill and decode: ffn-up by columns and
    ffn-down by rows under mp, one sum over the group. Layer params with a
    ``moe_gate_weight`` take the MoE branch (:func:`_moe`)."""
    ln = _layernorm(x, lp["ln2_gamma"], lp["ln2_beta"])
    h = copy_to_mp(ln, tp)
    if "moe_gate_weight" in lp:
        f = _moe(ln, h, lp, cdt, tp, ep)
    else:
        up = F.relu(torch.einsum("bsd,df->bsf", h,
                                 lp["ffn_up_weight"].to(cdt)))
        f = torch.einsum("bsf,fd->bsd", up, lp["ffn_down_weight"].to(cdt))
    return x + reduce_from_mp(f, tp)


def _moe(ln, h, lp, cdt, tp=None, ep=None):
    """The dense soft-gated mixture of this rank's experts, before the
    block's sum over the mp group: the gate an fp32 softmax of ``ln Wg``
    over every expert, this rank's slice of it cast to the compute dtype,
    each expert ``relu(h Wup_e) Wdown_e`` on this rank's d_ff shard,
    summed with the gate's weights and, over an ``ep`` axis, over the
    group's experts.

    Under mp (and ep) the gated sum is of partial expert outputs, so each
    rank's cotangent of the gate is partial: the gate is computed from the
    replicated ``ln`` (not the column-parallel input ``h``) and passes
    :func:`copy_to_mp` over the ep group before its slice at ``idx_ep *
    e_loc`` and over the mp group after, whose backwards sum it over each
    group. The gate's weight and the gate's share of ``ln``'s gradient are
    then whole on every rank, as the replicated params' are. The experts'
    input ``h`` passes the ep group's :func:`copy_to_mp` too, and the
    gated sum its :func:`reduce_from_mp`: ep is Megatron's pair over the
    expert axis."""
    gate = torch.softmax(torch.einsum("bsd,de->bse", ln.float(),
                                      lp["moe_gate_weight"].float()), dim=-1)
    if ep is not None:
        e_loc = lp["ffn_up_weight"].shape[0]
        gate = copy_to_mp(gate, ep).narrow(-1, ep[2] * e_loc, e_loc)
    gate = copy_to_mp(gate.to(cdt), tp)
    h = copy_to_mp(h, ep)
    up = F.relu(torch.einsum("bsd,edf->besf", h, lp["ffn_up_weight"].to(cdt)))
    down = torch.einsum("besf,efd->besd", up, lp["ffn_down_weight"].to(cdt))
    return reduce_from_mp(torch.einsum("besd,bse->bsd", down, gate), ep)


def _logits(x, params, cdt, tp=None):
    """fp32 logits of the tied head (the rank's vocab shard, then gathered
    under mp)."""
    x = copy_to_mp(_layernorm(x, params["final_ln_gamma"],
                              params["final_ln_beta"]), tp)
    local = torch.einsum("...d,vd->...v", x, params["embed_weight"].to(cdt))
    return gather_from_mp(local, tp).float()


def _embed(emb, tokens, tp, clamp):
    """Rows of int ``tokens`` from the embedding; under mp the rank holds
    vocab rows ``[index * v, (index + 1) * v)``, embeds the ids it does
    not hold as zeros, and the mp group sums the shards. ``clamp`` clips
    ids into the whole vocabulary first (the serving steps); without it an
    out-of-vocab id embeds as zeros (the training forward)."""
    v = emb.shape[0]
    _group, n, index = (None, 1, 0) if tp is None else tp
    if clamp:
        tokens = tokens.clamp(0, v * n - 1)
        if tp is None:
            return emb[tokens]
    local = tokens - index * v
    in_range = (local >= 0) & (local < v)
    x = torch.where(in_range[..., None], emb[local.clamp(0, v - 1)], 0.0)
    return reduce_from_mp(x, tp)


def _as_long(a, device):
    return torch.as_tensor(a, device=device).long()


def _forward(params, tokens, c, cdt, dev, tp=None, sp=None, ep=None, s0=0):
    """Logits (B, S, V) fp32 of int tokens (B, S): the causal block stack
    shared by the one-shot forward and the training loss (the JAX
    package's ``_forward_local``; ``tp``, ``sp`` and ``ep`` the groups of a
    rank's shards; ``s0`` the global position of the rank's first token).
    Out-of-vocab ids embed as zeros. Under ``c.remat``, while autograd
    records, each layer is recomputed in the backward (``jax.checkpoint``
    in the JAX package)."""
    emb = params["embed_weight"]
    _check_on(dev, params=emb)
    tokens = _as_long(tokens, dev)
    S = tokens.shape[1]
    x = _embed(emb, tokens, tp, clamp=False)
    x = (x + params["pos_embed_weight"][s0:s0 + S]).to(cdt)
    kw = dict(sp=sp, ep=ep, attn=c.attn,
              blocks=(c.attn_block_q, c.attn_block_k))
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.n_layers):
        lp = _layer(params, i)
        if remat:
            x = checkpoint(_block, x, lp, cdt, tp, use_reentrant=False, **kw)
        else:
            x = _block(x, lp, cdt, tp, **kw)
    return _logits(x, params, cdt, tp)


def make_forward_fn(config, device=None):
    """fn(params, tokens (B, S) int) -> logits (B, S, V) fp32 on ``device``
    (default ``cuda``), where the params must lie. Out-of-vocab ids embed
    as zeros (the JAX forward's mask)."""
    c = config
    cdt = torch_dtype(c.dtype)
    dev = resolve_device(device)

    @torch.inference_mode()
    def fwd(params, tokens):
        return _forward(params, tokens, c, cdt, dev)

    return fwd


def _reduce_axes(data_axes):
    """The axes the loss's sum and count are summed over, and the
    gradients: the data axes and ``sp`` (JAX's ``reduce_axes``)."""
    return tuple(data_axes) + ("sp",)


def _loss_closure(c, dev, mesh, data_axes):
    """The loss function of :func:`make_loss_fn` on ``dev``."""
    cdt = torch_dtype(c.dtype)
    tp, sp, ep = (_mp_context(mesh), _axis_context(mesh, "sp"),
                  _axis_context(mesh, "ep"))
    _g, n, index = (None, 1, 0) if mesh is None else \
        data_group(mesh, data_axes)
    reduce = mesh is not None and any(a in mesh.mesh_dim_names
                                      for a in _reduce_axes(data_axes))
    group = axis_group(mesh, _reduce_axes(data_axes))[0] if reduce else None

    def loss_fn(params, tokens):
        if n > 1:
            tokens = rank_rows(tokens, n, index, "tokens", "loss_fn")
        tokens = _as_long(tokens, dev)
        s0 = 0
        if sp is not None:
            # the rank's chunk of the sequence and the next token (the +1
            # target overlap)
            seq = tokens.shape[1] - 1
            if seq % sp[1]:
                raise MXNetError("loss_fn: sequence length %d does not "
                                 "divide over %d sp ranks" % (seq, sp[1]))
            s_loc = seq // sp[1]
            s0 = sp[2] * s_loc
            tokens = tokens[:, s0:s0 + s_loc + 1]
        logits = _forward(params, tokens[:, :-1], c, cdt, dev, tp, sp, ep,
                          s0)
        nll = -F.log_softmax(logits, dim=-1).gather(-1, tokens[:, 1:, None])
        if not reduce:
            return nll.mean()
        total = reduce_from_data(nll.sum(), group)
        count = reduce_from_data(torch.tensor(float(nll.numel()),
                                              device=dev), group)
        return total / count

    return loss_fn


def make_loss_fn(config, mesh=None, data_axes=("dp",), device=None):
    """``(loss_fn, specs)``: ``loss_fn(params, tokens (B, S+1) int)`` is
    the mean next-token cross-entropy, a scalar fp32 tensor on ``device``
    (default ``cuda``), where the params must lie; autograd reaches every
    param through it. The fp32 ``log_softmax`` of fp32 logits, as in the
    JAX package. ``specs`` is None without a mesh.

    On a ``mesh`` (every rank calls it, on its mesh device) the params are
    the rank's shards (:func:`shard_params`; ``specs`` is
    :func:`param_specs`) and ``tokens`` the global batch, whose rows the
    data axes among ``data_axes`` split and whose sequence an ``sp`` axis
    splits (the rank's chunk of S and the next token): the loss is the
    global mean, the sum and count summed over the data axes and sp. Each
    rank's gradient is its share (the mp and ep ranks of one data and sp
    index get the same gradient of every replicated param); their sum
    over the data axes and sp is the global loss's gradient, as
    :func:`make_train_step` takes it."""
    dev = _run_device(mesh, device, "make_loss_fn")
    specs = None if mesh is None else param_specs(config, mesh)
    return _loss_closure(config, dev, mesh, data_axes), specs


def make_train_step(config, mesh=None, optimizer=None, data_axes=("dp",),
                    device=None):
    """``(step, place)``: one train step on ``device`` (default ``cuda``),
    or on each rank of a ``mesh`` (every rank calls ``step`` with the
    global batch; the gradients are summed over the data axes and ``sp``,
    one collective a dtype, and the replicated params stay bit for bit
    equal across an mp or ep group).

    ``place(params)`` copies the params (whole; on a mesh, this rank's
    :func:`shard_params`) to the device as fp32 leaves that require grad
    and builds the carry ``(params, opt_state, 0)``.
    ``step(carry, tokens (B, S+1)) -> (carry, loss)`` runs the loss of
    :func:`make_loss_fn`, its gradient in every param, and the optimizer's
    update, which changes the carry's params and state in place (the JAX
    step donates its carry). ``optimizer`` is a ``FunctionalOptimizer`` or
    a dict of :func:`~..parallel.functional_optimizer` arguments; the
    default is sgd with lr 0.1 and momentum 0.9, as in the JAX package."""
    opt = optimizer or functional_optimizer("sgd", learning_rate=0.1,
                                            momentum=0.9)
    if isinstance(opt, dict):
        opt = functional_optimizer(**opt)
    if not isinstance(opt, FunctionalOptimizer):
        raise MXNetError("make_train_step: optimizer must be a "
                         "FunctionalOptimizer or a dict of its arguments, "
                         "got %r" % type(opt).__name__)
    loss_fn, _specs = make_loss_fn(config, mesh, data_axes, device)
    dev = _run_device(mesh, device, "make_train_step")
    group = None if mesh is None else \
        axis_group(mesh, _reduce_axes(data_axes))[0]

    def step(carry, tokens):
        params, opt_state, n = carry
        names = list(params)
        with torch.enable_grad():
            loss = loss_fn(params, tokens)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        all_reduce_flat_(list(grads), group)
        params, opt_state = opt.apply(params, dict(zip(names, grads)),
                                      opt_state, n)
        return (params, opt_state, n + 1), loss.detach()

    def place(params):
        if mesh is not None:
            params = shard_params(params, config, mesh)
        params = {k: torch.as_tensor(v).detach().to(
            dev, torch.float32, copy=True).requires_grad_(True)
            for k, v in params.items()}
        return params, opt.init(params), 0

    return step, place


def block_collective_counts(config, mesh, data_axes=("dp",)):
    """The collectives of one loss forward on ``mesh``, counted by the
    functions of :mod:`..parallel.tensor_parallel` while the loss runs on
    ``meta`` tensors (shapes only: nothing is sent, as the JAX package
    counts a traced jaxpr): ``psum_per_block`` the sums inside one
    transformer block (2 on an mp mesh: after the out-projection and
    ffn-down; one more after the MoE's gated sum on an ep mesh; 0 without
    either), ``psum_outside`` the others (the vocab-sharded embedding's,
    the loss sum's and count's over the data axes and sp),
    ``all_gather`` the gathers outside the blocks (the logits') and those
    of one block (K and V under ``attn="full"`` on sp: the JAX package
    counts the scanned block once), ``n_blocks`` the layers. The JAX
    package's keys and values for the same mesh shape. The ring's
    permutes and Ulysses' all-to-alls are no psum or gather and count in
    ``tensor_parallel.counts()`` only."""
    meta = torch.device("meta")
    params = shard_params({k: torch.empty(shape, device=meta) for k, shape
                           in _param_shapes(config).items()},
                          config, mesh, device=meta)
    n = data_group(mesh, data_axes)[1]
    loss_fn = _loss_closure(config, meta, mesh, data_axes)
    sp = _axis_context(mesh, "sp")
    s_loc = 8 // (1 if sp is None else sp[1])
    before = tpl.counts()
    with torch.no_grad():
        loss_fn(params, torch.zeros((n, 9), dtype=torch.long, device=meta))
        mid = tpl.counts()
        _block(torch.empty((1, s_loc, config.d_model), device=meta,
                           dtype=torch_dtype(config.dtype)),
               _layer(params, 0), torch_dtype(config.dtype),
               _mp_context(mesh), sp=sp, ep=_axis_context(mesh, "ep"),
               attn=config.attn)
    after = tpl.counts()

    def delta(a, b, *names):
        return sum(b[k] - a[k] for k in names)

    gathers = ("gather_from_mp", "all_gather")
    per_block = delta(mid, after, "reduce_from_mp")
    psums = delta(before, mid, "reduce_from_mp", "reduce_from_data")
    return {"psum_per_block": per_block,
            "psum_outside": psums - per_block * config.n_layers,
            "all_gather": delta(before, mid, *gathers)
            - delta(mid, after, *gathers) * (config.n_layers - 1),
            "n_blocks": config.n_layers}


def init_kv_cache(config, num_pages, page_size, dtype=None, device=None,
                  mesh=None):
    """Zeroed paged KV cache (n_layers, 2, num_pages + 1, page_size,
    n_heads, head_dim) in the compute dtype, on ``device`` (default
    ``cuda``); on a ``mesh``, this rank's ``n_heads / mp`` heads
    (:func:`kv_cache_spec`) on its mesh device. Page 0 is the scratch page;
    callers allocate real page ids from 1..num_pages."""
    c = config
    device = _run_device(mesh, device, "init_kv_cache")
    heads = c.n_heads // (1 if mesh is None else model_group(mesh)[1])
    cdt = torch_dtype(dtype if dtype is not None else c.dtype)
    dh = c.d_model // c.n_heads
    return torch.zeros((c.n_layers, 2, int(num_pages) + 1, int(page_size),
                        heads, dh), dtype=cdt, device=device)


def make_prefill_fn(config, page_size, device=None, mesh=None):
    """fn(params, cache, tokens (1, S_pad) int, length int, pages
    (S_pad // page_size,) int) -> (cache, logits (V,) fp32).

    Runs the same causal block forward as :func:`make_forward_fn` over the
    padded prompt, writes position p's K/V into
    ``cache[layer, :, pages[p // page_size], p % page_size]`` (in place)
    and returns the logits of position ``length - 1``. Padded tail
    positions write into whatever page their index names: callers pad
    ``pages`` with 0, the scratch page. Causal masking keeps the padded
    rows from touching valid ones. Params and cache must lie on
    ``device`` (default ``cuda``). On a ``mesh`` the params and cache are
    the rank's shards, every rank of the mesh makes the same call, and
    each returns the whole vocabulary's logits."""
    c = config
    cdt = torch_dtype(c.dtype)
    page_size = int(page_size)
    dev = _run_device(mesh, device, "make_prefill_fn")
    tp = _serving_context(mesh, "make_prefill_fn")
    blocks = (c.attn_block_q, c.attn_block_k)

    @torch.inference_mode()
    def prefill(params, cache, tokens, length, pages):
        emb = params["embed_weight"]
        _check_on(dev, params=emb, cache=cache)
        tokens = _as_long(tokens, dev)
        pages = _as_long(pages, dev)
        S = tokens.shape[1]
        n_pages = S // page_size
        x = _embed(emb, tokens, tp, clamp=True)
        x = (x + params["pos_embed_weight"][:S]).to(cdt)
        for i in range(c.n_layers):
            lp = _layer(params, i)
            h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
            q, k, v = _qkv(h, lp, cdt, tp)
            # (1, H, S, Dh) -> page grid (n_pages, page, H, Dh)
            cache[i, 0, pages] = k[0].transpose(0, 1).reshape(
                n_pages, page_size, k.shape[1], -1).to(cache.dtype)
            cache[i, 1, pages] = v[0].transpose(0, 1).reshape(
                n_pages, page_size, v.shape[1], -1).to(cache.dtype)
            o = _out_proj(_attention(q, k, v, attn=c.attn, blocks=blocks),
                          lp, cdt, tp)
            x = _ffn(x + o, lp, cdt, tp)
        return cache, _logits(x[0, int(length) - 1], params, cdt, tp)

    return prefill


def _paged_extend_attention(q, k, v, positions):
    """Paged attention for T query tokens per slot. q: (B, H, T, Dh); k/v:
    (B, H, L, Dh) gathered from the page pool; query row t of slot b sits
    at ``positions[b, t]`` and attends key column j iff ``j <=
    positions[b, t]`` (every row's own token was written before the call).
    One call serves the decode step (T = 1), the shared-prefix tail
    prefill and the speculative verify (the pending token + k proposals).
    fp32 softmax with q scaled in fp32 first; one pass over L computes the
    function the JAX package's blocked loop does."""
    Dh = k.shape[-1]
    L = k.shape[2]
    q32 = q.float() * (1.0 / (Dh ** 0.5))                     # (B, H, T, Dh)
    s = torch.einsum("bhtd,bhkd->bhtk", q32, k.float())
    cols = torch.arange(L, device=k.device)
    ok = cols[None, None, None, :] <= positions[:, None, :, None]
    s = torch.where(ok, s, torch.tensor(_NEG_INF, device=k.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bhtk,bhkd->bhtd", p, v.float()) / l_safe[..., None]
    return out.to(q.dtype)                                    # (B, H, T, Dh)


def _paged_blocks(params, cache, tokens, positions, block_tables, valid, c,
                  cdt, page_size, tp=None):
    """The layer stack of the paged steps (decode and extend): tokens,
    positions and valid (S, T), block_tables (S, MP); returns the final
    hidden states (S, T, d). Token (b, t) is written at page
    ``block_tables[b, positions[b, t] // page_size]`` offset
    ``positions[b, t] % page_size`` in place, all T rows of a layer before
    that layer's gather. Invalid rows, and rows past the table, write to
    the scratch page: they are the only rows that may share an index, so
    ``index_put_``'s unordered duplicate writes never touch a live page.
    The caller clamps positions at 0 and clears ``valid`` past the
    table."""
    S = tokens.shape[0]
    mp = block_tables.shape[1]
    max_ctx = mp * page_size
    emb, pos_w = params["embed_weight"], params["pos_embed_weight"]
    x = _embed(emb, tokens, tp, clamp=True) \
        + pos_w[positions.clamp(0, pos_w.shape[0] - 1)]
    x = x.to(cdt)                                               # (S, T, d)
    offset = positions % page_size
    page = block_tables.gather(1, (positions // page_size).clamp(0, mp - 1))
    page = torch.where(valid, page, 0)
    for i in range(c.n_layers):
        lp = _layer(params, i)
        h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
        q, k, v = _qkv(h, lp, cdt, tp)                      # (S, H, T, Dh)
        cache[i, 0, page, offset] = k.transpose(1, 2).to(cache.dtype)
        cache[i, 1, page, offset] = v.transpose(1, 2).to(cache.dtype)
        # paged gather: (S, MP, page, H, Dh) -> (S, H, L, Dh)
        kg = cache[i, 0][block_tables].reshape(
            S, max_ctx, k.shape[1], -1).transpose(1, 2)
        vg = cache[i, 1][block_tables].reshape(
            S, max_ctx, v.shape[1], -1).transpose(1, 2)
        o = _paged_extend_attention(q, kg, vg, positions)
        x = _ffn(x + _out_proj(o, lp, cdt, tp), lp, cdt, tp)
    return x


def decode_schedule_shape(config, slots, max_ctx):
    """The schedule-table key shape of the decode step's attention:
    (batch=slots, heads, seq_q=1, seq_k=max_ctx, head_dim, causal=0), the
    flash-attention consult's convention and the JAX package's key, so
    ``python -m mxnet_tpu_torch.tune``'s decode sweep fills this key. The
    port's paged decode attention is plain PyTorch over the whole window
    (:func:`_paged_extend_attention`); the key is what a decode call of
    B5 at that shape consults."""
    c = config
    return (int(slots), c.n_heads, 1, int(max_ctx),
            c.d_model // c.n_heads, 0)


def make_decode_fn(config, slots, max_pages_per_slot, page_size,
                   device=None, mesh=None):
    """fn(params, cache, tokens (S,) int, positions (S,) int,
    block_tables (S, max_pages_per_slot) int, active (S,) bool) ->
    (cache, logits (S, V) fp32), ``S == slots``.

    One decode step: embed token b at ``positions[b]``, write its
    per-layer K/V at page ``block_tables[b, positions[b] // page_size]``
    offset ``positions[b] % page_size`` (in place), attend over the
    slot's gathered pages (columns <= position) and emit next-token
    logits. Inactive slots compute too but write to the scratch page and
    get zero logits. Params and cache must lie on ``device`` (default
    ``cuda``); ``mesh`` as in :func:`make_prefill_fn`."""
    extend = make_extend_fn(config, slots, 1, max_pages_per_slot, page_size,
                            device, mesh)

    def decode(params, cache, tokens, positions, block_tables, active):
        if len(tokens) != slots:
            raise MXNetError("decode: %d tokens for %d slots"
                             % (len(tokens), slots))
        cache, logits = extend(params, cache, tokens[:, None],
                               positions[:, None], block_tables,
                               active[:, None])
        return cache, logits[:, 0]

    return decode


def make_extend_fn(config, slots, steps, max_pages_per_slot, page_size,
                   device=None, mesh=None):
    """fn(params, cache, tokens (S, T) int, positions (S, T) int,
    block_tables (S, max_pages_per_slot) int, valid (S, T) bool) ->
    (cache, logits (S, T, V) fp32), ``S == slots``, ``T == steps``.

    The multi-token form of :func:`make_decode_fn`: each slot appends up
    to T tokens against its cached pages in one call. Token (b, t) is
    written at page ``block_tables[b, positions[b, t] // page_size]``
    offset ``positions[b, t] % page_size``, then every row attends the
    slot's gathered pages under the per-row mask ``col <= positions[b,
    t]``; all T writes of a layer land before its gather, so row t sees
    rows < t of its own call. Two callers: the shared-prefix tail prefill
    (S = 1, rows at ``prefix_len..prompt_len - 1``, all past the shared
    pages, which it therefore never writes) and the speculative verify
    (rows are the pending token and k draft proposals).

    Invalid rows (``valid`` False: padded tails, slots speculating fewer
    than k tokens) write to the scratch page and get zero logits, as do
    rows at or past ``max_pages_per_slot * page_size``. Positions are
    clamped at 0. Params and cache must lie on ``device`` (default
    ``cuda``); ``mesh`` as in :func:`make_prefill_fn`."""
    c = config
    cdt = torch_dtype(c.dtype)
    page_size = int(page_size)
    dev = _run_device(mesh, device, "make_extend_fn")
    tp = _serving_context(mesh, "make_extend_fn")

    @torch.inference_mode()
    def extend(params, cache, tokens, positions, block_tables, valid):
        _check_on(dev, params=params["embed_weight"], cache=cache)
        tokens = _as_long(tokens, dev)
        positions = _as_long(positions, dev)
        block_tables = _as_long(block_tables, dev)
        valid = torch.as_tensor(valid, device=dev).bool()
        if tuple(tokens.shape) != (slots, steps):
            raise MXNetError("extend: tokens of shape %s for (slots, steps) "
                             "(%d, %d)" % (tuple(tokens.shape), slots, steps))
        if block_tables.shape[1] != max_pages_per_slot:
            raise MXNetError("extend: block tables of %d pages a slot, made "
                             "for %d" % (block_tables.shape[1],
                                         max_pages_per_slot))
        positions = positions.clamp_min(0)
        valid = valid & (positions < max_pages_per_slot * page_size)
        x = _paged_blocks(params, cache, tokens, positions, block_tables,
                          valid, c, cdt, page_size, tp)
        return cache, torch.where(valid[..., None],
                                  _logits(x, params, cdt, tp), 0.0)

    return extend


def draft_from_layers(config, params, n_layers):
    """Self-draft for speculative decoding: the FIRST ``n_layers`` blocks
    of the target, sharing its embedding, position and final-LN tensors.
    Returns ``(draft_config, draft_params)``: the shared tensors are the
    target's own objects and every stacked per-layer tensor is the view
    ``v[:n_layers]``, so nothing is copied. Raises ``ValueError`` outside
    ``[1, config.n_layers]``."""
    n = int(n_layers)
    if not 1 <= n <= config.n_layers:
        raise ValueError(
            "draft_from_layers: n_layers must lie in [1, %d], got %d"
            % (config.n_layers, n))
    dparams = {k: (v if k in _GLOBAL else v[:n]) for k, v in params.items()}
    return dataclasses.replace(config, n_layers=n), dparams
