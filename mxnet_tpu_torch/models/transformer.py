"""Decoder-only transformer LM for training and generative serving, in
PyTorch (counterpart of ``mxnet_tpu/models/transformer.py``, single
device only).

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

Not ported yet (ROADMAP.md Queue A item 8): mesh / ``mp`` sharding
(``param_specs``), ring and Ulysses attention, MoE (``n_experts > 0``) and
the schedule-table consult for attention blocks.
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
from ..parallel.spmd import FunctionalOptimizer, functional_optimizer

__all__ = ["TransformerConfig", "init_params", "params_from_jax",
           "make_loss_fn", "make_train_step", "make_forward_fn",
           "init_kv_cache", "make_prefill_fn", "make_decode_fn",
           "make_extend_fn", "draft_from_layers", "torch_dtype"]

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
    n_experts: int = 0          # 0 -> dense ffn; MoE is not ported yet
    dtype: str = "bfloat16"     # compute dtype (params stay fp32)
    remat: bool = False         # recompute each layer in the backward


def torch_dtype(name):
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise MXNetError("unknown compute dtype %r (one of %s)"
                         % (name, "|".join(_DTYPES)))


def _check_dense(config):
    if config.n_experts:
        raise MXNetError(
            "n_experts=%d: the MoE ffn is not ported yet (ROADMAP.md Queue A "
            "item 8); use n_experts=0" % config.n_experts)


def init_params(config, seed=0):
    """Flat fp32 param dict of CPU tensors; layer params stacked on a
    leading L dim. The same ``np.random.RandomState`` recipe as the JAX
    package, so one seed gives bit-identical weights in both."""
    _check_dense(config)
    c = config
    rng = np.random.RandomState(seed)
    dh = c.d_model // c.n_heads

    def norm(*shape, scale=0.02):
        return rng.normal(0.0, scale, shape).astype(np.float32)

    p = {
        "embed_weight": norm(c.vocab, c.d_model),
        "pos_embed_weight": norm(c.max_len, c.d_model),
        "final_ln_gamma": np.ones((c.d_model,), np.float32),
        "final_ln_beta": np.zeros((c.d_model,), np.float32),
    }
    L = c.n_layers
    p["ln1_gamma"] = np.ones((L, c.d_model), np.float32)
    p["ln1_beta"] = np.zeros((L, c.d_model), np.float32)
    p["ln2_gamma"] = np.ones((L, c.d_model), np.float32)
    p["ln2_beta"] = np.zeros((L, c.d_model), np.float32)
    p["attn_qkv_weight"] = norm(L, c.d_model, 3, c.n_heads, dh)
    p["attn_out_weight"] = norm(L, c.n_heads, dh, c.d_model)
    p["ffn_up_weight"] = norm(L, c.d_model, c.d_ff)
    p["ffn_down_weight"] = norm(L, c.d_ff, c.d_model)
    return {k: torch.from_numpy(v) for k, v in p.items()}


def params_from_jax(np_params, device=None):
    """Carry a JAX-package param dict (numpy or jax arrays, same names and
    shapes) across as fp32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in np_params.items()}


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


def _attention(q, k, v, causal=True):
    """(B, H, S, D) in, same out: the flash kernel (no mesh, no sp)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)


def _qkv(h, lp, cdt):
    """(B, S, d) -> q, k, v each (B, H, S, Dh)."""
    qkv = torch.einsum("bsd,dthe->tbhse", h, lp["attn_qkv_weight"].to(cdt))
    return qkv[0], qkv[1], qkv[2]


def _out_proj(o, lp, cdt):
    return torch.einsum("bhse,hed->bsd", o, lp["attn_out_weight"].to(cdt))


def _block(x, lp, cdt):
    """One transformer block; lp: this layer's params."""
    h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
    q, k, v = _qkv(h, lp, cdt)
    return _ffn(x + _out_proj(_attention(q, k, v), lp, cdt), lp, cdt)


def _ffn(x, lp, cdt):
    """The ffn half of a block (post-attention residual included), shared
    by the one-shot forward, prefill and decode."""
    h = _layernorm(x, lp["ln2_gamma"], lp["ln2_beta"])
    up = F.relu(torch.einsum("bsd,df->bsf", h, lp["ffn_up_weight"].to(cdt)))
    return x + torch.einsum("bsf,fd->bsd", up, lp["ffn_down_weight"].to(cdt))


def _logits(x, params, cdt):
    x = _layernorm(x, params["final_ln_gamma"], params["final_ln_beta"])
    return torch.einsum("...d,vd->...v", x,
                        params["embed_weight"].to(cdt)).float()


def _as_long(a, device):
    return torch.as_tensor(a, device=device).long()


def _forward(params, tokens, c, cdt, dev):
    """Logits (B, S, V) fp32 of int tokens (B, S): the causal block stack
    shared by the one-shot forward and the training loss (the JAX
    package's ``_forward_local`` with no mesh). Out-of-vocab ids embed as
    zeros. Under ``c.remat``, while autograd records, each layer is
    recomputed in the backward (``jax.checkpoint`` in the JAX package)."""
    emb = params["embed_weight"]
    _check_on(dev, params=emb)
    tokens = _as_long(tokens, dev)
    S = tokens.shape[1]
    in_range = (tokens >= 0) & (tokens < emb.shape[0])
    x = emb[tokens.clamp(0, emb.shape[0] - 1)]
    x = torch.where(in_range[..., None], x, 0.0)
    x = (x + params["pos_embed_weight"][:S]).to(cdt)
    remat = c.remat and torch.is_grad_enabled()
    for i in range(c.n_layers):
        lp = _layer(params, i)
        if remat:
            x = checkpoint(_block, x, lp, cdt, use_reentrant=False)
        else:
            x = _block(x, lp, cdt)
    return _logits(x, params, cdt)


def make_forward_fn(config, device=None):
    """fn(params, tokens (B, S) int) -> logits (B, S, V) fp32 on ``device``
    (default ``cuda``), where the params must lie. Out-of-vocab ids embed
    as zeros (the JAX forward's mask)."""
    _check_dense(config)
    c = config
    cdt = torch_dtype(c.dtype)
    dev = resolve_device(device)

    @torch.inference_mode()
    def fwd(params, tokens):
        return _forward(params, tokens, c, cdt, dev)

    return fwd


def make_loss_fn(config, mesh=None, data_axes=("dp",), device=None):
    """``(loss_fn, specs)``: ``loss_fn(params, tokens (B, S+1) int)`` is
    the mean next-token cross-entropy, a scalar fp32 tensor on ``device``
    (default ``cuda``), where the params must lie; autograd reaches every
    param through it. The fp32 ``log_softmax`` of fp32 logits, as in the
    JAX package.

    Single device only: ``specs`` is None and ``data_axes`` is unused
    until mesh sharding is ported; a ``mesh`` raises."""
    _check_dense(config)
    if mesh is not None:
        raise MXNetError("make_loss_fn: mesh sharding is not ported yet "
                         "(ROADMAP.md Queue A item 8); pass mesh=None to "
                         "train on one device")
    c = config
    cdt = torch_dtype(c.dtype)
    dev = resolve_device(device)

    def loss_fn(params, tokens):
        tokens = _as_long(tokens, dev)
        logits = _forward(params, tokens[:, :-1], c, cdt, dev)
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(-1, tokens[:, 1:, None]).mean()

    return loss_fn, None


def make_train_step(config, mesh=None, optimizer=None, data_axes=("dp",),
                    device=None):
    """``(step, place)``: one train step on ``device`` (default ``cuda``).

    ``place(params)`` copies the params to the device as fp32 leaves that
    require grad and builds the carry ``(params, opt_state, 0)``.
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
    dev = resolve_device(device)

    def step(carry, tokens):
        params, opt_state, n = carry
        names = list(params)
        with torch.enable_grad():
            loss = loss_fn(params, tokens)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        params, opt_state = opt.apply(params, dict(zip(names, grads)),
                                      opt_state, n)
        return (params, opt_state, n + 1), loss.detach()

    def place(params):
        params = {k: torch.as_tensor(v).detach().to(
            dev, torch.float32, copy=True).requires_grad_(True)
            for k, v in params.items()}
        return params, opt.init(params), 0

    return step, place


def init_kv_cache(config, num_pages, page_size, dtype=None, device=None):
    """Zeroed paged KV cache (n_layers, 2, num_pages + 1, page_size,
    n_heads, head_dim) in the compute dtype, on ``device`` (default
    ``cuda``). Page 0 is the scratch page; callers allocate real page ids
    from 1..num_pages."""
    c = config
    device = resolve_device(device)
    cdt = torch_dtype(dtype if dtype is not None else c.dtype)
    dh = c.d_model // c.n_heads
    return torch.zeros((c.n_layers, 2, int(num_pages) + 1, int(page_size),
                        c.n_heads, dh), dtype=cdt, device=device)


def make_prefill_fn(config, page_size, device=None):
    """fn(params, cache, tokens (1, S_pad) int, length int, pages
    (S_pad // page_size,) int) -> (cache, logits (V,) fp32).

    Runs the same causal block forward as :func:`make_forward_fn` over the
    padded prompt, writes position p's K/V into
    ``cache[layer, :, pages[p // page_size], p % page_size]`` (in place)
    and returns the logits of position ``length - 1``. Padded tail
    positions write into whatever page their index names: callers pad
    ``pages`` with 0, the scratch page. Causal masking keeps the padded
    rows from touching valid ones. Params and cache must lie on
    ``device`` (default ``cuda``)."""
    _check_dense(config)
    c = config
    cdt = torch_dtype(c.dtype)
    page_size = int(page_size)
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(params, cache, tokens, length, pages):
        emb = params["embed_weight"]
        _check_on(dev, params=emb, cache=cache)
        tokens = _as_long(tokens, dev)
        pages = _as_long(pages, dev)
        S = tokens.shape[1]
        n_pages = S // page_size
        x = emb[tokens.clamp(0, emb.shape[0] - 1)]
        x = (x + params["pos_embed_weight"][:S]).to(cdt)
        for i in range(c.n_layers):
            lp = _layer(params, i)
            h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
            q, k, v = _qkv(h, lp, cdt)
            # (1, H, S, Dh) -> page grid (n_pages, page, H, Dh)
            cache[i, 0, pages] = k[0].transpose(0, 1).reshape(
                n_pages, page_size, c.n_heads, -1).to(cache.dtype)
            cache[i, 1, pages] = v[0].transpose(0, 1).reshape(
                n_pages, page_size, c.n_heads, -1).to(cache.dtype)
            o = _out_proj(_attention(q, k, v), lp, cdt)
            x = _ffn(x + o, lp, cdt)
        return cache, _logits(x[0, int(length) - 1], params, cdt)

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
                  cdt, page_size):
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
    x = emb[tokens.clamp(0, emb.shape[0] - 1)] \
        + pos_w[positions.clamp(0, pos_w.shape[0] - 1)]
    x = x.to(cdt)                                               # (S, T, d)
    offset = positions % page_size
    page = block_tables.gather(1, (positions // page_size).clamp(0, mp - 1))
    page = torch.where(valid, page, 0)
    for i in range(c.n_layers):
        lp = _layer(params, i)
        h = _layernorm(x, lp["ln1_gamma"], lp["ln1_beta"])
        q, k, v = _qkv(h, lp, cdt)                          # (S, H, T, Dh)
        cache[i, 0, page, offset] = k.transpose(1, 2).to(cache.dtype)
        cache[i, 1, page, offset] = v.transpose(1, 2).to(cache.dtype)
        # paged gather: (S, MP, page, H, Dh) -> (S, H, L, Dh)
        kg = cache[i, 0][block_tables].reshape(
            S, max_ctx, c.n_heads, -1).transpose(1, 2)
        vg = cache[i, 1][block_tables].reshape(
            S, max_ctx, c.n_heads, -1).transpose(1, 2)
        o = _paged_extend_attention(q, kg, vg, positions)
        x = _ffn(x + _out_proj(o, lp, cdt), lp, cdt)
    return x


def make_decode_fn(config, slots, max_pages_per_slot, page_size,
                   device=None):
    """fn(params, cache, tokens (S,) int, positions (S,) int,
    block_tables (S, max_pages_per_slot) int, active (S,) bool) ->
    (cache, logits (S, V) fp32), ``S == slots``.

    One decode step: embed token b at ``positions[b]``, write its
    per-layer K/V at page ``block_tables[b, positions[b] // page_size]``
    offset ``positions[b] % page_size`` (in place), attend over the
    slot's gathered pages (columns <= position) and emit next-token
    logits. Inactive slots compute too but write to the scratch page and
    get zero logits. Params and cache must lie on ``device`` (default
    ``cuda``)."""
    extend = make_extend_fn(config, slots, 1, max_pages_per_slot, page_size,
                            device)

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
                   device=None):
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
    ``cuda``)."""
    _check_dense(config)
    c = config
    cdt = torch_dtype(c.dtype)
    page_size = int(page_size)
    dev = resolve_device(device)

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
                          valid, c, cdt, page_size)
        return cache, torch.where(valid[..., None], _logits(x, params, cdt),
                                  0.0)

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
