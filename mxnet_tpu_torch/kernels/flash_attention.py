"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain PyTorch versions (counterpart of
``mxnet_tpu/kernels/flash_attention.py``).

:func:`flash_attention` takes the ``(B, H, S, D)`` layout of the JAX
package's public function and is differentiable: it runs through a
``torch.autograd.Function`` (the counterpart of the JAX ``_flash``
custom VJP) whose forward is B5 (``csrc/flash_attention_fwd.cu``) and
whose backward is B6 (dq) and B7 (dk, dv) (``csrc/flash_attention_bwd.cu``),
all built at first use (see ``_build``). In bfloat16 all three run on the
tensor cores (wgmma fed by TMA, so the tensors TMA loads must be 16-byte
aligned); in float32 they run on the CUDA cores. The kernels are built
for a head dim D of 64, 128 or 256: a smaller D is zero-padded to the
next of them on the card (:func:`_pad_head_dim`; zero lanes add 0 to
q . k, to out and to delta, as the JAX package's padding to 128 lanes
does), with the scale taken from the unpadded D, and the outputs are
sliced back. Above 256 the kernels take any multiple of 128 (the wide
route, ``csrc/flash_attention_wide.cuh``: a grid axis over column groups
of the output, mma.sync on the tensor cores in bfloat16, the CUDA cores
in float32), and D is zero-padded to the next one.

The tile is a launch parameter, ``(block_q, block_k)``, one schedule for
the forward and both backward kernels (as the JAX package's blocks):
:data:`FLASH_TC_TILES` on the tensor cores, ``(64, 64)`` alone on the
CUDA cores and on the wide route. Left None, :func:`flash_attention`
consults the schedule table (``tune.schedule_for("flash_attention", (b, h, sq, sk, d,
causal), dtype)``) and falls back to the hand default, 64 x 64; a table
entry that does not fit the shape counts a ``fallback_illegal`` and runs
the hand default. An explicit tile the kernels do not take raises.

A CPU tensor goes to the plain versions, :func:`flash_attention_reference`
and :func:`flash_attention_bwd_reference`: with a tile they run the same
blocked algorithm (the forward's online softmax over key blocks of
``block_k``, the backward's sums over key blocks for dq and over query
blocks for dk and dv), without one the whole rows at once. There is no
fallback: a build or launch failure on a CUDA tensor raises.

Each kernel's wrapper counts its launches in a plain integer,
``flash_attention.launches`` (B5), ``flash_attention_bwd_dq.launches``
(B6) and ``flash_attention_bwd_dkv.launches`` (B7).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ._build import count as _count

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128, 256)
# above HEAD_DIMS[-1] the wide route takes any multiple of this
WIDE_MULTIPLE = 128

# the schedule knob values of block_q and block_k, and the hand default
FLASH_BLOCKS = (64, 128)
DEFAULT_BLOCK = 64
# (block_q, block_k) the tensor-core kernels are instantiated for, by the
# kernels' head dim (the FLASH_TC_TILES list of csrc/flash_attention_*.cu):
# at D = 256 a larger tile does not fit shared memory. The CUDA-core
# kernels take (64, 64) only.
FLASH_TC_TILES = {64: ((64, 64), (64, 128), (128, 64), (128, 128)),
                  128: ((64, 64), (64, 128), (128, 64), (128, 128)),
                  256: ((64, 64),)}
_GRID_Y = 65535


def _scale(sm_scale, d):
    return sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)


def _kernel_head_dim(d, what):
    """The head dim the kernels run a D of ``d`` at: the smallest of
    ``HEAD_DIMS`` that holds it, and above 256 the next multiple of
    :data:`WIDE_MULTIPLE` (the wide route)."""
    if d < 1:
        raise MXNetError("%s: head dim %d must be >= 1" % (what, d))
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    return -(-d // WIDE_MULTIPLE) * WIDE_MULTIPLE


def _pad_head_dim(t, d_to):
    """``t`` with its last dim zero-padded to ``d_to`` (a new contiguous
    tensor), or ``t`` itself when it is that wide already."""
    d = t.shape[-1]
    return t if d == d_to else torch.nn.functional.pad(t, (0, d_to - d))


def tile_legal(d, dtype, block_q, block_k, seq_q, seq_k):
    """``(ok, reason)``: whether the kernels take the tile ``(block_q,
    block_k)`` for a head dim ``d`` (before padding), ``dtype`` and these
    sequence lengths: a tile of :data:`FLASH_TC_TILES` for the kernels'
    head dim in bfloat16, ``(64, 64)`` in float32 and on the wide route
    (D above 256), and every kernel's
    grid within 65535 blocks on its y (B5 and B6 walk query blocks of
    ``block_q``, B7 key blocks of ``block_k``; the float32 B6 and B7 own
    32 rows a block at D = 256)."""
    try:
        kd = _kernel_head_dim(d, "flash_attention")
    except MXNetError as e:
        return False, str(e)
    tile = (int(block_q), int(block_k))
    if kd > HEAD_DIMS[-1]:
        if tile != (DEFAULT_BLOCK, DEFAULT_BLOCK):
            return False, ("the wide route (head dim %d) takes the tile "
                           "(64, 64) only, got %s" % (kd, tile))
        rows_q = rows_k = DEFAULT_BLOCK
    elif dtype == torch.bfloat16:
        if tile not in FLASH_TC_TILES[kd]:
            return False, ("tile %s is not one of the tensor-core tiles %s "
                           "at head dim %d" % (tile, FLASH_TC_TILES[kd], kd))
        rows_q, rows_k = tile
    else:
        if tile != (DEFAULT_BLOCK, DEFAULT_BLOCK):
            return False, ("the float32 kernels take the tile (64, 64) "
                           "only, got %s" % (tile,))
        rows_q = rows_k = 32 if kd == 256 else 64
    for seq, rows in ((seq_q, tile[0]), (seq_q, rows_q), (seq_k, rows_k)):
        if -(-seq // rows) > _GRID_Y:
            return False, ("%d rows exceed the kernels' grid limit of %d "
                           "blocks of %d" % (seq, _GRID_Y, rows))
    return True, ""


def _live(sq, sk, causal, kv_len, device, r0=0, c0=0):
    """(Sq, Sk) bool: key column ``c0 + j`` is live for query row ``r0 +
    i`` iff ``c0 + j < kv_len`` and, under ``causal``, ``r0 + i >= c0 +
    j`` (both from 0)."""
    cols = torch.arange(c0, c0 + sk, device=device)
    ok = (cols < kv_len)[None, :]
    if causal:
        rows = torch.arange(r0, r0 + sq, device=device)
        ok = ok & (rows[:, None] >= cols[None, :])
    return ok


def _scores(q, k, scale, causal, kv_len, r0=0, c0=0):
    """fp32 ``scale * q . k^T`` with masked entries at -1e30, as in the
    kernels; ``q``'s rows start at query row ``r0``, ``k``'s at key
    ``c0``."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    ok = _live(q.shape[-2], k.shape[-2], causal, kv_len, q.device, r0, c0)
    return torch.where(ok, s, torch.tensor(_NEG_INF, device=q.device))


def _check_blocks(block_q, block_k):
    """The plain versions' tile: both None (whole rows) or both >= 1."""
    if (block_q is None) != (block_k is None) or (
            block_q is not None and min(int(block_q), int(block_k)) < 1):
        raise MXNetError("flash_attention: block_q and block_k must both be "
                         "None or both >= 1, got %r, %r" % (block_q, block_k))


def flash_attention_reference(q, k, v, *, causal=False, sm_scale=None,
                              kv_len=None, block_q=None, block_k=None):
    """Masked, scaled softmax attention in fp32 math, ``(B, H, S, D)``.

    Returns ``(out, lse)``: ``out`` in the input dtype, ``lse`` the fp32
    row logsumexp ``(B, H, Sq)``. Causal masking keeps key column ``j``
    for query row ``i`` iff ``i >= j`` (both from 0); key columns
    ``>= kv_len`` are padding. Masked scores are ``-1e30`` as in the
    kernel. With a tile, the kernels' blocked algorithm: an online
    softmax over key blocks of ``block_k`` up to ``kv_len`` (a block
    masked whole adds exactly nothing, so every query block takes every
    key block; query rows are independent, so ``block_q`` changes no
    value); without one, the whole rows at once."""
    scale = _scale(sm_scale, q.shape[-1])
    kv_len = k.shape[-2] if kv_len is None else int(kv_len)
    _check_blocks(block_q, block_k)
    if block_k is None:
        s = _scores(q, k, scale, causal, kv_len)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out = torch.matmul(p, v.float()) / l_safe
        lse = (m + torch.log(l_safe))[..., 0]
        return out.to(q.dtype), lse
    bk = int(block_k)
    m = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for c0 in range(0, kv_len, bk):
        s = _scores(q, k[..., c0:c0 + bk, :], scale, causal, kv_len, 0, c0)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p, v[..., c0:c0 + bk, :].float())
        m = m_new
    l_safe = l_sum.clamp_min(1e-30)
    out = acc / l_safe[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def attention_delta(out, do):
    """delta = rowsum(dO * O) in fp32, ``(B, H, Sq)``: the term both
    backward kernels subtract from dO . V^T (``_bwd_call``'s ``jnp.sum``)."""
    return (do.float() * out.float()).sum(dim=-1)


def _p_ds(q, k, v, do, lse, delta, scale, causal, kv_len, r0=0, c0=0):
    """The fp32 ``p = exp(s - lse)`` and ``ds = p * (dO . V^T - delta)``
    of query rows ``q`` (from row ``r0``; ``do``, ``lse`` and ``delta``
    the same rows) against keys ``k``, ``v`` (from key ``c0``)."""
    p = torch.exp(_scores(q, k, scale, causal, kv_len, r0, c0)
                  - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def _bwd_plain(q, k, v, do, lse, delta, scale, causal, kv_len, blocks=None):
    """``(dq, dk, dv)`` in the input dtypes from the fp32 p and ds that
    both backward kernels recompute tile by tile. With ``blocks`` =
    ``(block_q, block_k)``, the kernels' sums: dq over key blocks of
    ``block_k`` (B6), dk and dv over query blocks of ``block_q`` (B7)."""
    if blocks is None:
        p, ds = _p_ds(q, k, v, do, lse, delta, scale, causal, kv_len)
        dq = torch.matmul(ds, k.float()) * scale
        dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
        dv = torch.matmul(p.transpose(-1, -2), do.float())
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    bq, bk = (int(b) for b in blocks)
    sq, sk = q.shape[-2], k.shape[-2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, bk):
        kb = k[..., c0:c0 + bk, :]
        _p, ds = _p_ds(q, kb, v[..., c0:c0 + bk, :], do, lse, delta, scale,
                       causal, kv_len, 0, c0)
        dq = dq + torch.matmul(ds, kb.float())
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, sq, bq):
        qb, dob = q[..., r0:r0 + bq, :], do[..., r0:r0 + bq, :]
        p, ds = _p_ds(qb, k, v, dob, lse[..., r0:r0 + bq],
                      delta[..., r0:r0 + bq], scale, causal, kv_len, r0, 0)
        dk = dk + torch.matmul(ds.transpose(-1, -2), qb.float() * scale)
        dv = dv + torch.matmul(p.transpose(-1, -2), dob.float())
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=False,
                                  sm_scale=None, kv_len=None, block_q=None,
                                  block_k=None):
    """The plain backward of :func:`flash_attention_reference`, in fp32
    math: ``(dq, dk, dv)`` in the input dtypes, from the forward's ``out``
    and fp32 ``lse`` and the incoming gradient ``do``. With
    ``p = exp(scale * q . k^T - lse)`` under the forward's masks,
    ``ds = p * (do . v^T - rowsum(do * out))``: ``dq = scale * ds . k``,
    ``dk = ds^T . (scale * q)``, ``dv = p^T . do``; with a tile, summed
    block by block as the kernels sum them (:func:`_bwd_plain`)."""
    scale = _scale(sm_scale, q.shape[-1])
    kv_len = k.shape[-2] if kv_len is None else int(kv_len)
    _check_blocks(block_q, block_k)
    blocks = None if block_q is None else (block_q, block_k)
    return _bwd_plain(q, k, v, do, lse, attention_delta(out, do), scale,
                      causal, kv_len, blocks)


def _check(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k, v must be (B, H, S, D), got "
                         "%s %s %s" % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    b, h, _sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise MXNetError("flash_attention: k/v shapes %s %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPES:
        raise MXNetError("flash_attention: q, k, v must share one dtype of "
                         "float32/bfloat16, got %s %s %s"
                         % (q.dtype, k.dtype, v.dtype))
    if not q.device == k.device == v.device:
        raise MXNetError("flash_attention: q, k, v on different devices")
    if not 1 <= kv_len <= k.shape[2]:
        raise MXNetError("flash_attention: kv_len %d outside [1, %d]"
                         % (kv_len, k.shape[2]))


def _check_bwd(q, k, v, do, lse, delta, kv_len):
    _check(q, k, v, kv_len)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise MXNetError("flash_attention backward: do %s %s must match q "
                         "%s %s" % (tuple(do.shape), do.dtype,
                                    tuple(q.shape), q.dtype))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device:
            raise MXNetError("flash_attention backward: %s must be float32 "
                             "%s on %s, got %s %s on %s"
                             % (name, tuple(q.shape[:3]), q.device,
                                t.dtype, tuple(t.shape), t.device))


def _launch(source, entry, inputs, outputs, scale, causal, kv_len, tile,
            tma_inputs=0):
    """Launch C entry point ``entry`` of ``csrc/<source>.cu`` on
    ``inputs`` (q, k, v first) and preallocated ``outputs`` at ``tile`` =
    ``(block_q, block_k)``. Every entry point takes the pointers, then
    (bh, seq_q, seq_k, d, kv_len, scale, causal, dtype, block_q, block_k,
    stream), and returns cudaGetLastError(). In bfloat16 up to D 256 the
    first ``tma_inputs`` inputs are loaded by TMA, which needs 16-byte
    aligned addresses (``hopper::panel_map`` in ``csrc/hopper_mma.cuh``);
    they are checked here so that a misaligned one raises a clear error.
    The wide route (D above 256) loads without TMA, in 16-byte loads when
    every operand is aligned and element by element otherwise."""
    from ._build import load

    q, k = inputs[0], inputs[1]
    b, h, sq, d = q.shape
    if d != _kernel_head_dim(d, entry):
        raise MXNetError("%s: head dim %d not supported by the CUDA kernel "
                         "(one of %s, or a multiple of %d above them)"
                         % (entry, d, HEAD_DIMS, WIDE_MULTIPLE))
    ok, why = tile_legal(d, q.dtype, tile[0], tile[1], sq, k.shape[2])
    if not ok:
        raise MXNetError("%s: %s" % (entry, why))
    tensors = (*inputs, *outputs)
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("%s: every tensor must be contiguous" % entry)
    if q.dtype == torch.bfloat16 and d <= HEAD_DIMS[-1] and any(
            t.data_ptr() % 16 for t in inputs[:tma_inputs]):
        raise MXNetError("%s: bfloat16 q, k, v%s must start on a 16-byte "
                         "boundary (the tensor-core kernel loads them with "
                         "TMA)" % (entry, ", dout" * (tma_inputs > 3)))
    fn = getattr(load(source), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 5 \
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), b * h, sq, k.shape[2], d,
                 kv_len, float(scale), int(bool(causal)), _DTYPES[q.dtype],
                 int(tile[0]), int(tile[1]), stream)
    if err != 0:
        raise MXNetError("%s launch failed at tile %s: CUDA error %d"
                         % (entry, tuple(tile), err))


def _on(t, what):
    """True on a CUDA tensor (launch the kernel); False on a CPU tensor, or
    a ``meta`` one, which holds shapes only (the plain version)."""
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise MXNetError("%s: unsupported device %s" % (what, t.device))
    return t.device.type == "cuda"


def _padded(what, *ts):
    """``(d, ts)``: the head dim D of ``ts`` (q first) and each of them
    zero-padded to the kernels' width for it (:func:`_kernel_head_dim`)."""
    d = ts[0].shape[-1]
    kd = _kernel_head_dim(d, what)
    return d, [_pad_head_dim(t, kd) for t in ts]


def _sliced(d, *ts):
    """``ts`` with their last dim sliced back to ``d`` (contiguous)."""
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous()
                 for t in ts)


def _card_tile(blocks):
    """The tile a launch runs: ``blocks``, or the hand default."""
    return tuple(blocks) if blocks is not None else (DEFAULT_BLOCK,
                                                     DEFAULT_BLOCK)


def _plain_blocks(blocks):
    return {} if blocks is None else dict(block_q=blocks[0],
                                          block_k=blocks[1])


def _forward(q, k, v, scale, causal, kv_len, blocks=None):
    """B5 on a CUDA tensor, the plain forward on a CPU one."""
    if not _on(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale, kv_len=kv_len,
                                         **_plain_blocks(blocks))
    b, h, sq, _d = q.shape
    d, (q, k, v) = _padded("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "flash_attention_fwd", (q, k, v),
            (out, lse), scale, causal, kv_len, _card_tile(blocks),
            tma_inputs=3)
    _count(flash_attention)
    return _sliced(d, out)[0], lse


def _launch_dq(q, k, v, do, lse, delta, scale, causal, kv_len, tile):
    """B6 on tensors already at the kernels' head dim."""
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd", "flash_attention_bwd_dq",
            (q, k, v, do, lse, delta), (dq,), scale, causal, kv_len, tile,
            tma_inputs=4)
    _count(flash_attention_bwd_dq)
    return dq


def _launch_dkv(q, k, v, do, lse, delta, scale, causal, kv_len, tile):
    """B7 on tensors already at the kernels' head dim."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd", "flash_attention_bwd_dkv",
            (q, k, v, do, lse, delta), (dk, dv), scale, causal, kv_len, tile,
            tma_inputs=4)
    _count(flash_attention_bwd_dkv)
    return dk, dv


def _blocks_arg(block_q, block_k):
    _check_blocks(block_q, block_k)
    return None if block_q is None else (int(block_q), int(block_k))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=False,
                           sm_scale=None, kv_len=None, block_q=None,
                           block_k=None):
    """dq of attention, ``(B, H, Sq, D)`` in q's dtype, from the forward's
    fp32 ``lse`` and :func:`attention_delta`, at the tile ``(block_q,
    block_k)`` (None: the hand default on the card, whole rows on the
    CPU). On a CUDA tensor this launches B6 and adds one to
    ``flash_attention_bwd_dq.launches``; on a CPU tensor it computes the
    same in plain PyTorch."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    blocks = _blocks_arg(block_q, block_k)
    if not _on(q, "flash_attention_bwd_dq"):
        return _bwd_plain(q, k, v, do, lse, delta, scale, causal, kv_len,
                          blocks)[0]
    d, padded = _padded("flash_attention_bwd_dq", q, k, v, do)
    return _sliced(d, _launch_dq(*padded, lse, delta, scale, causal,
                                 kv_len, _card_tile(blocks)))[0]


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=False,
                            sm_scale=None, kv_len=None, block_q=None,
                            block_k=None):
    """``(dk, dv)`` of attention, each ``(B, H, Sk, D)`` in k's dtype; key
    rows at or past ``kv_len`` get zeros. The tile as in
    :func:`flash_attention_bwd_dq`. On a CUDA tensor this launches B7 and
    adds one to ``flash_attention_bwd_dkv.launches``; on a CPU tensor it
    computes the same in plain PyTorch."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    blocks = _blocks_arg(block_q, block_k)
    if not _on(q, "flash_attention_bwd_dkv"):
        return _bwd_plain(q, k, v, do, lse, delta, scale, causal, kv_len,
                          blocks)[1:]
    d, padded = _padded("flash_attention_bwd_dkv", q, k, v, do)
    return _sliced(d, *_launch_dkv(*padded, lse, delta, scale, causal,
                                   kv_len, _card_tile(blocks)))


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=False,
                        sm_scale=None, kv_len=None, block_q=None,
                        block_k=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` (counterpart of
    ``_bwd_call``) at the tile ``(block_q, block_k)``. On a CUDA tensor:
    delta as a PyTorch reduction, then B6 and B7 on q, k, v and do padded
    once; on a CPU tensor, :func:`flash_attention_bwd_reference`."""
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len,
              block_q=block_q, block_k=block_k)
    if not _on(q, "flash_attention_bwd"):
        return flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    delta = attention_delta(out, do)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    tile = _card_tile(_blocks_arg(block_q, block_k))
    d, padded = _padded("flash_attention_bwd", q, k, v, do)
    args = (*padded, lse, delta, scale, causal, kv_len, tile)
    return _sliced(d, _launch_dq(*args), *_launch_dkv(*args))


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom VJP: the forward saves q,
    k, v, out and lse; the backward recomputes p from lse (no (S, S)
    residual) at the forward's tile. ``lse`` is an output but not
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len, blocks):
        out, lse = _forward(q, k, v, scale, causal, kv_len, blocks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (scale, causal, kv_len, blocks)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, kv_len, blocks = ctx.attrs
        # dout comes out of an einsum's backward and may be strided
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=causal, sm_scale=scale,
                                         kv_len=kv_len,
                                         **_plain_blocks(blocks))
        return dq, dk, dv, None, None, None, None


def _resolve_blocks(q, k, causal, block_q, block_k):
    """The tile of one call: explicit ``block_q``/``block_k`` win (a tile
    the kernels do not take raises on the card); the rest comes from the
    schedule table (``tune.schedule_for``) or the hand default. Returns
    None for the hand default with no entry (the plain versions then take
    whole rows). A table entry that does not fit the shape counts a
    ``fallback_illegal`` and runs the hand default."""
    if block_q is not None and block_k is not None:
        return int(block_q), int(block_k)
    if q.device.type == "meta":
        return None
    from .. import profiler
    from ..tune import table

    b, h, sq, d = q.shape
    shape = (b, h, sq, k.shape[2], d, int(bool(causal)))
    dtype, backend = table.dtype_name(q.dtype), table.backend_of(q)
    sched = table.schedule_for("flash_attention", shape, dtype, backend)
    if not sched and block_q is None and block_k is None:
        return None
    sched = sched or {}
    bq = block_q if block_q is not None else sched.get("block_q",
                                                       DEFAULT_BLOCK)
    bk = block_k if block_k is not None else sched.get("block_k",
                                                       DEFAULT_BLOCK)
    if sched and not tile_legal(d, q.dtype, bq, bk, sq, k.shape[2])[0]:
        profiler.tuning_record(
            fallbacks=1, kernel=table.make_key("flash_attention", shape,
                                               dtype, backend),
            schedule=None, source="fallback_illegal")
        bq = DEFAULT_BLOCK if block_q is None else block_q
        bk = DEFAULT_BLOCK if block_k is None else block_k
    return int(bq), int(bk)


def flash_attention(q, k, v, *, causal=False, sm_scale=None, kv_len=None,
                    return_lse=False, block_q=None, block_k=None):
    """Fused attention, ``(B, H, S, D)`` layout, differentiable in q, k, v.

    ``kv_len`` (default ``Sk``) marks key columns ``>= kv_len`` as
    padding. ``block_q``/``block_k`` are the tile of the forward and both
    backward kernels; left None, the schedule table is consulted for this
    (shape, dtype, backend), key ``flash_attention``, falling back to 64
    (see the module docstring). On a CUDA tensor the forward launches B5
    (any D: run at 64, 128 or 256 lanes, or a multiple of 128 above
    them; float32 or bfloat16) and
    adds one to ``flash_attention.launches``, and the backward launches B6
    and B7; on a CPU tensor both run the plain versions. Returns ``out``,
    or ``(out, lse)`` with ``return_lse`` (``lse`` carries no
    gradient)."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    blocks = _resolve_blocks(q, k, causal, block_q, block_k)
    out, lse = _FlashAttention.apply(q, k, v, scale, bool(causal), kv_len,
                                     blocks)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
