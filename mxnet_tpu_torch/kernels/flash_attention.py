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
aligned); in float32 they run on the CUDA cores. A
CPU tensor goes to the plain versions, :func:`flash_attention_reference` and
:func:`flash_attention_bwd_reference`. There is no fallback: a build or
launch failure on a CUDA tensor raises.

Each kernel's wrapper counts its launches in a plain integer,
``flash_attention.launches`` (B5), ``flash_attention_bwd_dq.launches``
(B6) and ``flash_attention_bwd_dkv.launches`` (B7).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def _scale(sm_scale, d):
    return sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)


def _live(sq, sk, causal, kv_len, device):
    """(Sq, Sk) bool: key column ``j`` is live for query row ``i`` iff
    ``j < kv_len`` and, under ``causal``, ``i >= j`` (both from 0)."""
    cols = torch.arange(sk, device=device)
    ok = (cols < kv_len)[None, :]
    if causal:
        rows = torch.arange(sq, device=device)
        ok = ok & (rows[:, None] >= cols[None, :])
    return ok


def _scores(q, k, scale, causal, kv_len):
    """fp32 ``scale * q . k^T`` with masked entries at -1e30, as in the
    kernels."""
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    ok = _live(q.shape[-2], k.shape[-2], causal, kv_len, q.device)
    return torch.where(ok, s, torch.tensor(_NEG_INF, device=q.device))


def flash_attention_reference(q, k, v, *, causal=False, sm_scale=None,
                              kv_len=None):
    """Masked, scaled softmax attention in fp32 math, ``(B, H, S, D)``.

    Returns ``(out, lse)``: ``out`` in the input dtype, ``lse`` the fp32
    row logsumexp ``(B, H, Sq)``. Causal masking keeps key column ``j``
    for query row ``i`` iff ``i >= j`` (both from 0); key columns
    ``>= kv_len`` are padding. Masked scores are ``-1e30`` as in the
    kernel."""
    scale = _scale(sm_scale, q.shape[-1])
    kv_len = k.shape[-2] if kv_len is None else int(kv_len)
    s = _scores(q, k, scale, causal, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def attention_delta(out, do):
    """delta = rowsum(dO * O) in fp32, ``(B, H, Sq)``: the term both
    backward kernels subtract from dO . V^T (``_bwd_call``'s ``jnp.sum``)."""
    return (do.float() * out.float()).sum(dim=-1)


def _bwd_plain(q, k, v, do, lse, delta, scale, causal, kv_len):
    """``(dq, dk, dv)`` in the input dtypes from the fp32 ``p = exp(s -
    lse)`` and ``ds = p * (dO . V^T - delta)`` that both backward kernels
    recompute tile by tile."""
    p = torch.exp(_scores(q, k, scale, causal, kv_len) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal=False,
                                  sm_scale=None, kv_len=None):
    """The plain backward of :func:`flash_attention_reference`, in fp32
    math: ``(dq, dk, dv)`` in the input dtypes, from the forward's ``out``
    and fp32 ``lse`` and the incoming gradient ``do``. With
    ``p = exp(scale * q . k^T - lse)`` under the forward's masks,
    ``ds = p * (do . v^T - rowsum(do * out))``: ``dq = scale * ds . k``,
    ``dk = ds^T . (scale * q)``, ``dv = p^T . do``."""
    scale = _scale(sm_scale, q.shape[-1])
    kv_len = k.shape[-2] if kv_len is None else int(kv_len)
    return _bwd_plain(q, k, v, do, lse, attention_delta(out, do), scale,
                      causal, kv_len)


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


def _launch(source, entry, inputs, outputs, scale, causal, kv_len,
            tma_inputs=0):
    """Launch C entry point ``entry`` of ``csrc/<source>.cu`` on
    ``inputs`` (q, k, v first) and preallocated ``outputs``. Every entry
    point takes the pointers, then (bh, seq_q, seq_k, d, kv_len, scale,
    causal, dtype, stream), and returns cudaGetLastError(). In bfloat16 the
    first ``tma_inputs`` inputs are loaded by TMA, which needs 16-byte
    aligned addresses (``hopper::panel_map`` in ``csrc/hopper_mma.cuh``);
    they are checked here so that a misaligned one raises a clear error."""
    from ._build import load

    q, k = inputs[0], inputs[1]
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise MXNetError("%s: head dim %d not supported by the CUDA kernel "
                         "(one of %s)" % (entry, d, HEAD_DIMS))
    if -(-max(sq, k.shape[2]) // 64) > 65535:
        # B*H rides the grid's x; the 64-row query or key blocks its y
        raise MXNetError("%s: %d rows exceed the kernel's grid limit of "
                         "65535 blocks of 64" % (entry, max(sq, k.shape[2])))
    tensors = (*inputs, *outputs)
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("%s: every tensor must be contiguous" % entry)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in inputs[:tma_inputs]):
        raise MXNetError("%s: bfloat16 q, k, v%s must start on a 16-byte "
                         "boundary (the tensor-core kernel loads them with "
                         "TMA)" % (entry, ", dout" * (tma_inputs > 3)))
    fn = getattr(load(source), entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), b * h, sq, k.shape[2], d,
                 kv_len, float(scale), int(bool(causal)), _DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise MXNetError("%s launch failed: CUDA error %d" % (entry, err))


def _on(t, what):
    if t.device.type not in ("cuda", "cpu"):
        raise MXNetError("%s: unsupported device %s" % (what, t.device))
    return t.device.type == "cuda"


def _forward(q, k, v, scale, causal, kv_len):
    """B5 on a CUDA tensor, the plain forward on a CPU one."""
    if not _on(q, "flash_attention"):
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale, kv_len=kv_len)
    b, h, sq, _d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", "flash_attention_fwd", (q, k, v),
            (out, lse), scale, causal, kv_len, tma_inputs=3)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal=False,
                           sm_scale=None, kv_len=None):
    """dq of attention, ``(B, H, Sq, D)`` in q's dtype, from the forward's
    fp32 ``lse`` and :func:`attention_delta`. On a CUDA tensor this
    launches B6 and adds one to ``flash_attention_bwd_dq.launches``; on a
    CPU tensor it computes the same in plain PyTorch."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    if not _on(q, "flash_attention_bwd_dq"):
        return _bwd_plain(q, k, v, do, lse, delta, scale, causal, kv_len)[0]
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd", "flash_attention_bwd_dq",
            (q, k, v, do, lse, delta), (dq,), scale, causal, kv_len,
            tma_inputs=4)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal=False,
                            sm_scale=None, kv_len=None):
    """``(dk, dv)`` of attention, each ``(B, H, Sk, D)`` in k's dtype; key
    rows at or past ``kv_len`` get zeros. On a CUDA tensor this launches
    B7 and adds one to ``flash_attention_bwd_dkv.launches``; on a CPU
    tensor it computes the same in plain PyTorch."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    if not _on(q, "flash_attention_bwd_dkv"):
        return _bwd_plain(q, k, v, do, lse, delta, scale, causal,
                          kv_len)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd", "flash_attention_bwd_dkv",
            (q, k, v, do, lse, delta), (dk, dv), scale, causal, kv_len,
            tma_inputs=4)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=False,
                        sm_scale=None, kv_len=None):
    """``(dq, dk, dv)`` of :func:`flash_attention` (counterpart of
    ``_bwd_call``). On a CUDA tensor: delta as a PyTorch reduction, then
    B6 and B7; on a CPU tensor, :func:`flash_attention_bwd_reference`."""
    kw = dict(causal=causal, sm_scale=sm_scale, kv_len=kv_len)
    if not _on(q, "flash_attention_bwd"):
        return flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash`` custom VJP: the forward saves q,
    k, v, out and lse; the backward recomputes p from lse (no (S, S)
    residual). ``lse`` is an output but not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len):
        out, lse = _forward(q, k, v, scale, causal, kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (scale, causal, kv_len)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, kv_len = ctx.attrs
        # dout comes out of an einsum's backward and may be strided
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=causal, sm_scale=scale,
                                         kv_len=kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=False, sm_scale=None, kv_len=None,
                    return_lse=False):
    """Fused attention, ``(B, H, S, D)`` layout, differentiable in q, k, v.

    ``kv_len`` (default ``Sk``) marks key columns ``>= kv_len`` as
    padding. On a CUDA tensor the forward launches B5 (D of 64 or 128,
    float32 or bfloat16) and adds one to ``flash_attention.launches``, and
    the backward launches B6 and B7; on a CPU tensor both run the plain
    versions. Returns ``out``, or ``(out, lse)`` with ``return_lse``
    (``lse`` carries no gradient)."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    scale = _scale(sm_scale, q.shape[3])
    out, lse = _FlashAttention.apply(q, k, v, scale, bool(causal), kv_len)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
