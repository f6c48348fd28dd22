"""Flash attention of the PyTorch port, forward and backward, against the
JAX package.

The port's plain versions (``flash_attention_reference`` and
``flash_attention_bwd_reference``, what the wrappers run on a CPU tensor)
are held against the Pallas kernels run in interpret mode (``_fwd_call``,
which also returns the logsumexp rows, and ``_bwd_call``) and against
``full_attention``, on the same numpy inputs; the port's autograd
gradients against ``jax.grad``. Tolerance rtol 1e-5 / atol 1e-5: both
sides are fp32 and differ only in summation order.

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.kernels.flash_attention import _bwd_call, _fwd_call
from mxnet_tpu.kernels.flash_attention import flash_attention as jax_flash
from mxnet_tpu.parallel.ring import full_attention
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, bh, sq, sk, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(bh, sq, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32),
            rng.randn(bh, sk, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(a)[None]          # (BH, S, D) -> (1, BH, S, D)


# (bh, sq, sk, d, causal, kv_len, block_q, block_k)
CASES = [
    (2, 48, 48, 16, True, 48, 16, 16),        # causal, square
    (2, 32, 32, 8, False, 32, 16, 8),         # full
    (3, 40, 56, 16, True, 50, 8, 8),          # uneven Sq/Sk + kv_len mask
    (2, 24, 40, 8, False, 17, 8, 8),          # kv_len mask, non-causal
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_reference_matches_pallas_interpret(case):
    bh, sq, sk, d, causal, kv_len, bq, bk = case
    q, k, v = _qkv(0, bh, sq, sk, d)
    scale = 1.0 / d ** 0.5
    o_j, lse_j = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale, causal, bq, bk, True, kv_len)
    o_t, lse_t = flash_attention_reference(_t(q), _t(k), _t(v),
                                           causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(o_t[0].numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse_t[0].numpy(), np.asarray(lse_j)[..., 0],
                               **TOL)
    # lse is the logsumexp of the masked, scaled scores
    s = torch.matmul(_t(q) * scale, _t(k).transpose(-1, -2))
    cols = torch.arange(sk)
    ok = (cols < kv_len)[None, :]
    if causal:
        ok = ok & (torch.arange(sq)[:, None] >= cols[None, :])
    s = s.masked_fill(~ok, float("-inf"))
    np.testing.assert_allclose(lse_t.numpy(),
                               torch.logsumexp(s, dim=-1).numpy(), **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_bwd_reference_matches_pallas_interpret(case):
    """The plain backward against ``_bwd_call`` (B6 and B7 in interpret
    mode), both fed the ``out`` and ``lse`` of the Pallas forward."""
    bh, sq, sk, d, causal, kv_len, bq, bk = case
    q, k, v = _qkv(0, bh, sq, sk, d)
    do = np.random.RandomState(7).randn(bh, sq, d).astype(np.float32)
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_j, lse_j = _fwd_call(jq, jk, jv, scale, causal, bq, bk, True, kv_len)
    want = _bwd_call(jq, jk, jv, jdo, o_j, lse_j, scale, causal, bq, bk,
                     True, kv_len)
    got = flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(np.asarray(o_j)),
        torch.from_numpy(np.asarray(lse_j)[..., 0])[None], _t(do),
        causal=causal, kv_len=kv_len)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    # key rows past kv_len are padding: zero gradients
    assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(causal):
    """``torch.autograd.grad`` through the port's ``flash_attention`` (the
    autograd Function, plain backward on the CPU) against ``jax.grad`` of
    the JAX package's flash kernel in interpret mode and of
    ``full_attention``, for a random cotangent."""
    rng = np.random.RandomState(11)
    q, k, v, w = (rng.randn(1, 2, 48, 16).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    args = tuple(map(jnp.asarray, (q, k, v)))
    for attn in (lambda *a: jax_flash(*a, causal=causal, interpret=True),
                 lambda *a: full_attention(*a, causal=causal)):
        want = jax.grad(lambda *a: (attn(*a) * w).sum(),
                        argnums=(0, 1, 2))(*args)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_cpu_backward_wrappers_take_the_plain_version_without_launching():
    q, k, v = (_t(a) for a in _qkv(5, 2, 24, 40, 8))
    do = _t(np.random.RandomState(6).randn(2, 24, 8).astype(np.float32))
    kw = dict(causal=True, kv_len=30)
    out, lse = flash_attention_reference(q, k, v, **kw)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    for a, b in zip(ref, (dq, dk, dv)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == before
    with pytest.raises(MXNetError, match="lse"):
        flash_attention_bwd_dq(q, k, v, do, lse.double(), delta, **kw)


def test_serving_under_inference_mode_builds_no_graph():
    q, k, v = (_t(a).requires_grad_() for a in _qkv(8, 2, 16, 16, 8))
    with torch.inference_mode():
        out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and not out.requires_grad
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad


def test_bf16_backward_keeps_the_input_dtype():
    q, k, v = (_t(a).bfloat16().requires_grad_()
               for a in _qkv(9, 2, 16, 16, 8))
    out = flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 for g in grads)
    f32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out32 = flash_attention(*f32, causal=True)
    refs = torch.autograd.grad(out32.square().sum(), f32)
    for g, r in zip(grads, refs):      # bf16 in and out: a few bf16 ulps
        np.testing.assert_allclose(g.float().numpy(), r.numpy(),
                                   atol=5e-2 * r.abs().max().item())


@pytest.mark.parametrize("causal", [True, False])
def test_public_wrapper_matches_jax_flash_and_full_attention(causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 48, 16).astype(np.float32) for _ in range(3))
    ours = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    args = tuple(map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jax_flash(*args, causal=causal,
                                           interpret=True)), **TOL)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(full_attention(*args, causal=causal)), **TOL)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    q, k, v = (_t(a) for a in _qkv(1, 2, 16, 16, 8))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.launches == before
    assert out.dtype == torch.float32 and lse.shape == (1, 2, 16)


def test_bf16_in_bf16_out_with_fp32_lse():
    q, k, v = (_t(a).bfloat16() for a in _qkv(2, 2, 16, 16, 8))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = flash_attention_reference(q.float(), k.float(), v.float(),
                                       causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=1e-2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "kv_len"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (_t(a) for a in _qkv(4, 2, 16, 16, 8))
    kw = {}
    if bad == "dtype":
        k = k.bfloat16()
    elif bad == "shape":
        v = v[:, :, :8]
    else:
        kw["kv_len"] = 0
    with pytest.raises(MXNetError):
        flash_attention(q, k, v, **kw)
