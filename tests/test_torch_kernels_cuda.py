"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it
also runs where JAX is not installed (the card's machine), without the
JAX-setting conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py

Tolerances. Each row of an output (a query row of out and dq, a key row
of dk and dv) is held against that row's own scale, max_d |x - ref| /
max_d |ref|: 2**-6 (two bf16 ulps) in bf16 and 1e-4 in fp32 (summation
order only), so rows whose values are small, as out is over thousands
of keys, are held as tightly as the rest. The scale is clamped from
below at 1% of the tensor's largest |ref|: a row whose exact value is 0
(dq of query row 0 under causal, where one live key gives ds = 0) comes
out of both sides as rounding noise of ~1e-7, which has no scale of its
own. lse is fp32 on both sides: 1e-3 absolute.
"""
import pytest
import torch

from mxnet_tpu_torch.kernels.flash_attention import (
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# (b, h, sq, sk, d, causal, kv_len)
SHAPES = [(1, 8, 200, 200, 64, True, 200), (2, 4, 96, 160, 128, False, 130),
          (1, 2, 150, 100, 64, True, 77)]


def _row_err(x, ref):
    """Largest row error relative to the row's own scale (clamped at 1% of
    the tensor's largest |ref|)."""
    diff = (x.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    floor = max(1e-2 * scale.max().item(), 1e-30)
    return (diff / scale.clamp_min(floor)).max().item()


def _inputs(gen, b, h, sq, sk, d, dt):
    return [torch.randn(b, h, s, d, device="cuda", generator=gen).to(dt)
            for s in (sq, sk, sk, sq)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_the_card(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, sq, sk, d, causal, kv_len) in SHAPES:
        q, k, v, _do = _inputs(gen, b, h, sq, sk, d, dt)
        before = flash_attention.launches
        out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                   return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                                 kv_len=kv_len)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert _row_err(out, ref) <= ROW_TOL[dt]
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_on_the_card(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (b, h, sq, sk, d, causal, kv_len) in SHAPES:
        q, k, v, do = _inputs(gen, b, h, sq, sk, d, dt)
        kw = dict(causal=causal, kv_len=kv_len)
        out, lse = flash_attention_reference(q, k, v, **kw)
        refs = flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
        before = (flash_attention_bwd_dq.launches,
                  flash_attention_bwd_dkv.launches)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert (flash_attention_bwd_dq.launches,
                flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                      before[1] + 1)
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            assert g.dtype == dt and g.shape == r.shape, name
            assert _row_err(g, r) <= ROW_TOL[dt], name
        # key rows past kv_len are padding: zero gradients
        assert not got[1][:, :, kv_len:].any()
        assert not got[2][:, :, kv_len:].any()
        # the wrappers take delta from the caller and match the pair
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        assert torch.equal(dq, got[0]) and torch.equal(dk, got[1]) \
            and torch.equal(dv, got[2])


@pytest.mark.cuda
def test_autograd_on_the_card_launches_the_backward_kernels():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, w = (t.requires_grad_(i < 3) for i, t in enumerate(
        _inputs(gen, 2, 4, 128, 128, 64, torch.float32)))
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out = flash_attention(q, k, v, causal=True)
    # a transposed cotangent reaches the backward non-contiguous
    grads = torch.autograd.grad((out.transpose(1, 2) *
                                 w.transpose(1, 2)).sum(), (q, k, v))
    ref = flash_attention_reference(q, k, v, causal=True)[0]
    refs = torch.autograd.grad((ref * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    for g, r in zip(grads, refs):
        assert _row_err(g, r) <= ROW_TOL[torch.float32]
