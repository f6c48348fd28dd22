"""The rounding of the tensor-core (bf16) flash-attention kernels, on the CPU.

B5, B6 and B7 run their bf16 products on the tensor cores, which take bf16
operands: the forward rounds P to bf16 before P . V, the dQ kernel rounds
dS to bf16 before dS . K and the dK/dV kernel rounds P^T and dS^T to bf16
before P^T . dO and dS^T . Q; dQ and dK are multiplied by the scale at the
end. The TPU kernels and the port's plain versions keep those in fp32.
This file holds a plain-PyTorch model of exactly that rounding
(``_tc_forward``, ``_tc_bwd_dq``, ``_tc_bwd_dkv``) against the JAX
package's Pallas kernels in interpret mode (``_fwd_call``, ``_bwd_call``)
and against the port's plain versions, on bf16 inputs made from a numpy
seed. It shows on
the CPU that the added rounding fits the limits the card run holds the
kernels to (``chip_smoke.py``'s ``KERNEL_TOL`` and ``BWD_TOL``): each row
within 2**-6 of its own scale, gradient rows with the scale floored at 1%
of the tensor's largest; lse within 1e-3.

The kernels themselves run only on the card (``tests/test_torch_kernels_cuda
.py``).

Head dims the kernels are not built for (C9, C11, C12): on the card the
dispatcher zero-pads D to 64, 128 or 256, and above 256 to a multiple of
128 (the wide route) (``_pad_head_dim``), keeps the scale of the unpadded
D and slices the outputs back. The padded route, run through the plain
versions on the CPU, is held against the JAX ``flash_attention`` (which
pads D to a multiple of 128 lanes) in interpret mode at D 8 (rtol 1e-5 /
atol 1e-5) and at D 192, 256, 320 and 384 at the default tile (rtol 1e-4
/ atol 1e-5), forward and ``jax.vjp`` gradient (fp32 both sides); the
``cuda`` cases hold B5, B6 and B7 at D 8, 32, 96, 192, 256, 320, 384 and
512 against the plain versions on the card, within the limits above
(1e-4 per row in fp32). Every tile at D 64, 128
and 256 is a ``cuda`` case of ``tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.kernels.flash_attention import _bwd_call, _fwd_call
from mxnet_tpu.kernels.flash_attention import flash_attention as jax_flash
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_reference,
)

ROW_TOL, LSE_TOL, FLOOR = 2.0 ** -6, 1e-3, 1e-2
TILE = 64      # the kernels' key tile (B5) and query tile (B7)


def _row_err(x, ref, floor=0.0):
    """max_d |x - ref| / max_d |ref| over rows, the scale clamped at
    ``floor`` of the largest row's."""
    x, ref = (torch.tensor(np.asarray(a, np.float32)) for a in (x, ref))
    diff = (x - ref).abs().amax(-1)
    scale = ref.abs().amax(-1)
    return (diff / scale.clamp_min(max(floor * scale.max().item(),
                                       1e-6))).max().item()


def _live(sq, sk, causal, kv_len):
    ok = (torch.arange(sk) < kv_len)[None, :]
    if causal:
        ok = ok & (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :])
    return ok


def _tc_forward(q, k, v, scale, causal, kv_len):
    """B5's bf16 numerics over (BH, S, D): per 64-key tile, fp32 scores of
    the bf16 operands times scale, an fp32 online softmax, P rounded to
    bf16 for P . V; out rounded once to bf16, fp32 lse."""
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, sq, d = q.shape
    live = _live(sq, k.shape[1], causal, kv_len)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    o = torch.zeros((bh, sq, d))
    for c0 in range(0, kv_len, TILE):
        cols = slice(c0, c0 + TILE)
        s = torch.matmul(qf, kf[:, cols].transpose(-1, -2)) * scale
        s = torch.where(live[:, cols], s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(p.bfloat16().float(), vf[:, cols])
        m = m_new
    l = l.clamp_min(1e-30)
    return (o / l).bfloat16(), (m + torch.log(l))[..., 0]


def _tc_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len):
    """B6's bf16 numerics: fp32 p and dS from the bf16 operands, dS rounded
    to bf16 for dS . K, dQ scaled at the end and rounded once to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    live = _live(q.shape[1], k.shape[1], causal, kv_len)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    return (torch.matmul(ds.bfloat16().float(), kf) * scale).bfloat16()


def _tc_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len):
    """B7's bf16 numerics: fp32 P^T and dS^T from the bf16 operands, both
    rounded to bf16 for the products over queries, dK scaled at the end,
    rows >= kv_len zero; dk and dv rounded once to bf16."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    live = _live(q.shape[1], k.shape[1], causal, kv_len)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.tensor(0.0))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.bfloat16().float().transpose(-1, -2), qf) * scale
    dv[:, kv_len:] = 0
    dk[:, kv_len:] = 0
    return dk.bfloat16(), dv.bfloat16()


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# (bh, sq, sk, d, causal, kv_len): causal and not, kv_len below Sk, ragged
# Sq (1, 17, 100), D of 64 and 128
CASES = [
    (2, 128, 128, 64, True, 128),
    (2, 128, 192, 64, False, 150),
    (2, 1, 64, 64, False, 50),
    (2, 17, 17, 64, True, 17),
    (2, 100, 128, 64, True, 100),
    (2, 100, 100, 128, True, 100),
    (2, 17, 80, 128, False, 70),
    (1, 64, 128, 128, False, 128),
]


def _blocks(sq, sk):
    """Pallas blocks that divide the shapes (interpret mode has no tiling
    rule of its own)."""
    return (TILE if sq % TILE == 0 else sq), (TILE if sk % TILE == 0 else sk)


def _case_id(c):
    return "x".join(map(str, c))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tc_forward_model_fits_the_limits(case):
    bh, sq, sk, d, causal, kv_len = case
    rng = np.random.RandomState(sq * 7 + sk + d)
    q, k, v = _bf16(rng, bh, sq, d), _bf16(rng, bh, sk, d), \
        _bf16(rng, bh, sk, d)
    scale = d ** -0.5
    out, lse = _tc_forward(q, k, v, scale, causal, kv_len)
    bq, bk = _blocks(sq, sk)
    o_j, lse_j = _fwd_call(_jnp(q), _jnp(k), _jnp(v), scale, causal, bq, bk,
                           True, kv_len)
    ref, ref_lse = flash_attention_reference(q[None], k[None], v[None],
                                             causal=causal, kv_len=kv_len)
    for want, want_lse in ((np.asarray(o_j.astype(jnp.float32)),
                            np.asarray(lse_j)[..., 0]),
                           (ref[0].float().numpy(), ref_lse[0].numpy())):
        assert _row_err(out.float(), want) <= ROW_TOL
        assert np.abs(lse.numpy() - want_lse).max() <= LSE_TOL


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tc_bwd_dkv_model_fits_the_limits(case):
    bh, sq, sk, d, causal, kv_len = case
    rng = np.random.RandomState(sq * 5 + sk + d)
    q, k, v, do = _bf16(rng, bh, sq, d), _bf16(rng, bh, sk, d), \
        _bf16(rng, bh, sk, d), _bf16(rng, bh, sq, d)
    scale = d ** -0.5
    bq, bk = _blocks(sq, sk)
    o_j, lse_j = _fwd_call(_jnp(q), _jnp(k), _jnp(v), scale, causal, bq, bk,
                           True, kv_len)
    _dq, dk_j, dv_j = _bwd_call(_jnp(q), _jnp(k), _jnp(v), _jnp(do), o_j,
                                lse_j, scale, causal, bq, bk, True, kv_len)
    out = torch.from_numpy(np.asarray(o_j.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0])
    delta = (do.float() * out.float()).sum(-1)
    dk, dv = _tc_bwd_dkv(q, k, v, do, lse, delta, scale, causal, kv_len)
    _, rk, rv = flash_attention_bwd_reference(
        q[None], k[None], v[None], out[None], lse[None], do[None],
        causal=causal, kv_len=kv_len)
    for want_k, want_v in ((np.asarray(dk_j.astype(jnp.float32)),
                            np.asarray(dv_j.astype(jnp.float32))),
                           (rk[0].float().numpy(), rv[0].float().numpy())):
        assert _row_err(dk.float(), want_k, FLOOR) <= ROW_TOL
        assert _row_err(dv.float(), want_v, FLOOR) <= ROW_TOL
    assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tc_bwd_dq_model_fits_the_limits(case):
    bh, sq, sk, d, causal, kv_len = case
    rng = np.random.RandomState(sq * 3 + sk + d)
    q, k, v, do = _bf16(rng, bh, sq, d), _bf16(rng, bh, sk, d), \
        _bf16(rng, bh, sk, d), _bf16(rng, bh, sq, d)
    scale = d ** -0.5
    bq, bk = _blocks(sq, sk)
    o_j, lse_j = _fwd_call(_jnp(q), _jnp(k), _jnp(v), scale, causal, bq, bk,
                           True, kv_len)
    dq_j, _dk, _dv = _bwd_call(_jnp(q), _jnp(k), _jnp(v), _jnp(do), o_j,
                               lse_j, scale, causal, bq, bk, True, kv_len)
    out = torch.from_numpy(np.asarray(o_j.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.asarray(lse_j)[..., 0])
    delta = (do.float() * out.float()).sum(-1)
    dq = _tc_bwd_dq(q, k, v, do, lse, delta, scale, causal, kv_len)
    rq, _rk, _rv = flash_attention_bwd_reference(
        q[None], k[None], v[None], out[None], lse[None], do[None],
        causal=causal, kv_len=kv_len)
    for want in (np.asarray(dq_j.astype(jnp.float32)), rq[0].float().numpy()):
        assert _row_err(dq.float(), want, FLOOR) <= ROW_TOL


# ---------------------------------------------------------------------------
# head dims other than 64 and 128 (C9)
# ---------------------------------------------------------------------------
def test_kernel_head_dim_pads_up_and_refuses_above_128():
    """D pads up to the next of 64, 128 and 256 (C11 repaired the raise
    above 128), and above 256 to the next multiple of 128, the wide route
    (C12 repaired the raise above 256); only a D below 1 raises. The wide
    route takes the hand tile (64, 64) alone."""
    assert [tfa._kernel_head_dim(d, "x") for d in (1, 8, 32, 64, 65, 96,
                                                   128, 129, 192, 256)] == \
        [64, 64, 64, 64, 128, 128, 128, 256, 256, 256]
    assert [tfa._kernel_head_dim(d, "x") for d in (257, 320, 384, 385, 512,
                                                   1000)] == \
        [384, 384, 384, 512, 512, 1024]
    with pytest.raises(MXNetError, match="head dim 0"):
        tfa._kernel_head_dim(0, "flash_attention")
    for dt in (torch.bfloat16, torch.float32):
        assert tfa.tile_legal(257, dt, 64, 64, 8, 8)[0]
        assert not tfa.tile_legal(512, dt, 128, 64, 8, 8)[0]
    t = torch.randn(2, 3, 5, 8)
    p = tfa._pad_head_dim(t, 64)
    assert p.shape == (2, 3, 5, 64) and p.is_contiguous()
    assert torch.equal(p[..., :8], t) and not p[..., 8:].any()
    assert tfa._pad_head_dim(p, 64) is p


@pytest.mark.parametrize("causal", [True, False])
def test_padded_route_matches_jax_flash_attention_at_d8(causal):
    """The card's route for D 8, run through the plain versions: q, k, v
    (and dout) zero-padded to 64 lanes, the scale of D 8, out, dq, dk and
    dv sliced back; against the JAX ``flash_attention`` (D padded to 128
    lanes) and its ``jax.vjp``."""
    rng = np.random.RandomState(8 + causal)
    q, k, v, do = (rng.randn(1, 2, 40, 8).astype(np.float32)
                   for _ in range(4))
    kd = tfa._kernel_head_dim(8, "test")
    scale = tfa._scale(None, 8)
    tq, tk, tv, tdo = (tfa._pad_head_dim(torch.from_numpy(a), kd)
                       for a in (q, k, v, do))
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal,
                                         sm_scale=scale)
    grads = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                          causal=causal, sm_scale=scale)
    want, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal,
                                             interpret=True),
                        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out[..., :8].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert not out[..., 8:].any()
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g[..., :8].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    # and the unpadded plain version, which runs any D on the CPU
    ref, ref_lse = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    torch.testing.assert_close(out[..., :8], ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_route_matches_jax_flash_attention_at_d192_d256(causal, d):
    """C11: the card's route for D 192 and 256 (padded to 256 lanes, the
    scale of the unpadded D), run through the plain versions at the
    default tile (64, 64), against the JAX ``flash_attention`` (D padded to
    256 lanes) at the same blocks, forward and ``jax.vjp`` gradient (fp32
    both sides, rtol 1e-4 / atol 1e-5)."""
    rng = np.random.RandomState(d + causal)
    q, k, v, do = (rng.randn(1, 2, 128, d).astype(np.float32)
                   for _ in range(4))
    kd = tfa._kernel_head_dim(d, "test")
    assert kd == 256
    scale = tfa._scale(None, d)
    tq, tk, tv, tdo = (tfa._pad_head_dim(torch.from_numpy(a), kd)
                       for a in (q, k, v, do))
    blocks = dict(block_q=64, block_k=64)
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal,
                                         sm_scale=scale, **blocks)
    grads = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                          causal=causal, sm_scale=scale,
                                          **blocks)
    want, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal,
                                             interpret=True, **blocks),
                        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert not out[..., d:].any()
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g[..., :d].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [320, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_padded_route_matches_jax_flash_attention_above_256(causal, d):
    """C12: the card's route for D 320 and 384 (the wide route, padded to
    384 lanes, the scale of the unpadded D), run through the plain
    versions at the hand tile (64, 64), against the JAX
    ``flash_attention`` (D padded to 384 lanes) at the same blocks,
    forward and ``jax.vjp`` gradient (fp32 both sides, rtol 1e-4 / atol
    1e-5)."""
    rng = np.random.RandomState(d + causal)
    q, k, v, do = (rng.randn(1, 2, 96, d).astype(np.float32)
                   for _ in range(4))
    kd = tfa._kernel_head_dim(d, "test")
    assert kd == 384
    scale = tfa._scale(None, d)
    tq, tk, tv, tdo = (tfa._pad_head_dim(torch.from_numpy(a), kd)
                       for a in (q, k, v, do))
    blocks = dict(block_q=64, block_k=64)
    out, lse = flash_attention_reference(tq, tk, tv, causal=causal,
                                         sm_scale=scale, **blocks)
    grads = flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo,
                                          causal=causal, sm_scale=scale,
                                          **blocks)
    want, vjp = jax.vjp(lambda *a: jax_flash(*a, causal=causal,
                                             interpret=True, **blocks),
                        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out[..., :d].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert not out[..., d:].any()
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g[..., :d].numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32, 96, 192, 256, 320, 384, 512])
def test_b5_b7_at_padded_head_dims_on_the_card(dtype, d):
    """B5, B6 and B7 at D 8, 32, 96, 192 and 256 (padded to 64, 64, 128,
    256 and 256 lanes) and on the wide route at D 320, 384 and 512
    (padded to 384, 384 and 512) against the plain versions at the
    unpadded D, causal and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else ROW_TOL
    gen = torch.Generator(device="cuda").manual_seed(d)
    for causal, sq, sk, kv_len in ((True, 200, 200, 200),
                                   (False, 96, 160, 130)):
        q, do = (torch.randn(2, 3, sq, d, device="cuda", generator=gen)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn(2, 3, sk, d, device="cuda", generator=gen)
                .to(dt) for _ in range(2))
        kw = dict(causal=causal, kv_len=kv_len)
        before = tfa.flash_attention.launches
        out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = flash_attention_reference(q, k, v, **kw)
        assert tfa.flash_attention.launches == before + 1
        assert out.shape == q.shape and out.dtype == dt
        assert _row_err(out.float().cpu(), ref.float().cpu()) <= tol
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
        got = tfa.flash_attention_bwd(q, k, v, ref, ref_lse, do, **kw)
        refs = flash_attention_bwd_reference(q, k, v, ref, ref_lse, do, **kw)
        for g, r in zip(got, refs):
            assert g.shape == r.shape and g.dtype == dt
            assert _row_err(g.float().cpu(), r.float().cpu(), FLOOR) <= tol

