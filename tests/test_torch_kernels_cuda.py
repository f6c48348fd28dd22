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
of keys, are held as tightly as the rest. In bf16, B5, B6 and B7 also
round P or dS to bf16 for their tensor-core products; that rounding alone
measures about 2**-7 on the CPU (tests/test_torch_flash_tc.py). The scale
is clamped from
below at 1% of the tensor's largest |ref|: a row whose exact value is 0
(dq of query row 0 under causal, where one live key gives ds = 0) comes
out of both sides as rounding noise of ~1e-7, which has no scale of its
own. lse is fp32 on both sides: 1e-3 absolute.

B1 (``fused_conv_fwd``) is held the same way per output pixel (a row of
Co channels), and its stats per channel against that channel's sum of
|y| (sum of y^2 for the squares): 1e-4 in fp32 (CUDA cores), 2**-6 in
bf16 (tensor cores). TF32 is off for the plain version's cuDNN
convolution.

B3 (``fused_conv_dgrad``) is held as B1 is, per input pixel, and its stats
per channel against that channel's sum of |e| (of |e * xhat|). B2
(``fused_conv_wgrad``) is held per (tap, Co) column of dw against the
column's largest sum of |terms| (the same product on absolute values):
1e-4 in both types, since both sides multiply the same rounded operands
in f32 and differ only in the order of the sums.

A NaN entering a prologue ReLU (B1, B2's x side) or B3's g-side rebuild
comes out where the plain version puts it (``jnp.maximum`` keeps a NaN),
in both types; the finite values are held as above.

The symbolic front end on the card: an in-place NDArray update reaching a
bound executor, the tiny fused ResNet's ``Executor.forward_backward``
(11/11/9 launches of B1/B2/B3, gradients within 1e-4 of the CPU's against
each tensor's scale, floored at 1% of the largest) and a checkpoint saved
from card arrays loading on the CPU bit for bit.
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_block as fb

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


# query lengths around the 64-row tile and the training length; keys 37
# longer, the last 9 padding (kv_len < Sk)
TILE_EDGE_SEQS = (1, 16, 63, 65, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_b5_b7_at_tile_edges_on_the_card(dtype, d):
    """B5 and B7 against their plain versions where the tiles are ragged:
    in bf16 the tensor-core kernels (TMA zero-fills rows past S), in fp32
    the CUDA-core ones, held at 1e-4 (TF32 would not pass). B7 takes a
    random ``out``: with the forward's, Sq = 1 under causal leaves one live
    score, whose ds = p * (dO . v - dO . out) is exactly 0, so dk would be
    rounding noise on both sides."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for sq in TILE_EDGE_SEQS:
        sk = sq + 37
        for causal in (True, False):
            kw = dict(causal=causal, kv_len=sk - 9)
            q, k, v, do = _inputs(gen, 1, 2, sq, sk, d, dt)
            o = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            ref, ref_lse = flash_attention_reference(q, k, v, **kw)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, ref_lse,
                                             attention_delta(o, do), **kw)
            _, ref_dk, ref_dv = flash_attention_bwd_reference(
                q, k, v, o, ref_lse, do, **kw)
            torch.cuda.synchronize()
            where = (sq, causal)
            assert _row_err(out, ref) <= ROW_TOL[dt], where
            torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
            assert _row_err(dk, ref_dk) <= ROW_TOL[dt], where
            assert _row_err(dv, ref_dv) <= ROW_TOL[dt], where
            assert not dk[:, :, sk - 9:].any() and not dv[:, :, sk - 9:].any()


@pytest.mark.cuda
def test_bf16_kernels_refuse_unaligned_tensors():
    """TMA needs 16-byte aligned tensors: the wrapper raises on one that is
    not, and launches nothing."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = _inputs(gen, 1, 2, 64, 64, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view_as(q)           # contiguous, 2 bytes off
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 == 2
    out, lse = flash_attention_reference(q, k, v)
    delta = attention_delta(out, do)
    before = (flash_attention.launches, flash_attention_bwd_dkv.launches)
    with pytest.raises(MXNetError, match="16-byte"):
        flash_attention(shifted, k, v)
    with pytest.raises(MXNetError, match="16-byte"):
        flash_attention_bwd_dkv(q, k, v, shifted, lse, delta)
    with pytest.raises(MXNetError, match="16-byte"):
        flash_attention_bwd_dq(q, shifted, v, do, lse, delta)
    assert (flash_attention.launches,
            flash_attention_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_b6_at_tile_edges_on_the_card(dtype, d):
    """B6 against the plain backward where the tiles are ragged: in bf16
    the tensor-core kernel, in fp32 the CUDA-core one. It takes a random
    ``out`` as B7 does above: with the forward's, Sq = 1 under causal gives
    ds = 0 exactly and dq would be rounding noise on both sides."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(10)
    for sq in TILE_EDGE_SEQS:
        sk = sq + 37
        for causal in (True, False):
            kw = dict(causal=causal, kv_len=sk - 9)
            q, k, v, do = _inputs(gen, 1, 2, sq, sk, d, dt)
            o = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
            _, lse = flash_attention_reference(q, k, v, **kw)
            before = flash_attention_bwd_dq.launches
            dq = flash_attention_bwd_dq(q, k, v, do, lse,
                                        attention_delta(o, do), **kw)
            ref = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)[0]
            torch.cuda.synchronize()
            assert flash_attention_bwd_dq.launches == before + 1
            assert dq.dtype == dt and dq.shape == q.shape
            assert _row_err(dq, ref) <= ROW_TOL[dt], (sq, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_take_more_than_65535_heads(dtype):
    """B*H rides the grid's x in every flash kernel, so B*H = 65536 runs:
    the forward and the backward against the plain versions."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = _inputs(gen, 1024, 64, 16, 16, 64, dt)
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, ref, ref_lse, do, causal=True)
    refs = flash_attention_bwd_reference(q, k, v, ref, ref_lse, do,
                                         causal=True)
    torch.cuda.synchronize()
    assert _row_err(out, ref) <= ROW_TOL[dt]
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert _row_err(g, r) <= ROW_TOL[dt], name


# (n, h, ci, co, k, stride): ResNet-50 unit shapes at batch 2, plus ragged
# tiles (Co 70, H 7) and a Ci that is not a multiple of the K chunk
CONV_SHAPES = [(2, 56, 64, 64, 3, 1), (2, 56, 128, 128, 3, 2),
               (2, 14, 1024, 2048, 1, 2), (2, 7, 512, 512, 3, 1),
               (3, 7, 40, 70, 3, 1), (2, 8, 8, 16, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_fwd_matches_plain_on_the_card(dtype):
    _card()
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (n, h, ci, co, k, stride) in CONV_SHAPES:
        x = torch.randn(n, h, h, ci, device="cuda", generator=gen).to(dt)
        w = (torch.randn(k, k, ci, co, device="cuda", generator=gen)
             / (k * k * ci) ** 0.5).to(dt)
        scale = torch.rand(ci, device="cuda", generator=gen) + 0.5
        bias = torch.randn(ci, device="cuda", generator=gen)
        for pro in (None, (scale, bias, True), (scale, bias, False)):
            before = fb.conv_fwd.launches
            y, st = fb.conv_fwd(x, w, stride=stride, prologue=pro,
                                emit_stats=True)
            ref, ref_st = fb.conv_fwd_reference(x, w, stride=stride,
                                                prologue=pro,
                                                emit_stats=True)
            torch.cuda.synchronize()
            assert fb.conv_fwd.launches == before + 1
            assert y.dtype == dt and y.shape == ref.shape
            assert _row_err(y, ref) <= ROW_TOL[dt]
            yf = ref.float()
            for t, bound in ((0, yf.abs().sum((0, 1, 2))),
                             (1, (yf * yf).sum((0, 1, 2)))):
                assert bool(((st[t] - ref_st[t]).abs()
                             <= ROW_TOL[dt] * bound + 1e-6).all())


@pytest.mark.cuda
def test_conv_fwd_takes_strided_input_and_refuses_odd_stride2():
    _card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 16, 8, 8, device="cuda", generator=gen)
    w = torch.randn(3, 3, 16, 8, device="cuda", generator=gen) / 12
    nhwc = x.permute(0, 2, 3, 1)      # a transposed view, as in the graph
    y, _ = fb.conv_fwd(nhwc, w)
    ref, _ = fb.conv_fwd_reference(nhwc.contiguous(), w)
    torch.cuda.synchronize()
    assert _row_err(y, ref) <= ROW_TOL[torch.float32]
    with pytest.raises(ValueError, match="stride-2 requires even"):
        fb.conv_fwd(nhwc[:, :7, :7], w, stride=2)


@pytest.mark.cuda
def test_conv_fwd_entry_point_checks_the_stats_scratch_rows():
    """The C entry point refuses a stats scratch buffer whose row count is
    not one per pixel tile of the kernel it launches (the CUDA-core kernel
    in fp32, kind 0; the tensor-core one in bf16, kind 2)."""
    _card()
    from mxnet_tpu_torch.kernels import _build

    for dt, kind in ((torch.float32, 0), (torch.bfloat16, 2)):
        x = torch.randn(2, 12, 12, 16, device="cuda").to(dt)
        w = torch.randn(1, 1, 16, 8, device="cuda").to(dt)
        fb.conv_fwd(x, w, emit_stats=True)  # builds it and binds the types
        lib = _build.load("fused_conv_fwd")
        tiles = lib.fused_conv_fwd_tiles(2, 12, 12, 16, 8, 1, 1, kind)
        assert tiles >= 1
        y = torch.empty(2, 12, 12, 8, device="cuda").to(dt)
        stats = torch.empty(2, 8, device="cuda")
        partial = torch.empty(tiles + 1, 2, 8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for rows in (tiles, tiles - 1, tiles + 1):
            err = lib.fused_conv_fwd(x.data_ptr(), w.data_ptr(), None, None,
                                     y.data_ptr(), partial.data_ptr(), rows,
                                     stats.data_ptr(), 2, 12, 12, 16, 8, 1,
                                     1, 0, 0, kind, stream)
            assert (err == 0) == (rows == tiles), (kind, rows)


def _grad_case(gen, n, h, ci, co, k, stride, dt):
    """x, w, a BN prologue, e and y_raw at the output and 5 BN-backward
    constants on the card."""
    ho = h // stride

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x = rnd(n, h, h, ci).to(dt)
    w = (rnd(k, k, ci, co) / (k * k * ci) ** 0.5).to(dt)
    pro = (torch.rand(ci, device="cuda", generator=gen) + 0.5,
           rnd(ci) * 0.5, True)
    e, y = rnd(n, ho, ho, co).to(dt), rnd(n, ho, ho, co).to(dt)
    consts = (torch.rand(co, device="cuda", generator=gen) + 0.5,
              rnd(co) * 0.2, torch.rand(co, device="cuda", generator=gen)
              + 0.5, rnd(co) * 0.01, rnd(co) * 0.01)
    return x, w, pro, e, y, consts


def _wgrad_err(dw, ref, x, g_parts, w_shape, stride, pro, g_bnbwd):
    """Largest |dw - ref| per (tap, Co) column over the column's largest
    sum of |terms|."""
    h = fb._apply_prologue(x, pro).float().abs()
    g = fb._g_value(g_parts, g_bnbwd).to(x.dtype).float().abs()
    k = int(w_shape[0])
    terms = torch.nn.grad.conv2d_weight(
        h.permute(0, 3, 1, 2), (int(w_shape[3]), int(w_shape[2]), k, k),
        g.permute(0, 3, 1, 2), stride=stride, padding=k // 2)
    col = terms.permute(2, 3, 1, 0).amax(dim=2).clamp_min(1e-30)
    return ((dw - ref).abs().amax(dim=2) / col).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_wgrad_matches_plain_on_the_card(dtype):
    _card()
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for (n, h, ci, co, k, stride) in CONV_SHAPES:
        x, w, pro, e, y, consts = _grad_case(gen, n, h, ci, co, k, stride, dt)
        for g_parts, g_bnbwd in ((e, None), ((e, y), consts)):
            for p in (None, pro):
                before = fb.conv_wgrad.launches
                kw = dict(stride=stride, x_prologue=p, g_bnbwd=g_bnbwd)
                dw = fb.conv_wgrad(x, g_parts, w.shape, **kw)
                ref = fb.conv_wgrad_reference(x, g_parts, w.shape, **kw)
                torch.cuda.synchronize()
                assert fb.conv_wgrad.launches == before + 1
                assert dw.dtype == torch.float32 and dw.shape == w.shape
                assert _wgrad_err(dw, ref, x, g_parts, w.shape, stride, p,
                                  g_bnbwd) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_dgrad_matches_plain_on_the_card(dtype):
    _card()
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for (n, h, ci, co, k, stride) in CONV_SHAPES:
        x, w, pro, e, y, consts = _grad_case(gen, n, h, ci, co, k, stride, dt)
        mask = (x, pro[0] + 0.5, pro[1], pro[1] * 0.3, pro[0])
        co2 = 24
        extra = None
        if k == 1 and stride == 1:
            s2 = 2 if h % 2 == 0 else 1
            extra = (torch.randn(n, h // s2, h // s2, co2, device="cuda",
                                 generator=gen).to(dt),
                     (torch.randn(1, 1, ci, co2, device="cuda",
                                  generator=gen) / ci ** 0.5).to(dt), s2)
        epilogues = [(None, None), (mask, None)] + (
            [(mask, extra)] if extra is not None else [])
        for g_parts, g_bnbwd in ((e, None), ((e, y), consts)):
            for out_mask, ex in epilogues:
                before = fb.conv_dgrad.launches
                kw = dict(stride=stride, g_bnbwd=g_bnbwd, out_mask=out_mask,
                          extra=ex)
                got, st = fb.conv_dgrad(g_parts, w, x.shape, **kw)
                ref, ref_st = fb.conv_dgrad_reference(g_parts, w, x.shape,
                                                      **kw)
                torch.cuda.synchronize()
                assert fb.conv_dgrad.launches == before + 1
                assert got.dtype == dt and got.shape == x.shape
                assert _row_err(got, ref) <= ROW_TOL[dt]
                if out_mask is None:
                    assert st is None
                    continue
                xhat = (x.float() - out_mask[3]) * out_mask[4]
                ef = ref.float()
                for t, bound in ((0, ef.abs().sum((0, 1, 2))),
                                 (1, (ef * xhat).abs().sum((0, 1, 2)))):
                    assert bool(((st[t] - ref_st[t]).abs()
                                 <= ROW_TOL[dt] * bound + 1e-6).all())


@pytest.mark.cuda
def test_bottleneck_train_on_the_card_launches_b1_b2_b3():
    """One downsample unit's forward and backward in fp32: 4 B1, 4 B2 and
    3 B3 launches, gradients as on the CPU."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(7)
    n, h, ci, c, co = 2, 14, 64, 32, 128

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    args = [rnd(n, h, h, ci), rnd(1, 1, ci, c, scale=ci ** -0.5),
            rnd(3, 3, c, c, scale=(9 * c) ** -0.5),
            rnd(1, 1, c, co, scale=c ** -0.5),
            rnd(1, 1, ci, co, scale=ci ** -0.5)]
    args += [rnd(v) * 0.2 + (1.0 if i % 2 == 0 else 0.0)
             for i, v in enumerate((ci, ci, c, c, c, c))]
    cot = rnd(n, h // 2, h // 2, co)
    grads = {}
    for dev in ("cpu", "cuda"):
        a = [t.to(dev).requires_grad_() for t in args]
        before = (fb.conv_fwd.launches, fb.conv_wgrad.launches,
                  fb.conv_dgrad.launches)
        out, _stats = fb.bottleneck_train(*a, 2, 2e-5)
        grads[dev] = torch.autograd.grad((out * cot.to(dev)).sum(), a)
        counts = (fb.conv_fwd.launches - before[0],
                  fb.conv_wgrad.launches - before[1],
                  fb.conv_dgrad.launches - before[2])
        assert counts == ((0, 0, 0) if dev == "cpu" else (4, 4, 3))
    for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
        rel = ((g_card.cpu() - g_cpu).abs().max()
               / g_cpu.abs().max().clamp_min(1e-30)).item()
        assert rel <= 1e-4


# (n, h, ci, co, k, stride): where the tensor-core B1 tiles are ragged or
# padded: 7x7 at batch 1, and each stride-2 step of ResNet-50 (56 -> 28,
# 28 -> 14, 14 -> 7; 3x3 and the 1x1 shortcut) at batch 3
TC_CONV_SHAPES = [(1, 7, 512, 512, 3, 1), (1, 7, 512, 2048, 1, 1),
                  (3, 56, 128, 128, 3, 2), (3, 56, 256, 512, 1, 2),
                  (3, 28, 256, 256, 3, 2), (3, 28, 512, 1024, 1, 2),
                  (3, 14, 512, 512, 3, 2), (3, 14, 1024, 2048, 1, 2)]


def _conv_case(gen, n, h, ci, co, k, dt):
    x = torch.randn(n, h, h, ci, device="cuda", generator=gen).to(dt)
    w = (torch.randn(k, k, ci, co, device="cuda", generator=gen)
         / (k * k * ci) ** 0.5).to(dt)
    scale = torch.rand(ci, device="cuda", generator=gen) + 0.5
    bias = torch.randn(ci, device="cuda", generator=gen) * 0.5
    return x, w, (scale, bias, True)


def _conv_check(x, w, stride, pro, stats, dt):
    y, st = fb.conv_fwd(x, w, stride=stride, prologue=pro, emit_stats=stats)
    ref, ref_st = fb.conv_fwd_reference(x, w, stride=stride, prologue=pro,
                                        emit_stats=stats)
    torch.cuda.synchronize()
    assert y.dtype == dt and y.shape == ref.shape
    assert _row_err(y, ref) <= ROW_TOL[dt]
    if not stats:
        assert st is None
        return
    yf = ref.float()
    for t, bound in ((0, yf.abs().sum((0, 1, 2))),
                     (1, (yf * yf).sum((0, 1, 2)))):
        assert bool(((st[t] - ref_st[t]).abs()
                     <= ROW_TOL[dt] * bound + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_CONV_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv_fwd_tensor_cores_at_padded_tiles(shape):
    """The bf16 tensor-core B1 against its plain version, prologue and
    stats on and off; none of these goes to the CUDA cores."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    n, h, ci, co, k, stride = shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, w, pro = _conv_case(gen, n, h, ci, co, k, torch.bfloat16)
    before = (fb.conv_fwd.launches, fb.conv_fwd.core_route_launches)
    for p in (None, pro, (pro[0], pro[1], False)):
        for stats in (False, True):
            _conv_check(x, w, stride, p, stats, torch.bfloat16)
    assert (fb.conv_fwd.launches - before[0],
            fb.conv_fwd.core_route_launches - before[1]) == (6, 0)


@pytest.mark.cuda
def test_conv_fwd_routes_rows_tma_cannot_load_to_the_cuda_cores():
    """A bf16 Ci that is not a multiple of 8 cannot be loaded by TMA: the
    wrapper sends it, by shape, to the CUDA-core kernel and counts it; fp32
    is not a route and is not counted."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(13)
    for ci, co, dt, routed in ((20, 64, torch.bfloat16, 1),
                               (64, 36, torch.bfloat16, 1),
                               (64, 64, torch.bfloat16, 0),
                               (20, 64, torch.float32, 0)):
        x, w, pro = _conv_case(gen, 2, 9, ci, co, 3, dt)
        before = (fb.conv_fwd.launches, fb.conv_fwd.core_route_launches)
        _conv_check(x, w, 1, pro, True, dt)
        assert (fb.conv_fwd.launches - before[0],
                fb.conv_fwd.core_route_launches - before[1]) == (1, routed)


@pytest.mark.cuda
def test_conv_fwd_tensor_cores_refuse_unaligned_tensors():
    """TMA needs 16-byte aligned x and w: the wrapper raises on either, and
    launches nothing."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, w, pro = _conv_case(gen, 2, 8, 64, 64, 3, torch.bfloat16)
    before = fb.conv_fwd.launches
    for t in (x, w):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        shifted = flat[1:].view_as(t)          # contiguous, 2 bytes off
        shifted.copy_(t)
        assert shifted.data_ptr() % 16 == 2
        args = (shifted, w) if t is x else (x, shifted)
        with pytest.raises(MXNetError, match="16-byte"):
            fb.conv_fwd(*args, prologue=pro)
    assert fb.conv_fwd.launches == before


# (n, h, ci, co, k, stride): the tensor-core B2 and B3 at their edges.
# 7x7 at batch 1 and 2 gives ragged boxes; Ci and Co of 8 and 72 a partial
# K slice and a partial N tile; 64 and 128 take B3's two Ci tile widths;
# the 28x28 and 56x56 shapes put several boxes in a B2 chunk and split
# the pixels into several chunks.
TC_GRAD_SHAPES = [(1, 7, 64, 64, 3, 1), (2, 7, 72, 8, 3, 1),
                  (2, 7, 8, 72, 1, 1), (1, 14, 72, 72, 3, 2),
                  (2, 14, 8, 8, 1, 2), (2, 8, 128, 64, 3, 1),
                  (2, 14, 128, 256, 1, 2), (4, 28, 64, 64, 3, 1),
                  (3, 56, 64, 256, 1, 1)]


def _grad_counts():
    return (fb.conv_wgrad.launches, fb.conv_wgrad.core_route_launches,
            fb.conv_dgrad.launches, fb.conv_dgrad.core_route_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_GRAD_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv_wgrad_tensor_cores_at_edges(shape):
    """The bf16 tensor-core B2 against its plain version, g whole and
    rebuilt, the prologue off, with and without its ReLU; none of these
    goes to the CUDA cores."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    n, h, ci, co, k, stride = shape
    gen = torch.Generator(device="cuda").manual_seed(15)
    x, w, pro, e, y, consts = _grad_case(gen, n, h, ci, co, k, stride,
                                         torch.bfloat16)
    before = _grad_counts()
    for g_parts, g_bnbwd in ((e, None), ((e, y), consts)):
        for p in (None, pro, (pro[0], pro[1], False)):
            kw = dict(stride=stride, x_prologue=p, g_bnbwd=g_bnbwd)
            dw = fb.conv_wgrad(x, g_parts, w.shape, **kw)
            ref = fb.conv_wgrad_reference(x, g_parts, w.shape, **kw)
            torch.cuda.synchronize()
            assert dw.dtype == torch.float32 and dw.shape == w.shape
            assert bool(torch.isfinite(dw).all())
            assert _wgrad_err(dw, ref, x, g_parts, w.shape, stride, p,
                              g_bnbwd) <= 1e-4, (g_bnbwd is None, p)
    after = _grad_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (6, 0)


def _dgrad_check(g_parts, w, x, stride, g_bnbwd, out_mask, extra):
    kw = dict(stride=stride, g_bnbwd=g_bnbwd, out_mask=out_mask, extra=extra)
    got, st = fb.conv_dgrad(g_parts, w, x.shape, **kw)
    ref, ref_st = fb.conv_dgrad_reference(g_parts, w, x.shape, **kw)
    torch.cuda.synchronize()
    dt = w.dtype
    assert got.dtype == dt and got.shape == x.shape
    assert _row_err(got, ref) <= ROW_TOL[dt]
    if out_mask is None:
        assert st is None
        return
    xhat = (x.float() - out_mask[3]) * out_mask[4]
    ef = ref.float()
    for t, bound in ((0, ef.abs().sum((0, 1, 2))),
                     (1, (ef * xhat).abs().sum((0, 1, 2)))):
        assert bool(((st[t] - ref_st[t]).abs()
                     <= ROW_TOL[dt] * bound + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_GRAD_SHAPES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv_dgrad_tensor_cores_at_edges(shape):
    """The bf16 tensor-core B3 against its plain version, g whole and
    rebuilt, with and without the mask and its stats, and at the 1x1s the
    shortcut's extra term at s2 = 1 and (even H) 2; none of these goes to
    the CUDA cores."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    n, h, ci, co, k, stride = shape
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(16)
    x, w, pro, e, y, consts = _grad_case(gen, n, h, ci, co, k, stride, dt)
    mask = (x, pro[0] + 0.5, pro[1], pro[1] * 0.3, pro[0])
    epilogues = [(None, None), (mask, None)]
    if k == 1 and stride == 1:
        for s2 in (1, 2) if h % 2 == 0 else (1,):
            co2 = 24 if s2 == 1 else 136
            epilogues.append((mask, (
                torch.randn(n, h // s2, h // s2, co2, device="cuda",
                            generator=gen).to(dt),
                (torch.randn(1, 1, ci, co2, device="cuda", generator=gen)
                 / ci ** 0.5).to(dt), s2)))
    before = _grad_counts()
    for g_parts, g_bnbwd in ((e, None), ((e, y), consts)):
        for out_mask, extra in epilogues:
            _dgrad_check(g_parts, w, x, stride, g_bnbwd, out_mask, extra)
    after = _grad_counts()
    assert (after[2] - before[2], after[3] - before[3]) == \
        (2 * len(epilogues), 0)


@pytest.mark.cuda
def test_conv_grads_route_rows_tma_cannot_load_to_the_cuda_cores():
    """A bf16 Co of 12 cannot be loaded by TMA: B2 and B3 send it, by
    shape, to the CUDA-core kernels and count it there; fp32 is not a
    route and is not counted."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(17)
    for co, dt, routed in ((12, torch.bfloat16, 1), (16, torch.bfloat16, 0),
                           (12, torch.float32, 0)):
        x, w, pro, e, y, consts = _grad_case(gen, 2, 9, 16, co, 3, 1, dt)
        before = _grad_counts()
        dw = fb.conv_wgrad(x, (e, y), w.shape, x_prologue=pro,
                           g_bnbwd=consts)
        ref = fb.conv_wgrad_reference(x, (e, y), w.shape, x_prologue=pro,
                                      g_bnbwd=consts)
        assert _wgrad_err(dw, ref, x, (e, y), w.shape, 1, pro,
                          consts) <= 1e-4
        mask = (x, pro[0] + 0.5, pro[1], pro[1] * 0.3, pro[0])
        _dgrad_check((e, y), w, x, 1, consts, mask, None)
        after = _grad_counts()
        assert tuple(a - b for a, b in zip(after, before)) == \
            (1, routed, 1, routed)


@pytest.mark.cuda
def test_conv_grads_tensor_cores_refuse_unaligned_tensors():
    """TMA needs 16-byte aligned operands: B2 and B3 raise on a contiguous
    view 2 bytes off, and launch nothing."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(18)
    x, w, pro, e, y, consts = _grad_case(gen, 2, 8, 64, 64, 3, 1,
                                         torch.bfloat16)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        out = flat[1:].view_as(t)
        out.copy_(t)
        assert out.data_ptr() % 16 == 2
        return out

    before = _grad_counts()
    with pytest.raises(MXNetError, match="16-byte"):
        fb.conv_wgrad(shifted(x), e, w.shape, x_prologue=pro)
    with pytest.raises(MXNetError, match="16-byte"):
        fb.conv_wgrad(x, (e, shifted(y)), w.shape, g_bnbwd=consts)
    with pytest.raises(MXNetError, match="16-byte"):
        fb.conv_dgrad(e, shifted(w), x.shape)
    with pytest.raises(MXNetError, match="16-byte"):
        fb.conv_dgrad((shifted(e), y), w, x.shape, g_bnbwd=consts)
    assert _grad_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_grads_are_deterministic(dtype):
    """Two calls give bit-identical dw, e and stats: the pixel chunks and
    tiles are added in order, with no atomics."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(19)
    x, w, pro, e, y, consts = _grad_case(gen, 8, 56, 64, 64, 3, 1, dt)
    mask = (x, pro[0] + 0.5, pro[1], pro[1] * 0.3, pro[0])
    runs = []
    for _ in range(2):
        dw = fb.conv_wgrad(x, (e, y), w.shape, x_prologue=pro,
                           g_bnbwd=consts)
        ex, st = fb.conv_dgrad((e, y), w, x.shape, g_bnbwd=consts,
                               out_mask=mask)
        runs.append((dw, ex, st))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the symbolic front end on the card: NDArray, Executor, checkpoints
# ---------------------------------------------------------------------------
TINY_RESNET = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
                   num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
TINY_SHAPES = {"data": (4, 3, 64, 64), "softmax_label": (4,)}


def _tiny_executor(ctx, fused=True):
    import numpy as np

    from mxnet_tpu_torch.models import resnet

    sym = resnet.resnet(fused=fused, **TINY_RESNET)
    ex = sym.simple_bind(ctx, **TINY_SHAPES)
    args, auxs = resnet.init_params(sym, TINY_SHAPES["data"], seed=0)
    for k, v in args.items():
        ex.arg_dict[k][:] = v
    for k, v in auxs.items():
        ex.aux_dict[k][:] = v
    rng = np.random.RandomState(4)
    batch = {"data": rng.randn(*TINY_SHAPES["data"]).astype(np.float32),
             "softmax_label": rng.randint(0, 5, (4,)).astype(np.float32)}
    return ex, batch


@pytest.mark.cuda
def test_ndarray_inplace_update_reaches_a_bound_executor_on_the_card():
    import mxnet_tpu_torch as mx

    _card()
    ex, batch = _tiny_executor(mx.gpu(0), fused=False)
    w = ex.arg_dict["fc1_weight"]
    assert w.tensor.is_cuda
    tensor = w.tensor
    ex.forward(**batch)
    before = ex.outputs[0].asnumpy()
    w *= 0.0
    ex.arg_dict["fc1_bias"][:] = 0.0
    assert w.tensor is tensor and ex.arg_dict["fc1_weight"] is w
    ex.forward(**batch)
    after = ex.outputs[0].asnumpy()
    assert abs(after - 0.2).max() < 1e-6 and abs(before - 0.2).max() > 1e-3


@pytest.mark.cuda
def test_executor_forward_backward_on_the_card_launches_b1_b2_b3():
    """The tiny fused net's forward_backward on the card: 11 B1, 11 B2 and
    9 B3 launches, outputs and gradients as on the CPU (fp32, TF32 off;
    each gradient against its own scale, floored at 1% of the largest)."""
    import mxnet_tpu_torch as mx

    _card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        ex, batch = _tiny_executor(ctx)
        before = (fb.conv_fwd.launches, fb.conv_wgrad.launches,
                  fb.conv_dgrad.launches)
        ex.forward_backward(**batch)
        counts = (fb.conv_fwd.launches - before[0],
                  fb.conv_wgrad.launches - before[1],
                  fb.conv_dgrad.launches - before[2])
        got[ctx.device_type] = (ex.outputs[0].asnumpy(), {
            k: v.asnumpy() for k, v in ex.grad_dict.items()}, counts)
    assert got["gpu"][2] == (11, 11, 9) and got["cpu"][2] == (0, 0, 0)
    assert abs(got["gpu"][0] - got["cpu"][0]).max() <= 1e-4
    floor = 1e-2 * max(abs(g).max() for g in got["cpu"][1].values())
    for k, g in got["cpu"][1].items():
        err = abs(got["gpu"][1][k] - g).max() / max(abs(g).max(), floor)
        assert err <= 1e-4, (k, err)


@pytest.mark.cuda
def test_checkpoint_saved_from_the_card_loads_on_the_cpu_bit_exact(tmp_path):
    import mxnet_tpu_torch as mx

    _card()
    ex, _batch = _tiny_executor(mx.gpu(0))
    args = {k: v for k, v in ex.arg_dict.items()
            if k not in TINY_SHAPES}
    prefix = str(tmp_path / "card")
    mx.model.save_checkpoint(prefix, 3, ex._symbol, args, ex.aux_dict)
    bf = mx.nd.array([1.5, -2.25], ctx=mx.gpu(0)).astype("bfloat16")
    mx.nd.save(str(tmp_path / "bf"), [bf])
    sym, a2, x2 = mx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == ex._symbol.tojson()
    for mine, theirs in ((args, a2), (ex.aux_dict, x2)):
        assert sorted(mine) == sorted(theirs)
        for k, v in mine.items():
            assert theirs[k].context == mx.cpu()
            assert torch.equal(v.tensor.cpu(), theirs[k].tensor), k
    (back,) = mx.nd.load(str(tmp_path / "bf"), ctx=mx.cpu())
    assert back.tensor.dtype == torch.bfloat16
    assert back.context == mx.cpu()
    (on_card,) = mx.nd.load(str(tmp_path / "bf"))
    assert on_card.context == mx.gpu(0)
    assert torch.equal(on_card.tensor, bf.tensor)
    assert torch.equal(back.tensor, bf.tensor.cpu())


NAN_SHAPES = [(2, 12, 16, 32, 3, 1), (2, 12, 16, 32, 1, 2)]


def _same_nans(got, ref, what):
    """NaN where the plain version has NaN (and somewhere), the finite
    values held per row as elsewhere in this file."""
    nan = torch.isnan(ref)
    assert bool(nan.any()), what
    assert torch.equal(torch.isnan(got), nan), what
    assert _row_err(got.masked_fill(nan, 0), ref.masked_fill(nan, 0)) <= \
        ROW_TOL[got.dtype if got.dtype in ROW_TOL else torch.float32], what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_passes_the_prologue_relu_as_in_the_plain_versions(dtype):
    """A NaN pixel through B1's prologue, B2's x prologue and B3's g-side
    rebuild: NaN where the plain version (``jnp.maximum``'s semantics, which
    keep a NaN) has it, the finite values as before. B1's outputs that no
    NaN reaches are bit for bit those of the same call without the NaN."""
    _card()
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(21)
    for (n, h, ci, co, k, stride) in NAN_SHAPES:
        x, w, pro, e, y, consts = _grad_case(gen, n, h, ci, co, k, stride, dt)
        xn = x.clone()
        xn[0, 4, 6, 2] = float("nan")
        xn[1, 8, 0, 9] = float("nan")
        # B1: the NaN passes the ReLU into the convolution
        yk, stk = fb.conv_fwd(xn, w, stride=stride, prologue=pro,
                              emit_stats=True)
        yr, str_ = fb.conv_fwd_reference(xn, w, stride=stride, prologue=pro,
                                         emit_stats=True)
        y0, _ = fb.conv_fwd(x, w, stride=stride, prologue=pro)
        torch.cuda.synchronize()
        _same_nans(yk, yr, "B1 %s" % (k,))
        fin = ~torch.isnan(yr)
        assert torch.equal(yk[fin], y0[fin]), "B1 finite outputs changed"
        assert torch.equal(torch.isnan(stk), torch.isnan(str_))
        # B2: the x-side prologue
        for g_parts, g_bnbwd in ((e, None), ((e, y), consts)):
            kw = dict(stride=stride, x_prologue=pro, g_bnbwd=g_bnbwd)
            dw = fb.conv_wgrad(xn, g_parts, w.shape, **kw)
            ref = fb.conv_wgrad_reference(xn, g_parts, w.shape, **kw)
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            assert bool(nan.any()) and torch.equal(torch.isnan(dw), nan)
            assert _wgrad_err(dw.masked_fill(nan, 0), ref.masked_fill(nan, 0),
                              x, g_parts, w.shape, stride, pro,
                              g_bnbwd) <= 1e-4
        # B3: a NaN in e reaches dL/dy through the rebuild
        en = e.clone()
        en[1, 2, 3, 4] = float("nan")
        mask = (x, pro[0] + 0.5, pro[1], pro[1] * 0.3, pro[0])
        kw = dict(stride=stride, g_bnbwd=consts, out_mask=mask)
        got, st = fb.conv_dgrad((en, y), w, x.shape, **kw)
        ref, ref_st = fb.conv_dgrad_reference((en, y), w, x.shape, **kw)
        torch.cuda.synchronize()
        _same_nans(got, ref, "B3 %s" % (k,))
        assert torch.equal(torch.isnan(st), torch.isnan(ref_st))
