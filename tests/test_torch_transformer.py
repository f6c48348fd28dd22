"""The PyTorch port's transformer (forward, prefill, paged decode) against
the JAX package, on the CPU at a small size.

Inputs come from numpy seeds and go through both packages. Tolerances:
the one-shot forward and prefill atol 5e-5 / rtol 1e-5, teacher-forced
decode atol 5e-4 / rtol 1e-4 — the tolerances tests/test_generate.py
holds the JAX package's own prefill/decode to (fp32, summation order
only); the KV cache contents atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64, dtype="float32")


@pytest.fixture(scope="module")
def models():
    jc, tc = jtfm.TransformerConfig(**SMALL), ttfm.TransformerConfig(**SMALL)
    return jc, jtfm.init_params(jc, seed=0), tc, ttfm.init_params(tc, seed=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_params_bit_identical_to_jax(seed):
    jp = jtfm.init_params(jtfm.TransformerConfig(**SMALL), seed=seed)
    tp = ttfm.init_params(ttfm.TransformerConfig(**SMALL), seed=seed)
    assert set(jp) == set(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        assert tuple(tp[k].shape) == jp[k].shape, k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tp["attn_qkv_weight"].shape == (2, 32, 3, 4, 8)
    assert tp["attn_out_weight"].shape == (2, 4, 8, 32)


def test_params_from_jax_both_ways(models):
    jc, jp, tc, tp = models
    carried = ttfm.params_from_jax(jp, device="cpu")
    for k in jp:
        np.testing.assert_array_equal(carried[k].numpy(), np.asarray(jp[k]))
    # and back: the port's params drive the JAX forward to the same logits
    toks = np.random.RandomState(4).randint(0, 64, (1, 12)).astype(np.int32)
    back = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    np.testing.assert_array_equal(
        np.asarray(jtfm.make_forward_fn(jc)(back, jnp.asarray(toks))),
        np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks))))


@pytest.mark.parametrize("shape", [(2, 24), (1, 64)])
def test_forward_matches_jax(models, shape):
    jc, jp, tc, tp = models
    toks = np.random.RandomState(1).randint(0, 64, shape).astype(np.int32)
    ref = np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks)))
    got = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=1e-5)


def test_forward_zeroes_out_of_vocab_ids_like_jax(models):
    jc, jp, tc, tp = models
    toks = np.array([[3, 70, -2, 5]], np.int32)
    ref = np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(ttfm.make_forward_fn(tc, device="cpu")(tp, toks).numpy(),
                               ref, atol=5e-5, rtol=1e-5)


def test_prefill_and_decode_match_jax_step_by_step(models):
    """Mirror of tests/test_generate.py's prefill/decode acceptance, run
    through both packages on the same cache layout and block tables."""
    jc, jp, tc, tp = models
    rng = np.random.RandomState(1)
    S, plen, page = 24, 10, 8
    toks = rng.randint(0, jc.vocab, (1, S)).astype(np.int32)
    fwd = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)[0].numpy()

    cache_j = jtfm.init_kv_cache(jc, 16, page)
    cache_t = ttfm.init_kv_cache(tc, 16, page, device="cpu")
    assert tuple(cache_t.shape) == cache_j.shape == (2, 2, 17, 8, 4, 8)
    prefill_j = jax.jit(jtfm.make_prefill_fn(jc, page))
    prefill_t = ttfm.make_prefill_fn(tc, page, device="cpu")
    padded = np.zeros((1, 16), np.int32)
    padded[0, :plen] = toks[0, :plen]
    pages = np.array([1, 2], np.int32)
    cache_j, lj = prefill_j(jp, cache_j, padded, np.int32(plen), pages)
    cache_t, lt = prefill_t(tp, cache_t, padded, plen, pages)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=5e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), fwd[plen - 1], atol=5e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cache_t.numpy(), np.asarray(cache_j),
                               atol=1e-6)

    decode_j = jax.jit(jtfm.make_decode_fn(jc, slots=4, max_pages_per_slot=8,
                                           page_size=page, block_k=16))
    decode_t = ttfm.make_decode_fn(tc, 4, 8, page, device="cpu")
    bt = np.zeros((4, 8), np.int32)
    bt[2, :2] = [1, 2]
    free = [3, 4, 5, 6]
    for p in range(plen, S):
        if bt[2, p // page] == 0:
            bt[2, p // page] = free.pop(0)
        tokens = np.zeros((4,), np.int32)
        tokens[2] = toks[0, p]
        positions = np.zeros((4,), np.int32)
        positions[2] = p
        active = np.zeros((4,), bool)
        active[2] = True
        cache_j, gj = decode_j(jp, cache_j, tokens, positions, bt, active)
        cache_t, gt = decode_t(tp, cache_t, tokens, positions, bt, active)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=5e-4,
                                   rtol=1e-4, err_msg="position %d" % p)
        np.testing.assert_allclose(gt.numpy()[2], fwd[p], atol=5e-4,
                                   rtol=1e-4, err_msg="position %d" % p)
        # inactive slots get zero logits
        assert not gt.numpy()[[0, 1, 3]].any()
    np.testing.assert_allclose(cache_t.numpy(), np.asarray(cache_j),
                               atol=1e-6)


def test_bf16_compute_dtype_matches_jax(models):
    """bf16 plumbing: layernorm in fp32 cast back, weights cast per
    product, fp32 logits. bf16 rounds at other places in the two
    frameworks, so the tolerance is bf16-sized: 2e-2 on logits of
    magnitude ~0.2."""
    kw = dict(SMALL, dtype="bfloat16")
    jc, tc = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    _, jp, _, tp = models
    toks = np.random.RandomState(2).randint(0, 64, (1, 16)).astype(np.int32)
    ref = np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks)))
    got = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-2)
    cache = ttfm.init_kv_cache(tc, 2, 8, device="cpu")
    assert cache.dtype == torch.bfloat16


def test_moe_is_refused_by_name():
    """``n_experts > 0``, refused before the MoE ffn was ported: the same
    seed gives the JAX package's weights bit for bit, and the one-shot
    forward and prefill match the JAX forward (tests/test_torch_moe.py
    holds the rest)."""
    kw = dict(SMALL, n_experts=2)
    jc, tc = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    jp, tp = jtfm.init_params(jc, seed=0), ttfm.init_params(tc, seed=0)
    assert list(tp) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    toks = np.random.RandomState(6).randint(0, 64, (1, 16)).astype(np.int32)
    ref = np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks)))
    got = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5, rtol=1e-5)
    cache = ttfm.init_kv_cache(tc, 2, 8, device="cpu")
    _cache, last = ttfm.make_prefill_fn(tc, 8, device="cpu")(
        tp, cache, toks, 16, np.array([1, 2]))
    np.testing.assert_allclose(last.numpy(), ref[0, 15], atol=5e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("make", [
    lambda c: ttfm.make_forward_fn(c),
    lambda c: ttfm.make_prefill_fn(c, 8),
    lambda c: ttfm.make_decode_fn(c, 4, 8, 8),
    lambda c: ttfm.make_extend_fn(c, 4, 3, 8, 8),
    lambda c: ttfm.init_kv_cache(c, 2, 8),
    lambda c: ttfm.params_from_jax({"embed_weight": np.zeros((2, 2))}),
], ids=["forward", "prefill", "decode", "extend", "kv_cache",
        "params_from_jax"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, make):
    """No device given means cuda; with no CUDA device that raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        make(ttfm.TransformerConfig(**SMALL))


def test_step_functions_refuse_params_on_another_device(models):
    _, _, tc, tp = models
    meta = {k: v.to("meta") for k, v in tp.items()}
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(MXNetError, match="params is on meta"):
        ttfm.make_forward_fn(tc, device="cpu")(meta, toks)
    cache = ttfm.init_kv_cache(tc, 2, 8, device="cpu")
    with pytest.raises(MXNetError, match="cache is on meta"):
        ttfm.make_prefill_fn(tc, 8, device="cpu")(
            tp, cache.to("meta"), toks, 8, np.array([1], np.int32))


def test_config_fields_and_defaults_match_jax():
    """C19: the port's TransformerConfig has the JAX one's fields, in its
    order, with its defaults (``attn``, ``attn_block_q`` and
    ``attn_block_k`` were missing), so one dict builds both."""
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ttfm.TransformerConfig) == fields(jtfm.TransformerConfig)
    kw = dict(SMALL, attn="full", attn_block_q=16, attn_block_k=32)
    assert dataclasses.asdict(ttfm.TransformerConfig(**kw)) == \
        dataclasses.asdict(jtfm.TransformerConfig(**kw))


def test_config_tile_reaches_the_flash_call(models, monkeypatch):
    """C19: ``attn_block_q``/``attn_block_k`` reach ``flash_attention``'s
    ``block_q``/``block_k`` in the forward and in prefill, as the JAX
    ``_block`` passes them; the plain version's blocked softmax at that
    tile gives the same logits as the whole rows."""
    import dataclasses

    _jc, _jp, tc, tp = models
    seen = []
    real = ttfm.flash_attention

    def recording(*a, **kw):
        seen.append((kw["block_q"], kw["block_k"]))
        return real(*a, **kw)

    monkeypatch.setattr(ttfm, "flash_attention", recording)
    toks = np.random.RandomState(6).randint(0, 64, (2, 24)).astype(np.int32)
    plain = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)
    assert seen == [(None, None)] * tc.n_layers
    tiled_cfg = dataclasses.replace(tc, attn_block_q=16, attn_block_k=8)
    seen.clear()
    tiled = ttfm.make_forward_fn(tiled_cfg, device="cpu")(tp, toks)
    assert seen == [(16, 8)] * tc.n_layers
    np.testing.assert_allclose(tiled.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    seen.clear()
    cache = ttfm.init_kv_cache(tiled_cfg, 4, 8, device="cpu")
    _cache, last = ttfm.make_prefill_fn(tiled_cfg, 8, device="cpu")(
        tp, cache, toks[:1], 24, np.array([1, 2, 3]))
    assert seen == [(16, 8)] * tc.n_layers
    np.testing.assert_allclose(last.numpy(), plain[0, 23].numpy(),
                               rtol=1e-5, atol=1e-5)
