"""Shared-prefix KV cache and speculative decoding of the PyTorch port
against the JAX package, on the CPU in fp32.

- ``make_extend_fn`` against the JAX function from the same numpy cache and
  inputs (valid and invalid rows, a row at ``max_ctx - 1``), and against
  the one-shot forward; ``draft_from_layers`` against JAX's, with storage
  shared.
- ``PrefixIndex`` + ``PagePool``: one seeded random sequence of operations
  through both packages at once, equal after every operation; the ports of
  ``tests/test_prefix_spec.py``'s index, knob, profiler, copy-on-write and
  ``extend_tail`` tests.
- ``GenerateServer``: prefix sharing and speculation give the port's own
  unshared / non-speculative tokens exactly, with exact token accounting
  and every page returned; the same prompts through the JAX server give
  the same tokens and counters.
- The reference quirks the port keeps: acceptance is exact argmax
  equality (first index on ties); a round verifies ``min(k, max_ctx - L)``
  proposals even past ``max_new_tokens``; ``insert`` keeps the indexed
  page of a duplicate run.

Tolerance rtol 1e-4 / atol 1e-5 unless a case says otherwise.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import profiler as jprofiler
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.serving import GenerateServer as JaxGenerateServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.models import transformer as tfm
from mxnet_tpu_torch.serving import (
    GenerateError,
    GenerateServer,
    GenerativePredictor,
    PagePool,
    PrefixIndex,
)
from mxnet_tpu_torch.serving import generate as tgen

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64, dtype="float32")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX numpy params, port config, port params), the port's
    carried across from the JAX package's seed-0 params."""
    jc = jtfm.TransformerConfig(**SMALL)
    jp = jtfm.init_params(jc, seed=0)
    return jc, jp, tfm.TransformerConfig(**SMALL), \
        tfm.params_from_jax(jp, device="cpu")


@pytest.fixture(autouse=True)
def _reset_counters():
    profiler.generate_reset()
    jprofiler.generate_reset()
    yield
    profiler.generate_reset()
    jprofiler.generate_reset()


# ---------------------------------------------------------------------------
# make_extend_fn / draft_from_layers
# ---------------------------------------------------------------------------
def _extend_inputs(T, page=8, mp=8, slots=3, num_pages=20, seed=0):
    """A random cache and one extend call's inputs: slot 0 holds a full
    table and ends at max_ctx - 1, slot 1 half a table with its last rows
    invalid, slot 2 no row valid (an idle slot)."""
    rng = np.random.RandomState(seed)
    dh = SMALL["d_model"] // SMALL["n_heads"]
    cache = rng.normal(0.0, 0.5, (SMALL["n_layers"], 2, num_pages + 1, page,
                                  SMALL["n_heads"], dh)).astype(np.float32)
    bt = np.zeros((slots, mp), np.int32)
    bt[0] = np.arange(1, mp + 1)
    bt[1, :4] = np.arange(mp + 1, mp + 5)
    tokens = rng.randint(0, SMALL["vocab"], (slots, T)).astype(np.int32)
    positions = np.zeros((slots, T), np.int32)
    valid = np.zeros((slots, T), bool)
    max_ctx = mp * page
    positions[0] = np.arange(max_ctx - T, max_ctx)
    valid[0] = True
    positions[1] = np.arange(20, 20 + T)
    valid[1, :max(1, T - 2)] = True
    positions[2] = np.arange(T) + 5
    return cache, tokens, positions, bt, valid


@pytest.mark.parametrize("T", [1, 3, 8])
def test_make_extend_fn_matches_jax(model, T):
    import jax

    jc, jp, tc, tp = model
    cache, tokens, positions, bt, valid = _extend_inputs(T)
    S, MP = bt.shape
    fj = jax.jit(jtfm.make_extend_fn(jc, S, T, MP, 8, block_k=16))
    cj, lj = fj(jp, cache.copy(), tokens, positions, bt, valid)
    ft = tfm.make_extend_fn(tc, S, T, MP, 8, device="cpu")
    ct, lt = ft(tp, torch.from_numpy(cache.copy()), tokens, positions, bt,
                valid)
    lj, cj = np.asarray(lj), np.asarray(cj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=RTOL, atol=ATOL)
    assert not lt.numpy()[~valid].any()            # invalid rows: zeros
    # every live page; the scratch page (0) takes the invalid rows'
    # writes, several to one (page, offset), with no fixed winner
    np.testing.assert_allclose(ct.numpy()[:, :, 1:], cj[:, :, 1:],
                               rtol=RTOL, atol=ATOL)
    assert not np.array_equal(ct.numpy()[:, :, 1:], cache[:, :, 1:])


def test_extend_matches_forward(model):
    """The extend step reproduces the one-shot forward at every valid row,
    and zeroes the padded ones."""
    jc, jp, tc, tp = model
    pred = GenerativePredictor(tc, tp, slots=2, page_size=8, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, tc.vocab, size=13)
    pages = pred.pool.alloc(pred.pages_needed(13))
    bt = np.zeros((1, pred.max_pages_per_slot), np.int32)
    bt[0, :len(pages)] = pages
    tok = np.zeros((1, 16), np.int32)
    tok[0, :13] = tokens
    pos = np.arange(16, dtype=np.int32)[None]
    valid = np.zeros((1, 16), bool)
    valid[0, :13] = True
    got = pred.extend(tok, pos, bt, valid)
    ref = tfm.make_forward_fn(tc, device="cpu")(tp, tokens[None])[0].numpy()
    jref = np.asarray(jtfm.make_forward_fn(jc)(jp, tokens[None]))[0]
    np.testing.assert_allclose(got[0, :13], ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0, :13], jref, rtol=RTOL, atol=ATOL)
    assert np.all(got[0, 13:] == 0)


def test_draft_from_layers_matches_jax_and_shares_storage(model):
    jc, jp, tc, tp = model
    jd_cfg, jd = jtfm.draft_from_layers(jc, jp, 1)
    td_cfg, td = tfm.draft_from_layers(tc, tp, 1)
    assert {k: getattr(jd_cfg, k) for k in td_cfg.__dict__} == \
        td_cfg.__dict__ and td_cfg.n_layers == 1
    assert sorted(jd) == sorted(td)
    for k, v in td.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jd[k]))
        assert v.untyped_storage().data_ptr() == \
            tp[k].untyped_storage().data_ptr(), k
    assert td["embed_weight"] is tp["embed_weight"]
    assert td["attn_qkv_weight"].shape[0] == 1
    for n in (0, tc.n_layers + 1):
        with pytest.raises(ValueError):
            tfm.draft_from_layers(tc, tp, n)


def test_draft_predictor_copies_nothing(model):
    """A spec server's draft binds views of the target's fp32 tensors."""
    _, _, tc, tp = model
    with GenerateServer(tc, tp, slots=2, page_size=8, spec_k=2, draft=1,
                        device="cpu") as srv:
        target, draft = srv.predictor._params, srv.draft_predictor._params
        for k, v in draft.items():
            assert v.untyped_storage().data_ptr() == \
                target[k].untyped_storage().data_ptr(), k
        assert srv.draft_predictor.slots == srv.predictor.slots
        assert srv.draft_predictor.config.n_layers == 1


# ---------------------------------------------------------------------------
# PrefixIndex + PagePool: one random sequence through both packages
# ---------------------------------------------------------------------------
class _Both:
    """A pool and an index of one package; each operation returns what
    it returned, or the exception's class name."""

    def __init__(self, mod, pages, page_size, max_pages):
        self.pool = mod.PagePool(pages)
        self.idx = mod.PrefixIndex(page_size, max_pages)

    def do(self, op, *a):
        try:
            if op in ("alloc", "ref", "unref"):
                return getattr(self.pool, op)(*a)
            if op == "clear":
                return self.idx.clear(self.pool)
            return getattr(self.idx, op)(*a, self.pool)
        except Exception as e:
            return type(e).__name__

    def state(self):
        return (dict(self.pool._refcount), self.pool.stats(),
                self.idx.stats(), self.idx.pages)


@pytest.mark.parametrize("max_pages", [0, 5])
def test_pool_and_index_sequence_matches_jax(max_pages):
    rng = np.random.RandomState(11)
    ours = _Both(tgen, 12, 4, max_pages)
    theirs = _Both(jgen, 12, 4, max_pages)
    prefixes = [rng.randint(0, 6, 8).tolist() for _ in range(3)]
    held, seen = [], set()
    for step in range(300):
        op = rng.randint(0, 8)
        if op == 0:
            args = ("alloc", int(rng.randint(0, 5)))
        elif op == 1 and held:
            args = ("unref", held.pop(rng.randint(len(held))))
        elif op == 2 and held:
            args = ("ref", list(held[rng.randint(len(held))]))
        elif op == 3:
            toks = prefixes[rng.randint(3)] + rng.randint(0, 6, int(
                rng.randint(0, 9))).tolist()
            args = ("match", toks)
        elif op == 4 and held:
            pages = held[rng.randint(len(held))]
            toks = prefixes[rng.randint(3)] + rng.randint(0, 6, 8).tolist()
            args = ("insert", toks[:4 * len(pages)], pages)
        elif op == 5:
            args = ("evict_lru",)
        elif op == 6:
            # a foreign id, or a page already returned: both raise
            args = (("unref", "ref")[rng.randint(2)],
                    [int(rng.randint(1, 20))])
        elif op == 7 and step % 50 == 0:
            args = ("clear",)
        else:
            continue
        a, b = ours.do(*args), theirs.do(*args)
        assert a == b, (step, args, a, b)
        if args[0] in ("alloc", "match") and isinstance(a, list) and a:
            held.append(a)
        assert ours.state() == theirs.state(), (step, args)
        seen.add((args[0], isinstance(a, str)))
    for pages in held:
        assert ours.do("unref", pages) == theirs.do("unref", pages)
    ours.do("clear")
    theirs.do("clear")
    assert ours.state() == theirs.state()
    # every kind of operation ran, and some of them raised
    assert {op for op, _ in seen} >= {"alloc", "unref", "ref", "match",
                                       "insert", "evict_lru", "clear"}
    assert any(raised for _, raised in seen)


# ---------------------------------------------------------------------------
# tests/test_prefix_spec.py's index tests, on the port
# ---------------------------------------------------------------------------
def test_refcount_torture_randomized_interleavings():
    rng = np.random.default_rng(7)
    pool = PagePool(8)
    idx = PrefixIndex(page_size=4)
    live = []
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0 and pool.free_pages >= 3:
            tokens = rng.integers(0, 16, size=9).tolist()
            matched = idx.match(tokens, pool)
            pages = matched + pool.alloc(3 - len(matched))
            idx.insert(tokens, pages, pool)
            live.append(pages)
        elif op == 1 and live:
            pool.unref(live.pop(rng.integers(0, len(live))))
        elif op == 2:
            idx.evict_lru(pool)
        elif op == 3 and live and pool.free_pages:
            live[rng.integers(0, len(live))].extend(pool.alloc(1))
    for pages in live:
        pool.unref(pages)
    idx.clear(pool)
    s = pool.stats()
    assert s["in_use"] == 0 and s["free"] == pool.num_pages
    assert s["allocs"] == s["frees"]
    assert s["ref_high_water"] >= 2
    assert idx.pages == 0


def test_prefix_match_longest_and_tail_cap():
    pool = PagePool(8)
    idx = PrefixIndex(page_size=4)
    tokens = list(range(12))
    pages = pool.alloc(3)
    idx.insert(tokens, pages, pool)
    assert idx.pages == 3
    assert all(pool.refcount(p) == 2 for p in pages)
    m = idx.match(tokens, pool)
    assert m == pages[:2]                 # (len - 1) // page_size pages
    pool.unref(m)
    m = idx.match(tokens + [99, 98], pool)
    assert m == pages
    pool.unref(m)
    m = idx.match(tokens[:4] + [33] * 8, pool)
    assert m == pages[:1]
    pool.unref(m)
    assert idx.match(tokens[:4], pool) == []
    assert idx.match([], pool) == []


def test_prefix_insert_dedupes_and_keeps_indexed_page():
    """The reference quirk the port keeps: a duplicate run keeps the
    already-indexed page, and the second request's copy stays private."""
    pool = PagePool(8)
    idx = PrefixIndex(page_size=4)
    tokens = list(range(8))
    first = pool.alloc(2)
    idx.insert(tokens, first, pool)
    dup = pool.alloc(2)
    assert idx.insert(tokens, dup, pool) == 0
    assert all(pool.refcount(p) == 1 for p in dup)
    m = idx.match(tokens + [1], pool)
    assert m == first
    pool.unref(m)


def test_prefix_evict_lru_order_and_shared_page_survival():
    pool = PagePool(8)
    idx = PrefixIndex(page_size=2)
    a, b = pool.alloc(1), pool.alloc(1)
    idx.insert([0, 1], a, pool)
    idx.insert([2, 3], b, pool)
    assert idx.match([0, 1, 9], pool) == a
    assert idx.evict_lru(pool)
    assert pool.refcount(b[0]) == 1
    assert idx.match([2, 3, 9], pool) == []
    pool.unref(a)
    assert idx.evict_lru(pool)
    assert pool.refcount(a[0]) == 1
    pool.unref(a)
    pool.unref(b)
    assert not idx.evict_lru(pool)
    assert pool.in_use == 0


def test_prefix_index_max_pages_bound():
    pool = PagePool(8)
    idx = PrefixIndex(page_size=2, max_pages=2)
    pages = pool.alloc(4)
    idx.insert([0, 1, 2, 3], pages[:2], pool)
    idx.insert([4, 5, 6, 7], pages[2:], pool)
    assert idx.pages <= 2
    assert idx.stats()["evictions"] >= 2
    idx.clear(pool)
    pool.unref(pages)
    assert pool.in_use == 0


def test_prefix_eviction_deepest_leaf_first():
    pool = PagePool(8)
    idx = PrefixIndex(page_size=2)
    pages = pool.alloc(3)
    idx.insert([0, 1, 2, 3, 4, 5], pages, pool)
    assert idx.evict_lru(pool)
    m = idx.match([0, 1, 2, 3, 9], pool)
    assert m == pages[:2]
    pool.unref(m)
    idx.clear(pool)
    pool.unref(pages)
    assert pool.in_use == 0


# ---------------------------------------------------------------------------
# knobs and profiler counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knob,bad", [
    ("MXNET_GENERATE_PREFIX_CACHE", "maybe"),
    ("MXNET_GENERATE_PREFIX_EVICT", "-3"),
    ("MXNET_GENERATE_SPEC_K", "2.5"),
    ("MXNET_GENERATE_DRAFT", "one"),
])
def test_malformed_knob_raises_naming_knob(monkeypatch, knob, bad):
    monkeypatch.setenv(knob, bad)
    with pytest.raises(GenerateError) as ei:
        GenerateServer(config=object(), params={}, device="cpu")
    assert knob in str(ei.value)


def test_knobs_turn_the_features_on(model, monkeypatch):
    _, _, tc, tp = model
    monkeypatch.setenv("MXNET_GENERATE_PREFIX_CACHE", "1")
    monkeypatch.setenv("MXNET_GENERATE_PREFIX_EVICT", "7")
    monkeypatch.setenv("MXNET_GENERATE_SPEC_K", "3")
    monkeypatch.setenv("MXNET_GENERATE_DRAFT", "1")
    with GenerateServer(tc, tp, slots=2, page_size=8, device="cpu") as srv:
        assert srv.prefix is not None and srv.prefix.max_pages == 7
        assert srv.prefix_stats()["pages"] == 0
        assert srv.draft_predictor.config.n_layers == 1
        assert srv._spec_k == 3
    with GenerateServer(tc, tp, slots=2, page_size=8, device="cpu",
                        prefix_cache=False, spec_k=0) as srv:
        assert srv.prefix is None and srv.draft_predictor is None
        assert srv.prefix_stats() is None


def test_spec_without_draft_raises(model):
    _, _, tc, tp = model
    with pytest.raises(GenerateError) as ei:
        GenerateServer(config=tc, params=tp, slots=2, page_size=8,
                       spec_k=2, device="cpu")
    assert "MXNET_GENERATE_DRAFT" in str(ei.value)
    with pytest.raises(GenerateError, match="n_layers must lie"):
        GenerateServer(config=tc, params=tp, slots=2, page_size=8,
                       spec_k=2, draft=3, device="cpu")


_RECORDS = [
    dict(prefix_hits=2, shared_pages=5, prefill_tokens_saved=80,
         prefix_evictions=1, draft_proposed=10, draft_accepted=7,
         spec_rounds=4, page_ref_high_water=3, prefix_pages=6),
    dict(requests=3, prefills=2, prefill_tokens=40, tokens=9,
         busy_seconds=0.5, slot_steps=8, active_slot_steps=6,
         pages_in_use=2, pages_high_water=4, pool_pages=16,
         draft_proposed=4, draft_accepted=4),
]


@pytest.mark.parametrize("records", [_RECORDS[:1], _RECORDS],
                         ids=["prefix_spec", "mixed"])
def test_profiler_counters_match_jax(records):
    for rec in records:
        profiler.generate_record(**rec)
        jprofiler.generate_record(**rec)
    profiler.generate_record(ttfts=[0.01, 0.02])
    jprofiler.generate_record(ttfts=[0.01, 0.02])
    ours, theirs = profiler.generate_stats(), jprofiler.generate_stats()
    assert ours == theirs
    assert ours["prefix_hits"] == 2 and ours["prefix_pages"] == 6
    assert ours["acceptance_rate"] == round(
        ours["draft_accepted"] / ours["draft_proposed"], 3)
    with pytest.raises(ValueError):
        profiler.generate_record(prefix_hitz=1)


# ---------------------------------------------------------------------------
# copy-on-write and extend_tail, on the cache's bytes
# ---------------------------------------------------------------------------
def test_cow_shared_pages_never_written(model):
    _, _, tc, tp = model
    pred = GenerativePredictor(tc, tp, slots=2, page_size=8, device="cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, tc.vocab, size=21)       # 2 full pages + 5
    pages = pred.pool.alloc(3)
    pred.prefill(prompt, pages)
    shared = pages[:2]
    before = pred._kv[:, :, shared].clone()
    tail = rng.integers(1, tc.vocab, size=6)
    pred.pool.ref(shared)
    priv2 = pred.pool.alloc(1)
    logits = pred.extend_tail(tail, 16, shared + priv2)
    assert logits.shape == (tc.vocab,)
    assert torch.equal(pred._kv[:, :, shared], before)   # bit for bit
    assert pred._kv[:, :, priv2].any()
    prompt2 = np.concatenate([prompt[:16], tail])
    ref = pred.prefill(prompt2, pred.pool.alloc(pred.pages_needed(22)))
    np.testing.assert_allclose(logits, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tail,start,match", [
    ([1, 2], 3, "not page-aligned"),
    ([1] * 60, 8, "exceeds the per-slot context bound"),
    ([], 8, "empty tail"),
])
def test_extend_tail_rejects_unaligned_or_oversized(model, tail, start,
                                                     match):
    _, _, tc, tp = model
    pred = GenerativePredictor(tc, tp, slots=2, page_size=8, device="cpu")
    with pytest.raises(GenerateError, match=match):
        pred.extend_tail(tail, start, [1])


# ---------------------------------------------------------------------------
# the server: exact against the port's own plain runs
# ---------------------------------------------------------------------------
def _shared_prompts(seed=0, n=4, prefix_pages=2, page=8, tail=5, vocab=64):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=prefix_pages * page).tolist()
    return [prefix + rng.integers(1, vocab, size=tail).tolist()
            for _ in range(n)] + [rng.integers(1, vocab, size=7).tolist()]


def _greedy(srv, prompts, max_new=8):
    return [srv.generate(p, max_new_tokens=max_new)["tokens"]
            for p in prompts]


def _serve(params_cfg, prompts, **kw):
    tc, tp = params_cfg
    profiler.generate_reset()
    with GenerateServer(tc, tp, slots=2, page_size=8, max_steps=8,
                        device="cpu", **kw) as srv:
        outs = _greedy(srv, prompts)
        stats = srv.stats()
        in_use_before = srv.predictor.pool.in_use
        index_pages = srv.prefix.pages if srv.prefix is not None else 0
        srv.clear_prefix()
        pools = [srv.predictor.pool.stats()]
        if srv.draft_predictor is not None:
            pools.append(srv.draft_predictor.pool.stats())
    assert in_use_before == index_pages
    for pool in pools:
        assert pool["in_use"] == 0 and pool["allocs"] == pool["frees"]
    return outs, stats


def test_server_prefix_parity_and_token_accounting(model):
    _, _, tc, tp = model
    prompts = _shared_prompts()
    base, off = _serve((tc, tp), prompts)
    outs, on = _serve((tc, tp), prompts, prefix_cache=True)
    assert outs == base
    assert off["prefill_tokens"] == sum(map(len, prompts))
    assert on["prefix_hits"] == 3 and on["shared_pages"] == 6
    assert on["prefill_tokens_saved"] == 3 * 16
    assert on["prefill_tokens"] + on["prefill_tokens_saved"] \
        == off["prefill_tokens"]
    assert on["page_ref_high_water"] >= 2 and "prefix_pages" in on


def test_server_spec_parity_and_acceptance(model):
    _, _, tc, tp = model
    prompts = _shared_prompts(seed=11)
    base, _ = _serve((tc, tp), prompts)
    outs, st = _serve((tc, tp), prompts, spec_k=3, draft=1)
    assert outs == base
    assert st["spec_rounds"] > 0 and st["draft_proposed"] > 0
    assert 0.0 <= st["acceptance_rate"] <= 1.0
    assert st["tokens"] == sum(map(len, outs))


def test_server_prefix_plus_spec_combined_parity(model):
    _, _, tc, tp = model
    prompts = _shared_prompts(seed=13)
    base, _ = _serve((tc, tp), prompts)
    outs, st = _serve((tc, tp), prompts, prefix_cache=True, spec_k=2,
                      draft=1)
    assert outs == base
    assert st["prefix_hits"] > 0 and st["draft_proposed"] > 0


def test_server_concurrent_prefix_spec_parity(model):
    """Requests admitted together (two share a round before the index
    holds their prefix) still give the plain chains."""
    _, _, tc, tp = model
    prompts = _shared_prompts(seed=17, n=6)
    base, _ = _serve((tc, tp), prompts)
    profiler.generate_reset()
    with GenerateServer(tc, tp, slots=3, page_size=8, max_steps=8,
                        device="cpu", prefix_cache=True, spec_k=3,
                        draft=1) as srv:
        futs = [srv.submit(p, max_new_tokens=8) for p in prompts]
        outs = [f.result(timeout=120)["tokens"] for f in futs]
        srv.clear_prefix()
        assert srv.predictor.pool.in_use == 0
        assert srv.draft_predictor.pool.in_use == 0
    assert outs == base


def test_prefix_eviction_under_pool_pressure(model):
    """With a pool the index's pins would otherwise starve, LRU eviction
    keeps every request admissible."""
    _, _, tc, tp = model
    pred = GenerativePredictor(tc, tp, slots=1, page_size=8, max_ctx=64,
                               device="cpu")            # pool = 8 pages
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, tc.vocab, size=26).tolist() for _ in range(5)]
    with GenerateServer(predictor=pred, max_steps=4, prefix_cache=True) \
            as srv:
        outs = [srv.generate(p, max_new_tokens=4) for p in prompts]
        st = srv.stats()
        srv.clear_prefix()
        assert pred.pool.in_use == 0
    assert all(len(o["tokens"]) == 4 for o in outs)
    assert st["prefix_evictions"] > 0
    assert st["exhausted"] == 0 and st["finished"] == 5


# ---------------------------------------------------------------------------
# the reference quirks the port keeps
# ---------------------------------------------------------------------------
def _tie_logits(logits, lead):
    """Logits whose top two entries, tokens 0 and 1, tie (or, with
    ``lead``, token ``lead`` leads by 1)."""
    out = np.zeros_like(logits)
    out[..., 0] = out[..., 1] = 5.0
    if lead is not None:
        out[..., lead] = 6.0
    return out


@pytest.mark.parametrize("draft_lead,accepted", [(None, True), (1, False)],
                         ids=["draft_ties_too", "draft_picks_second"])
def test_acceptance_is_exact_argmax_first_index_on_ties(model, draft_lead,
                                                         accepted):
    """The target's logits tie tokens 0 and 1: its token is 0, the first
    index. A draft that also ties proposes 0, which is accepted; a draft
    that proposes 1 is rejected although 1 ties with the target's top."""
    _, _, tc, tp = model
    with GenerateServer(tc, tp, slots=2, page_size=8, max_steps=8,
                        spec_k=2, draft=1, device="cpu") as srv:
        pred, draft = srv.predictor, srv.draft_predictor
        extend, decode = pred.extend, draft.decode
        pred.extend = lambda *a: _tie_logits(extend(*a), None)
        draft.decode = lambda *a: _tie_logits(decode(*a), draft_lead)
        out = srv.generate(np.arange(1, 10), max_new_tokens=7)["tokens"]
        st = srv.stats()
    assert out[1:] == [0] * 6
    assert st["draft_proposed"] > 0
    assert st["draft_accepted"] == (st["draft_proposed"] if accepted else 0)


def test_last_round_verifies_past_max_new_tokens(model):
    """k_i = min(k, max_ctx - L), not the tokens left: with 2 tokens left a
    k = 6 round still verifies 7 rows, and _check_done cuts the chain."""
    _, _, tc, tp = model
    prompt = np.arange(1, 10)
    with GenerateServer(tc, tp, slots=1, page_size=8, max_steps=8,
                        device="cpu") as srv:
        base = srv.generate(prompt, max_new_tokens=3)["tokens"]
    rows = []
    with GenerateServer(tc, tp, slots=1, page_size=8, max_steps=8,
                        spec_k=6, draft=1, device="cpu") as srv:
        extend = srv.predictor.extend

        def counting(tokens, positions, block_tables, valid):
            rows.append(int(np.asarray(valid).sum()))
            return extend(tokens, positions, block_tables, valid)

        srv.predictor.extend = counting
        out = srv.generate(prompt, max_new_tokens=3)
        assert srv.predictor.pool.in_use == 0
    assert out["tokens"] == base and out["finish_reason"] == "length"
    assert rows[0] == 7                           # 1 pending + 6 proposals
    # a round near the context bound verifies fewer: max_ctx - L proposals
    with GenerateServer(tc, tp, slots=1, page_size=8, max_steps=8,
                        spec_k=6, draft=1, device="cpu") as srv:
        extend = srv.predictor.extend
        rows.clear()
        srv.predictor.extend = counting
        out = srv.generate(np.arange(1, 62) % 60, max_new_tokens=3)
    assert rows[0] == 1 + 64 - 62 and len(out["tokens"]) == 3


# ---------------------------------------------------------------------------
# one cross-package run
# ---------------------------------------------------------------------------
COUNTERS = ("prefill_tokens", "prefill_tokens_saved", "prefix_hits",
            "spec_rounds", "draft_proposed", "draft_accepted")


def test_prefix_spec_server_matches_jax_server(model):
    jc, jp, tc, tp = model
    prompts = _shared_prompts(seed=23)
    kw = dict(slots=2, page_size=8, max_steps=8, prefix_cache=True,
              spec_k=2, draft=1)
    with GenerateServer(tc, tp, device="cpu", **kw) as srv:
        ours = _greedy(srv, prompts)
        ours_st = srv.stats()
    with JaxGenerateServer(jc, jp, **kw) as srv:
        theirs = _greedy(srv, prompts)
        theirs_st = srv.stats()
    assert ours == theirs
    assert {k: ours_st[k] for k in COUNTERS} == \
        {k: theirs_st[k] for k in COUNTERS}
    assert ours_st["prefix_hits"] == 3 and ours_st["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's traces and its near-tie rule for chains on the card
# ---------------------------------------------------------------------------
def _bench_serve():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_serve.py")
    spec = importlib.util.spec_from_file_location("bench_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_prefix_trace_and_damping_are_bench_serves():
    import chip_smoke as cs

    bs = _bench_serve()
    t = cs.PREFIX_TRACE
    prefix, work = bs._sample_prefix_workload(
        t["requests"], t["rate"], t["seed"], t["prefix"], 32000,
        share_frac=t["share"], tail_lo=t["tail"][0], tail_hi=t["tail"][1],
        free_lo=t["free"][0], free_hi=t["free"][1], out_len=t["new"])
    ours_prefix, ours = cs._prefix_workload(32000)
    assert ours_prefix == prefix
    assert ours == [(a, p, s) for a, p, _n, s in work]
    params = tfm.init_params(tfm.TransformerConfig(**SMALL), seed=0)
    theirs = bs._damp_upper_layers({k: v.numpy() for k, v in params.items()},
                                   cs.SPEC_TRACE["damp"])
    for k, v in cs._damp_upper_layers(params, cs.SPEC_TRACE["damp"]).items():
        np.testing.assert_array_equal(v.numpy(), theirs[k])


def _forward_with_top(top, second):
    """A stand-in one-shot forward whose last row has logit 1.0 at token
    ``top`` and 1.0 - gap at token ``second``."""
    def fwd(_params, chain):
        out = torch.zeros(1, chain.shape[1], 16)
        out[0, -1, top[0]] = 1.0
        out[0, -1, second[0]] = 1.0 - second[1]
        return out
    return fwd


@pytest.mark.parametrize("b,gap,parted", [
    ([5, 3, 7], 0.0, None),            # equal chains
    ([5, 4, 9], 0.0, (1, 0.0)),        # an exact tie
    ([5, 4, 9], 0.04, (1, 0.04)),      # both tokens within LOGIT_TOL
    ([5, 4, 9], 0.08, "raises"),       # a gap under 2 * LOGIT_TOL, but the
                                       # second token past LOGIT_TOL
    ([5, 4, 9], 0.2, "raises"),        # the second token far below the top
    ([5, 3], 0.0, "raises"),           # a chain cut short, no difference
], ids=["equal", "tie", "near", "past_tol", "apart", "short"])
def test_chip_smoke_near_tie_rule(b, gap, parted):
    import chip_smoke as cs

    fwd = _forward_with_top((3,), (4, gap))
    pairs = [([1, 2], [5, 3, 7], b)]
    if parted == "raises":
        with pytest.raises(RuntimeError):
            cs._near_tie_pairs(torch, np, fwd, None, pairs, "t")
        return
    got = cs._near_tie_pairs(torch, np, fwd, None, pairs, "t")
    if parted is None:
        assert got == []
    else:
        assert got[0][0] == parted[0]
        assert got[0][1] == pytest.approx(parted[1], abs=1e-6)
