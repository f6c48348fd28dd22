"""Generative serving of the PyTorch port against the JAX package.

- Greedy token chains: the port's ``GenerateServer(device="cpu")`` and the
  JAX package's ``GenerateServer`` serve the same prompts from the same
  params and must emit identical tokens, under both admission policies,
  with every KV page returned afterwards.
- The page pool: the JAX package's accounting and typed-exhaustion tests,
  run as cases against both pools side by side.
- The port's own contract: default device is ``cuda`` and raises without
  one, malformed knobs raise naming the knob, the prefix cache and
  speculative decoding run, and importing the port pulls in neither JAX
  nor ``mxnet_tpu``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import profiler as jprofiler
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.serving import GenerateServer as JaxGenerateServer
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serving import (
    GenerateError,
    GenerateServer,
    GenerativePredictor,
    PagePool,
    PagePoolExhausted,
    ServerClosed,
)
from mxnet_tpu_torch.serving import generate as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64, dtype="float32")


@pytest.fixture(scope="module")
def model():
    cfg = ttfm.TransformerConfig(**SMALL)
    return cfg, ttfm.init_params(cfg, seed=0)


@pytest.fixture(autouse=True)
def _reset_counters():
    tprofiler.generate_reset()
    jprofiler.generate_reset()
    yield
    tprofiler.generate_reset()
    jprofiler.generate_reset()


# ---------------------------------------------------------------------------
# greedy chains: port == JAX package
# ---------------------------------------------------------------------------
def _requests(seed, n):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (int(rng.randint(2, 40)),)).astype(np.int32),
             int(rng.randint(1, 14))) for _ in range(n)]


def _serve(server, reqs):
    with server as srv:
        futs = [srv.submit(p, max_new_tokens=m) for p, m in reqs]
        out = [f.result(timeout=120) for f in futs]
        return out, srv.stats(), srv.predictor.pool.stats()


@pytest.mark.parametrize("policy", ["continuous", "drain"])
def test_greedy_chains_match_jax_server(model, policy):
    cfg, params = model
    reqs = _requests(7, 10)
    kw = dict(slots=3, page_size=8, max_steps=16, admit_policy=policy)
    ours, stats, pool = _serve(
        GenerateServer(cfg, params, device="cpu", **kw), reqs)
    theirs, _, _ = _serve(
        JaxGenerateServer(jtfm.TransformerConfig(**SMALL),
                          {k: v.numpy() for k, v in params.items()}, **kw),
        reqs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a["tokens"] == b["tokens"], "request %d" % i
        assert a["finish_reason"] == b["finish_reason"] == "length"
        assert len(a["tokens"]) == reqs[i][1]
    assert stats["finished"] == len(reqs)
    assert stats["pages_in_use"] == 0
    assert pool["in_use"] == 0 and pool["allocs"] == pool["frees"] > 0
    assert stats["prefills"] == len(reqs)
    assert stats["ttft_p99_ms"] >= stats["ttft_p50_ms"] > 0


def test_eos_stops_early_and_streams(model):
    cfg, params = model
    chunks = []
    with GenerateServer(cfg, params, device="cpu", slots=2, page_size=8,
                        max_steps=16, stream_flush=2) as srv:
        toks = srv.generate(np.arange(4, 20), max_new_tokens=6)["tokens"]
        eos = toks[3]
        r = srv.generate(np.arange(4, 20), max_new_tokens=12, eos_id=eos,
                         stream_fn=chunks.append)
        assert r["finish_reason"] == "eos"
        assert r["tokens"] == toks[:toks.index(eos) + 1]
        assert [t for c in chunks for t in c] == r["tokens"]
        assert srv.stats()["pages_in_use"] == 0


def test_submit_validation(model):
    cfg, params = model
    with GenerateServer(cfg, params, device="cpu", slots=2,
                        page_size=8) as srv:
        for bad in (dict(tokens=np.zeros((0,), np.int32)),
                    dict(tokens=np.arange(64)),          # == max_ctx
                    dict(tokens=np.arange(1, 9), max_new_tokens=0),
                    dict(tokens=np.arange(1, 9), deadline=-1),
                    dict(tokens=np.array([1, 64], np.int32)),
                    dict(tokens=np.array([-1, 2], np.int32))):
            with pytest.raises(GenerateError):
                srv.submit(**bad)
    with pytest.raises(ServerClosed):
        srv.submit(np.arange(1, 9))


def test_pool_exhaustion_backpressures_then_recycles(model):
    cfg, params = model
    pred = GenerativePredictor(cfg, params, slots=2, page_size=8,
                               max_ctx=64, device="cpu")
    pred.pool = PagePool(4)
    with GenerateServer(predictor=pred, max_steps=12) as srv:
        with pytest.raises(PagePoolExhausted):
            srv.submit(np.arange(1, 35), max_new_tokens=2)  # 5 > 4 pages
        a = srv.submit(np.arange(1, 21), max_new_tokens=8)   # 3 pages
        b = srv.submit(np.arange(2, 22), max_new_tokens=2)   # waits
        assert len(b.result(timeout=60)["tokens"]) == 2
        assert len(a.result(timeout=60)["tokens"]) == 8
        stats = srv.stats()
    assert stats["pages_in_use"] == 0 and stats["pages_high_water"] <= 4


def test_close_fails_queued_and_inflight_typed(model):
    cfg, params = model
    srv = GenerateServer(cfg, params, device="cpu", slots=1, page_size=8,
                         max_steps=60)
    inflight = srv.submit(np.arange(1, 9), max_new_tokens=50)
    queued = srv.submit(np.arange(2, 10), max_new_tokens=2)
    srv.close()
    for fut in (inflight, queued):
        with pytest.raises(ServerClosed):
            fut.result(timeout=10)
    assert srv.predictor.pool.in_use == 0


# ---------------------------------------------------------------------------
# page pool: the JAX package's accounting tests, on both pools
# ---------------------------------------------------------------------------
def _interleaved(pool_cls, _exhausted, _error):
    pool = pool_cls(6)
    a = pool.alloc(2)
    b = pool.alloc(3)
    assert len(set(a) | set(b)) == 5 and 0 not in a + b
    assert pool.in_use == 5 and pool.high_water == 5
    pool.free(a)
    c = pool.alloc(3)
    assert pool.in_use == 6
    pool.free(b)
    pool.free(c)
    assert pool.in_use == 0 and pool.free_pages == 6
    return a, b, c


def _exhaustion(pool_cls, exhausted, _error):
    pool = pool_cls(3)
    got = pool.alloc(2)
    with pytest.raises(exhausted):
        pool.alloc(2)
    assert pool.in_use == 2 and pool.free_pages == 1
    return got


def _double_free(pool_cls, _exhausted, error):
    pool = pool_cls(2)
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(error):
        pool.free(pages)
    with pytest.raises(error):
        pool.free([99])
    return pages


def _refcounts(pool_cls, _exhausted, error):
    pool = pool_cls(3)
    p = pool.alloc(2)
    pool.ref(p[:1])
    assert pool.refcount(p[0]) == 2
    pool.unref(p)
    assert pool.in_use == 1 and pool.refcount(p[0]) == 1
    with pytest.raises(error):
        pool.ref([3])
    pool.unref(p[:1])
    assert pool.in_use == 0
    return p


@pytest.mark.parametrize("scenario", [_interleaved, _exhaustion,
                                      _double_free, _refcounts],
                         ids=lambda f: f.__name__.strip("_"))
def test_page_pool_matches_jax_pool(scenario):
    ours = scenario(tgen.PagePool, tgen.PagePoolExhausted, tgen.GenerateError)
    theirs = scenario(jgen.PagePool, jgen.PagePoolExhausted,
                      jgen.GenerateError)
    assert ours == theirs      # same page ids handed out in the same order


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------
def test_default_device_is_cuda_and_raises_without_one(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    cfg, params = model
    with pytest.raises(MXNetError, match="cuda"):
        GenerateServer(cfg, params, slots=2, page_size=8)
    with pytest.raises(MXNetError, match="cuda"):
        GenerativePredictor(cfg, params, slots=2, page_size=8)


@pytest.mark.parametrize("knob,value", [
    ("MXNET_GENERATE_SLOTS", "zero"), ("MXNET_GENERATE_PAGE_SIZE", "0"),
    ("MXNET_GENERATE_POOL_BYTES", "-1"), ("MXNET_GENERATE_MAX_STEPS", "x"),
    ("MXNET_GENERATE_PREFIX_CACHE", "maybe"), ("MXNET_GENERATE_SPEC_K", "-2"),
    ("MXNET_SERVE_QUEUE_DEPTH", "0"), ("MXNET_SERVE_SUBMIT_TIMEOUT", "nan"),
])
def test_malformed_knob_raises_naming_it(model, monkeypatch, knob, value):
    cfg, params = model
    monkeypatch.setenv(knob, value)
    with pytest.raises(MXNetError, match=knob):
        GenerateServer(cfg, params, device="cpu")


def test_knob_defaults_match_jax_registry():
    from mxnet_tpu import config as jconfig

    for name, (default, _desc) in tconfig.KNOBS.items():
        assert jconfig.KNOBS[name][0] == default, name


@pytest.mark.parametrize("kw,counter", [
    (dict(prefix_cache=True), "prefix_hits"),
    (dict(spec_k=2, draft=1), "spec_rounds")])
def test_unported_features_raise_by_name(model, kw, counter):
    """The shared-prefix cache and speculative decoding, refused by name
    while they were not ported, now run, and ``stats()`` shows their
    counter."""
    cfg, params = model
    prompt = np.arange(1, 20)
    with GenerateServer(cfg, params, device="cpu", slots=2, page_size=8,
                        max_steps=8, **kw) as srv:
        first = srv.generate(prompt, max_new_tokens=4)["tokens"]
        again = srv.generate(prompt, max_new_tokens=4)["tokens"]
        stats = srv.stats()
    assert first == again and len(first) == 4
    assert stats[counter] > 0


def test_import_pulls_in_neither_jax_nor_mxnet_tpu():
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import mxnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mxnet_tpu_torch.__path__, 'mxnet_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print('IMPORTED', len(names), sorted(names))\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for name in ("parallel.spmd", "lr_scheduler", "kernels.flash_attention",
                 "models.transformer", "serving.broker",
                 "kernels.fused_block", "serving.predictor", "ir.passes",
                 "models.resnet", "executor", "initializer",
                 "parallel.mesh", "parallel.feed", "kvstore",
                 "module.spmd_group", "ops.nn", "ops.rnn", "models.lenet",
                 "models.mlp", "models.alexnet", "models.vgg",
                 "models.inception", "models.mobilenet", "models.resnext",
                 "parallel.tensor_parallel", "serving.generate",
                 "tune.table", "tune.search", "tune.model", "tune.harness",
                 "tune.background", "tune.pipeline", "tune.__main__",
                 "operator", "ops.custom", "monitor", "visualization", "rtc",
                 "executor_manager", "log", "libinfo", "util", "test_utils",
                 "contrib.tensorboard"):
        assert "'mxnet_tpu_torch.%s'" % name in r.stdout, name
