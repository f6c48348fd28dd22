"""The sharded ``GenerativePredictor(mesh=)`` and ``GenerateServer`` over it
in the port, on 2 gloo ranks on the CPU (``tests/torch_mp_workers.py``):
rank 0 leads, rank 1 follows in lockstep.

Held against the JAX package's sharded predictor (a ``(dp 1, mp 2)`` mesh
of CPU devices, tests/test_model_parallel.py's setup: the tiny model at
max_len 32, 2 slots, pages of 4) and the port's one-device predictor:
prefill, decode, extend and extend_tail logits within rtol 1e-4 / atol
1e-5 with the same argmax; ``sharded_stats()`` equal to the JAX dict. The
served tokens (fp32, greedy) and prefix-cache counters equal the
one-device server's exactly. A follower killed mid-serve makes the leader
raise, not hang.
"""
import os
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.serving.generate import GenerativePredictor as JPredictor
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serving import GenerateServer
from mxnet_tpu_torch.serving.generate import GenerativePredictor

import torch_dp_workers as w
import torch_mp_workers as mw

RANK_TIMEOUT = 240
TOL = dict(rtol=1e-4, atol=1e-5)


def _params():
    return ttfm.init_params(ttfm.TransformerConfig(**mw.SERVE_CFG), seed=0)


def _jax_predictor():
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "mp"))
    return JPredictor(jtfm.TransformerConfig(**mw.SERVE_CFG),
                      {k: v.numpy() for k, v in _params().items()},
                      slots=mw.SLOTS, page_size=mw.PAGE, mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded ranks, a killed-follower pair (both started first), the
    JAX sharded predictor's script and the one-device port's, computed
    meanwhile."""
    out = tmp_path_factory.mktemp("mp_serve")
    dead_out = tmp_path_factory.mktemp("mp_dead")
    ctx = w.start_ranks("torch_mp_workers:mp_serve_worker", 2, out)
    dead = w.start_ranks("torch_mp_workers:dead_follower_worker", 2,
                         dead_out)
    jpred = _jax_predictor()
    ref = {"jax": mw.predictor_script(jpred),
           "jax_stats": jpred.sharded_stats()}
    cfg = ttfm.TransformerConfig(**mw.SERVE_CFG)
    ref["one"] = mw.predictor_script(GenerativePredictor(
        cfg, _params(), slots=mw.SLOTS, page_size=mw.PAGE, device="cpu"))
    ref["served"] = {on: mw.serve(GenerateServer, cfg, _params(), on,
                                  device="cpu") for on in (False, True)}
    ranks = w.join_ranks(ctx, out, RANK_TIMEOUT)
    # the killed follower ends with a signal, so only the leader is joined
    # (and the rest killed at the time limit)
    deadline = time.monotonic() + RANK_TIMEOUT
    leader = dead.processes[0]
    leader.join(max(deadline - time.monotonic(), 0.1))
    alive = leader.is_alive()
    for p in dead.processes:
        if p.is_alive():
            p.kill()
    assert not alive, "the leader hung on a dead follower"
    ref["dead"] = torch.load(os.path.join(dead_out, "rank0.pt"),
                             weights_only=False)
    return ranks, ref


@pytest.mark.parametrize("call", ["prefill", "decode", "extend",
                                  "extend_tail"])
def test_sharded_logits_match_jax_and_one_device(runs, call):
    ranks, ref = runs
    got = ranks[0]["script"][call]
    cfg = mw.SERVE_CFG
    assert got.shape[-1] == cfg["vocab"] and np.isfinite(got).all()
    for want in (ref["jax"][call], ref["one"][call]):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_sharded_stats_match_jax(runs):
    """Measured per-rank bytes: half the KV pages' heads on each rank."""
    ranks, ref = runs
    stats = ranks[0]["stats"]
    assert stats == ref["jax_stats"]
    assert stats["kv_bytes_per_chip"] * 2 == stats["kv_bytes_total"]
    assert ranks[0]["mp_stats"] == {
        "group_size": 2, "mp_size": 2,
        "param_bytes_per_chip": stats["param_bytes_per_chip"],
        "live_bytes_per_chip": stats["param_bytes_per_chip"]
        + stats["kv_bytes_per_chip"]}
    heads = mw.SERVE_CFG["n_heads"] // 2
    for r in ranks:
        assert r["kv_shape"][4] == heads


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["plain", "prefix"])
def test_served_tokens_equal_one_device(runs, prefix_cache):
    ranks, ref = runs
    got, want = ranks[0]["served"][prefix_cache], ref["served"][prefix_cache]
    assert got == want
    if prefix_cache:
        assert got["hits"] == 2 and got["saved"] == 16


def test_followers_run_every_call_and_exit_at_close(runs):
    """The follower returned from each of its three ``follow()`` loops
    (the ranks joined), having run the leader's calls: the script's four,
    then each server's prefills (full, or tails through ``extend``) and
    decode steps."""
    ranks, _ref = runs
    script, plain, prefix = ranks[1]["calls"]
    assert script == {"prefill": 1, "decode": 1, "extend": 2}
    served = ranks[0]["served"]
    assert plain["prefill"] == served[False]["prefills"] == 6
    assert plain["extend"] == 0 and prefix["extend"] == served[True]["hits"]
    assert prefix["prefill"] + prefix["extend"] == served[True]["prefills"]
    assert plain["decode"] > 0 and prefix["decode"] > 0


def test_refusals_on_a_mesh(runs):
    ranks, _ref = runs
    errors = ranks[0]["errors"]
    assert "item 8b" in errors["spec"] and "spec_k=2" in errors["spec"]
    assert "mesh= OR device=" in errors["device"]
    assert "closed" in errors["closed"]


def test_leader_raises_when_a_follower_dies(runs):
    _ranks, ref = runs
    dead = ref["dead"]
    assert dead["error"] is not None and "GenerateError" in dead["error"]
    assert "lockstep is broken" in dead["error"]
    assert dead["seconds"] < 60


def test_follow_and_close_outside_a_mesh():
    """One device: ``follow`` raises, ``close`` is a no-op and the
    predictor keeps serving."""
    from mxnet_tpu_torch.serving.generate import GenerateError

    cfg = ttfm.TransformerConfig(**mw.SERVE_CFG)
    pred = GenerativePredictor(cfg, _params(), slots=mw.SLOTS,
                               page_size=mw.PAGE, device="cpu")
    with pytest.raises(GenerateError, match="follow"):
        pred.follow()
    pred.close()
    with pytest.raises(GenerateError, match="not bound on a mesh"):
        pred.sharded_stats()
    assert pred.prefill(np.array([1, 2], np.int32),
                        pred.pool.alloc(1)).shape == (cfg.vocab,)
