"""Tensor parallelism of a symbol in the PyTorch port (``param_rules`` over
the ``mp`` axis: ``parallel/symbol_mp.py``, ``TrainStep``, ``Module`` under
``MXNET_MP_SIZE``, ``AOTPredictor(mesh=)``, speculative decoding on a
sharded ``GenerativePredictor`` and the fleet's sharded replica group)
against the JAX package, on the CPU.

The port's ranks are gloo processes (``tests/torch_mp_symbol_workers.py``,
started through ``torch_dp_workers.start_ranks``); the JAX package runs in
this process on its 8 virtual CPU devices. Each case is the JAX package's
``tests/test_model_parallel.py`` case of the same name where there is one:

- ``Module(kvstore='tpu')`` under ``MXNET_MP_SIZE=2`` and the JAX test's
  rules on 4 ranks (dp 2 x mp 2), global batch 32, 2 epochs: the final
  weights within rtol 2e-5 / atol 2e-6 of the JAX mp run's (8 devices, dp
  4 x mp 2) and of the port's pure data-parallel run's; ``mp_stats``;
- ``TrainStep(param_rules=)`` for 3 steps against the JAX ``TrainStep`` on
  its mp mesh, rtol 1e-4 / atol 1e-5: an MLP whose rules make the Megatron
  pair, and a conv net whose conv weight and FC weight are gathered at use;
  the collectives each route runs; a planted fault (the row-parallel FC's
  sum over the mp group dropped) fails that parity;
- the rule grammar and ``ShardingRuleError``, case for case;
- the sharded predictor on 2 ranks: outputs within rtol 1e-5 / atol 1e-6
  of the JAX sharded and unsharded predictors, the bytes a rank in the
  ratio the rules give;
- speculative decoding on a sharded tiny transformer: the token chains of
  the unsharded port server and of the JAX ``GenerateServer(spec_k=)``;
- the group drain on a member's death and the group's validation, against
  a port replica group of 2 gloo ranks behind a tracker.
"""
import os
import signal
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
import torch_dp_workers as w
import torch_mp_symbol_workers as sw
from mxnet_tpu import nd as jnd

RANK_TIMEOUT = 240
TOL = dict(rtol=1e-4, atol=1e-5)
MODULE_TOL = dict(rtol=2e-5, atol=2e-6)
PRED_TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9)
BATCHES = 3


def _ranks(tmp_path_factory, name, world, *args):
    out = tmp_path_factory.mktemp(name.split(":")[-1])
    ctx = w.start_ranks("torch_mp_symbol_workers:" + name, world, out, *args)
    return ctx, out


def _jax_rules(text):
    from mxnet_tpu.parallel.spmd import parse_rules

    return parse_rules(text)


# ---------------------------------------------------------------------------
# Module under MXNET_MP_SIZE (the JAX test_mp_dp_composition_module_parity)
# ---------------------------------------------------------------------------
def _jax_module_fit(env, args0, epochs=2, batch=32):
    X, y, _ = sw.module_data()
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        it = jmx.io.NDArrayIter(X, y, batch_size=batch, shuffle=False)
        mod = jmx.mod.Module(sw.net(jmx, "mlp"),
                             context=[jmx.cpu(i) for i in range(8)])
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: jnd.NDArray(v.copy())
                                    for k, v in args0.items()})
        mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        assert mod._fused is not None
        for _ in range(epochs):
            it.reset()
            for b in it:
                mod.forward_backward(b)
                mod.update()
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def module_runs(tmp_path_factory):
    _X, _y, rng = sw.module_data()
    with tmx.cpu():
        args0 = sw.module_args(tmx, rng)
    env = {"MXNET_MP_SIZE": "2", "MXNET_MP_RULES": sw.MLP_RULES}
    mp = _ranks(tmp_path_factory, "module_worker", 4, env, args0)
    want = _jax_module_fit(env, args0)
    mp = w.join_ranks(*mp, RANK_TIMEOUT)
    dp = _ranks(tmp_path_factory, "module_worker", 4, {}, args0)
    dp = w.join_ranks(*dp, RANK_TIMEOUT)
    return mp, dp, want


def test_mp_dp_composition_module_parity(module_runs):
    mp, dp, want = module_runs
    for r in mp:
        assert r["fused"]
        for k, v in want.items():
            np.testing.assert_allclose(r["params"][k], v, **MODULE_TOL,
                                       err_msg="mp vs JAX mp: %s" % k)
            np.testing.assert_allclose(r["params"][k], dp[0]["params"][k],
                                       **MODULE_TOL,
                                       err_msg="mp vs port dp: %s" % k)


def test_mp_module_stats_and_blocks(module_runs):
    mp, dp, _want = module_runs
    stats = mp[0]["mp_stats"]
    assert stats["mp_size"] == 2 and stats["dp_size"] == 2
    assert stats["group_size"] == 4
    assert 0 < stats["param_bytes_per_chip"] < stats["live_bytes_per_chip"]
    # fc1 (32, 16) on its rows, fc2 (4, 32) on its columns; biases whole
    assert mp[0]["held"] == {"fc1_weight": (16, 16), "fc1_bias": (32,),
                             "fc2_weight": (4, 16), "fc2_bias": (4,)}
    assert stats["param_bytes_per_chip"] == 4 * (256 + 32 + 64 + 4)
    assert dp[0]["mp_stats"] == {} and dp[0]["held"]["fc1_weight"] == (32, 16)


def test_mp_module_batch_must_divide_by_dp(tmp_path_factory):
    ctx = _ranks(tmp_path_factory, "module_batch_worker", 4, 15)
    for err in w.join_ranks(*ctx, RANK_TIMEOUT):
        assert err == ("fused SPMD step: batch size 15 not divisible by the "
                       "dp size 2 (MXNET_MP_SIZE=2 over 4 devices)")


# ---------------------------------------------------------------------------
# TrainStep(param_rules=) against the JAX TrainStep
# ---------------------------------------------------------------------------
def _jax_trainstep(kind, rules, batches):
    from mxnet_tpu.parallel.mesh import train_mesh
    from mxnet_tpu.parallel.spmd import TrainStep

    sym = sw.net(jmx, kind)
    ts = TrainStep(sym, dict(OPT), mesh=train_mesh(mp=2),
                   param_rules=_jax_rules(rules))
    args, aux = sw.params(jmx, sym, kind)
    carry = ts.place(dict(args), ts.optimizer.init(dict(args)), dict(aux))
    losses = []
    for x, y in batches:
        carry, loss = ts(carry, {"data": x, "softmax_label": y})
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: np.asarray(v) for k, v in carry[0].items()},
            "aux": {k: np.asarray(v) for k, v in carry[2].items()}}


RULES = {"mlp": sw.MLP_RULES, "conv": sw.CONV_RULES}


@pytest.fixture(scope="module")
def trainstep_runs(tmp_path_factory):
    out = {}
    for kind in ("mlp", "conv"):
        batches = [sw.data(kind, 8, seed=s) for s in range(BATCHES)]
        ctx = _ranks(tmp_path_factory, "trainstep_worker", 2, kind,
                     RULES[kind], 2, batches, OPT)
        want = _jax_trainstep(kind, RULES[kind], batches)
        out[kind] = (w.join_ranks(*ctx, RANK_TIMEOUT), want)
    batches = [sw.data("mlp", 8, seed=s) for s in range(BATCHES)]
    ctx = _ranks(tmp_path_factory, "trainstep_worker", 2, "mlp",
                 RULES["mlp"], 2, batches, OPT, True)
    out["fault"] = (w.join_ranks(*ctx, RANK_TIMEOUT), out["mlp"][1])
    ctx = _ranks(tmp_path_factory, "trainstep_worker", 4, "mlp",
                 RULES["mlp"], 2, batches, OPT, False, True)
    out["zero"] = (w.join_ranks(*ctx, RANK_TIMEOUT), out["mlp"][1])
    return out


def _matches(got, want):
    try:
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **TOL,
                                       err_msg=k)
        for k, v in want["aux"].items():
            np.testing.assert_allclose(got["aux"][k], v, **TOL, err_msg=k)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_trainstep_param_rules_matches_jax(trainstep_runs, kind):
    ranks, want = trainstep_runs[kind]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], **TOL)
        assert set(r["params"]) == set(want["params"])
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["params"][k], v, **TOL, err_msg=k)
        for k, v in want["aux"].items():
            np.testing.assert_allclose(r["aux"][k], v, **TOL, err_msg=k)
    # replicated params stay bit for bit equal on the ranks
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k])


def test_trainstep_routes_and_blocks(trainstep_runs):
    """The MLP runs the Megatron pair (fc1's input copied and its whole bias
    scattered, fc2's partial product summed: one of each a step, nothing
    gathered); the conv net gathers its conv weight and its FC weight at
    each use. A rank holds half of each sharded weight, and of its
    optimizer state, which comes back whole."""
    (mlp, _), (conv, _) = trainstep_runs["mlp"], trainstep_runs["conv"]
    for r in mlp:
        assert r["counts"] == {"copy_to_mp": BATCHES,
                               "reduce_from_mp": BATCHES,
                               "gather_from_mp": 0,
                               "scatter_to_mp": BATCHES,
                               "reduce_from_data": 0, "ppermute": 0,
                               "all_to_all": 0, "all_gather": 0}
        assert r["held"]["fc1_weight"] == (16, 16)
        assert r["held"]["fc2_weight"] == (4, 16)
        assert r["opt"]["fc1_weight"][0].shape == (32, 16)
        # each step sends fc2's (8, 4) partial product, fc1_bias's (16,)
        # slice gradient
        assert r["bytes"]["reduce_from_mp"] == BATCHES * 8 * 4 * 4
        assert r["bytes"]["scatter_to_mp"] == BATCHES * 16 * 4
    for r in conv:
        assert r["counts"]["gather_from_mp"] == 2 * BATCHES
        assert r["counts"]["reduce_from_mp"] == 0
        assert r["held"]["conv1_weight"] == (4, 2, 3, 3)
        assert r["held"]["fc1_weight"] == (4, 36)
        assert r["bytes"]["gather_from_mp"] == BATCHES * 4 * (
            4 * 2 * 3 * 3 + 4 * 36)
    assert mlp[0]["mem"]["param_bytes_per_dev"] == 4 * (256 + 32 + 64 + 4)


def test_zero_composes_with_mp(trainstep_runs):
    """ZeRO on dp 2 x mp 2: the replicated params' updates shard over the
    data axis, the sharded params keep their blocks; the steps land where
    the JAX TrainStep's do, and the optimizer state comes back whole."""
    ranks, want = trainstep_runs["zero"]
    for r in ranks:
        assert r["mem"]["zero"] and r["mem"]["zero_params"] == 2
        assert r["mem"]["num_shards"] == 2
        assert _matches(r, want)
        assert r["opt"]["fc1_bias"][0].shape == (32,)
        assert r["opt"]["fc1_weight"][0].shape == (32, 16)


def test_parity_catches_planted_reduce(trainstep_runs):
    ranks, want = trainstep_runs["fault"]
    assert not any(_matches(r, want) for r in ranks)
    assert _matches(trainstep_runs["mlp"][0][0], want)


# ---------------------------------------------------------------------------
# the rules (the JAX test_mp_rules_grammar_and_rule_errors)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("text", [":", "nospec", "x:", "(:mp"])
def test_mp_rules_grammar_errors(text):
    from mxnet_tpu.base import MXNetError as JError
    from mxnet_tpu.parallel.spmd import parse_rules as jparse
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.spmd import parse_rules

    with pytest.raises(JError, match="MXNET_MP_RULES"):
        jparse(text)
    with pytest.raises(MXNetError, match="MXNET_MP_RULES"):
        parse_rules(text)


def test_mp_rules_grammar_parses_as_jax():
    from mxnet_tpu.parallel.spmd import parse_rules as jparse
    from mxnet_tpu_torch.parallel.spmd import parse_rules

    assert parse_rules("") == jparse("") == []
    text = ".*_weight:*,mp;bias$:mp"
    got, want = parse_rules(text), jparse(text)
    assert got[0][1] == (None, "mp") and got[1][1] == ("mp",)
    assert [(p, tuple(s)) for p, s in want] == got


@pytest.fixture(scope="module")
def rule_errors(tmp_path_factory):
    ctx = _ranks(tmp_path_factory, "rules_worker", 2)
    return w.join_ranks(*ctx, RANK_TIMEOUT)[0]


@pytest.mark.parametrize("case,match", [("odd", "odd_weight"),
                                        ("no_axis", "no axis")])
def test_mp_rule_errors_as_jax(rule_errors, case, match):
    import jax

    from mxnet_tpu.parallel.mesh import train_mesh
    from mxnet_tpu.parallel.spmd import ShardingRuleError, param_shardings

    params, rules = {
        "odd": ({"odd_weight": jax.numpy.zeros((7, 3))},
                [("odd_weight", (None, "mp"))]),
        "no_axis": ({"w": jax.numpy.zeros((4, 4))},
                    [("w", ("nope", None))])}[case]
    with pytest.raises(ShardingRuleError, match=match) as jerr:
        param_shardings(params, train_mesh(mp=2), rules)
    cls, msg = rule_errors[case]
    assert cls == "ShardingRuleError" and match in msg
    # the same reason, after the rule and the parameter
    assert msg.split(": ")[-1] == str(jerr.value).split(": ")[-1]


def test_mp_rule_that_fits_shards(rule_errors):
    assert rule_errors["fits"] == (None, {"w": (None, "mp")})


# ---------------------------------------------------------------------------
# the sharded predictor (the JAX test_mp_sharded_predictor_group)
# ---------------------------------------------------------------------------
def _pred_args():
    rng = np.random.RandomState(0)
    sym = sw.net(jmx, "pred")
    arg_shapes, _, _ = sym.infer_shape(data=(1, 8))
    args = {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    return sym, args, rng.randn(3, 8).astype(np.float32)


@pytest.fixture(scope="module")
def predictor_runs(tmp_path_factory):
    from mxnet_tpu.parallel.mesh import train_mesh
    from mxnet_tpu.serving import AOTPredictor

    sym, args, x = _pred_args()
    ctx = _ranks(tmp_path_factory, "predictor_worker", 2, args, x,
                 sw.PRED_RULES)
    with pytest.warns(UserWarning):
        sharded = AOTPredictor(sym, args, data_shapes={"data": (1, 8)},
                               mesh=train_mesh(mp=2),
                               param_rules=sw.PRED_RULES)
        plain = AOTPredictor(sym, args, data_shapes={"data": (1, 8)})
    want = (sharded.predict({"data": x}), plain.predict({"data": x}))
    return w.join_ranks(*ctx, RANK_TIMEOUT), want, args


def test_mp_sharded_predictor_group(predictor_runs):
    ranks, (jsharded, jplain), args = predictor_runs
    got = ranks[0]["outs"]
    for a, b, c in zip(got, jsharded, jplain):
        np.testing.assert_allclose(a, b, **PRED_TOL)
        np.testing.assert_allclose(a, c, **PRED_TOL)
    st = ranks[0]["stats"]
    assert st["group_size"] == 2 and st["mp_size"] == 2
    whole = sum(v.nbytes for v in args.values())
    chip = sum(v.nbytes // (2 if k in ("fc1_weight", "fc2_weight") else 1)
               for k, v in args.items())
    assert st["param_bytes_total"] == whole
    assert st["param_bytes_per_chip"] / st["param_bytes_total"] == \
        chip / whole
    assert ranks[0]["mp_stats"] == {"group_size": 2, "mp_size": 2,
                                    "param_bytes_per_chip": chip}
    for r in ranks:
        assert r["shards"] == {"fc1_weight": (16, 4), "fc2_weight": (2, 16)}
    assert ranks[1]["calls"] == 1


def test_mp_sharded_predictor_refusals(predictor_runs):
    errors = predictor_runs[0][0]["errors"]
    assert "mesh= OR device=" in errors["device"]
    assert "swap_params on a sharded predictor" in errors["swap"]
    assert "closed" in errors["closed"]


# ---------------------------------------------------------------------------
# speculative decoding on a sharded predictor
# ---------------------------------------------------------------------------
def _jax_spec(params):
    from mxnet_tpu.models import transformer as jtfm
    from mxnet_tpu.serving import GenerateServer

    cfg = jtfm.TransformerConfig(**sw.SPEC_CFG)
    srv = GenerateServer(cfg, params, slots=2, page_size=4,
                         spec_k=sw.SPEC_K, draft=sw.SPEC_DRAFT)
    try:
        futs = [srv.submit(p, max_new_tokens=sw.SPEC_NEW)
                for p in sw.spec_prompts()]
        return [list(f.result(timeout=120)["tokens"]) for f in futs]
    finally:
        srv.close()


@pytest.fixture(scope="module")
def spec_runs(tmp_path_factory):
    from mxnet_tpu.models import transformer as jtfm

    params = {k: np.asarray(v) for k, v in jtfm.init_params(
        jtfm.TransformerConfig(**sw.SPEC_CFG), seed=0).items()}
    ctx = _ranks(tmp_path_factory, "spec_worker", 2, params)
    want = _jax_spec(params)
    with tmx.cpu():
        plain = sw.spec_serve(params, device="cpu")
    return w.join_ranks(*ctx, RANK_TIMEOUT), plain, want


def test_sharded_speculation_matches_unsharded_and_jax(spec_runs):
    ranks, (plain, plain_stats), want = spec_runs
    got = [list(t) for t in ranks[0]["tokens"]]
    assert got == [list(t) for t in plain] == want
    st = ranks[0]["stats"]
    assert st["draft_proposed"] == plain_stats["draft_proposed"] > 0
    assert st["draft_accepted"] == plain_stats["draft_accepted"]
    # the follower ran every target and draft call of the leader's
    calls = ranks[1]["calls"]
    assert calls["prefill"] == len(sw.spec_prompts())
    assert calls["extend"] == st["spec_rounds"] > 0
    assert calls["draft"] > 0


# ---------------------------------------------------------------------------
# the fleet's sharded replica group
# ---------------------------------------------------------------------------
def _wait_for(fn, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError("timed out waiting for %s" % what)


def test_mp_group_drain_on_member_death(tmp_path_factory):
    """A port replica group of 2 gloo ranks (a sharded predictor) behind a
    tracker: only its leader is routable and serves the sharded outputs;
    a draining member gates the group, resuming re-admits it; after the
    follower is SIGKILLed the group drains with no request sent."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.serving.fleet import FleetRouter, NoLiveReplica
    from mxnet_tpu_torch.tracker import Tracker

    sym, args, x = _pred_args()
    with tmx.cpu():
        from mxnet_tpu_torch.serving import AOTPredictor

        with pytest.warns(UserWarning):
            plain = AOTPredictor(sw.net(tmx, "pred"), args,
                                 data_shapes={"data": (1, 8)}, device="cpu",
                                 ladder=(1, 4))
        want = plain.predict({"data": x})[0]
    trk = Tracker(num_workers=0, num_servers=0, heartbeat_timeout=10.0)
    trk.serve_in_background()
    profiler.fleet_reset()
    ctx, out = _ranks(tmp_path_factory, "group_replica_worker", 2, trk.addr,
                      args, sw.PRED_RULES)
    router = FleetRouter(tracker_uri=trk.addr, view_interval=0.2,
                         timeout=15.0, retries=1)
    try:
        def view():
            router.refresh_view(force=True)
            return {h.group_rank: h for h in router._handles.values()
                    if h.group == "g"}

        members = _wait_for(lambda: len(view()) == 2 and view(),
                            "the group's 2 members")
        leader, follower = members[0], members[1]

        def routable():
            router.refresh_view(force=True)
            return [h.addr for h in router._routable("m", set())]

        assert routable() == [leader.addr]
        got = router.request("m", x, timeout=30.0)[0]
        np.testing.assert_allclose(got, want, **PRED_TOL)
        router.drain(follower.addr)
        assert routable() == []
        router.resume(follower.addr)
        _wait_for(lambda: routable() == [leader.addr], "the group back")
        pid = int(follower.info["pid"])
        os.kill(pid, signal.SIGKILL)
        _wait_for(lambda: routable() == [], "the group drained")
        with pytest.raises(NoLiveReplica):
            router.request("m", x, timeout=2.0)
        stats = profiler.fleet_stats()
        assert stats.get("failovers", 0) == 0
        assert stats.get("inflight_lost", 0) == 0
        router.stop_fleet()
        ctx.processes[0].join(RANK_TIMEOUT)
        assert ctx.processes[0].exitcode == 0
    finally:
        router.close()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        trk.shutdown()
        profiler.fleet_reset()


def test_mp_replica_server_group_validation():
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.fleet import FleetError, ReplicaServer

    server = ModelServer(ladder=(1,), device="cpu")
    try:
        with pytest.raises(FleetError, match="group_size"):
            ReplicaServer(server, group="g", group_size=0)
        with pytest.raises(FleetError, match="group_rank"):
            ReplicaServer(server, group="g", group_size=2, group_rank=2)
        rep = ReplicaServer(server, group="g", group_size=2, group_rank=1)
        info = rep._info()
        assert info["group"] == "g" and info["group_size"] == 2 \
            and info["group_rank"] == 1
        rep.shutdown()
    finally:
        server.close()

