"""Data-parallel ``TrainStep(mesh=)`` and ZeRO in the port against the JAX
package, on the CPU.

The tiny fused and unfused ResNets (2 stages of one bottleneck unit, 8, 16
and 32 channels, 5 classes, 32x32 images, Xavier weights of seed 0) take 3
steps of sgd (lr 0.1, momentum 0.9, wd 1e-4) on one seeded global batch of
8, in fp32, on 2 gloo ranks (each keeps its 4 rows) and on 4 ranks of a
``("dcn", "dp")`` mesh. Against the JAX ``TrainStep`` on a mesh of as many
CPU devices: losses rtol 2e-5, the gathered outputs rtol 2e-4, atol 2e-5
(``tests/test_fused_spmd.py``'s bars), params and moving statistics at the
port-vs-JAX step bar of ``tests/test_torch_fused_train.py`` (rtol 1e-4, an
atol of 1e-5 of the reference's largest |value|, floored at 1e-5): the
port's one-device unfused step is already further than
test_fused_spmd.py's atol of 2e-6 from JAX's on a BatchNorm beta of a few
1e-3 after these 3 steps (the summation orders of the two packages), and
that bar holds two runs of one package.
Against the port's own one-device step at test_fused_spmd.py's bars in
full (params and aux rtol 2e-4, atol 2e-6): what the data parallelism
changes. Every rank's params, optimizer state and aux are bit for bit
equal after every step. ``metric_stats`` and the sentinel (``skip``, over
a batch with one NaN pixel) match JAX's. A fused run whose step sums the
fused units' gradients again (the unit summed them), or sums no gradient
at all, fails the parity check.

ZeRO on an uneven shape (``tests/test_zero.py``'s: fc1_weight 13x33 over 2
ranks, fc1_bias below the min size 16), 5 steps of sgd, sgd with momentum
and wd, and adam, against the replicated update: losses rtol 1e-5, params
rtol 1e-5, atol 1e-6; the replicated run against JAX's at the same bar
(rtol 2e-5 for the losses). The logical optimizer state of a ``zero=True``
run round-trips bit for bit through ``zero=False``, ``zero=True`` and a
one-device step, and each rank holds about half the optimizer bytes.

The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX
calls ``pltpu.CompilerParams``: the alias is set with ``monkeypatch``.
"""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.parallel.spmd import TrainStep as JTrainStep
from mxnet_tpu.parallel.spmd import data_sharding

import torch_dp_workers as w

RANK_TIMEOUT = 300


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _close(got, want, rtol, atol, what=""):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _mesh(n, names=("dp",), shape=None):
    devs = np.array(jax.devices()[:n])
    return Mesh(devs if shape is None else devs.reshape(shape), names)


def _jax_train(mesh, axes, fused, batches=None, **kw):
    """The JAX TrainStep on ``mesh``: per-step losses, the last step's
    params, aux, outputs and stats, and the sentinel's counters."""
    ts = JTrainStep(jresnet.resnet(fused=fused, **w.TINY), dict(w.OPT),
                    mesh=mesh, data_axes=axes, **kw)
    carry = ts.place(*ts.init_params(w.SHAPES,
                                     initializer=jmx.initializer.Xavier()))
    res = {"losses": []}
    for i in range(w.STEPS):
        b = batches[i] if batches is not None else w.train_batch()
        b = {k: jax.device_put(v, data_sharding(mesh, axes))
             for k, v in b.items()}
        carry, r = ts(carry, b, jax.random.PRNGKey(i))
        loss = r[0] if isinstance(r, tuple) else r
        res["losses"].append(float(loss))
        if isinstance(r, tuple):
            res["out"] = np.asarray(r[1][0])
            if len(r) > 2:
                res["stats"] = {k: np.asarray(v) for k, v in r[2].items()}
    res["params"] = {k: np.asarray(v) for k, v in carry[0].items()}
    res["aux"] = {k: np.asarray(v) for k, v in carry[2].items()}
    res["health"] = ts.health_stats(carry)
    return res


def _jax_zero_ref(opt):
    ts = JTrainStep(w.zero_symbol(jmx), dict(opt), mesh=_mesh(2),
                    zero=False, zero_min_size=16)
    carry = ts.place(*ts.init_params(w.ZERO_SHAPES, seed=3))
    losses = []
    for i in range(w.ZERO_STEPS):
        carry, loss = ts(carry, w.zero_batch(), jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in carry[0].items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 2-rank runs (started first) and the JAX references,
    computed meanwhile."""
    d_train = tmp_path_factory.mktemp("dp_ranks")
    d_zero = tmp_path_factory.mktemp("zero_ranks")
    train = w.start_ranks("dp_train_worker", 2, d_train, {"dp": 2})
    zero = w.start_ranks("zero_worker", 2, d_zero)
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        mesh = _mesh(2)
        for fused in (True, False):
            ref[fused] = _jax_train(mesh, ("dp",), fused,
                                    return_outputs=True, metric_stats=True)
        ref["sentinel"] = _jax_train(
            mesh, ("dp",), False,
            batches=[w.train_batch(), w.train_batch(nan=True),
                     w.train_batch()], sentinel="skip")
        ref["zero"] = {name: _jax_zero_ref(opt)
                       for name, opt in w.ZERO_OPTS.items()}
    for fused in (True, False):
        ref["one", fused] = w._train(None, fused, return_outputs=True)
    return (w.join_ranks(train, d_train, RANK_TIMEOUT),
            w.join_ranks(zero, d_zero, RANK_TIMEOUT), ref)


def _ranks_equal(ranks, key):
    """Every step's params, optimizer state and aux equal bit for bit
    on every rank."""
    for step, snaps in enumerate(zip(*(r[key]["snaps"] for r in ranks))):
        first = snaps[0]
        for other in snaps[1:]:
            for part in ("params", "aux", "opt"):
                assert set(first[part]) == set(other[part])
                for k, v in first[part].items():
                    vs = v if isinstance(v, tuple) else (v,)
                    os_ = other[part][k] if isinstance(v, tuple) \
                        else (other[part][k],)
                    for a, b in zip(vs, os_):
                        assert torch.equal(a, b), (step, part, k)


def _hold(port, ref, one_device=None):
    """The last step against JAX's (``ref``) and, when given, against the
    port's one-device run."""
    _close(port["losses"], ref["losses"], 2e-5, 0, "losses")
    if "out" in ref:
        _close(port["outs"][-1], ref["out"], 2e-4, 2e-5, "outputs")
    snap = port["snaps"][-1]
    for part in ("params", "aux"):
        assert set(snap[part]) == set(ref[part])
        for k, v in ref[part].items():
            _close(snap[part][k], v, 1e-4,
                   1e-5 * max(float(np.abs(v).max()), 1.0), k)
            if one_device is not None:
                _close(snap[part][k],
                       one_device["snaps"][-1][part][k].numpy(), 2e-4, 2e-6,
                       k)
    if one_device is not None and "out" in ref:
        _close(port["losses"], one_device["losses"], 2e-5, 0, "losses")
        _close(port["outs"][-1], one_device["outs"][-1].numpy(), 2e-4, 2e-5,
               "outputs")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_dp_train_step_matches_jax(runs, fused):
    ranks, _zero, ref = runs
    _ranks_equal(ranks, fused)
    for r in ranks:
        _hold(r[fused], ref[fused], ref["one", fused])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_metric_stats_are_global_and_match_jax(runs, fused):
    ranks, _zero, ref = runs
    got = ranks[0][fused]["stats"][-1]
    assert set(got) == set(ref[fused]["stats"]) == {"n", "sum_loss",
                                                     "correct", "sum_ce"}
    assert int(got["n"]) == int(ref[fused]["stats"]["n"]) == w.BATCH
    assert int(got["correct"]) == int(ref[fused]["stats"]["correct"])
    for k in ("sum_loss", "sum_ce"):
        _close(got[k], ref[fused]["stats"][k], 1e-5, 0, k)
        assert torch.equal(got[k], ranks[1][fused]["stats"][-1][k])


def test_sentinel_skip_matches_jax(runs):
    ranks, _zero, ref = runs
    _ranks_equal(ranks, "sentinel")
    want = ref["sentinel"]["health"]
    for r in ranks:
        got = r["sentinel"]["health"]
        assert {k: v for k, v in got.items() if k != "last_loss"} == \
            {k: v for k, v in want.items() if k != "last_loss"}
        assert got["skipped"] == got["nonfinite_loss"] == 1
        assert np.isnan(r["sentinel"]["losses"][1])
        # the skipped step left the params as they were
        s = r["sentinel"]["snaps"]
        assert all(torch.equal(s[0]["params"][k], s[1]["params"][k])
                   for k in s[0]["params"])
        _close(r["sentinel"]["losses"][::2], ref["sentinel"]["losses"][::2],
               2e-5, 0, "losses")
        for k, v in ref["sentinel"]["params"].items():
            _close(s[-1]["params"][k], v, 1e-4,
                   1e-5 * max(float(np.abs(v).max()), 1.0), k)


@pytest.mark.parametrize("fault", ["double", "drop"])
def test_parity_catches_planted_step_sums(runs, fault):
    ranks, _zero, ref = runs
    with pytest.raises(AssertionError):
        _hold(ranks[0][fault], ref[True])


def test_dcn_dp_mesh_reduces_over_both_axes(tmp_path):
    """A ``("dcn", "dp")`` 2x2 mesh whose data axes are both: 4 ranks of
    two rows each against the JAX 2x2 mesh."""
    ctx = w.start_ranks("dp_train_worker", 4, tmp_path, {"dcn": 2, "dp": 2})
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        ref = _jax_train(_mesh(4, ("dcn", "dp"), (2, 2)), ("dcn", "dp"),
                         True, return_outputs=True, metric_stats=True)
    ranks = w.join_ranks(ctx, tmp_path, RANK_TIMEOUT)
    one = w._train(None, True, return_outputs=True)
    _ranks_equal(ranks, True)
    for r in ranks:
        _hold(r[True], ref, one)


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", list(w.ZERO_OPTS))
def test_zero_matches_replicated(runs, opt):
    _ranks, zero, _ref = runs
    for r in zero:
        res = r[opt]
        l_rep, l_zero = res["losses"]
        _close(l_zero, l_rep, 1e-5, 0, "losses")
        p_rep, p_zero = res["params"]
        for k in p_rep:
            _close(p_zero[k], p_rep[k].numpy(), 1e-5, 1e-6, k)
        plan = res["plan"]
        assert "fc1_weight" in plan and "fc1_bias" not in plan
        assert plan["fc1_weight"] == ((13, 33), 429, 2, 215)
        rows = res["opt_zero_rows"]
        if opt != "sgd":
            leaf = rows["fc1_weight"]
            leaf = leaf[0] if isinstance(leaf, tuple) else leaf
            assert tuple(leaf.shape) == (1, 215)
    for k, v in zero[0][opt]["params"][1].items():
        assert torch.equal(v, zero[1][opt]["params"][1][k]), k


@pytest.mark.parametrize("opt", list(w.ZERO_OPTS))
def test_replicated_dp_update_matches_jax(runs, opt):
    _ranks, zero, ref = runs
    losses, params = ref["zero"][opt]
    _close(zero[0][opt]["losses"][0], losses, 2e-5, 0, "losses")
    for k, v in params.items():
        _close(zero[0][opt]["params"][0][k], v, 1e-5, 1e-6, k)


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("opt", ["sgd-mom-wd", "adam"])
def test_logical_opt_state_round_trips_across_mesh_sizes(runs, opt):
    from mxnet_tpu_torch.parallel import TrainStep

    _ranks, zero, _ref = runs
    logical = zero[0][opt]["logical"]
    for r in zero:
        res = r[opt]
        assert set(res["logical"]) == set(res["opt_rep"])
        for k in res["logical"]:
            for a, b, c, d, rep in zip(*(_leaves(res[x][k]) for x in (
                    "logical", "back_rep", "relogical")),
                    _leaves(logical[k]), _leaves(res["opt_rep"][k])):
                # the same on both ranks, kept by zero=False, split and
                # gathered again by zero=True
                assert torch.equal(a, d) and torch.equal(a, b) \
                    and torch.equal(a, c), k
                _close(a, rep.numpy(), 1e-5, 1e-6, k)
    # one device: placed as it is
    ts = TrainStep(w.zero_symbol(), w.ZERO_OPTS[opt], device="cpu")
    p, _o, a = ts.init_params(w.ZERO_SHAPES, seed=3)
    one = ts.place(p, logical, a)[1]
    for k in logical:
        for x, y in zip(_leaves(one[k]), _leaves(logical[k])):
            assert torch.equal(x, y), k


def test_zero_halves_the_optimizer_bytes_a_rank(runs):
    _ranks, zero, _ref = runs
    for r in zero:
        rep, zer = r["sgd-mom-wd"]["memory"]
        assert zer["zero"] and not rep["zero"]
        assert zer["num_shards"] == rep["num_shards"] == 2
        assert zer["zero_params"] == 2   # fc1_weight and fc2_weight
        assert zer["param_bytes_per_dev"] == rep["param_bytes_per_dev"]
        # momentum of (429, 130, 13, 10) elements: the two planned ones
        # as rows of 215 and 65, the biases whole
        assert rep["opt_bytes_per_dev"] == 4 * (429 + 130 + 13 + 10)
        assert zer["opt_bytes_per_dev"] == 4 * (215 + 65 + 13 + 10)
        assert zer["collective_bytes_per_step_est"] == \
            rep["collective_bytes_per_step_est"]
