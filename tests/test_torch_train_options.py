"""``TrainStep``'s single-device options in the PyTorch port against the JAX
package, on the CPU at a small size.

- The ReLU / maximum / minimum / clip gradients at a tie (and just off it)
  against the JAX ops: ``jnp.maximum`` and ``jnp.clip`` give half the
  gradient at a tie, and so must the port.
- ``LayerNorm``, ``batch_dot`` and ``softmax(temperature=)``, forward and
  gradient, against the JAX ops; the bench transformer's Symbol JSON equal
  to the JAX ``get_symbol``'s.
- ``plan_remat`` and its ``pass_stats`` equal to the JAX package's.
- Every remat mode trains three steps bit for bit as ``remat=False``;
  ``residual_stats`` on the bench transformer: ``pass`` keeps at least 30%
  fewer bytes than ``False`` and no more than ``conv``.
- Three fp32 steps with every option on (``remat="pass"``, the layout pass,
  ``return_outputs``, ``metric_stats``, ``sentinel="record"``) against the
  JAX ``TrainStep`` with the same options on a tiny fused ResNet.
- The sentinel: knob validation, ``off`` leaves ``opt_state`` alone,
  ``record`` counts, ``skip`` is a bit-identical no-op, ``halt`` raises
  and syncs once a step, the counters are not checkpointed.

Tolerances: rtol 1e-4 / atol 1e-5 of the reference's largest |value|
unless stated. The JAX fused kernels name ``pltpu.TPUCompilerParams``,
which this JAX calls ``pltpu.CompilerParams``: the fused-ResNet test sets
that alias with ``monkeypatch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu.ir import remat as jremat
from mxnet_tpu.models import bench_transformer as jbench
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import nn as jnn, registry as jreg
from mxnet_tpu.parallel import spmd as jspmd
from mxnet_tpu_torch import initializer as tinit, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ir.remat import SAVE_OPS, plan_remat
from mxnet_tpu_torch.models import bench_transformer, resnet as tresnet
from mxnet_tpu_torch.ops import nn as tnn, registry as treg
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.parallel.spmd import functional_optimizer

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(num_classes=4, seq_len=8, d_model=16, n_heads=2, n_layers=1,
            d_ff=32)
BENCH = dict(num_classes=16, seq_len=128, d_model=128, n_heads=4,
             n_layers=4, d_ff=512)
# a tiny fused ResNet-50-style net (bottleneck units, the CIFAR stem at
# 16x16): the JAX step runs its Pallas units in interpret mode, so the
# net is as small as a fused unit per stage allows
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=5, image_shape=(3, 16, 16), bottle_neck=True)
RESNET_SHAPES = {"data": (4, 3, 16, 16), "softmax_label": (4,)}
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _t(a):
    return torch.tensor(np.asarray(a))


def _tf_batch(cfg=TINY, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(batch, cfg["seq_len"],
                              cfg["d_model"]).astype(np.float32),
            "softmax_label": rng.randint(0, cfg["num_classes"], (batch,))
            .astype(np.float32)}


def _shapes(batch):
    return {k: tuple(v.shape) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# gradients at a tie
# ---------------------------------------------------------------------------
def _op_pair(name, **attrs):
    jop, top = jreg.get(name).fn, treg.get(name).fn
    return (lambda *v: jop(*v, **attrs)), (lambda *v: top(*v, **attrs))


# each op's tie points sit in the input: 0 for the ReLUs, the scalar for
# maximum/minimum, both bounds for clip; the rest is just off them
_TIES = [
    ("Activation", dict(act_type="relu"), 0.0),
    ("relu", {}, 0.0),
    ("_maximum_scalar", dict(scalar=0.5), 0.5),
    ("_minimum_scalar", dict(scalar=0.5), 0.5),
    ("clip", dict(a_min=0.0, a_max=1.0), 0.0),
    ("clip", dict(a_min=0.0, a_max=1.0), 1.0),
]


@pytest.mark.parametrize("name,attrs,tie", _TIES)
def test_gradient_at_a_tie_matches_jax(name, attrs, tie):
    x = np.array([tie, tie, tie - 1e-3, tie + 1e-3, -0.75, 0.25, 0.75,
                  1.5], np.float32)
    cot = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    jfn, tfn = _op_pair(name, **attrs)
    jx = jnp.asarray(x)
    jv = np.asarray(jfn(jx))
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v) * cot))(jx))
    tx = _t(x).requires_grad_()
    tv = tfn(tx)
    tg = torch.autograd.grad((tv * _t(cot)).sum(), tx)[0].numpy()
    assert np.array_equal(tv.detach().numpy(), jv)
    # half the gradient at the tie (the reference's maximum/clip), all or
    # none of it just off it
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg[:2], 0.5 * cot[:2])


def test_batch_norm_variance_at_its_zero_floor_matches_jax():
    """The training BatchNorm's variance is ``maximum(E[x²] - E[x]², 0)``.
    Channel 0's squares underflow, so its variance is exactly 0 while
    d var / dx is not: the reference passes half of it at that tie."""
    x = np.zeros((4, 2, 1, 1), np.float32)
    x[1, 0] = 1e-23
    x[:, 1, 0, 0] = [0.3, -1.2, 0.8, 2.0]
    g, b = np.ones(2, np.float32), np.zeros(2, np.float32)
    mm, mv = np.zeros(2, np.float32), np.ones(2, np.float32)
    cot = np.array([1.0, 2.0], np.float32)
    kw = dict(eps=2e-5, fix_gamma=False, __is_train__=True)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jnn.batch_norm(
        v, jnp.asarray(g), jnp.asarray(b), jnp.asarray(mm), jnp.asarray(mv),
        **kw)[2] * cot))(jnp.asarray(x)))
    tx = _t(x).requires_grad_()
    var = tnn.batch_norm(tx, _t(g), _t(b), _t(mm), _t(mv), **kw)[2]
    assert var[0].item() == 0.0
    tg = torch.autograd.grad((var * _t(cot)).sum(), tx)[0].numpy()
    assert tg[1, 0, 0, 0] != 0.0
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# the bench transformer's ops and graph
# ---------------------------------------------------------------------------
def _fwd_grad_parity(jfn, tfn, arrays, seed=1):
    """Forward outputs and the gradient of sum(outputs * cotangents) with
    respect to every input, port against JAX."""
    jout = jfn(*[jnp.asarray(a) for a in arrays])
    jout = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*np.shape(o)).astype(np.float32) for o in jout]

    def jloss(*xs):
        outs = jfn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    jgs = jax.grad(jloss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    txs = [_t(a).requires_grad_() for a in arrays]
    tout = tfn(*txs)
    tout = tout if isinstance(tout, tuple) else (tout,)
    tgs = torch.autograd.grad(sum((o * _t(c)).sum()
                                  for o, c in zip(tout, cots)), txs)
    assert len(tout) == len(jout)
    for i, (o, jo) in enumerate(zip(tout, jout)):
        _close(o.detach().numpy(), np.asarray(jo), what="output %d" % i)
    for i, (g, jg) in enumerate(zip(tgs, jgs)):
        _close(g.numpy(), np.asarray(jg), what="gradient %d" % i)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 6) * 2 + 0.5).astype(np.float32)
    c = x.shape[axis]
    g = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    kw = dict(axis=axis, eps=1e-5)
    _fwd_grad_parity(lambda *a: jnn.layer_norm(*a, **kw),
                     lambda *a: tnn.layer_norm(*a, **kw), (x, g, b))


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_batch_dot_matches_jax(ta, tb):
    rng = np.random.RandomState(2)
    a = rng.randn(*((3, 5, 4) if ta else (3, 4, 5))).astype(np.float32)
    b = rng.randn(*((3, 6, 5) if tb else (3, 5, 6))).astype(np.float32)
    jfn, tfn = _op_pair("batch_dot", transpose_a=ta, transpose_b=tb)
    _fwd_grad_parity(jfn, tfn, (a, b))


@pytest.mark.parametrize("name,attrs", [
    ("softmax", dict(axis=-1, temperature=4.0)),
    ("softmax", dict(axis=1, temperature=None, length=None)),
    ("softmax", dict(axis=-1, temperature=0.5, length=3)),
    ("log_softmax", dict(axis=-1, temperature=2.0))])
def test_softmax_temperature_matches_jax(name, attrs):
    x = np.random.RandomState(3).randn(2, 4, 7).astype(np.float32) * 3
    jfn, tfn = _op_pair(name, **attrs)
    _fwd_grad_parity(jfn, tfn, (x,))


@pytest.mark.parametrize("cfg", [TINY, BENCH], ids=["tiny", "bench"])
def test_bench_transformer_json_equals_jax(cfg):
    t = bench_transformer.get_symbol(**cfg)
    assert t.tojson() == jbench.get_symbol(**cfg).tojson()
    b = _tf_batch(cfg)
    assert t.infer_shape(**_shapes(b))[1] == [(4, cfg["num_classes"])]


# ---------------------------------------------------------------------------
# the remat plan
# ---------------------------------------------------------------------------
def _plan_models():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        return {"transformer": (bench_transformer.get_symbol(**TINY),
                                jbench.get_symbol(**TINY)),
                "fused_resnet": (tresnet.resnet(fused=True, **RESNET),
                                 jresnet.resnet(fused=True, **RESNET))}


@pytest.mark.parametrize("model", ["transformer", "fused_resnet"])
def test_remat_plan_and_pass_stats_equal_jax(model):
    tsym_, jsym_ = _plan_models()[model]
    assert SAVE_OPS == jremat.SAVE_OPS
    profiler.pass_reset()
    jprofiler.pass_reset()
    tp, jp = plan_remat(tsym_), jremat.plan_remat(jsym_)
    assert tp.to_dict() == jp.to_dict()
    assert tp.n_save > 0 and tp.n_recompute > 0
    ts = profiler.pass_stats(reset=True)["passes"]["remat"]
    js = jprofiler.pass_stats(reset=True)["passes"]["remat"]
    assert {k: ts[k] for k in ts} == {k: js[k] for k in ts}
    ops = {n.name: n.op.name for n in tsym_._topo() if not n.is_variable()}
    assert all(ops[n] in SAVE_OPS for n in tp.save)
    assert not any(ops[n] in SAVE_OPS for n in tp.recompute)
    with pytest.raises(MXNetError, match="unnamed"):
        s = bench_transformer.get_symbol(**TINY)
        next(n for n in s._topo() if not n.is_variable()).name = ""
        plan_remat(s, record=False)


# ---------------------------------------------------------------------------
# every remat mode trains as remat=False
# ---------------------------------------------------------------------------
def _models():
    return {"transformer": (bench_transformer.get_symbol(**TINY),
                            _tf_batch(), None),
            "fused_resnet": (tresnet.resnet(fused=True, **RESNET),
                             _resnet_batch(), tinit.Xavier())}


def _resnet_batch(seed=4):
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(*RESNET_SHAPES["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, 5, RESNET_SHAPES["softmax_label"])
            .astype(np.float32)}


def _train(sym, batch, init, steps=3, **kw):
    ts = TrainStep(sym, OPT, device="cpu", **kw)
    carry = ts.place(*ts.init_params(_shapes(batch), initializer=init))
    losses = []
    for _ in range(steps):
        carry, loss = ts(carry, batch)
        losses.append(float(loss))
    return ts, carry, losses


@pytest.fixture(scope="module")
def reference_runs():
    return {name: _train(s, b, init, remat=False)[1:]
            for name, (s, b, init) in _models().items()}


@pytest.mark.parametrize("model", ["transformer", "fused_resnet"])
@pytest.mark.parametrize("mode", [True, "conv", "pass"])
def test_remat_modes_train_bit_identical(reference_runs, model, mode):
    s, batch, init = _models()[model]
    _ts, carry, losses = _train(s, batch, init, remat=mode)
    ref_carry, ref_losses = reference_runs[model]
    assert losses == ref_losses
    for d, ref in ((carry[0], ref_carry[0]), (carry[1], ref_carry[1]),
                   (carry[2], ref_carry[2])):
        assert set(d) == set(ref)
        for k in ref:
            assert torch.equal(d[k], ref[k]), (mode, k)


def test_remat_knob_and_validation(monkeypatch):
    s = bench_transformer.get_symbol(**TINY)
    with pytest.raises(MXNetError, match="remat"):
        TrainStep(s, OPT, device="cpu", remat="bogus")
    with pytest.raises(MXNetError, match="unknown pass"):
        TrainStep(s, OPT, device="cpu", train_passes=("nosuch",))
    monkeypatch.setenv("MXNET_TPU_REMAT", "pass")
    ts = TrainStep(s, OPT, device="cpu")
    assert ts.remat == "pass" and ts._remat_plan is not None
    monkeypatch.setenv("MXNET_TPU_REMAT", "1")
    assert TrainStep(s, OPT, device="cpu").remat is True
    monkeypatch.setenv("MXNET_TPU_REMAT", "junk")
    with pytest.raises(MXNetError, match="MXNET_TPU_REMAT"):
        TrainStep(s, OPT, device="cpu")
    monkeypatch.delenv("MXNET_TPU_REMAT")
    monkeypatch.setenv("MXNET_IR_TRAIN_PASSES", "layout")
    assert TrainStep(s, OPT, device="cpu").train_passes == ("layout",)
    monkeypatch.delenv("MXNET_IR_TRAIN_PASSES")
    ts = TrainStep(s, OPT, device="cpu")
    assert ts.symbol is s and ts.remat is False and ts._remat_plan is None


@pytest.fixture(scope="module")
def bench_residuals():
    """residual_stats of every mode on the bench config, in both packages
    (forward only)."""
    s, js = bench_transformer.get_symbol(**BENCH), jbench.get_symbol(**BENCH)
    batch = _tf_batch(BENCH, batch=16)
    ts = TrainStep(s, OPT, device="cpu")
    params, _, aux = ts.init_params(_shapes(batch), seed=0)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    out = {}
    for mode in (False, True, "conv", "pass"):
        out[mode] = (
            TrainStep(s, OPT, device="cpu", remat=mode).residual_stats(
                params, aux, batch),
            jspmd.TrainStep(js, jspmd.functional_optimizer(**OPT),
                            remat=mode).residual_stats(jparams, {}, batch))
    for mode, (t, j) in out.items():
        print("residual_stats remat=%r: port %r, JAX %r" % (mode, t, j))
    return out


def test_remat_pass_cuts_residual_bytes_30pct(bench_residuals):
    off, sel = bench_residuals[False][0], bench_residuals["pass"][0]
    assert 1.0 - sel["residual_bytes"] / off["residual_bytes"] >= 0.30
    assert sel["n_residuals"] < off["n_residuals"]


def test_remat_pass_no_costlier_than_conv(bench_residuals):
    sel, conv = bench_residuals["pass"][0], bench_residuals["conv"][0]
    assert sel["residual_bytes"] <= conv["residual_bytes"]
    assert sel["n_residuals"] <= conv["n_residuals"]
    # full recompute keeps only the step's inputs: the same storages as
    # the JAX package's checkpoint keeps
    assert bench_residuals[True][0] == bench_residuals[True][1]


# ---------------------------------------------------------------------------
# every option on, against the JAX TrainStep
# ---------------------------------------------------------------------------
ALL_ON = dict(remat="pass", train_passes=("layout",), return_outputs=True,
              metric_stats=True, sentinel="record")


def test_all_options_three_steps_match_jax(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    from mxnet_tpu_torch import name as tname

    batch = _resnet_batch()
    # fresh name scopes: the two graphs get the same automatic names
    with mx.name.NameManager():
        js = jspmd.TrainStep(jresnet.resnet(fused=True, **RESNET),
                             jspmd.functional_optimizer(**OPT), **ALL_ON)
    jc = js.place(*js.init_params(RESNET_SHAPES,
                                  initializer=mx.initializer.Xavier()))
    with tname.NameManager():
        ts = TrainStep(tresnet.resnet(fused=True, **RESNET), OPT,
                       device="cpu", **ALL_ON)
    assert ts.symbol.tojson() == js.symbol.tojson()
    tc = ts.place(*ts.init_params(RESNET_SHAPES, initializer=tinit.Xavier()))
    for _ in range(3):
        jc, (jloss, jouts, jstats) = js(
            jc, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0))
        tc, (tloss, touts, tstats) = ts(tc, batch)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        assert len(touts) == len(jouts) == 1
        _close(touts[0].numpy(), np.asarray(jouts[0]))
        assert set(tstats) == set(jstats) == {"n", "sum_loss", "correct",
                                              "sum_ce"}
        assert int(tstats["n"]) == int(jstats["n"]) == 4
        assert int(tstats["correct"]) == int(jstats["correct"])
        for k in ("sum_loss", "sum_ce"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=1e-5)
    for k, v in jc[0].items():
        _close(tc[0][k].numpy(), np.asarray(v), what=k)
    for k, v in jc[2].items():
        _close(tc[2][k].numpy(), np.asarray(v), what=k)
    assert ts.health_stats(tc) == pytest.approx(js.health_stats(jc))
    assert ts.health_stats(tc)["healthy"] == 3


def test_metric_stats_needs_return_outputs():
    s = bench_transformer.get_symbol(**TINY)
    with pytest.raises(MXNetError, match="requires return_outputs"):
        TrainStep(s, OPT, device="cpu", metric_stats=True)


def test_returned_outputs_and_stats_agree_with_numpy():
    s = bench_transformer.get_symbol(**TINY)
    batch = _tf_batch()
    ts = TrainStep(s, OPT, device="cpu", return_outputs=True,
                   metric_stats=True)
    carry = ts.place(*ts.init_params(_shapes(batch)))
    carry, (loss, outs, stats) = ts(carry, batch)
    probs = outs[0].numpy().astype(np.float64)
    lbl = batch["softmax_label"].astype(np.int64)
    assert int(stats["correct"]) == int((probs.argmax(1) == lbl).sum())
    ce = -np.log(probs[np.arange(4), lbl] + 1e-12).sum()
    np.testing.assert_allclose(float(stats["sum_ce"]), ce, rtol=1e-5)
    np.testing.assert_allclose(float(stats["sum_loss"]), float(loss) * 4,
                               rtol=1e-6)
    assert not outs[0].requires_grad


# ---------------------------------------------------------------------------
# the sentinel (mirrors tests/test_self_healing.py)
# ---------------------------------------------------------------------------
DIM, CLASSES, BATCH = 16, 10, 32


def _mlp():
    from mxnet_tpu_torch import symbol as sym

    return sym.SoftmaxOutput(
        sym.FullyConnected(sym.Variable("data"), num_hidden=CLASSES,
                           name="fc"), name="softmax")


def _mlp_batch(rng, poison=False):
    x = rng.randn(BATCH, DIM).astype(np.float32)
    if poison:
        x[0, 0] = np.nan
    return {"data": x, "softmax_label": rng.randint(0, CLASSES, (BATCH,))
            .astype(np.float32)}


def _sentinel_step(sentinel, **kw):
    ts = TrainStep(_mlp(), functional_optimizer("sgd", learning_rate=0.1,
                                                momentum=0.9),
                   device="cpu", sentinel=sentinel, **kw)
    carry = ts.place(*ts.init_params({"data": (BATCH, DIM),
                                      "softmax_label": (BATCH,)}))
    return ts, carry


def test_sentinel_knob_validation(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SENTINEL", "sometimes")
    with pytest.raises(MXNetError, match="MXNET_TPU_SENTINEL"):
        _sentinel_step(None)
    with pytest.raises(MXNetError, match="off|record|skip|halt"):
        _sentinel_step("bogus")
    monkeypatch.setenv("MXNET_TPU_SENTINEL", "record")
    assert _sentinel_step(None)[0].sentinel == "record"


def test_sentinel_off_keeps_opt_state_clean():
    ts, carry = _sentinel_step("off")
    assert TrainStep._SENT not in carry[1]
    assert ts.health_stats(carry) is None
    carry, _ = ts(carry, _mlp_batch(np.random.RandomState(0)))
    assert TrainStep._SENT not in carry[1] and carry[3] == 1


def test_sentinel_record_counts_without_protecting():
    rng = np.random.RandomState(0)
    ts, carry = _sentinel_step("record")
    carry, _ = ts(carry, _mlp_batch(rng))
    snap = ts.health_stats(carry)
    assert snap["healthy"] == 1 and snap["unhealthy"] == 0
    assert snap["last_healthy"] == 1 and np.isfinite(snap["last_loss"])
    carry, _ = ts(carry, _mlp_batch(rng, poison=True))
    snap = ts.health_stats(carry)
    assert (snap["unhealthy"], snap["consec"], snap["skipped"]) == (1, 1, 0)
    assert snap["nonfinite_loss"] == snap["nonfinite_grad"] == 1
    assert snap["nonfinite_param"] == 1
    # record does not protect: the poisoned update landed
    assert not all(torch.isfinite(v).all() for v in carry[0].values())


def test_sentinel_skip_is_a_bit_identical_noop():
    rng = np.random.RandomState(0)
    ts, carry = _sentinel_step("skip")
    carry, _ = ts(carry, _mlp_batch(rng))
    def keep(c):
        return [v.clone() for d in (c[0], c[2]) for v in d.values()] + \
            [v.clone() for k, v in c[1].items() if k != TrainStep._SENT]

    before, step_before = keep(carry), int(carry[3])
    assert step_before == 1
    carry, _ = ts(carry, _mlp_batch(rng, poison=True))
    assert all(torch.equal(a, b) for a, b in zip(keep(carry), before))
    # the skipped step does not advance the optimizer's step counter
    assert int(carry[3]) == step_before
    snap = ts.health_stats(carry)
    assert snap["skipped"] == 1 and snap["consec"] == 1
    carry, _ = ts(carry, _mlp_batch(rng))
    snap = ts.health_stats(carry)
    assert snap["consec"] == 0 and snap["healthy"] == 2
    assert int(carry[3]) == 2
    assert all(torch.isfinite(v).all() for v in carry[0].values())


def test_sentinel_skip_reads_a_device_step_only_when_needed():
    """Adam's bias correction needs the step count, which under ``skip`` is
    a device tensor: one counted host read a step. SGD reads nothing."""
    profiler.pipeline_reset()
    rng = np.random.RandomState(0)
    ts, carry = _sentinel_step("skip")
    carry, _ = ts(carry, _mlp_batch(rng))
    assert profiler.pipeline_stats() == {}
    ts = TrainStep(_mlp(), functional_optimizer("adam", learning_rate=0.01),
                   device="cpu", sentinel="skip")
    carry = ts.place(*ts.init_params({"data": (BATCH, DIM),
                                      "softmax_label": (BATCH,)}))
    for _ in range(2):
        carry, _ = ts(carry, _mlp_batch(rng))
    assert profiler.pipeline_stats(reset=True) == {"host_syncs": 2}


def test_sentinel_halt_raises_on_first_unhealthy_step():
    rng = np.random.RandomState(0)
    profiler.pipeline_reset()
    profiler.health_reset()
    ts, carry = _sentinel_step("halt")
    carry, _ = ts(carry, _mlp_batch(rng))
    assert profiler.pipeline_stats()["host_syncs"] == 1
    with pytest.raises(MXNetError, match="sentinel halt"):
        ts(carry, _mlp_batch(rng, poison=True))
    assert profiler.pipeline_stats(reset=True)["host_syncs"] == 2
    assert profiler.health_stats(reset=True)["sentinel"]["unhealthy"] == 1


def test_sentinel_counters_are_transient_in_logical_state():
    rng = np.random.RandomState(0)
    ts, carry = _sentinel_step("skip")
    carry, _ = ts(carry, _mlp_batch(rng, poison=True))
    logical = ts.logical_opt_state(carry[1], carry[0])
    assert TrainStep._SENT not in logical
    assert set(logical) == set(carry[0])
    # a restored carry gets fresh counters
    fresh = ts.place(carry[0], logical, carry[2])
    assert ts.health_stats(fresh)["unhealthy"] == 0
