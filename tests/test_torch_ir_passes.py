"""The IR passes of the PyTorch port against the JAX package's, on the CPU
at a small size.

- ``fusion`` then ``layout`` on a tiny pre-activation bottleneck ResNet,
  and ``residual`` on a tiny basic-block ResNet-18: the same rewritten Symbol
  JSON, provenance and ``pass_stats`` as the JAX passes, and the rewritten
  graph's training forward, auxiliary updates and gradients equal to the
  unrewritten graph's in the port and to the JAX rewritten graph's.
- The layout pass on a transpose-relu-transpose chain (both transposes
  cancel), its kill switch ``MXNET_IR_LAYOUT=0``, node names kept for the
  remat plan; the BatchNorm it sinks runs on NHWC with ``axis=3``.
- ``_ConvResidualAdd`` against the JAX op; the rule registry; the
  ``quantize`` pass still raises by name.

Tolerances: rtol 1e-4 / atol 1e-5 of the reference's largest |value|. The
JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX calls
``pltpu.CompilerParams``: each test sets that alias with ``monkeypatch``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu import ir as jir, profiler as jprofiler
from mxnet_tpu.executor import _graph_closure as jax_graph_closure
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.ops import fused as jfused
from mxnet_tpu_torch import ir, name as tname, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _graph_closure
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import fused as tfused
from mxnet_tpu_torch.ops import nn as tnn

RTOL, ATOL = 1e-4, 1e-5
BOTTLENECK = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
                  num_classes=5, image_shape=(3, 16, 16), bottle_neck=True)
# ResNet-18's basic-block layout (2 units in each of 4 stages) at tiny
# width, at 32x32: at 16x16 and batch 2 its last stage normalizes over 8
# values a channel, and the unrewritten graphs of the two packages already
# differ by 1.5e-4 of the largest gradient there (2.5e-5 at this size)
BASIC = dict(units=[2, 2, 2, 2], num_stages=4, filter_list=[8, 8, 16, 16, 32],
             num_classes=5, image_shape=(3, 32, 32), bottle_neck=False)
SHAPES = {"bottleneck": {"data": (2, 3, 16, 16), "softmax_label": (2,)},
          "basic": {"data": (4, 3, 32, 32), "softmax_label": (4,)}}


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _both(build, passes):
    """(port graph, port rewritten, provenance), the same for JAX; each
    package builds and rewrites in a fresh name scope, so automatic names
    agree."""
    profiler.pass_reset()
    jprofiler.pass_reset()
    with tname.NameManager():
        t = build(tresnet)
        to, tprov = ir.PassManager(passes).apply(t)
    with mx.name.NameManager():
        j = build(jresnet)
        jo, jprov = jir.PassManager(passes).apply(j)
    return (t, to, tprov), (j, jo, jprov)


def _values(sym, shapes, seed=0):
    """Every argument and aux state of ``sym`` (numpy fp32): Xavier-sized
    random params, a nonzero BN beta, moving stats 0/1, a seeded batch."""
    rng = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(**shapes)
    vals = {}
    for name, shape in zip(sym.list_arguments(), args):
        if name == "softmax_label":
            vals[name] = rng.randint(0, 5, shape).astype(np.float32)
        elif name == "data":
            vals[name] = rng.randn(*shape).astype(np.float32)
        elif name.endswith("gamma"):
            vals[name] = (rng.rand(*shape) + 0.5).astype(np.float32)
        elif name.endswith(("beta", "bias")):
            vals[name] = (rng.randn(*shape) * 0.1).astype(np.float32)
        else:
            fan_in = int(np.prod(shape[1:])) or 1
            vals[name] = (rng.randn(*shape) / np.sqrt(fan_in)) \
                .astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux):
        vals[name] = (np.ones if "var" in name else np.zeros)(shape,
                                                              np.float32)
    return vals


def _params(sym):
    return [n for n in sym.list_arguments()
            if n not in ("data", "softmax_label")]


def _port_run(sym, vals, cot):
    """Training outputs, aux updates and d sum(out * cot) / d params."""
    v = {k: torch.tensor(a) for k, a in vals.items()}
    for k in _params(sym):
        v[k].requires_grad_()
    outs, aux = _graph_closure(sym, True)(v)
    grads = torch.autograd.grad((outs[0] * torch.tensor(cot)).sum(),
                                [v[k] for k in _params(sym)])
    return (outs[0].detach().numpy(), {k: a.numpy() for k, a in aux.items()},
            {k: g.numpy() for k, g in zip(_params(sym), grads)})


def _jax_run(sym, vals, cot):
    fn = jax_graph_closure(sym, True)
    names = _params(sym)

    def loss(p):
        v = {k: jnp.asarray(a) for k, a in vals.items()}
        v.update(p)
        outs, aux = fn(v, jax.random.PRNGKey(0))
        return jnp.sum(outs[0] * cot), (outs[0], aux)

    grads, (out, aux) = jax.grad(loss, has_aux=True)(
        {k: jnp.asarray(vals[k]) for k in names})
    return (np.asarray(out), {k: np.asarray(a) for k, a in aux.items()},
            {k: np.asarray(g) for k, g in grads.items()})


def _assert_runs_match(got, want, tag):
    _close(got[0], want[0], what=tag + " output")
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        _close(got[1][k], want[1][k], what="%s aux %s" % (tag, k))
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], what="%s grad %s" % (tag, k))


def _bottleneck(mod):
    return mod.resnet(fused=False, **BOTTLENECK)


def _basic(mod):
    return mod.resnet(**BASIC)


@pytest.mark.parametrize("passes,build,shapes", [
    (("fusion", "layout"), _bottleneck, SHAPES["bottleneck"]),
    (("residual",), _basic, SHAPES["basic"])],
    ids=["fusion+layout", "residual"])
def test_passes_rewrite_as_jax_and_keep_the_math(passes, build, shapes):
    (t, to, tprov), (j, jo, jprov) = _both(build, passes)
    assert t.tojson() == j.tojson()
    assert to.tojson() == jo.tojson()
    assert tprov == jprov
    tstats = profiler.pass_stats(reset=True)["passes"]
    jstats = jprofiler.pass_stats(reset=True)["passes"]
    assert set(tstats) == set(jstats) == set(passes)
    for p in passes:
        assert tstats[p] == {k: jstats[p][k] for k in tstats[p]}, p
    if "layout" in passes:
        # the BatchNorm after the fused units now runs on NHWC
        bn = [n for n in to._topo() if not n.is_variable()
              and n.op.name == "BatchNorm"]
        assert [n.attrs.get("axis") for n in bn][-1] == 3
        assert tprov[-1]["transposes_cancelled"] == \
            jprov[-1]["transposes_cancelled"]
    else:
        assert sum(1 for n in to._topo() if not n.is_variable()
                   and n.op.name == "_ConvResidualAdd") == 8
    vals = _values(t, shapes)
    assert set(_values(to, shapes)) == set(vals)
    cot = np.random.RandomState(1).randn(shapes["data"][0], 5) \
        .astype(np.float32)
    before, after = _port_run(t, vals, cot), _port_run(to, vals, cot)
    _assert_runs_match(after, before, "port rewritten vs unrewritten")
    _assert_runs_match(after, _jax_run(jo, vals, cot),
                       "port vs JAX rewritten")


def _transpose_chain(sym):
    data = sym.Variable("data")
    t1 = sym.transpose(data, axes=(0, 2, 3, 1), name="t_in")
    act = sym.Activation(t1, act_type="relu", name="act")
    t2 = sym.transpose(act, axes=(0, 3, 1, 2), name="t_out")
    fc = sym.FullyConnected(sym.Flatten(t2, name="flat"), num_hidden=3,
                            name="fc")
    return sym.SoftmaxOutput(fc, name="softmax")


def test_layout_pass_cancels_a_transpose_chain_as_jax():
    from mxnet_tpu_torch import symbol as tsym

    profiler.pass_reset()
    s = _transpose_chain(tsym)
    out, provs = ir.PassManager(("layout",)).apply(s)
    jout, jprovs = jir.PassManager(("layout",)).apply(
        _transpose_chain(mx.sym))
    assert out.tojson() == jout.tojson() and provs == jprovs
    assert provs[0]["transposes_cancelled"] == 2
    assert profiler.pass_stats(reset=True)["passes"]["layout"][
        "transposes_cancelled"] == 2
    names = {n.name for n in out._topo() if not n.is_variable()}
    assert {"act", "fc"} <= names
    assert "fc" in ir.plan_remat(out, record=False).save
    shapes = {"data": (2, 3, 4, 4), "softmax_label": (2,)}
    rng = np.random.RandomState(0)
    args, _, _ = s.infer_shape(**shapes)
    vals = {k: (rng.randn(*v) * 0.5).astype(np.float32)
            for k, v in zip(s.list_arguments(), args)}
    vals["softmax_label"] = np.array([0, 2], np.float32)
    v = {k: torch.tensor(a) for k, a in vals.items()}
    o1 = _graph_closure(s, True)(v)[0][0]
    o2 = _graph_closure(out, True)(v)[0][0]
    assert torch.equal(o1, o2)


def test_layout_kill_switch(monkeypatch):
    from mxnet_tpu_torch import symbol as tsym

    monkeypatch.setenv("MXNET_IR_LAYOUT", "0")
    out, provs = ir.PassManager(("layout",)).apply(_transpose_chain(tsym))
    assert provs[0]["rewrites"] == 0
    assert sum(1 for n in out._topo() if not n.is_variable()
               and n.op.name == "transpose") == 2
    monkeypatch.setenv("MXNET_IR_LAYOUT", "maybe")
    with pytest.raises(MXNetError, match="MXNET_IR_LAYOUT"):
        ir.PassManager(("layout",)).apply(_transpose_chain(tsym))


def test_batch_norm_on_axis_3_matches_jax_with_moving_stats():
    """The sunk BatchNorm's statistics reduce over N, H, W of NHWC data:
    outputs, batch mean/var and their gradients against the JAX op."""
    from mxnet_tpu.ops import nn as jnn

    rng = np.random.RandomState(2)
    x = (rng.randn(2, 5, 5, 6) * 1.5 + 0.7).astype(np.float32)
    g = (rng.rand(6) + 0.5).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    mm, mv = np.zeros(6, np.float32), np.ones(6, np.float32)
    cots = [rng.randn(*s).astype(np.float32) for s in (x.shape, (6,), (6,))]
    kw = dict(eps=2e-5, fix_gamma=False, axis=3, __is_train__=True)

    def jloss(v, gg, bb):
        outs = jnn.batch_norm(v, gg, bb, jnp.asarray(mm), jnp.asarray(mv),
                              **kw)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    jg, jouts = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    tx, tg_, tb = (torch.tensor(a).requires_grad_() for a in (x, g, b))
    touts = tnn.batch_norm(tx, tg_, tb, torch.tensor(mm), torch.tensor(mv),
                           **kw)
    tgs = torch.autograd.grad(sum((o * torch.tensor(c)).sum()
                                  for o, c in zip(touts, cots)),
                              (tx, tg_, tb))
    for o, jo in zip(touts, jouts):
        _close(o.detach().numpy(), np.asarray(jo))
    for a, ja in zip(tgs, jg):
        _close(a.numpy(), np.asarray(ja))


@pytest.mark.parametrize("bias", [False, True])
def test_conv_residual_add_matches_jax(bias):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 6, 6).astype(np.float32)
    w = (rng.randn(8, 4, 3, 3) * 0.2).astype(np.float32)
    r = rng.randn(2, 8, 3, 3).astype(np.float32)
    bb = rng.randn(8).astype(np.float32) if bias else None
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=8,
              no_bias=not bias)
    cot = rng.randn(2, 8, 3, 3).astype(np.float32)
    ins = [x, w, r] + ([bb] if bias else [])

    def jloss(*a):
        return jnp.sum(jfused._conv_residual_add(*a[:3], *a[3:], **kw) * cot)

    jval = jfused._conv_residual_add(*[jnp.asarray(a) for a in ins], **kw)
    jg = jax.grad(jloss, argnums=tuple(range(len(ins))))(
        *[jnp.asarray(a) for a in ins])
    tins = [torch.tensor(a).requires_grad_() for a in ins]
    tval = tfused._conv_residual_add(*tins[:3], *tins[3:], **kw)
    tg = torch.autograd.grad((tval * torch.tensor(cot)).sum(), tins)
    _close(tval.detach().numpy(), np.asarray(jval))
    for a, ja in zip(tg, jg):
        _close(a.numpy(), np.asarray(ja))


def test_rule_registry_matches_jax():
    assert ir.list_rules() == jir.list_rules()
    assert [r.name for r in ir.residual_rules()] == \
        [r.name for r in jir.residual_rules()]
    assert [r.name for r in ir.layout_rules()] == \
        [r.name for r in jir.layout_rules()]
    with pytest.raises(MXNetError, match="unknown rule"):
        ir.get_rule("nosuch")
    with pytest.raises(MXNetError, match="duplicate"):
        ir.register_rule(ir.get_rule("transpose_cancel"))


def test_quantize_pass_raises_by_name():
    from mxnet_tpu_torch import symbol as tsym

    with pytest.raises(MXNetError, match="quantize.*not ported"):
        ir.apply_passes(_transpose_chain(tsym), ["quantize"])
    with pytest.raises(MXNetError, match="unknown pass"):
        ir.apply_passes(_transpose_chain(tsym), ["nosuch"])
