"""The PyTorch port's executor, optimizers, metrics, iterators and symbol
front end against the JAX package, on the CPU.

- ``simple_bind`` on the tiny ResNet of ``tests/test_torch_fused_train.py``
  (fused and unfused, that file's batch seed): the training forward's
  outputs and aux updates and every gradient against the JAX executor;
  ``grad_req`` add (two passes sum) and null; ``forward_backward`` equal to
  ``forward`` + ``backward``; the weights updated in place reaching the
  next forward; ``reshape``.
- Each optimizer, three updates of two parameters, against the JAX
  ``Updater`` (with ``rescale_grad``, ``clip_gradient``, weight decay and
  per-name multipliers); ``parallel.functional_optimizer`` against the new
  ``SGD`` and ``Adam``.
- Each metric against JAX on the same arrays; ``NDArrayIter`` and
  ``ResizeIter`` batches and pads; ``Symbol`` files, attributes, types,
  arithmetic and the name and attribute scopes.

Tolerance: fp32, rtol 1e-4 and an atol of 1e-5 of the reference's largest
|value|. The JAX fused kernels name ``pltpu.TPUCompilerParams``, which
this JAX calls ``pltpu.CompilerParams``: aliased by ``monkeypatch``.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import fused_block as tfb
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.parallel import functional_optimizer

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
SHAPES = {"data": (4, 3, 64, 64), "softmax_label": (4,)}
BATCH_SEED = 4      # tests/test_torch_fused_train.py's batch


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port's default context is the card: these tests ask for the
    CPU."""
    with mx.cpu():
        yield


@contextlib.contextmanager
def _alias():
    """The alias for a module-scoped fixture (undone after it)."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        yield


def _close(got, want, what="", floor=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()) if want.size else 0.0,
                floor or 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * scale,
                               err_msg=what)


def _batch():
    rng = np.random.RandomState(BATCH_SEED)
    return {"data": rng.randn(*SHAPES["data"]).astype(np.float32),
            "softmax_label": rng.randint(0, 5, SHAPES["softmax_label"])
            .astype(np.float32)}


def _params(fused):
    return tresnet.init_params(tresnet.resnet(fused=fused, **TINY),
                               SHAPES["data"], seed=0)


def _bind(pkg, resnet, fused, grad_req="write"):
    ctx = pkg.cpu()
    sym = resnet.resnet(fused=fused, **TINY)
    ex = sym.simple_bind(ctx, grad_req=grad_req, **SHAPES)
    args, auxs = _params(fused)
    for k, v in args.items():
        ex.arg_dict[k][:] = v
    for k, v in auxs.items():
        ex.aux_dict[k][:] = v
    return ex


def _snapshot(ex, names=None):
    return ([o.asnumpy() for o in ex.outputs],
            {k: v.asnumpy() for k, v in ex.aux_dict.items()},
            {k: v.asnumpy() for k, v in ex.grad_dict.items()
             if v is not None and (names is None or k in names)})


@pytest.fixture(scope="module")
def jax_exec():
    """The JAX executor's training forward (outputs, aux) and backward
    (every gradient), fused and unfused, grad_req write."""
    out = {}
    with _alias():
        for fused in (True, False):
            ex = _bind(jmx, jresnet, fused)
            b = _batch()
            ex.forward(is_train=True, **b)
            fwd = _snapshot(ex)
            ex.backward()
            out[fused] = (fwd, _snapshot(ex))
    return out


def _grad_floor(grads):
    """The largest |gradient| of any tensor: the gradients are held as one
    reference, atol 1e-5 of its largest |value|. bn0's gamma has an exact
    gradient of 0 here (BN -> ReLU -> BN is invariant to scaling gamma and
    beta together, and beta is 0), so each package gives rounding noise of
    its own summation order (~1e-6 of the largest gradient), which has no
    scale of its own."""
    return max(float(np.abs(g).max()) for g in grads.values())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_simple_bind_forward_backward_matches_jax(jax_exec, fused):
    (j_outs, j_aux, _), (_, _, j_grads) = jax_exec[fused]
    ex = _bind(mx, tresnet, fused)
    before = (tfb.conv_fwd.launches, tfb.conv_wgrad.launches)
    ex.forward(is_train=True, **_batch())
    t_outs, t_aux, _ = _snapshot(ex)
    _close(t_outs[0], j_outs[0], "outputs")
    for k in j_aux:
        _close(t_aux[k], j_aux[k], k)
    ex.backward()
    _, _, t_grads = _snapshot(ex)
    assert set(t_grads) == set(j_grads)
    floor = _grad_floor(j_grads)
    for k in j_grads:
        _close(t_grads[k], j_grads[k], k, floor=floor)
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tfb.conv_fwd.launches, tfb.conv_wgrad.launches) == before


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_grad_req_add_null_and_forward_backward(fused):
    names = tresnet.resnet(fused=fused, **TINY).list_arguments()
    null = {n for n in names if "bn" in n} | {"data", "softmax_label"}
    reqs = {n: "null" if n in null else "add" for n in names}
    ex_add = _bind(mx, tresnet, fused, grad_req=reqs)
    ex_one = _bind(mx, tresnet, fused)
    b = _batch()
    ex_one.forward_backward(**b)
    one = _snapshot(ex_one)
    aux0 = {k: v.asnumpy() for k, v in ex_add.aux_dict.items()}
    ex_add.forward(is_train=True, **b)
    ex_add.backward()
    ex_add.forward_backward(**b)
    assert not set(ex_add.grad_dict) & null
    for k, g in ex_add.grad_dict.items():
        _close(g.asnumpy(), 2 * one[2][k], k,
               floor=_grad_floor(one[2]) * 2)
    # forward + backward equals forward_backward; aux applied once per
    # training forward (two here: the momentum mix applied twice)
    ex_two = _bind(mx, tresnet, fused)
    ex_two.forward(is_train=True, **b)
    ex_two.backward()
    two = _snapshot(ex_two)
    _close(two[0][0], one[0][0])
    for k in one[2]:
        assert np.array_equal(two[2][k], one[2][k]), k
    m = 0.9
    for k, v in ex_add.aux_dict.items():
        batch_stat = (one[1][k] - m * aux0[k]) / (1 - m)
        _close(v.asnumpy(), m * one[1][k] + (1 - m) * batch_stat, k)


def test_weights_updated_in_place_reach_the_next_forward():
    ex = _bind(mx, tresnet, False)
    b = _batch()
    ex.forward(**b)
    first = ex.outputs[0].asnumpy()
    w = ex.arg_dict["fc1_weight"]
    tensor = w.tensor
    upd = mx.optimizer.get_updater(mx.optimizer.SGD(learning_rate=10.0))
    ex.forward_backward(**b)
    upd(0, ex.grad_dict["fc1_weight"], w)
    assert w.tensor is tensor and ex.arg_dict["fc1_weight"] is w
    ex.forward(**b)
    assert not np.allclose(ex.outputs[0].asnumpy(), first)
    w[:] = 0.0
    ex.arg_dict["fc1_bias"][:] = 0.0
    ex.forward(**b)
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), 0.2, rtol=1e-6)


def test_backward_frees_the_graph_and_reruns_when_asked():
    ex = _bind(mx, tresnet, False)
    b = _batch()
    ex.forward(is_train=True, **b)
    assert ex._pending is not None
    ex.backward()
    assert ex._pending is None
    g1 = ex.grad_dict["fc1_weight"].asnumpy()
    ex.backward()             # no graph kept: the forward runs again
    np.testing.assert_array_equal(ex.grad_dict["fc1_weight"].asnumpy(), g1)
    ex.forward(is_train=False, **b)
    assert ex._pending is None


def test_reshape_and_bind_errors():
    ex = _bind(mx, tresnet, True)
    ex2 = ex.reshape(data=(2, 3, 64, 64), softmax_label=(2,))
    assert ex2.arg_dict["data"].shape == (2, 3, 64, 64)
    assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    ex2.forward(data=_batch()["data"][:2])
    assert ex2.outputs[0].shape == (2, 5)
    sym = tresnet.resnet(fused=False, **TINY)
    with pytest.raises(MXNetError, match="missing arguments"):
        sym.bind(mx.cpu(), {"data": mx.nd.zeros((1,))})
    # group2ctx, refused before: the executor records its placement
    placed = sym.simple_bind(mx.cpu(), group2ctx={"a": mx.cpu()}, **SHAPES)
    assert placed.placement == {"a": mx.cpu()}
    with pytest.raises(MXNetError, match="grad_req"):
        sym.simple_bind(mx.cpu(), grad_req="sometimes", **SHAPES)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                 clip_gradient=0.5)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=1.0)),
    ("adagrad", dict(learning_rate=0.1, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, wd=1e-3)),
    ("rmsprop", dict(learning_rate=0.01, centered=True, clip_weights=0.5)),
    ("adadelta", dict(wd=1e-3)),
    ("adamax", dict(wd=1e-3)),
    ("nadam", dict(wd=1e-3)),
    ("signum", dict(learning_rate=0.01, wd=1e-3, wd_lh=1e-2)),
    ("signum", dict(learning_rate=0.01, momentum=0.0)),
    ("ftrl", dict(learning_rate=0.1, wd=1e-3)),
]


def _opt_run(pkg, name, kw, steps=3, dtype="float32", multi=False):
    rng = np.random.RandomState(11)
    names = {0: "fc_weight", 1: "fc_bias"}
    opt = pkg.optimizer.create(name, rescale_grad=0.25,
                               param_idx2name=names, multi_precision=multi,
                               **kw)
    opt.set_lr_mult({"fc_bias": 2.0})
    opt.set_wd_mult({})
    upd = pkg.optimizer.get_updater(opt)
    ctx = pkg.cpu()
    ws = [pkg.nd.array(rng.randn(4, 3).astype(np.float32), ctx=ctx)
          .astype(dtype), pkg.nd.array(rng.randn(3).astype(np.float32),
                                       ctx=ctx).astype(dtype)]
    for _ in range(steps):
        for i, w in enumerate(ws):
            g = pkg.nd.array(rng.randn(*w.shape).astype(np.float32) * 3,
                             ctx=ctx).astype(dtype)
            upd(i, g, w)
    return [w.asnumpy().astype(np.float32) for w in ws], upd


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_optimizer_three_updates_match_jax(name, kw):
    got, tu = _opt_run(mx, name, kw)
    want, ju = _opt_run(jmx, name, kw)
    for g, w in zip(got, want):
        _close(g, w, name)
    # the states too, through the .states byte format
    tmap, jmap = tu.get_states_map(), ju.get_states_map()
    assert set(tmap) == set(jmap)


def test_multi_precision_sgd_matches_jax():
    kw = dict(learning_rate=0.1, momentum=0.9)
    got, _ = _opt_run(mx, "sgd", kw, dtype="float16", multi=True)
    want, _ = _opt_run(jmx, "sgd", kw, dtype="float16", multi=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3)


def test_unknown_and_unported_optimizers_raise():
    # SGLD and DCASGD are ported (tests/test_torch_sparse.py holds them
    # against the JAX package), and so is Test (tests/test_torch_surface.py)
    assert type(mx.optimizer.create("sgld")).__name__ == "SGLD"
    assert type(mx.optimizer.create("dcasgd")).__name__ == "DCASGD"
    assert type(mx.optimizer.create("test")).__name__ == "Test"
    with pytest.raises(MXNetError, match="unknown optimizer"):
        mx.optimizer.create("nope")


def _functional_run(fopt, tensor, step_of):
    """Three updates of a functional optimizer (either package's) on the
    seeded weights and gradients; the weights as numpy."""
    rng = np.random.RandomState(2)
    w0 = {"a_weight": rng.randn(5, 4).astype(np.float32),
          "a_bias": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              w0.items()} for _ in range(3)]
    params = {k: tensor(v) for k, v in w0.items()}
    state = fopt.init(params)
    for step, g in enumerate(grads):
        params, state = fopt.apply(params, {k: tensor(v) for k, v in
                                            g.items()}, state, step_of(step))
    return w0, grads, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("sgd", dict(learning_rate=0.1, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
                 clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=1e-3, clip_gradient=0.3))])
def test_functional_optimizer_agrees_with_the_new_optimizers(name, kw):
    """``parallel.functional_optimizer`` (TrainStep's) and ``Optimizer``
    through an ``Updater`` (Module's) take the same three updates; both
    apply weight decay to every parameter here (an empty ``wd_mult``).
    With ``clip_gradient`` > 0 both clip (the rescaled gradients reach
    1.33 here)."""
    fo = functional_optimizer(name, rescale_grad=0.5, wd_mult={}, **kw)
    w0, grads, params = _functional_run(fo, torch.tensor, int)
    opt = mx.optimizer.create(name, rescale_grad=0.5, **kw)
    upd = mx.optimizer.get_updater(opt)
    ws = {k: mx.nd.array(v) for k, v in w0.items()}
    for g in grads:
        for i, k in enumerate(sorted(ws)):
            upd(i, mx.nd.array(g[k]), ws[k])
    for k in w0:
        _close(ws[k].asnumpy(), params[k], k)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3))])
def test_clip_gradient_zero_keeps_each_jax_path(name, kw):
    """``clip_gradient=0`` means no clipping to the JAX package's
    ``functional_optimizer`` and a zeroed gradient to its update ops
    (``clip_gradient >= 0``). The port's two paths share the ops and keep
    each reference's meaning: the functional optimizer at 0 is the JAX
    functional optimizer at 0 and the port's unclipped one; the
    ``Optimizer`` at 0 is the JAX ``Updater`` at 0."""
    from mxnet_tpu.parallel.spmd import functional_optimizer as jfo
    import jax.numpy as jnp

    tfo = functional_optimizer(name, rescale_grad=0.5, wd_mult={},
                               clip_gradient=0.0, **kw)
    _, _, got = _functional_run(tfo, torch.tensor, int)
    jf = jfo(name, rescale_grad=0.5, wd_mult={}, clip_gradient=0.0, **kw)
    _, _, want = _functional_run(jf, jnp.asarray, jnp.int32)
    unclipped = functional_optimizer(name, rescale_grad=0.5, wd_mult={},
                                     **kw)
    _, _, free = _functional_run(unclipped, torch.tensor, int)
    for k in want:
        _close(got[k], want[k], k)
        np.testing.assert_array_equal(got[k], free[k])
    kw0 = dict(kw, clip_gradient=0.0)
    got, _ = _opt_run(mx, name, kw0)
    want, _ = _opt_run(jmx, name, kw0)
    for g, w in zip(got, want):
        _close(g, w, name)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_data(seed=0, n=8, k=4):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, k).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    return rng.randint(0, k, (n,)).astype(np.float32), probs


METRICS = [("acc", {}), ("top_k_acc", {"top_k": 2}), ("ce", {}),
           ("nll_loss", {}), ("perplexity", {}),
           ("perplexity", {"ignore_label": 1}), ("mae", {}), ("mse", {}),
           ("rmse", {}), ("pearsonr", {}), ("loss", {}), ("f1", {}),
           ("f1", {"average": "micro"}), (["acc", "ce"], {})]


@pytest.mark.parametrize("name,kw", METRICS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(METRICS)])
def test_metric_matches_jax(name, kw):
    results = []
    for pkg in (mx, jmx):
        m = pkg.metric.create(name, **kw)
        for seed in (0, 1):
            label, probs = _metric_data(seed, k=2 if name == "f1" else 4)
            if name in ("mae", "mse", "rmse", "pearsonr"):
                probs = probs[:, 0]
            m.update([pkg.nd.array(label)], [pkg.nd.array(probs)])
        results.append(m.get_name_value())
    (tn, tv), (jn, jv) = zip(*results[0]), zip(*results[1])
    assert tn == jn
    _close(tv, jv, str(name))


def test_custom_metric_and_update_dict():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(axis=1)).sum()), len(label)

    out = []
    for pkg in (mx, jmx):
        m = pkg.metric.np(feval)
        label, probs = _metric_data(3)
        m.update_dict({"softmax_label": pkg.nd.array(label)},
                      {"softmax_output": pkg.nd.array(probs)})
        out.append(m.get())
    assert out[0] == out[1]
    with pytest.raises(MXNetError, match="unknown metric"):
        mx.metric.create("nope")


# ---------------------------------------------------------------------------
# iterators
# ---------------------------------------------------------------------------
def _epochs(pkg, n_epochs=2, **kw):
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    np.random.seed(5)
    it = pkg.io.NDArrayIter(x, y, batch_size=4, **kw)
    out = []
    for _ in range(n_epochs):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out, [(d.name, d.shape) for d in it.provide_data + it.provide_label]


@pytest.mark.parametrize("kw", [{}, {"last_batch_handle": "discard"},
                                {"last_batch_handle": "roll_over"},
                                {"shuffle": True}],
                         ids=["pad", "discard", "roll_over", "shuffle"])
def test_ndarray_iter_matches_jax(kw):
    (tb, td), (jb, jd) = _epochs(mx, **kw), _epochs(jmx, **kw)
    assert td == jd
    assert len(tb) == len(jb)
    for te, je in zip(tb, jb):
        assert len(te) == len(je)
        for (a, b, p), (c, d, q) in zip(te, je):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
            assert p == q


def test_ndarray_iter_keeps_numpy_on_the_host_and_takes_a_generator():
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    with mx.gpu(0):
        it = mx.io.NDArrayIter(x, batch_size=4, shuffle=True,
                               rng=np.random.RandomState(0))
    assert it.data[0][1].context == mx.cpu()
    order = np.arange(8)
    np.random.RandomState(0).shuffle(order)
    first = next(iter(it)).data[0].asnumpy().ravel()
    np.testing.assert_array_equal(first, order[:4])
    it = mx.io.ResizeIter(mx.io.NDArrayIter(x, batch_size=4), 5)
    assert len(list(it)) == 5


# ---------------------------------------------------------------------------
# symbol front end
# ---------------------------------------------------------------------------
def test_symbol_files_load_in_both_packages(tmp_path):
    for fused in (True, False):
        tsym = tresnet.resnet(fused=fused, **TINY)
        tsym.save(str(tmp_path / "t.json"))
        jsym = jmx.sym.load(str(tmp_path / "t.json"))
        assert jsym.list_arguments() == tsym.list_arguments()
        assert jsym.list_auxiliary_states() == \
            tsym.list_auxiliary_states()
        jresnet.resnet(fused=fused, **TINY).save(str(tmp_path / "j.json"))
        back = mx.sym.load(str(tmp_path / "j.json"))
        assert back.list_arguments() == tsym.list_arguments()
        assert back.infer_shape(**SHAPES) == tsym.infer_shape(**SHAPES)


def test_symbol_attributes_types_and_arithmetic():
    with mx.AttrScope(lr_mult="0.5"):
        a = mx.sym.var("a", wd_mult=0.0)
        c = mx.sym.Activation(a, act_type="relu", name="act")
    assert a.attr("lr_mult") == "0.5" and a.attr("__wd_mult__") == 0.0
    d = c.attr_dict()
    assert d["act"]["act_type"] == "relu" and d["a"]["lr_mult"] == "0.5"
    b = mx.sym.var("b")
    expr = (a * 2 + b) / (b - 1) - a ** 2
    expr = -expr.reshape((2, -1)).sum(axis=1)
    jexpr = (jmx.sym.var("a") * 2 + jmx.sym.var("b")) / (
        jmx.sym.var("b") - 1) - jmx.sym.var("a") ** 2
    jexpr = -jexpr.reshape((2, -1)).sum(axis=1)
    rng = np.random.RandomState(0)
    va = rng.rand(2, 3).astype(np.float32)
    vb = rng.rand(2, 3).astype(np.float32) + 2
    te = expr.bind(mx.cpu(), {"a": mx.nd.array(va), "b": mx.nd.array(vb)})
    je = jexpr.bind(jmx.cpu(), {"a": jmx.nd.array(va),
                                "b": jmx.nd.array(vb)})
    _close(te.forward()[0].asnumpy(), je.forward()[0].asnumpy())
    at, ot, xt = tresnet.resnet(fused=True, **TINY).infer_type(
        data=np.float32)
    aj, oj, xj = jresnet.resnet(fused=True, **TINY).infer_type(
        data=np.float32)
    assert [np.dtype(t) for t in at + ot + xt] == \
        [np.dtype(t) for t in aj + oj + xj]


def test_name_manager_and_prefix():
    with mx.name.NameManager():
        a = mx.sym.Activation(mx.sym.var("x"), act_type="relu")
        b = mx.sym.Activation(mx.sym.var("x"), act_type="relu")
    assert (a.name, b.name) == ("activation0", "activation1")
    with mx.name.Prefix("net_"):
        c = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=3)
    assert c.name == "net_fullyconnected0"
    assert "net_fullyconnected0_weight" in c.list_arguments()


def test_lr_scheduler_drives_the_optimizer_as_in_jax():
    out = []
    for pkg in (mx, jmx):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create("sgd", learning_rate=0.4, momentum=0.5,
                                   lr_scheduler=sched)
        upd = pkg.optimizer.get_updater(opt)
        w = pkg.nd.array(np.ones((2, 2), np.float32), ctx=pkg.cpu())
        for step in range(6):
            upd(0, pkg.nd.array(np.full((2, 2), 0.1 * (step + 1),
                                        np.float32), ctx=pkg.cpu()), w)
        out.append((w.asnumpy(), sched.base_lr))
    _close(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == 0.1


def test_mixed_load_and_init_attribute_initializers():
    shape = (3, 4)
    mixed = mx.init.Mixed(["^fc", ".*"], [mx.init.Constant(0.5),
                                          mx.init.One()])
    b, w = mx.nd.zeros(shape), mx.nd.zeros(shape)
    mixed("fc_weight", b)
    mixed("emb_weight", w)
    assert b.asnumpy().tolist() == [[0.5] * 4] * 3
    assert w.asnumpy().tolist() == [[1.0] * 4] * 3
    src = {"arg:fc_weight": mx.nd.array(np.arange(12.0).reshape(shape))}
    load = mx.init.Load(src, default_init=mx.init.Zero())
    w2, other = mx.nd.zeros(shape), mx.nd.ones(shape)
    load("fc_weight", w2)
    load("other_weight", other)
    assert w2.asnumpy().ravel().tolist() == list(np.arange(12.0))
    assert not other.asnumpy().any()
    with pytest.raises(MXNetError, match="no initializer pattern"):
        mx.init.Mixed(["^x$"], [mx.init.One()])("y", w)
    # a variable's __init__ attribute overrides the name-suffix dispatch
    v = mx.sym.var("v_weight", init=mx.init.Constant(2.0))
    desc = mx.init.InitDesc("v_weight", v.attr_dict()["v_weight"])
    arr = mx.nd.zeros((2,))
    mx.init.Xavier()(desc, arr)
    assert arr.asnumpy().tolist() == [2.0, 2.0]
