"""More than one device in one process in the PyTorch port against the JAX
package, on the CPU: N CPU contexts stand for N devices, as in the JAX
package's own tests (``tests/conftest.py`` gives JAX 8 host devices).

- ``_split_input_slice``, even, uneven and refused, against the JAX one;
- ``Module`` on ``[cpu(0), cpu(1)]`` (an MLP with BatchNorm, so the
  moving statistics differ between the executors): 3 batches under the
  ``device`` and ``local`` kvstores, parameters and aux states against the
  JAX ``Module``'s; merged and unmerged outputs and input gradients, an
  uneven ``work_load_list``, ``backward(out_grads)``, ``update_metric`` and
  ``get_params``' host mean; ``fit``/``score``/``predict`` and
  ``FeedForward`` / ``DataParallelExecutorManager`` over the list;
- ``group2ctx``: the four cases of ``tests/test_model_parallel.py`` against
  the port, each placed node's recorded context;
- ``Module(kvstore='tpu')`` on ``cpu(0..3)``, the one-process fused step,
  against the JAX group: the four cases of ``tests/test_fused_module.py``;
  the duplicate and indivisible refusals; the fused unit's BatchNorm
  statistics across two replicas against the JAX ``shard_map`` wrapper;
  a tiny fused ResNet whose statistics cross the replicas against one
  device;
- ``TrainStep`` on ``make_mesh({"dp": 2}, devices=[cpu(0), cpu(1)])``
  against the JAX ``TrainStep`` on two CPU devices, ZeRO bit for bit
  against replicated;
- ``DeviceQueueIter(module=)`` over the list;
- a Gluon parameter on a list;
- a fused ResNet's body and head placed on two CPU contexts, bit for bit
  the unplaced bind (on the card, with the head on the host:
  ``tests/test_torch_multi_context_cuda.py``, which imports no JAX);
- no port file cites item 14.

rtol 1e-4 / atol 1e-5 unless a case says otherwise. The JAX fused kernels
name ``pltpu.TPUCompilerParams``, which this JAX calls
``pltpu.CompilerParams``: the alias is set with ``monkeypatch``.
"""
import glob
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu_torch.base import MXNetError

import torch_dp_workers as w

RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_and_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)
    with mx.cpu():
        yield


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


# ---------------------------------------------------------------------------
# the batch split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,work", [(10, [1, 1]), (10, [1, 2, 1]),
                                        (7, [3, 1]), (5, [1, 1, 1, 1, 1]),
                                        (2, [1, 1, 1])])
def test_split_input_slice_matches_jax(batch, work):
    from mxnet_tpu.module.executor_group import _split_input_slice as jsplit
    from mxnet_tpu_torch.module.executor_group import _split_input_slice

    if batch < len(work):
        with pytest.raises(MXNetError, match="smaller than device count"):
            _split_input_slice(batch, work)
        with pytest.raises(jmx.base.MXNetError,
                           match="smaller than device count"):
            jsplit(batch, work)
        return
    assert _split_input_slice(batch, work) == jsplit(batch, work)


# ---------------------------------------------------------------------------
# Module over two contexts, the per-executor path
# ---------------------------------------------------------------------------
def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _toy(n=96, d=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = x[:, :4].argmax(axis=1).astype(np.float32)
    return x, y


def _init(pkg, sym, d=8, seed=1):
    rng = np.random.RandomState(seed)
    shapes, _, aux_shapes = sym.infer_shape(data=(2, d))
    args = {n: pkg.nd.array(rng.normal(0, 0.3, s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: pkg.nd.array((np.ones(s) if "var" in n else np.zeros(s))
                           .astype(np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _module(pkg, contexts, kvstore, batches=3, work=None, batch=32):
    x, y = _toy()
    sym = _mlp(pkg)
    args, aux = _init(pkg, sym)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    mod = pkg.mod.Module(sym, context=contexts, work_load_list=work)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    metric = pkg.metric.Accuracy()
    for i, b in enumerate(it):
        if i == batches:
            break
        mod.forward_backward(b)
        mod.update()
        mod.update_metric(metric, b.label)
    arg, auxp = mod.get_params()
    return mod, ({k: _np(v) for k, v in arg.items()},
                 {k: _np(v) for k, v in auxp.items()}, metric.get())


@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_module_two_contexts_matches_jax(kvstore):
    """The JAX ``test_module_multi_device_data_parallel`` on both packages:
    after 3 batches the parameters and the averaged moving statistics
    agree, and so does the accuracy."""
    mod, (arg, aux, acc) = _module(mx, [mx.cpu(0), mx.cpu(1)], kvstore)
    _jm, (jarg, jaux, jacc) = _module(jmx, [jmx.cpu(0), jmx.cpu(1)],
                                      kvstore)
    assert len(mod._exec_group.execs) == 2
    assert mod._kvstore is not None and mod._kvstore.type == kvstore
    assert set(arg) == set(jarg) and set(aux) == set(jaux)
    for k in jarg:
        _close(arg[k], jarg[k], k)
    for k in jaux:
        _close(aux[k], jaux[k], k)
    assert acc[0] == jacc[0] and abs(acc[1] - jacc[1]) < 1e-6


def _bound(pkg, work=None, batch=12):
    sym = _mlp(pkg)
    args, aux = _init(pkg, sym)
    mod = pkg.mod.Module(sym, context=[pkg.cpu(0), pkg.cpu(1)],
                         work_load_list=work)
    mod.bind(data_shapes=[("data", (batch, 8))],
             label_shapes=[("softmax_label", (batch,))],
             inputs_need_grad=True)
    mod.init_params(arg_params=args, aux_params=aux)
    x, y = _toy(batch)
    b = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    return mod, b


@pytest.mark.parametrize("work", [None, [2, 1]], ids=["even", "uneven"])
def test_outputs_input_grads_metric_and_params_match_jax(work):
    """Merged (one array along the batch) and unmerged (one a context)
    outputs and input gradients, ``backward(out_grads)`` split by the
    slices, ``update_metric`` slice by slice, and ``get_params``' host
    mean of two differing copies, against the JAX group."""
    got = {}
    for pkg in (mx, jmx):
        mod, b = _bound(pkg, work)
        mod.forward(b, is_train=True)
        og = pkg.nd.array(np.linspace(-1, 1, 48).reshape(12, 4)
                          .astype(np.float32))
        mod.backward([og])
        res = {"out_split": [_np(o) for o in
                             mod.get_outputs(merge_multi_context=False)[0]],
               "dx_split": [_np(g) for g in mod.get_input_grads(
                   merge_multi_context=False)[0]],
               "slices": [(s.start, s.stop)
                          for s in mod._exec_group.slices]}
        if pkg is mx:
            # the JAX merge concatenates arrays on two devices and raises
            # there (XLA's incompatible devices: a reference caveat), so
            # the port's merge is held to JAX's parts concatenated
            res["out"] = _np(mod.get_outputs()[0])
            res["dx"] = _np(mod.get_input_grads()[0])
            assert mod.get_outputs()[0].context == mx.cpu(0)
        metric = pkg.metric.Accuracy()
        mod.update_metric(metric, b.label)
        res["metric"] = metric.get()
        # two copies apart: the second executor's fc2_weight doubled
        grp = mod._exec_group
        w1 = grp.param_arrays[grp.param_names.index("fc2_weight")][1]
        w1[:] = w1 * 2.0
        mod._params_dirty = True
        res["mean"] = _np(mod.get_params()[0]["fc2_weight"])
        got[pkg.__name__] = res
    t, j = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    assert t["slices"] == j["slices"]
    _close(t["out"], np.concatenate(j["out_split"]), "outputs")
    _close(t["dx"], np.concatenate(j["dx_split"]), "input grads")
    for a, b_ in zip(t["out_split"], j["out_split"]):
        _close(a, b_, "outputs per context")
    for a, b_ in zip(t["dx_split"], j["dx_split"]):
        _close(a, b_, "input grads per context")
    assert t["metric"] == j["metric"]
    _close(t["mean"], j["mean"], "get_params mean")


def test_fit_score_predict_and_feedforward_over_a_list():
    """``fit`` and ``score`` over two contexts against the JAX package's;
    ``FeedForward(ctx=[...])`` trains through the same group to the JAX
    one's parameters. ``predict`` merges the contexts' outputs, which the
    JAX package cannot do over two devices (a reference caveat): the
    port's is held to one context bound with the same parameters."""
    x, y = _toy(64, seed=3)
    res = {}
    for pkg in (mx, jmx):
        sym = _mlp(pkg)
        args, aux = _init(pkg, sym)
        mod = pkg.mod.Module(sym, context=[pkg.cpu(0), pkg.cpu(1)])
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                optimizer="sgd", kvstore="device",
                optimizer_params={"learning_rate": 0.1},
                arg_params=args, aux_params=aux)
        score = mod.score(pkg.io.NDArrayIter(x, y, batch_size=16), "acc")
        ff = pkg.model.FeedForward(_mlp(pkg), ctx=[pkg.cpu(0), pkg.cpu(1)],
                                   num_epoch=1, optimizer="sgd",
                                   learning_rate=0.1, arg_params=args,
                                   aux_params=aux)
        np.random.seed(5)   # FeedForward shuffles with numpy's stream
        ff.fit(x, y)
        res[pkg.__name__] = (score[0][1], {k: _np(v) for k, v in
                                           ff.arg_params.items()}, mod)
    t, j = res["mxnet_tpu_torch"], res["mxnet_tpu"]
    assert abs(t[0] - j[0]) < 1e-6
    for k, v in j[1].items():
        _close(t[1][k], v, k)
    mod = t[2]
    pred = mod.predict(mx.io.NDArrayIter(x, y, batch_size=16))
    one = mx.mod.Module(_mlp(mx), context=mx.cpu(0))
    one.bind(data_shapes=[("data", (16, 8))],
             label_shapes=[("softmax_label", (16,))], for_training=False)
    one.set_params(*mod.get_params())
    want = one.predict(mx.io.NDArrayIter(x, y, batch_size=16))
    assert pred.shape == (64, 4)
    _close(pred.asnumpy(), want.asnumpy(), "predict")


# ---------------------------------------------------------------------------
# ctx_group placement
# ---------------------------------------------------------------------------
def _g2c_net(pkg):
    data = pkg.sym.var("data")
    with pkg.AttrScope(ctx_group="dev1"):
        h = pkg.sym.FullyConnected(data=data, num_hidden=8, name="fc1")
        h = pkg.sym.Activation(data=h, act_type="tanh", name="a1")
    with pkg.AttrScope(ctx_group="dev2"):
        h = pkg.sym.FullyConnected(data=h, num_hidden=4, name="fc2")
    return h


def _chain_net(pkg):
    data = pkg.sym.var("data")
    with pkg.AttrScope(ctx_group="dev1"):
        h = pkg.sym.FullyConnected(data=data, num_hidden=5, name="l1")
    with pkg.AttrScope(ctx_group="dev2"):
        h = pkg.sym.Activation(data=h, act_type="sigmoid", name="mid")
        h = pkg.sym.FullyConnected(data=h, num_hidden=5, name="l2")
    with pkg.AttrScope(ctx_group="dev1"):
        net = pkg.sym.make_loss(pkg.sym.sum(h), name="loss")
    return net


def _bind_and_run(pkg, net, group2ctx, shapes):
    r = np.random.RandomState(0)
    arg_names = net.list_arguments()
    arg_shapes, _, _ = net.infer_shape(**shapes)
    args = {n: pkg.nd.array(r.uniform(-1, 1, s).astype(np.float32))
            for n, s in zip(arg_names, arg_shapes)}
    grads = {n: pkg.nd.zeros(s) for n, s in zip(arg_names, arg_shapes)}
    exe = net.bind(ctx=pkg.cpu(), args=args, args_grad=grads,
                   group2ctx=group2ctx)
    out = exe.forward(is_train=True)[0].asnumpy()
    exe.backward([pkg.nd.ones(out.shape)])
    return exe, out, {n: exe.grad_dict[n].asnumpy() for n in arg_names}


@pytest.mark.parametrize("case", ["matches_single_device", "placement",
                                  "module_group2ctxs", "chained_roundtrip"])
def test_group2ctx_cases_match_jax(case):
    """The four cases of ``tests/test_model_parallel.py:51-137`` on the
    port: placed and unplaced binds agree with each other and with the JAX
    package, and each placed node's context is recorded on the
    executor."""
    if case == "module_group2ctxs":
        outs = {}
        for pkg in (mx, jmx):
            g2c = {"dev1": pkg.cpu(0), "dev2": pkg.cpu(1)}
            mod = pkg.mod.Module(_g2c_net(pkg), context=pkg.cpu(),
                                 label_names=None, group2ctxs=g2c)
            mod.bind(data_shapes=[("data", (2, 3))], for_training=True)
            mod.init_params(pkg.init.Xavier())
            if pkg is mx:   # the JAX module takes the port's initial values
                host = {k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()}
            else:
                mod.set_params({k: pkg.nd.array(v)
                                for k, v in host.items()}, {})
            assert all(e._group2ctx == g2c for e in mod._exec_group.execs)
            mod.forward(pkg.io.DataBatch(data=[pkg.nd.ones((2, 3))],
                                         label=None), is_train=True)
            outs[pkg.__name__] = mod.get_outputs()[0].asnumpy()
            mod.backward()
        assert outs["mxnet_tpu_torch"].shape == (2, 4)
        _close(outs["mxnet_tpu_torch"], outs["mxnet_tpu"], "outputs")
        pmod = mx.mod.Module(_g2c_net(mx), context=[mx.cpu(0), mx.cpu(1)],
                             label_names=None,
                             group2ctxs=[{"dev1": mx.cpu(0),
                                          "dev2": mx.cpu(1)},
                                         {"dev1": mx.cpu(1),
                                          "dev2": mx.cpu(0)}])
        pmod.bind(data_shapes=[("data", (4, 3))], for_training=True)
        pmod.init_params(mx.init.Xavier())
        pmod.forward(mx.io.DataBatch(data=[mx.nd.ones((4, 3))], label=None),
                     is_train=True)
        e0, e1 = pmod._exec_group.execs
        assert e0.node_devices["fc2"] == mx.cpu(1)
        assert e1.node_devices["fc2"] == mx.cpu(0)
        return
    net = _chain_net if case == "chained_roundtrip" else _g2c_net
    shapes = {"data": (3, 4)}
    ref = _bind_and_run(mx, net(mx), None, shapes)
    got = _bind_and_run(mx, net(mx), {"dev1": mx.cpu(0), "dev2": mx.cpu(1)},
                        shapes)
    jgot = _bind_and_run(jmx, net(jmx),
                         {"dev1": jmx.cpu(0), "dev2": jmx.cpu(1)}, shapes)
    _close(got[1], ref[1], "placed vs unplaced", rtol=1e-6, atol=1e-6)
    _close(got[1], jgot[1], "port vs JAX")
    for n in ref[2]:
        _close(got[2][n], ref[2][n], n, rtol=1e-6, atol=1e-6)
        _close(got[2][n], jgot[2][n], n)
    exe = got[0]
    assert exe.placement == {"dev1": mx.cpu(0), "dev2": mx.cpu(1)}
    if case == "placement":
        # every node of a placed group ran there, its variables too
        want = {"fc1": mx.cpu(0), "a1": mx.cpu(0), "fc1_weight": mx.cpu(0),
                "fc2": mx.cpu(1), "fc2_weight": mx.cpu(1),
                "fc2_bias": mx.cpu(1)}
        for name, ctx in want.items():
            assert exe.node_devices[name] == ctx, name
    # outputs and gradients land in the executor's arrays on its context
    assert exe.outputs[0].context == mx.cpu()
    assert all(g.context == mx.cpu() for g in exe.grad_dict.values())


# ---------------------------------------------------------------------------
# Module(kvstore='tpu') over cpu(0..3): the fused step on a one-process mesh
# ---------------------------------------------------------------------------
def _fused_mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _fused_data(n=128, d=16, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, 4)
    return X, X.dot(W).argmax(axis=1).astype(np.float32)


def _fused_init(pkg, seed=0):
    rng = np.random.RandomState(seed)
    sym = _fused_mlp(pkg)
    shapes, _, _ = sym.infer_shape(data=(2, 16))
    return {n: pkg.nd.array(rng.normal(0, 0.1, s).astype(np.float32))
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fused_fit(pkg, kvstore, contexts, X, y, epochs=2, batch=32,
               optimizer="sgd", opt_params=None):
    it = pkg.io.NDArrayIter(X, y, batch_size=batch, shuffle=False)
    mod = pkg.mod.Module(_fused_mlp(pkg), context=contexts)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: v.copy()
                                for k, v in _fused_init(pkg).items()})
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                       optimizer_params=opt_params or {
                           "learning_rate": 0.1, "momentum": 0.9})
    metric = pkg.metric.Accuracy()
    for _ in range(epochs):
        it.reset()
        metric.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
    return mod, metric.get()[1]


def _cpus(pkg, n=4):
    return [pkg.cpu(i) for i in range(n)]


def test_fused_four_contexts_matches_jax_and_single_device():
    """``test_fused_matches_single_device_local`` on both packages: the
    fused step over cpu(0..3) takes the one-process mesh, and its
    parameters match the JAX fused group's and the port's one-context
    local path."""
    from mxnet_tpu_torch.parallel.mesh import LocalMesh

    X, y = _fused_data()
    mod, acc = _fused_fit(mx, "tpu", _cpus(mx), X, y)
    assert mod._fused is not None
    assert isinstance(mod._kvstore.mesh, LocalMesh)
    assert mod._kvstore.mesh.devices.size == 4
    jmod, jacc = _fused_fit(jmx, "tpu", _cpus(jmx), X, y)
    assert jmod._fused is not None
    lmod, _lacc = _fused_fit(mx, "local", mx.cpu(0), X, y)
    p, jp, lp = (m.get_params()[0] for m in (mod, jmod, lmod))
    for k in jp:
        _close(p[k].asnumpy(), jp[k].asnumpy(), k)
        _close(p[k].asnumpy(), lp[k].asnumpy(), k, rtol=2e-5, atol=2e-6)
    assert abs(acc - jacc) < 1e-6


def test_fused_score_and_checkpoint(tmp_path):
    X, y = _fused_data(seed=3)
    mod, _ = _fused_fit(mx, "tpu", _cpus(mx), X, y)
    jmod, _ = _fused_fit(jmx, "tpu", _cpus(jmx), X, y)
    it = mx.io.NDArrayIter(X, y, batch_size=32)
    acc = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
    jacc = dict(jmod.score(jmx.io.NDArrayIter(X, y, batch_size=32),
                           jmx.metric.Accuracy()))["accuracy"]
    assert abs(acc - jacc) < 1e-6
    prefix = str(tmp_path / "fused")
    mod.save_checkpoint(prefix, 2, save_optimizer_states=True)
    _sym, args2, _aux2 = mx.model.load_checkpoint(prefix, 2)
    p, _ = mod.get_params()
    for k in p:
        np.testing.assert_array_equal(p[k].asnumpy(), args2[k].asnumpy())
    mod.load_optimizer_states(prefix + "-0002.states")
    # the states round-trip: the next step from them equals the JAX one's
    jmod.save_checkpoint(str(tmp_path / "jfused"), 2,
                         save_optimizer_states=True)
    it.reset()
    b = next(iter(it))
    mod.forward_backward(b)
    mod.update()
    jb = next(iter(jmx.io.NDArrayIter(X, y, batch_size=32)))
    jmod.load_optimizer_states(str(tmp_path / "jfused") + "-0002.states")
    jmod.forward_backward(jb)
    jmod.update()
    for k, v in jmod.get_params()[0].items():
        _close(mod.get_params()[0][k].asnumpy(), v.asnumpy(), k)


def test_fused_explicit_forward_backward_update_still_trains():
    """forward/backward/update go through the executors over the four
    contexts, and a following fused step starts from their weights, in
    both packages alike."""
    X, y = _fused_data(seed=7)
    got = {}
    for pkg in (mx, jmx):
        it = pkg.io.NDArrayIter(X, y, batch_size=32)
        mod = pkg.mod.Module(_fused_mlp(pkg), context=_cpus(pkg))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: v.copy()
                                    for k, v in _fused_init(pkg).items()})
        mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        assert mod._fused is not None
        batch = next(iter(it))
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        p1 = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
        mod.forward_backward(batch)
        mod.update()
        p2 = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
        got[pkg.__name__] = (p1, p2)
    (t1, t2), (j1, j2) = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    for k in j1:
        _close(t1[k], j1[k], k)
        _close(t2[k], j2[k], k)
        assert np.abs(t2[k] - t1[k]).max() > 1e-7


def test_fused_falls_back_for_exotic_optimizer():
    X, y = _fused_data(seed=5)
    accs = {}
    for pkg in (mx, jmx):
        mod, acc = _fused_fit(pkg, "tpu", _cpus(pkg), X, y, epochs=1,
                              optimizer="rmsprop",
                              opt_params={"learning_rate": 0.01})
        assert mod._fused is None
        accs[pkg.__name__] = mod.get_params()[0]
    for k, v in accs["mxnet_tpu"].items():
        _close(accs["mxnet_tpu_torch"][k].asnumpy(), v.asnumpy(), k)


@pytest.mark.parametrize("contexts,batch,match", [
    ([0, 0, 1, 2], 32, "duplicate devices"),
    ([0, 1, 2], 32, "not divisible by 3 devices")])
def test_fused_refusals_match_jax(contexts, batch, match):
    """Duplicate contexts (by device type and id) and a batch the count
    does not divide are refused, in the JAX package's words."""
    from mxnet_tpu_torch.module.spmd_group import FusedSPMDGroup
    from mxnet_tpu.module.spmd_group import FusedSPMDGroup as JGroup

    for pkg, group, err in ((mx, FusedSPMDGroup, MXNetError),
                            (jmx, JGroup, jmx.base.MXNetError)):
        sym = _fused_mlp(pkg)
        args = _fused_init(pkg)
        opt = pkg.optimizer.create("sgd", learning_rate=0.1)
        with pytest.raises(err, match=match):
            group(sym, [pkg.cpu(i) for i in contexts], opt, args, {},
                  ["data"], ["softmax_label"], batch_size=batch)


def test_fused_mp_over_a_list_raises_by_name(monkeypatch):
    monkeypatch.setenv("MXNET_MP_SIZE", "2")
    X, y = _fused_data()
    it = mx.io.NDArrayIter(X, y, batch_size=32)
    mod = mx.mod.Module(_fused_mlp(mx), context=_cpus(mx))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    with pytest.raises(MXNetError, match="MXNET_MP_SIZE=2 over a device "
                                         "list.*not ported"):
        mod.init_optimizer(kvstore="tpu")


def _jax_unit(stride, shortcut):
    import jax
    from jax.sharding import Mesh
    from mxnet_tpu.kernels import fused_block as jfb

    x = w.unit_inputs(stride, shortcut)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    names = [k for k in w.UNIT_ARGS if x[k] is not None]

    def loss(*vals):
        v = dict(zip(names, vals))
        out, stats = jfb.bottleneck_train_spmd(
            *[v.get(k) for k in w.UNIT_ARGS], stride, 1e-5, None, mesh,
            ("dp",))
        return jax.numpy.sum(out ** 2) * 1e-3, (out, stats)

    (_l, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(
            *[x[k] for k in names])
    return (np.asarray(out), [np.asarray(s) for s in stats],
            {k: np.asarray(g) for k, g in zip(names, grads)})


def test_fused_unit_statistics_cross_two_replicas_as_jax():
    """The fused unit's BatchNorm sums and weight gradients summed across
    two replicas of a one-process mesh (threads meeting in the local
    collectives) against the JAX ``shard_map`` wrapper on two devices; the
    summed values bit for bit equal on both replicas."""
    from mxnet_tpu_torch.kernels import fused_block as fb
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 2}, devices=[mx.cpu(0), mx.cpu(1)])
    stride, shortcut = 2, True
    r0, r1 = mesh.run(lambda i: w._unit_case(fb, mesh.replica(i), i, 2,
                                             stride, shortcut))
    out, stats, grads = _jax_unit(stride, shortcut)
    _close(np.concatenate([r0["out"].numpy(), r1["out"].numpy()]), out)
    for a, b, s in zip(r0["stats"], r1["stats"], stats):
        assert torch.equal(a, b)
        _close(a.numpy(), s)
    for k, g in grads.items():
        if k == "data":
            _close(np.concatenate([r0["grads"][k].numpy(),
                                   r1["grads"][k].numpy()]), g, k)
            continue
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
        _close(r0["grads"][k].numpy(), g, k)


def test_tiny_fused_resnet_on_two_replicas_matches_one_device():
    """A tiny fused ResNet through ``TrainStep`` over two replicas: its
    BatchNorm statistics cross them (the fused units' and the plain
    BatchNorm's), so three steps give one device's parameters and moving
    statistics on the whole batch, within fp32 summation order."""
    from mxnet_tpu_torch.models import resnet
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    res = {}
    for kind in ("one", "two"):
        mesh = make_mesh({"dp": 2}, devices=[mx.cpu(0), mx.cpu(1)]) \
            if kind == "two" else None
        ts = TrainStep(resnet.resnet(fused=True, **w.TINY), dict(w.OPT),
                       mesh=mesh, device="cpu" if mesh is None else None)
        carry = ts.place(*ts.init_params(w.SHAPES,
                                         initializer=mx.init.Xavier()))
        losses = []
        for i in range(w.STEPS):
            carry, loss = ts(carry, w.train_batch(seed=4 + i))
            losses.append(float(loss))
        res[kind] = (losses, {k: v.numpy() for k, v in carry[0].items()},
                     {k: v.numpy() for k, v in carry[2].items()})
        if kind == "two":
            r0, r1 = carry.replicas
            for k in r0[0]:
                assert torch.equal(r0[0][k], r1[0][k]), k
    _close(res["two"][0], res["one"][0], "losses")
    for d in (1, 2):
        for k, v in res["one"][d].items():
            _close(res["two"][d][k], v, k, atol=1e-4)


# ---------------------------------------------------------------------------
# TrainStep on make_mesh(devices=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["sgd-mom-wd", "adam"])
def test_trainstep_on_a_device_list_matches_jax(opt):
    """``TrainStep`` on ``make_mesh({"dp": 2}, devices=[cpu(0), cpu(1)])``
    against the JAX one on ``jax.devices("cpu")[:2]``: losses and params
    after 5 steps; ZeRO over the replicas bit for bit the replicated
    step, and its logical optimizer state the replicated one."""
    import jax
    from mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mxnet_tpu.parallel.spmd import TrainStep as JTrainStep
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    jts = JTrainStep(w.zero_symbol(jmx), dict(w.ZERO_OPTS[opt]),
                     mesh=jmake_mesh({"dp": 2}, jax.devices("cpu")[:2]),
                     zero=False, zero_min_size=16)
    jc = jts.place(*jts.init_params(w.ZERO_SHAPES, seed=3))
    jl = []
    for i in range(w.ZERO_STEPS):
        jc, loss = jts(jc, w.zero_batch(), jax.random.PRNGKey(i))
        jl.append(float(loss))
    runs = {}
    for zero in (False, True):
        mesh = make_mesh({"dp": 2}, devices=[mx.cpu(0), mx.cpu(1)])
        ts = TrainStep(w.zero_symbol(), dict(w.ZERO_OPTS[opt]), mesh=mesh,
                       zero=zero, zero_min_size=16)
        c = ts.place(*ts.init_params(w.ZERO_SHAPES, seed=3))
        losses = []
        for _ in range(w.ZERO_STEPS):
            c, loss = ts(c, w.zero_batch())
            losses.append(float(loss))
        runs[zero] = (losses, c, ts.logical_opt_state(c[1], c[0]))
    losses, carry, logical = runs[False]
    _close(losses, jl, "losses")
    for k, v in jc[0].items():
        _close(carry[0][k].numpy(), np.asarray(v), k)
    zl, zc, zlogical = runs[True]
    assert zl == losses
    for k in carry[0]:
        assert torch.equal(zc[0][k], carry[0][k]), k
    flat = lambda s: [t for v in s.values()  # noqa: E731
                      for t in (v if isinstance(v, tuple) else (v,))]
    for a, b in zip(flat(zlogical), flat(logical)):
        assert torch.equal(a, b)


def test_trainstep_on_a_device_list_refuses_foreign_tensors():
    """Over a one-process mesh a method takes a carry the step made or a
    piece of its newest carry (each replica gets its own); a dict of
    tensors it did not make raises by name rather than hand replica 0's
    tensors to every replica, and ``place`` takes such values for all."""
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"dp": 2}, devices=[mx.cpu(0), mx.cpu(1)])
    ts = TrainStep(w.zero_symbol(), dict(w.ZERO_OPTS["adam"]), mesh=mesh,
                   zero_min_size=16)
    params, opt_state, aux = ts.init_params(w.ZERO_SHAPES, seed=3)
    carry = ts.place(params, opt_state, aux)
    r0, r1 = carry.replicas
    assert all(r0[0][k] is not r1[0][k] for k in r0[0])
    ts.logical_opt_state(carry[1], carry[0])
    mine = {k: v.clone() for k, v in carry[0].items()}
    with pytest.raises(MXNetError, match="neither a carry this step made"):
        ts.value_and_grad(mine, carry[2], w.zero_batch())
    with pytest.raises(MXNetError, match="neither a carry this step made"):
        ts.whole_params(mine)
    again = ts.place(mine, ts.logical_opt_state(carry[1], carry[0]),
                     carry[2])
    for k in mine:
        assert torch.equal(again.replicas[1][0][k], mine[k]), k
    assert ts.mesh is mesh and sorted(ts.param_names) == sorted(mine)


# ---------------------------------------------------------------------------
# DeviceQueueIter over the list
# ---------------------------------------------------------------------------
def test_device_queue_iter_over_a_context_list(tmp_path):
    """``tests/test_input_pipeline.py``'s fit through
    ``DeviceQueueIter(module=)`` over the four-context fused group (each
    replica takes its rows of every placed batch) against the JAX one,
    and the multi-context local path over view batches."""
    from mxnet_tpu.parallel.feed import DeviceQueueIter as JDQ
    from mxnet_tpu_torch.parallel.feed import DeviceQueueIter

    X, y = _fused_data(n=128, seed=2)
    res = {}
    for pkg, dq_cls in ((mx, DeviceQueueIter), (jmx, JDQ)):
        mod = pkg.mod.Module(_fused_mlp(pkg), context=_cpus(pkg))
        with dq_cls(pkg.io.NDArrayIter(X, y, batch_size=32),
                    module=mod) as dq:
            mod.fit(dq, num_epoch=2, kvstore="tpu", optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1,
                                      "momentum": 0.9},
                    arg_params={k: v.copy()
                                for k, v in _fused_init(pkg).items()})
        assert mod._fused is not None
        res[pkg.__name__] = {k: v.asnumpy()
                             for k, v in mod.get_params()[0].items()}
        if pkg is mx:
            placed = dq._place_batch(next(iter(pkg.io.NDArrayIter(
                X, y, batch_size=32))))
            parts = placed.data[0].tensor._mx_replicas
            assert [tuple(p.shape) for p in parts] == [(8, 16)] * 4
            np.testing.assert_array_equal(parts[3].numpy(), X[24:32])
    for k, v in res["mxnet_tpu"].items():
        _close(res["mxnet_tpu_torch"][k], v, k)
    # the per-executor path slices view batches per context
    it = mx.io.NDArrayIter(X, y, batch_size=64)
    mod = mx.mod.Module(_fused_mlp(mx), context=[mx.cpu(0), mx.cpu(1)])
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.initializer.Xavier())
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    metric = mx.metric.Accuracy()
    for _ in range(2):
        it.reset()
        for b in it:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
    assert metric.num_inst == 2 * 128


# ---------------------------------------------------------------------------
# Gluon
# ---------------------------------------------------------------------------
def test_gluon_parameter_on_a_context_list():
    """A parameter initialised on a list keeps one copy, on the first
    context, as the JAX package keeps it: ``list_ctx`` is the list,
    ``list_data``/``list_grad`` the one copy; deferred init keeps the
    list. An input on the first context trains as on one."""
    got = {}
    for pkg in (mx, jmx):
        pkg.random.seed(0)
        net = pkg.gluon.nn.Dense(3, in_units=4)
        net.initialize(ctx=[pkg.cpu(0), pkg.cpu(1)])
        deferred = pkg.gluon.nn.Dense(3)
        deferred.initialize(ctx=[pkg.cpu(0), pkg.cpu(1)])
        assert deferred.weight.list_ctx() == [pkg.cpu(0), pkg.cpu(1)]
        deferred(pkg.nd.ones((2, 5)))
        assert deferred.weight.list_ctx() == [pkg.cpu(0), pkg.cpu(1)]
        wt = net.weight
        rng = np.random.RandomState(0)
        wt.set_data(pkg.nd.array(rng.randn(3, 4).astype(np.float32)))
        net.bias.set_data(pkg.nd.array(rng.randn(3).astype(np.float32)))
        assert wt.list_ctx() == [pkg.cpu(0), pkg.cpu(1)]
        assert len(wt.list_data()) == len(wt.list_grad()) == 1
        assert wt.data().context == pkg.cpu(0)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        x = pkg.nd.array(np.linspace(-1, 1, 8).reshape(2, 4)
                         .astype(np.float32), ctx=pkg.cpu(0))
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(2)
        got[pkg.__name__] = (wt.data().asnumpy(), net.bias.data().asnumpy())
    for a, b in zip(got["mxnet_tpu_torch"], got["mxnet_tpu"]):
        _close(a, b, "after one step")


def test_gluon_list_input_on_another_card_raises_by_name(monkeypatch):
    """On cards, an input on the second context cannot meet the one copy
    on the first: torch's device mismatch becomes a clear MXNetError (the
    JAX package raises XLA's ValueError there). Emulated on the CPU by a
    forward that raises torch's message."""
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])

    def mismatch(*_a):
        raise RuntimeError("Expected all tensors to be on the same device, "
                           "but found at least two devices")

    monkeypatch.setattr(net, "forward", mismatch)
    with pytest.raises(MXNetError, match="keeps one copy, on cpu\\(0\\)"):
        net(mx.nd.ones((2, 4)))


# ---------------------------------------------------------------------------
# ctx_group placement of a fused ResNet's head (the card's case:
# tests/test_torch_multi_context_cuda.py, chip_smoke.py multi_context (c))
# ---------------------------------------------------------------------------
def placed_resnet(pkg, build, num_classes):
    """The body of ``build()``'s net (through ``pool1``) built under
    ``ctx_group="body"`` and a head of its own (Flatten, ``fc1``,
    ``softmax``) under ``"head"``."""
    with pkg.AttrScope(ctx_group="body"):
        feat = build().get_internals()["pool1_output"]
    with pkg.AttrScope(ctx_group="head"):
        fc1 = pkg.sym.FullyConnected(pkg.sym.Flatten(feat),
                                     num_hidden=num_classes, name="fc1")
        return pkg.sym.SoftmaxOutput(fc1, name="softmax")


def test_placed_resnet_head_runs_on_its_group_on_the_cpu():
    """The body/head split the card case binds, on two CPU contexts: each
    head node recorded on the head's context, outputs and gradients those
    of the unplaced bind."""
    from mxnet_tpu_torch.models import resnet

    sym = placed_resnet(mx, lambda: resnet.resnet(fused=True, **w.TINY),
                        w.TINY["num_classes"])
    args, auxs = resnet.init_params(sym, w.SHAPES["data"], seed=0)
    batch = w.train_batch()
    outs = []
    for g2c in (None, {"body": mx.cpu(0), "head": mx.cpu(1)}):
        ex = sym.simple_bind(mx.cpu(0), group2ctx=g2c, **w.SHAPES)
        for d, src in ((ex.arg_dict, args), (ex.aux_dict, auxs)):
            for k, v in src.items():
                d[k][:] = v
        ex.forward_backward(**batch)
        outs.append((ex.outputs[0].asnumpy(),
                     {k: v.asnumpy() for k, v in ex.grad_dict.items()
                      if k not in batch}, ex))
    (ref, rg, _), (got, gg, ex) = outs
    np.testing.assert_array_equal(got, ref)
    for k, g in rg.items():
        np.testing.assert_array_equal(gg[k], g)
    for name in ("fc1", "fc1_weight", "softmax", "softmax_label"):
        assert ex.node_devices[name] == mx.cpu(1), name
    assert ex.node_devices["pool1"] == mx.cpu(0)


# ---------------------------------------------------------------------------
# the port's files
# ---------------------------------------------------------------------------
def test_no_port_file_cites_item_14():
    cited = []
    for path in glob.glob(os.path.join(ROOT, "mxnet_tpu_torch", "**", "*"),
                          recursive=True):
        if os.path.isfile(path) and path.endswith((".py", ".cu", ".cuh",
                                                   ".cc", ".h")):
            with open(path, encoding="utf-8", errors="replace") as f:
                if "item 14" in f.read():
                    cited.append(os.path.relpath(path, ROOT))
    assert not cited, cited
