"""``Module.fit`` of the PyTorch port against the JAX package's, on the CPU.

The tiny ResNet of ``tests/test_torch_fused_train.py`` (fused and
unfused), 12 seeded images from that file's batch seed in batches of 4, 2
epochs, Xavier weights after ``mx.random.seed(0)``, under sgd with
momentum (lr 0.1, momentum 0.9, wd 1e-4) and adam (lr 0.01, wd 1e-4):

- teacher-forced, every batch: the port's Module is given the JAX
  Module's state before the batch (parameters, moving statistics,
  optimizer states through the ``.states`` bytes, update counts) and takes
  the batch. Its outputs match JAX's (rtol 1e-4, atol 1e-5 of the largest
  |value|). Its gradients match within 5e-2 of each tensor's largest
  |gradient|, floored at 1% of the largest of any tensor: from one state a
  pre-activation within an ulp of 0 can take its ReLU mask one way in one
  package and the other way in the other, which moves a 1x1 weight's
  gradient by one term of a 1024-term sum (measured: 3.4e-2 of the
  tensor's largest at batch 5, unfused adam; 2.7e-3 at batch 2, fused sgd;
  ~1e-5 at the other batches), and bn0's gamma has an exactly-zero
  gradient here, which each package gives as noise of its own summation
  order. The tight check of the gradients from one state is
  ``tests/test_torch_executor.py``'s. Given JAX's gradients, ``update`` then gives JAX's
  parameters (rtol 1e-4, atol 1e-5 of each tensor's largest |value|);
- free-running: each package's own ``fit``. The first epoch's outputs
  match at that tolerance. Under sgd lr 0.1 with momentum the two
  trajectories then drift apart by rounding noise: bn0's gamma has an
  exactly-zero gradient at this init (BN -> ReLU -> BN is invariant to
  scaling gamma and beta together), so each package's gradient there is
  noise of its own summation order, and after three updates that noise
  flips ReLU masks (measured: outputs 1e-6 -> 4e-5 -> 5e-3 of the largest
  over batches 2, 3 and 5; whole update 5.4% apart in relative L2 at a
  cosine of 0.9985, fused). So epoch 2 under sgd is held at 1e-2 of the
  largest output and the whole update within 10% in relative L2 at a
  cosine >= 0.995; adam stays within the standard tolerance in outputs
  and within 1e-3 in the whole update's relative L2;
- a checkpoint (symbol, params, ``.states``) written by either package
  loads in the other and continues training to the same next-batch
  outputs; ``.states`` bytes of either package load in the other, and a
  hostile pickle is refused;
- seeded ``init_params`` bit-identical; every unported Module option
  raises by name; the default context is the card.
"""
import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import resnet as tresnet

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(units=[2, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 64, 64), bottle_neck=True)
BATCH_SEED = 4      # tests/test_torch_fused_train.py's batch
N, BATCH, EPOCHS = 12, 4, 2
OPTS = {"sgd": dict(learning_rate=0.1, momentum=0.9, wd=1e-4),
        "adam": dict(learning_rate=0.01, wd=1e-4)}
CASES = [(f, o) for f in (True, False) for o in ("sgd", "adam")]
IDS = ["%s-%s" % ("fused" if f else "unfused", o) for f, o in CASES]


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@contextlib.contextmanager
def _alias():
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        yield


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=atol * max(float(np.abs(want).max()), 1.0), err_msg=what)


def _data():
    rng = np.random.RandomState(BATCH_SEED)
    return (rng.randn(N, 3, 64, 64).astype(np.float32),
            rng.randint(0, 5, (N,)).astype(np.float32))


def _module(pkg, resnet, fused):
    return pkg.mod.Module(resnet.resnet(fused=fused, **TINY),
                          context=pkg.cpu())


def _np(d):
    return {k: v.asnumpy() for k, v in d.items()}


def _fit(pkg, resnet, fused, opt, record_state=False):
    """One ``fit``: per batch the outputs (and, with ``record_state``, the
    state before the batch and the batch); then the final params."""
    x, y = _data()
    mod = _module(pkg, resnet, fused)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    pkg.random.seed(0)
    rec = []
    if record_state:
        step = mod.forward_backward

        def forward_backward(batch):
            g = mod._exec_group
            opt_ = mod._optimizer
            rec.append({
                "args": {n: b[0].asnumpy().copy() for n, b in
                         zip(mod._param_names, g.param_arrays)},
                "aux": {n: b[0].asnumpy().copy() for n, b in
                        zip(mod._aux_names, g.aux_arrays)},
                "states": mod._updater.get_states(),
                "counts": dict(opt_._index_update_count),
                "num_update": opt_.num_update,
                "batch": (batch.data[0].asnumpy(), batch.label[0].asnumpy())})
            step(batch)
            rec[-1]["grads"] = {n: b[0].asnumpy().copy() for n, b in
                                zip(mod._param_names,
                                    mod._exec_group.grad_arrays)}

        mod.forward_backward = forward_backward
    outs = []
    mod.fit(it, num_epoch=EPOCHS, optimizer=opt, optimizer_params=OPTS[opt],
            initializer=pkg.initializer.Xavier(),
            batch_end_callback=lambda p: outs.append(
                mod.get_outputs()[0].asnumpy()))
    args, aux = mod.get_params()
    return {"outs": outs, "args": _np(args), "aux": _np(aux), "rec": rec}


@pytest.fixture(scope="module")
def jax_fits():
    with _alias():
        return {case: _fit(jmx, jresnet, *case, record_state=True)
                for case in CASES}


@pytest.mark.parametrize("fused,opt", CASES, ids=IDS)
def test_fit_teacher_forced_matches_jax_every_batch(jax_fits, fused, opt):
    ref = jax_fits[(fused, opt)]
    x, y = _data()
    mod = _module(mx, tresnet, fused)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer=opt, optimizer_params=OPTS[opt])
    after = [r["args"] for r in ref["rec"][1:]] + [ref["args"]]
    assert len(ref["rec"]) == EPOCHS * N // BATCH
    for i, (state, want_args) in enumerate(zip(ref["rec"], after)):
        mod.set_params({k: mx.nd.array(v) for k, v in state["args"].items()},
                       {k: mx.nd.array(v) for k, v in state["aux"].items()})
        mod._updater.set_states(state["states"])
        mod._optimizer._index_update_count = dict(state["counts"])
        mod._optimizer.num_update = state["num_update"]
        data, label = state["batch"]
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(data)],
                                             [mx.nd.array(label)]))
        _close(mod.get_outputs()[0].asnumpy(), ref["outs"][i],
               "outputs %d" % i)
        grads = dict(zip(mod._param_names, mod._exec_group.grad_arrays))
        floor = 1e-2 * max(float(np.abs(g).max())
                           for g in state["grads"].values())
        for k, g in state["grads"].items():
            scale = max(float(np.abs(g).max()), floor)
            np.testing.assert_allclose(grads[k][0].asnumpy(), g, rtol=RTOL,
                                       atol=5e-2 * scale,
                                       err_msg="%s at batch %d" % (k, i))
            grads[k][0][:] = g
        mod.update()
        got, _aux = mod.get_params()
        for k, v in want_args.items():
            _close(got[k].asnumpy(), v, "%s after batch %d" % (k, i))


@pytest.mark.parametrize("fused,opt", CASES, ids=IDS)
def test_fit_free_running_matches_jax(jax_fits, fused, opt):
    ref = jax_fits[(fused, opt)]
    got = _fit(mx, tresnet, fused, opt)
    assert len(got["outs"]) == len(ref["outs"]) == EPOCHS * N // BATCH
    per_epoch = N // BATCH
    for i, (a, b) in enumerate(zip(got["outs"], ref["outs"])):
        if i < per_epoch or opt == "adam":
            _close(a, b, "outputs %d" % i)
        else:
            _close(a, b, "outputs %d" % i, rtol=0, atol=1e-2)
    mx.random.seed(0)
    init = _module(mx, tresnet, fused)
    init.bind([("data", (BATCH, 3, 64, 64))],
              [("softmax_label", (BATCH,))])
    mx.random.seed(0)
    init.init_params(mx.initializer.Xavier())
    p0 = _np(init.get_params()[0])
    keys = sorted(ref["args"])
    ut = np.concatenate([(got["args"][k] - p0[k]).ravel() for k in keys])
    uj = np.concatenate([(ref["args"][k] - p0[k]).ravel() for k in keys])
    rel = np.linalg.norm(ut - uj) / np.linalg.norm(uj)
    cos = ut @ uj / (np.linalg.norm(ut) * np.linalg.norm(uj))
    if opt == "adam":
        assert rel <= 1e-3, rel
    else:
        assert rel <= 0.1 and cos >= 0.995, (rel, cos)
    for k, v in ref["aux"].items():
        assert np.isfinite(got["aux"][k]).all() and \
            got["aux"][k].shape == v.shape


def test_seeded_init_params_are_bit_identical():
    out = []
    for pkg, resnet in ((mx, tresnet), (jmx, jresnet)):
        mod = _module(pkg, resnet, True) if pkg is mx else None
        with _alias():
            if mod is None:
                mod = _module(pkg, resnet, True)
            mod.bind([("data", (BATCH, 3, 64, 64))],
                     [("softmax_label", (BATCH,))])
            pkg.random.seed(0)
            mod.init_params(pkg.initializer.Xavier())
        out.append([_np(d) for d in mod.get_params()])
    for t, j in zip(*out):
        assert sorted(t) == sorted(j)
        for k in j:
            assert np.array_equal(t[k], j[k]), k


# ---------------------------------------------------------------------------
# checkpoints and optimizer states across the packages
# ---------------------------------------------------------------------------
def _trained(pkg, resnet, prefix):
    """An unfused module fitted one epoch (sgd with momentum), then
    checkpointed at epoch 1 with its optimizer states."""
    x, y = _data()
    mod = _module(pkg, resnet, False)
    pkg.random.seed(0)
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params=OPTS["sgd"],
            initializer=pkg.initializer.Xavier())
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    return mod


def _continue(pkg, mod):
    """Two more batches; the second batch's outputs (its forward after the
    first's update)."""
    x, y = _data()
    for i in range(2):
        b = pkg.io.DataBatch([pkg.nd.array(x[i * BATCH:(i + 1) * BATCH])],
                             [pkg.nd.array(y[i * BATCH:(i + 1) * BATCH])])
        mod.forward_backward(b)
        mod.update()
    return mod.get_outputs()[0].asnumpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_of_either_package_continues_in_the_other(tmp_path,
                                                             writer):
    prefix = str(tmp_path / "ckpt")
    (w_pkg, w_res), (r_pkg, r_res) = ((jmx, jresnet), (mx, tresnet))[
        ::1 if writer == "jax" else -1]
    written = _trained(w_pkg, w_res, prefix)
    want = _continue(w_pkg, written)
    loaded = r_pkg.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                   context=r_pkg.cpu())
    loaded.bind([("data", (BATCH, 3, 64, 64))],
                [("softmax_label", (BATCH,))])
    loaded.init_optimizer(optimizer="sgd", optimizer_params=OPTS["sgd"])
    _close(_continue(r_pkg, loaded), want, "next-batch outputs")
    _, _, aux = r_pkg.model.load_checkpoint(prefix, 1)
    assert sorted(aux) == sorted(written.get_params()[1])


def test_checkpoint_files_round_trip_bit_exact(tmp_path):
    prefix = str(tmp_path / "m")
    mod = _trained(mx, tresnet, prefix)
    args, auxs = mod.get_params()
    sym, a2, x2 = mx.model.load_checkpoint(prefix, 1)
    assert sym.tojson() == mod.symbol.tojson()
    for mine, theirs in ((args, a2), (auxs, x2)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert torch.equal(mine[k].tensor, theirs[k].tensor), k
    with np.load(prefix + "-0001.params", allow_pickle=False) as npz:
        assert all(k.startswith(("arg:", "aux:")) for k in npz.keys())
    # inference from the loaded module gives the trained module's outputs
    x, _ = _data()
    batch = mx.io.DataBatch([mx.nd.array(x[:BATCH])])
    mod.forward(batch, is_train=False)
    want = mod.get_outputs()[0].asnumpy()
    inf = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    inf.bind([("data", (BATCH, 3, 64, 64))], for_training=False)
    inf.forward(batch)
    assert np.array_equal(inf.get_outputs()[0].asnumpy(), want)
    mod.save_params(str(tmp_path / "p.params"))
    inf.load_params(str(tmp_path / "p.params"))
    np.testing.assert_array_equal(
        inf.predict(mx.io.NDArrayIter(x[:BATCH], batch_size=BATCH))
        .asnumpy(), want)


def test_optimizer_states_load_in_both_packages():
    rng = np.random.RandomState(1)
    states = {}
    for pkg in (mx, jmx):
        upd = pkg.optimizer.get_updater(pkg.optimizer.create(
            "adam", learning_rate=0.01))
        w = pkg.nd.array(np.ones((3, 2), np.float32), ctx=pkg.cpu())
        for i in range(2):
            upd(i, pkg.nd.array(rng.randn(3, 2).astype(np.float32),
                                ctx=pkg.cpu()), w)
        states[pkg] = upd
    t_bytes, j_bytes = states[mx].get_states(), states[jmx].get_states()
    into_port = mx.optimizer.get_updater(mx.optimizer.create("adam"))
    into_port.set_states(j_bytes)
    into_jax = jmx.optimizer.get_updater(jmx.optimizer.create("adam"))
    into_jax.set_states(t_bytes)
    for a, b in ((into_port.get_states_map(),
                  states[jmx].get_states_map()),
                 (into_jax.get_states_map(), states[mx].get_states_map())):
        assert sorted(a) == sorted(b) == [0, 1]
        for k in a:
            for u, v in zip(a[k], b[k]):
                assert np.array_equal(u, v)


class _Boom:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


@pytest.mark.parametrize("payload", [
    {0: _Boom()}, {0: np.ones(2)}, ({0: np.ones(2)}, {"opt": 1}), [1, 2]],
    ids=["os.system", "plain", "pair", "not-a-dict"])
def test_states_unpickler_admits_numpy_only(payload):
    upd = mx.optimizer.get_updater(mx.optimizer.create("sgd"))
    data = pickle.dumps(payload)
    if isinstance(payload, dict) and isinstance(payload[0], _Boom):
        with pytest.raises(MXNetError, match="refusing to load"):
            upd.set_states(data)
    elif isinstance(payload, list):
        with pytest.raises(MXNetError, match="expected a dict"):
            upd.set_states(data)
    else:
        upd.set_states(data)
        assert np.array_equal(upd.get_states_map()[0], np.ones(2))


# ---------------------------------------------------------------------------
# what is not ported, devices
# ---------------------------------------------------------------------------
def _small():
    return tresnet.resnet(fused=False, **TINY)


def _iter():
    x, y = _data()
    return mx.io.NDArrayIter(x, y, batch_size=BATCH)


@pytest.mark.parametrize("kw,name", [
    (dict(context=[mx.cpu(), mx.cpu(1)]), "more than one context"),
    (dict(group2ctxs={"a": mx.cpu()}), "group2ctxs"),
    (dict(compression_params={"type": "2bit"}), "compression_params")])
def test_unported_module_arguments_raise_by_name(kw, name):
    kw.setdefault("context", mx.cpu())
    with pytest.raises(MXNetError, match="%s.*not ported" % name):
        mx.mod.Module(_small(), **kw)


@pytest.mark.parametrize("env,name", [
    (("MXNET_CHECKPOINT_DIR", "/nonexistent"), "HealthGuard"),
    (("MXNET_TUNE_BACKGROUND", "1"), "BackgroundTuner")])
def test_unported_knobs_raise_by_name(monkeypatch, env, name):
    monkeypatch.setenv(*env)
    with pytest.raises(MXNetError, match="%s.*not ported" % name):
        mod = mx.mod.Module(_small(), context=mx.cpu())
        mod.fit(_iter(), num_epoch=1)


@pytest.mark.parametrize("kvstore", ["dist_sync", "dist_async"])
def test_other_kvstores_raise_by_name(kvstore):
    mod = mx.mod.Module(_small(), context=mx.cpu())
    with pytest.raises(MXNetError, match="kvstore='%s' is not ported"
                       % kvstore):
        mod.fit(_iter(), num_epoch=1, kvstore=kvstore)


def test_monitor_and_sparse_raise_by_name():
    mod = mx.mod.Module(_small(), context=mx.cpu())
    with pytest.raises(MXNetError, match="monitor.*not ported"):
        mod.fit(_iter(), num_epoch=1, monitor=object())
    with pytest.raises(MXNetError, match="sparse.*not ported"):
        mod.fit(_iter(), num_epoch=1, sparse_row_id_fn=lambda b: {})
    mod.bind(*(lambda it: (it.provide_data, it.provide_label))(_iter()))
    with pytest.raises(MXNetError, match="monitors are not ported"):
        mod.install_monitor(object())
    with pytest.raises(MXNetError, match="sparse"):
        mx.nd.zeros((2, 2)).attach_grad(stype="row_sparse")


def test_module_defaults_to_the_card():
    if torch.cuda.is_available():
        with mx.gpu(0):
            assert mx.mod.Module(_small())._context == [mx.gpu(0)]
        return
    with mx.gpu(0):       # the default outside any ``with`` block
        with pytest.raises(MXNetError, match="no CUDA device"):
            mx.mod.Module(_small())


def test_score_and_predict_match_jax():
    x, y = _data()
    args, auxs = tresnet.init_params(_small(), (BATCH, 3, 64, 64), seed=1)
    res = []
    for pkg, resnet in ((mx, tresnet), (jmx, jresnet)):
        mod = _module(pkg, resnet, False)
        it = pkg.io.NDArrayIter(x[:10], y[:10], batch_size=BATCH)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.set_params({k: pkg.nd.array(v) for k, v in args.items()},
                       {k: pkg.nd.array(v) for k, v in auxs.items()})
        res.append((mod.score(it, ["acc", "ce"]),
                    mod.predict(it).asnumpy()))
    (ts, tp), (js, jp) = res
    assert tp.shape == (10, 5)
    _close(tp, jp)
    assert [n for n, _ in ts] == [n for n, _ in js]
    _close([v for _, v in ts], [v for _, v in js])
