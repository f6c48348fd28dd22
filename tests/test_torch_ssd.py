"""The SSD300 detector of the port (``mxnet_tpu_torch/models/ssd.py``) and
its mAP metrics against the JAX package's, on the CPU.

- The Symbol JSON of the full (VGG16-reduced, 300x300) and tiny builders,
  training and detection, equals the JAX builders'; the full training
  symbol infers (2, 21, 8732) / (2, 34928) / (2, 8732), the detection one
  (1, 8732, 6), in both packages; ``models.get_symbol("ssd")`` builds it.
- The tiny SSD (``get_tiny_symbol_train``, 64x64 images, 2 classes): the
  first training forward's three outputs and every gradient, from shared
  weights (the seeded Xavier draws, bit for bit the same in both), at
  rtol 1e-4 / atol 1e-5 (the class targets exactly); one ``Module.fit``
  batch of each package (outputs, gradients, the weights after the sgd
  update); the detection graph served by the port's ``AOTPredictor``
  against the JAX executor's forward.
- ``MApMetric`` and ``VOC07MApMetric`` on ``tests/test_map_metric.py``'s
  hand-made cases, in both packages, equal to the hand values.
"""
import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu.models  # noqa: F401
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.models  # noqa: F401
from mxnet_tpu.contrib import eval_metric as jmetric
from mxnet_tpu_torch.contrib import eval_metric as tmetric

RTOL, ATOL = 1e-4, 1e-5
TINY_SHAPE = (3, 64, 64)
TINY_CLASSES = 2
TINY_BATCH = 2
OPT = dict(learning_rate=0.02, momentum=0.9, wd=5e-4)


def _build(pkg, fn, **kw):
    with pkg.name.NameManager():
        return getattr(pkg.models.ssd, fn)(**kw)


@pytest.mark.parametrize("fn,kw", [
    ("get_symbol_train", dict(num_classes=20)),
    ("get_symbol", dict(num_classes=20)),
    ("get_symbol", dict(num_classes=3, nms_thresh=0.45, force_suppress=True,
                        nms_topk=200)),
    ("get_tiny_symbol_train", {}),
    ("get_tiny_symbol", dict(num_classes=2, nms_thresh=0.4)),
])
def test_symbol_json_matches_jax(fn, kw):
    got, want = _build(mx, fn, **kw), _build(jmx, fn, **kw)
    assert got.tojson() == want.tojson()
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()


def test_full_size_shapes_and_anchors():
    for pkg in (mx, jmx):
        train = _build(pkg, "get_symbol_train", num_classes=20)
        args, outs, _ = train.infer_shape(data=(2, 3, 300, 300),
                                          label=(2, 4, 5))
        assert [tuple(o) for o in outs] == [(2, 21, 8732), (2, 34928),
                                            (2, 8732)]
        det = _build(pkg, "get_symbol", num_classes=3)
        _, outs, _ = det.infer_shape(data=(1, 3, 300, 300))
        assert [tuple(o) for o in outs] == [(1, 8732, 6)]
    with mx.name.NameManager():
        via = mx.models.get_symbol("ssd", num_classes=20)
    assert via.tojson() == _build(mx, "get_symbol", num_classes=20).tojson()


def _tiny_inputs(n=TINY_BATCH, seed=3):
    return cs.ssd_batch(np, n, seed=seed, classes=TINY_CLASSES,
                        shape=TINY_SHAPE, boxes=3)


def _tiny_params(pkg, sym, shapes):
    ex = sym.simple_bind(pkg.cpu(), grad_req="null", **shapes)
    pkg.random.seed(0)
    init = pkg.init.Xavier()
    out = {}
    for name, arr in ex.arg_dict.items():
        if name not in shapes:
            init(pkg.init.InitDesc(name), arr)
            out[name] = arr.asnumpy()
    return out


def _forward_backward(pkg):
    sym = _build(pkg, "get_tiny_symbol_train")
    x, y = _tiny_inputs()
    shapes = dict(data=x.shape, label=y.shape)
    params = _tiny_params(pkg, sym, shapes)
    ex = sym.simple_bind(pkg.cpu(), **shapes)
    for name, arr in ex.arg_dict.items():
        arr[:] = {"data": x, "label": y}.get(name, params.get(name))
    ex.forward(is_train=True)
    outs = [o.asnumpy() for o in ex.outputs]
    ex.backward()
    grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if k not in shapes and g is not None}
    return params, outs, grads


def test_tiny_forward_and_gradients_match_jax():
    with mx.cpu():
        tparams, touts, tgrads = _forward_backward(mx)
    jparams, jouts, jgrads = _forward_backward(jmx)
    for k in jparams:
        np.testing.assert_array_equal(tparams[k], jparams[k], err_msg=k)
    assert [o.shape for o in touts] == [o.shape for o in jouts]
    np.testing.assert_array_equal(touts[2], jouts[2])
    assert (touts[2] > 0).any()
    for k, (t, j) in enumerate(zip(touts[:2], jouts[:2])):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                   err_msg="output %d" % k)
    assert sorted(tgrads) == sorted(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k], g, rtol=RTOL, atol=ATOL,
                                   err_msg="gradient " + k)


def _ce_metric(pkg):
    """example/ssd's MultiBoxMetric's cross-entropy half, on the host."""
    class CrossEntropy(pkg.metric.EvalMetric):
        def __init__(self):
            super().__init__("ssd_ce")

        def update(self, labels, preds):
            p = [v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
                 for v in preds]
            lbl = p[2].astype(int)
            picked = np.take_along_axis(p[0], lbl[:, None, :], 1)
            self.sum_metric += float(-np.log(picked + 1e-12).mean())
            self.num_inst += 1

    return CrossEntropy()


def _fit_one_batch(pkg):
    """One ``Module.fit`` batch of the tiny SSD from the seeded Xavier
    weights: (outputs, gradients, weights after the update, metric)."""
    sym = _build(pkg, "get_tiny_symbol_train")
    x, y = _tiny_inputs(4, seed=5)
    it = pkg.io.NDArrayIter({"data": x}, {"label": y}, batch_size=4)
    mod = pkg.mod.Module(sym, data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    step, rec = mod.forward_backward, {}

    def forward_backward(data_batch):
        step(data_batch)
        rec["outs"] = [o.asnumpy().copy() for o in mod.get_outputs()]
        rec["grads"] = {n: g[0].asnumpy().copy() for n, g in
                        zip(mod._param_names, mod._exec_group.grad_arrays)}

    mod.forward_backward = forward_backward
    metric = _ce_metric(pkg)
    pkg.random.seed(0)
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            initializer=pkg.init.Xavier(), eval_metric=metric)
    args, _aux = mod.get_params()
    return (rec["outs"], rec["grads"],
            {k: v.asnumpy() for k, v in args.items()}, metric.get()[1])


def test_one_module_fit_batch_matches_jax():
    with mx.cpu():
        outs, grads, params, ce = _fit_one_batch(mx)
    jouts, jgrads, jparams, jce = _fit_one_batch(jmx)
    np.testing.assert_array_equal(outs[2], jouts[2])
    for k, (t, j) in enumerate(zip(outs[:2], jouts[:2])):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                   err_msg="output %d" % k)
    assert sorted(grads) == sorted(jgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], g, rtol=RTOL, atol=ATOL,
                                   err_msg="gradient " + k)
    for k, p in jparams.items():
        np.testing.assert_allclose(params[k], p, rtol=RTOL, atol=ATOL,
                                   err_msg="parameter " + k)
    np.testing.assert_allclose(ce, jce, rtol=1e-5)


def test_tiny_detection_served_by_aot_predictor_matches_jax():
    """The tiny detector's NMS output through the port's AOTPredictor
    (ladder (1, 4), a request of 3 padded to 4) against the JAX executor's
    inference forward, from the same weights."""
    from mxnet_tpu_torch.serving import AOTPredictor

    x, _y = _tiny_inputs(3, seed=9)
    sym = _build(mx, "get_tiny_symbol", num_classes=2)
    params = _tiny_params(mx, sym, dict(data=(1,) + TINY_SHAPE))
    got = AOTPredictor(sym, params, data_shapes={"data": (1,) + TINY_SHAPE},
                       ladder=(1, 4), device="cpu").predict({"data": x})[0]
    jsym = _build(jmx, "get_tiny_symbol", num_classes=2)
    ex = jsym.simple_bind(jmx.cpu(), grad_req="null", data=x.shape)
    for name, arr in ex.arg_dict.items():
        arr[:] = x if name == "data" else params[name]
    ex.forward(is_train=False)
    want = ex.outputs[0].asnumpy()
    assert got.shape == want.shape == (3, 8 * 8 * 4, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# mAP metrics: tests/test_map_metric.py's hand-made cases in both packages
# ---------------------------------------------------------------------------
BOX_A = [0.1, 0.1, 0.4, 0.4]
BOX_B = [0.6, 0.6, 0.9, 0.9]
FAR = [0.05, 0.7, 0.15, 0.8]


def _pad(rows, n, width):
    out = np.full((n, width), -1.0, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


MAP_CASES = [
    # (id, metric, kwargs, gts, dets, label width, want)
    ("perfect", "MApMetric", {}, [[0] + BOX_A, [0] + BOX_B],
     [[0, 0.9] + BOX_A, [0, 0.8] + BOX_B], 5, 1.0),
    ("perfect-voc07", "VOC07MApMetric", {}, [[0] + BOX_A, [0] + BOX_B],
     [[0, 0.9] + BOX_A, [0, 0.8] + BOX_B], 5, 1.0),
    ("interleaved-fp", "MApMetric", {}, [[0] + BOX_A, [0] + BOX_B],
     [[0, 0.9] + BOX_A, [0, 0.8] + FAR, [0, 0.7] + BOX_B], 5,
     0.5 + 0.5 * 2 / 3),
    ("interleaved-fp-voc07", "VOC07MApMetric", {},
     [[0] + BOX_A, [0] + BOX_B],
     [[0, 0.9] + BOX_A, [0, 0.8] + FAR, [0, 0.7] + BOX_B], 5,
     (6 * 1.0 + 5 * (2 / 3)) / 11),
    ("duplicate", "MApMetric", {}, [[0] + BOX_A],
     [[0, 0.9] + BOX_A, [0, 0.8] + BOX_A], 5, 1.0),
    ("duplicate-reversed", "MApMetric", {}, [[0] + BOX_A],
     [[0, 0.9] + BOX_A, [0, 0.95] + BOX_A], 5, 1.0),
    ("difficult", "MApMetric", {}, [[0] + BOX_A + [1], [0] + BOX_B + [0]],
     [[0, 0.9] + BOX_A, [0, 0.8] + BOX_B], 6, 1.0),
    ("difficult-used", "MApMetric", {"use_difficult": True},
     [[0] + BOX_A + [1], [0] + BOX_B + [0]],
     [[0, 0.9] + BOX_A, [0, 0.8] + BOX_B], 6, 1.0),
    ("missed-class", "MApMetric", {"class_names": ["a", "b"]},
     [[0] + BOX_A, [1] + BOX_B], [[0, 0.9] + BOX_A], 5, [1.0, 0.0, 0.5]),
    ("suppressed", "MApMetric", {}, [[0] + BOX_A],
     [[-1, 0.99] + BOX_B, [0, 0.9] + BOX_A], 5, 1.0),
]


@pytest.mark.parametrize("cid,cls,kw,gts,dets,width,want", MAP_CASES,
                         ids=[c[0] for c in MAP_CASES])
def test_map_metrics_match_jax_and_the_hand_values(cid, cls, kw, gts, dets,
                                                   width, want):
    got = []
    for mod in (tmetric, jmetric):
        m = getattr(mod, cls)(ovp_thresh=0.5, **kw)
        m.update([np.asarray([_pad(gts, max(len(gts), 1), width)])],
                 [np.asarray([_pad(dets, max(len(dets), 1), 6)])])
        got.append(m.get())
    assert got[0][0] == got[1][0]
    assert got[0][1] == pytest.approx(got[1][1])
    assert got[0][1] == pytest.approx(want)


def test_map_metrics_are_registered_and_in_contrib():
    assert mx.contrib.MApMetric is tmetric.MApMetric
    assert mx.contrib.VOC07MApMetric is tmetric.VOC07MApMetric
    for pkg, mod in ((mx, tmetric), (jmx, jmetric)):
        assert isinstance(pkg.metric.create("m_ap"), mod.MApMetric)
        assert isinstance(pkg.metric.create("voc07_m_ap"),
                          mod.VOC07MApMetric)
