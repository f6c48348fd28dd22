"""The PTB LSTM language model on the port against the JAX package, on the
CPU, at a small width (vocabulary 50, 32 units, 2 layers, 8 steps, batch
4).

``chip_smoke.py`` builds the model with ``lm_symbol`` (from either
package's ``mx``): its Symbol JSON equals ``examples/rnn/lstm_bucketing.py``'s
``lstm_lm_sym`` through the JAX package, and the port's equals both. One
``Module.fit`` batch (SGD at learning rate 1.0 on the per-token mean loss,
the RNN states fixed at zero, dropout 0) from the same parameters, saved
by the JAX package's ``nd.save`` and loaded by the port's ``nd.load``, gives
the JAX ``Module``'s outputs and updated parameters within rtol 1e-4 /
atol 1e-5. The next-token graph (``lm_next_token_symbol``: Embedding ->
SequenceMask -> RNN -> SequenceLast -> FullyConnected -> softmax -> top 5)
behind the port's ``AOTPredictor`` gives the JAX ``AOTPredictor``'s top-5
probabilities within 1e-4 and the same ids, on padded prompts at the
ladder's batches. Last, the card's op sweep in ``chip_smoke.py`` carries a
copy of ``tests/test_op_sweep.py``'s specs for the 95 names of item 7b
(the card's machine has no JAX): the copy is held equal to them.
"""
import importlib.util
import json
import os
import warnings

import numpy as np
import pytest

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_op_sweep import ALIAS_SPECS, SPECS
from test_torch_ops_coverage import TENSOR_7B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=50, hidden=32, embed=32, layers=2, seq=8, batch=4)
RTOL, ATOL = 1e-4, 1e-5


def _example():
    path = os.path.join(ROOT, "examples", "rnn", "lstm_bucketing.py")
    spec = importlib.util.spec_from_file_location("lstm_bucketing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scoped_json(pkg, build):
    """A graph's JSON built inside a fresh name scope of its package (auto
    names are global counters)."""
    from mxnet_tpu.name import NameManager as JNM
    from mxnet_tpu_torch.name import NameManager as TNM

    with (TNM if pkg is mx else JNM)():
        return json.loads(build().tojson())


def _lm(pkg, p=0.0):
    c = SMALL
    return cs.lm_symbol(pkg, c["vocab"], c["hidden"], c["embed"],
                        c["layers"], p=p)


def _next_token(pkg):
    c = SMALL
    return cs.lm_next_token_symbol(pkg, c["vocab"], c["hidden"], c["embed"],
                                   c["layers"])


def test_lm_symbol_json_is_the_examples_in_both_packages():
    c = SMALL
    example = _scoped_json(jmx, lambda: _example().lstm_lm_sym(
        c["seq"], c["vocab"], c["hidden"], c["embed"], c["layers"]))
    assert _scoped_json(jmx, lambda: _lm(jmx)) == example
    assert _scoped_json(mx, lambda: _lm(mx)) == example
    assert _scoped_json(mx, lambda: _lm(mx, p=0.5)) == \
        _scoped_json(jmx, lambda: _lm(jmx, p=0.5))


def test_next_token_symbol_json_matches_jax():
    got = _scoped_json(mx, lambda: _next_token(mx))
    assert got == _scoped_json(jmx, lambda: _next_token(jmx))
    ops = [n["op"] for n in got["nodes"] if n["op"] != "null"]
    assert ops == ["Embedding", "SequenceMask", "swapaxes", "RNN",
                   "SequenceLast", "FullyConnected", "softmax", "topk"]


def test_lm_shapes_and_arguments_match_jax():
    c = SMALL
    got = []
    for pkg in (mx, jmx):
        sym = _lm(pkg)
        shapes = sym.infer_shape(data=(c["batch"], c["seq"]),
                                 softmax_label=(c["batch"], c["seq"]))
        got.append((sym.list_arguments(), shapes))
    assert got[0] == got[1]
    args = dict(zip(got[0][0], got[0][1][0]))
    assert args["embed_weight"] == (c["vocab"], c["embed"])
    assert args["pred_weight"] == (c["vocab"], c["hidden"])


def _shared_params(tmp_path):
    """``lm_params`` saved by the JAX package and loaded by each."""
    c = SMALL
    params = cs.lm_params(np, _lm(mx), c["batch"], c["seq"])
    fname = str(tmp_path / "lm.params")
    jmx.nd.save(fname, {k: jmx.nd.array(v) for k, v in params.items()})
    with mx.cpu():
        port = {k: v for k, v in mx.nd.load(fname).items()}
    jax_side = jmx.nd.load(fname)
    for k, v in params.items():
        assert np.array_equal(port[k].asnumpy(), v), k
    return params, port, jax_side


def _fit_one_batch(pkg, params, x, y):
    c = SMALL
    ctx = pkg.cpu()
    mod = pkg.mod.Module(_lm(pkg), context=ctx,
                         fixed_param_names=list(cs.LM_STATES))
    it = pkg.io.NDArrayIter(x, y, batch_size=c["batch"])
    outs = []
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(learning_rate=cs.LM_LR,
                                  rescale_grad=1.0 / (c["batch"] * c["seq"])),
            initializer=pkg.init.Uniform(cs.LM_INIT), arg_params=params,
            batch_end_callback=lambda _p: outs.append(
                mod.get_outputs()[0].asnumpy()))
    arg, _aux = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in arg.items()}


def test_one_fit_batch_matches_the_jax_module(tmp_path):
    c = SMALL
    params, port, jax_side = _shared_params(tmp_path)
    x, y = cs.lm_corpus(np, c["batch"], c["seq"], c["vocab"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with mx.cpu():
            t_outs, t_params = _fit_one_batch(mx, port, x, y)
        j_outs, j_params = _fit_one_batch(jmx, jax_side, x, y)
    assert len(t_outs) == len(j_outs) == 1
    np.testing.assert_allclose(t_outs[0], j_outs[0], rtol=RTOL, atol=ATOL)
    loss = -np.log(t_outs[0][np.arange(c["batch"] * c["seq"]),
                             y.reshape(-1).astype(int)]).mean()
    assert abs(loss - np.log(c["vocab"])) < 0.1
    assert sorted(t_params) == sorted(j_params)
    for k in t_params:
        np.testing.assert_allclose(t_params[k], j_params[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        moved = not np.array_equal(t_params[k], params[k])
        assert moved == (k not in cs.LM_STATES), k


def test_next_token_predictor_matches_jax(tmp_path):
    from mxnet_tpu.serving import AOTPredictor as JAOT
    from mxnet_tpu_torch.serving import AOTPredictor

    c = SMALL
    params, _port, _jax_side = _shared_params(tmp_path)
    served = {k: v for k, v in params.items() if k not in cs.LM_STATES}
    rng = np.random.RandomState(5)
    lens = rng.randint(2, c["seq"] + 1, 7).astype(np.float32)
    x, _y = cs.lm_corpus(np, 7, c["seq"], c["vocab"], seed=6)
    x[np.arange(c["seq"])[None, :] >= lens[:, None]] = 0
    shapes = {"data": (1, c["seq"]), "sequence_length": (1,)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = AOTPredictor(_next_token(mx), served, data_shapes=shapes,
                            ladder=(1, 4), device="cpu")
        ref = JAOT(_next_token(jmx), served, data_shapes=shapes,
                   ladder=(1, 4))
    for a, b in ((0, 4), (4, 7), (6, 7)):        # full, partly filled, one
        got = port.predict({"data": x[a:b], "sequence_length": lens[a:b]})
        want = ref.predict({"data": x[a:b], "sequence_length": lens[a:b]})
        assert got[0].shape == (b - a, cs.LM_TOPK)
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                                   atol=ATOL)
        assert np.array_equal(got[1], np.asarray(want[1]))
    # a prompt's answer does not depend on its padding
    one = port.predict({"data": x[6:7], "sequence_length": lens[6:7]})
    x2 = x[6:7].copy()
    x2[0, int(lens[6]):] = 7
    two = port.predict({"data": x2, "sequence_length": lens[6:7]})
    assert np.array_equal(one[1], two[1])
    np.testing.assert_allclose(one[0], two[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", TENSOR_7B)
def test_chip_smoke_sweep_spec_is_the_sweeps(name):
    inputs, attrs, diff = cs.sweep_specs(np)[name]
    spec = SPECS.get(name) or SPECS[ALIAS_SPECS[name]]
    assert attrs == spec["attrs"]
    assert diff == spec.get("diff_args")
    assert len(inputs) == len(spec["inputs"])
    for a, b in zip(inputs, spec["inputs"]):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(a, np.asarray(b))


def test_chip_smoke_sweep_covers_the_slice():
    assert sorted(cs.sweep_specs(np)) == sorted(TENSOR_7B)
