"""The MXNet surface of the PyTorch port against the JAX package's, on the
CPU (ROADMAP.md Queue C: C14, C15 and C16).

- The surface gate, in the manner of ``tests/test_torch_ops_coverage.py``:
  for every module the port has (a file of ``mxnet_tpu_torch`` whose
  counterpart exists in ``mxnet_tpu``), every public name of the JAX
  module (defined there, or re-exported by a package's ``__init__``)
  exists in the port, except the names listed in ``JAX_ONLY`` (JAX or TPU
  internals with no counterpart) and ``NOT_PORTED`` (names of parts that
  ROADMAP.md queues, each with its reason). The same holds for the public
  attributes of the front end's classes (``CLASSES``).
- Parity cases for what C14 added: Symbol composition ``net(x=other)``,
  ``infer_shape_partial``, ``get_children``, ``debug_str``, ``eval``,
  ``sym.zeros``/``sym.ones``, a reference Symbol JSON with a
  ``CuDNNBatchNorm`` node, the 13 NDArray fluent methods, ``nd.moveaxis``
  and ``nd.onehot_encode``, ``autograd.get_symbol``, the ``Test``
  optimizer, ``HybridBlock.infer_shape`` and the context helpers.
- C15, each knob the reference honours in a ported module:
  ``MXNET_BACKWARD_DO_MIRROR`` (gradients equal to the JAX package's with
  the knob set, and fewer storages kept by ``residual_probe``),
  ``MXNET_IR_PASSES`` (``apply_passes``' default), ``MXNET_INFER_DEBUG``
  (the tracebacks on stderr) and ``MXNET_TPU_FUSED_ROW_TILE`` /
  ``set_row_tile`` (raise by name); and every JAX knob marked honoured
  whose reader is a ported module is in the port's ``KNOBS``.
- C16: the gloo rank tests meet at a ``file://`` rendezvous under the
  test's own directory.

Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import ast
import importlib
import json
import os
import re
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.name import NameManager as TNameManager

TOL = dict(rtol=1e-4, atol=1e-5)
PKG = {"jax": jmx, "port": tmx}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX or TPU internals that have no counterpart in the port
JAX_ONLY = {
    "": {"tpu": "the TPU context", "num_tpus": "TPU count",
         "storage": "the JAX host-pool allocator",
         "engine": "the JAX dependency engine (torch orders the card)"},
    "util": {"shard_map": "the version shim over jax.shard_map (the port's "
             "collectives are torch.distributed's, parallel/mesh.py)"},
    "context": {"tpu": "the TPU context", "num_tpus": "TPU count"},
    "autograd": {"TapeNode": "the JAX tape (torch keeps the tape)",
                 "GradEntry": "the JAX tape", "record_op": "the JAX tape"},
    "base": {"dtype_np": "numpy dtypes; the port's arrays are torch "
             "tensors (base.dtype_torch)"},
    "random": {"next_key": "JAX PRNG keys", "current_key_state": "JAX PRNG "
               "keys", "push_trace_key": "JAX PRNG keys under jit",
               "pop_trace_key": "JAX PRNG keys under jit"},
    "ndarray.ndarray": {"register_stateful_post": "the JAX tape's "
                        "stateful-op hooks"},
    "kernels.fused_block": {"mxu_plan": "the TPU MXU blocking plan"},
    "kernels.flash_attention": {"effective_blocks": "the Pallas grid's "
                                "block clamp"},
    "kvstore_server": {"zero_slice_pytree": "JAX pytrees",
                       "zero_value_sharded": "JAX sharded arrays"},
    "ops.registry": {"apply_op": "the JAX jitted-op cache",
                     "apply_op_with_key": "the JAX jitted-op cache"},
    "ops.nn": {"crop_op": "op implementation functions: the registry's "
               "names are gated by tests/test_torch_ops_coverage.py",
               "log_softmax": "as crop_op", "softmax": "as crop_op",
               "rnn": "the RNN op lives in the port's ops/rnn.py"},
    "ops.tensor": {"argmax": "as ops.nn's", "argmin": "as ops.nn's"},
    "serving": {"ExecutableCache": "no compiled program a bucket "
                "(serving/predictor.py)"},
    "serving.predictor": {"ExecutableCache": "as serving's"},
    "tune.harness": {"clock": "the TPU harness's timer",
                     "make_run": "the Pallas run factory",
                     "pin_single_core": "TPU core pinning"},
    "ir": {"registered_kernels": "the Pallas kernel registry of "
           "ir/remat.py", "policy_for": "the jax.checkpoint policies"},
    "ir.remat": {"policy_for": "the jax.checkpoint policies"},
}

# parts of ported modules that ROADMAP.md still queues
_ITEM10 = "item 10, second part (the distributed training plane)"
NOT_PORTED = {
    "": {n: _ITEM10 for n in ("CheckpointManager", "checkpoint", "dist")},
    "callback": {"elastic_checkpoint": _ITEM10},
    "chaos": {n: _ITEM10 for n in ("nan_fault", "rpc_fault", "tick_step")},
    "embedding": {"checkpoint": _ITEM10},
    "kvstore": {"DistKVStore": _ITEM10, "two_bit_pack_core": _ITEM10,
                "two_bit_round_trip_core": _ITEM10},
}


def _port_modules():
    root = os.path.join(ROOT, "mxnet_tpu_torch")
    out = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("csrc", "_build",
                                                "__pycache__")]
        for f in files:
            if not f.endswith(".py") or f == "__main__.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            rel = rel.replace(os.sep, ".")
            if rel.endswith("__init__"):
                rel = rel[:-len("__init__")].rstrip(".")
            jax_file = os.path.join(ROOT, "mxnet_tpu", *rel.split(".")) \
                if rel else os.path.join(ROOT, "mxnet_tpu")
            if os.path.exists(jax_file + ".py") or \
                    os.path.exists(os.path.join(jax_file, "__init__.py")):
                out.append(rel)
    return sorted(out)


def _imported_submodules(module):
    """The names a package's ``__init__`` binds to its own submodules by
    ``from . import x [as y]`` (read from its source: which submodules
    are attributes at run time depends on what else was imported)."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and \
                node.module is None:
            names |= {a.asname or a.name for a in node.names}
    return names


def _public(module):
    """A module's public names: what it defines, what its ``__all__``
    lists, and for a package the submodules its ``__init__`` imports and
    every name it re-exports from its own package."""
    pkg = module.__file__.endswith("__init__.py")
    listed = set(getattr(module, "__all__", ()) or ())
    names = {n for n in _imported_submodules(module)
             if not n.startswith("_")} if pkg else set()
    for k, v in vars(module).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        owner = getattr(v, "__module__", None)
        if k in listed or owner == module.__name__ or \
                (pkg and owner and owner.startswith("mxnet_tpu")):
            names.add(k)
    return names


def _has(module, name):
    try:
        getattr(module, name)
    except Exception:   # a name the port refuses by name is still missing
        return False
    return True


PORT_MODULES = _port_modules()


def test_the_gate_covers_the_front_end():
    for rel in ("", "symbol.symbol", "ndarray.ndarray", "gluon.rnn",
                "gluon.contrib.rnn", "gluon.data.vision", "module",
                "model", "context", "autograd", "optimizer", "parallel"):
        assert rel in PORT_MODULES, rel
    listed = set(JAX_ONLY) | set(NOT_PORTED)
    assert listed <= set(PORT_MODULES), listed - set(PORT_MODULES)


@pytest.mark.parametrize("rel", PORT_MODULES, ids=lambda r: r or "top")
def test_every_jax_name_of_a_ported_module_exists(rel):
    jm = importlib.import_module("mxnet_tpu" + ("." + rel if rel else ""))
    pm = importlib.import_module("mxnet_tpu_torch" + ("." + rel if rel
                                                      else ""))
    allowed = dict(JAX_ONLY.get(rel, {}))
    allowed.update(NOT_PORTED.get(rel, {}))
    public = _public(jm)
    missing = sorted(n for n in public if n not in allowed
                     and not _has(pm, n))
    assert not missing, "%s: %s" % (rel or "top", missing)
    # the listed names are really missing (a stale entry fails here)
    stale = sorted(n for n in allowed if n in public and _has(pm, n))
    assert not stale, "%s: listed but present: %s" % (rel or "top", stale)


CLASSES = [
    ("symbol.symbol", "Symbol", {}),
    ("ndarray.ndarray", "NDArray", {}),
    ("gluon.block", "Block", {}),
    ("gluon.block", "HybridBlock", {}),
    ("gluon.block", "SymbolBlock", {}),
    ("gluon.parameter", "Parameter", {}),
    ("gluon.parameter", "ParameterDict", {}),
    ("gluon.trainer", "Trainer", {}),
    ("module.base_module", "BaseModule", {}),
    ("module.module", "Module", {}),
    ("module.bucketing_module", "BucketingModule", {}),
    ("module.sequential_module", "SequentialModule", {}),
    ("module.python_module", "PythonModule", {}),
    ("module.python_module", "PythonLossModule", {}),
    ("model", "FeedForward", {}),
    ("executor", "Executor", {}),
    ("context", "Context", {"jax_device": "the JAX device of a context"}),
    ("kvstore", "KVStore", {}),
    ("io", "DataIter", {}),
    ("io", "NDArrayIter", {}),
    ("optimizer", "Optimizer", {}),
    ("metric", "EvalMetric", {}),
    ("gluon.rnn.rnn_cell", "RecurrentCell", {}),
    ("gluon.rnn.rnn_layer", "LSTM", {}),
]


@pytest.mark.parametrize("rel,cls,allowed", CLASSES,
                         ids=[c[1] for c in CLASSES])
def test_every_jax_attribute_of_a_front_end_class_exists(rel, cls, allowed):
    jc = getattr(importlib.import_module("mxnet_tpu." + rel), cls)
    pc = getattr(importlib.import_module("mxnet_tpu_torch." + rel), cls)
    missing = sorted(k for k in dir(jc) if not k.startswith("_")
                     and k not in allowed and not hasattr(pc, k))
    assert not missing, "%s: %s" % (cls, missing)


# ---------------------------------------------------------------------------
# C14 parity cases
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _both(build):
    """``build(mx)`` in each package, inside fresh name scopes."""
    out = {}
    with JNameManager():
        out["jax"] = build(jmx)
    with TNameManager():
        out["port"] = build(tmx)
    return out


def _net(mx):
    x = mx.sym.var("x")
    fc = mx.sym.FullyConnected(x, num_hidden=3, name="fc")
    return mx.sym.Activation(fc, act_type="tanh", name="act")


def test_symbol_composition_matches_jax():
    def build(mx):
        net = _net(mx)
        z = mx.sym.var("z")
        pre = mx.sym.FullyConnected(z, num_hidden=5, name="pre")
        return net(x=pre), net(pre), net
    got = _both(build)
    for j, t in zip(got["jax"][:2], got["port"][:2]):
        assert json.loads(t.tojson()) == json.loads(j.tojson())
        assert t.list_arguments() == j.list_arguments()
        assert t.infer_shape(z=(2, 7)) == j.infer_shape(z=(2, 7))
    # composing leaves the original graph as it was
    assert got["port"][2].list_arguments() == ["x", "fc_weight", "fc_bias"]
    # the composed graph runs: the port's output equals the JAX one's
    rng = np.random.RandomState(0)
    args = {"z": rng.randn(2, 7), "pre_weight": rng.randn(5, 7),
            "pre_bias": rng.randn(5), "fc_weight": rng.randn(3, 5),
            "fc_bias": rng.randn(3)}
    outs = {}
    for name, mx in PKG.items():
        kw = {k: mx.nd.array(v.astype(np.float32)) for k, v in args.items()}
        outs[name] = got[name][0].eval(ctx=mx.cpu(), **kw)[0].asnumpy()
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_infer_shape_partial_children_and_debug_str_match_jax():
    def build(mx):
        return _net(mx)
    got = _both(build)
    for kw in ({}, {"x": (4, 6)}):
        j = got["jax"].infer_shape_partial(**kw)
        t = got["port"].infer_shape_partial(**kw)
        assert [list(map(lambda s: None if s is None else tuple(s), part))
                for part in t] == \
            [list(map(lambda s: None if s is None else tuple(s), part))
             for part in j]
    assert got["port"].get_children().list_outputs() == \
        got["jax"].get_children().list_outputs()
    assert got["port"].debug_str() == got["jax"].debug_str()
    assert tmx.sym.var("v").get_children() is None
    with pytest.raises(MXNetError, match="bind"):
        got["port"].gradient(["x"])


def test_sym_zeros_and_ones_match_jax():
    got = _both(lambda mx: (mx.sym.zeros((2, 3)), mx.sym.ones((4,),
                                                               "float32")))
    for j, t in zip(got["jax"], got["port"]):
        assert json.loads(t.tojson()) == json.loads(j.tojson())
        assert t.infer_shape() == j.infer_shape()
        np.testing.assert_array_equal(t.eval(ctx=tmx.cpu())[0].asnumpy(),
                                      j.eval(ctx=jmx.cpu())[0].asnumpy())


def test_cudnn_batchnorm_json_from_the_reference_loads(tmp_path):
    """A reference graph whose BatchNorm is written ``CuDNNBatchNorm``
    loads in both packages and runs to the same output."""
    def build(mx):
        x = mx.sym.var("data")
        return mx.sym.BatchNorm(x, fix_gamma=False, name="bn")
    got = _both(build)
    text = got["jax"].tojson().replace('"op": "BatchNorm"',
                                       '"op": "CuDNNBatchNorm"')
    assert "CuDNNBatchNorm" in text
    path = tmp_path / "g-symbol.json"
    path.write_text(text)
    rng = np.random.RandomState(1)
    vals = {"data": rng.randn(4, 3, 2, 2), "bn_gamma": rng.rand(3) + 0.5,
            "bn_beta": rng.randn(3), "bn_moving_mean": rng.randn(3),
            "bn_moving_var": rng.rand(3) + 0.5}
    outs = {}
    for name, mx in PKG.items():
        sym = mx.sym.load(str(path))
        assert sym.list_auxiliary_states() == ["bn_moving_mean",
                                               "bn_moving_var"]
        args = {k: mx.nd.array(vals[k].astype(np.float32))
                for k in sym.list_arguments()}
        aux = {k: mx.nd.array(vals[k].astype(np.float32))
               for k in sym.list_auxiliary_states()}
        ex = sym.bind(mx.cpu(), args, aux_states=aux)
        outs[name] = ex.forward(is_train=False)[0].asnumpy()
        # the round trip writes the canonical op name
        again = mx.sym.load_json(sym.tojson())
        assert json.loads(again.tojson()) == json.loads(sym.tojson())
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)
    assert tmx.nd.CuDNNBatchNorm is not None and tmx.sym.CuDNNBatchNorm


FLUENT = [
    ("flip", dict(axis=1), None),
    ("tile", dict(reps=(2, 1, 3)), None),
    ("repeat", dict(repeats=2, axis=2), None),
    ("pad", dict(mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                 constant_value=0.5), "4d"),
    ("slice", dict(begin=(0, 1, 0), end=(2, 3, 3)), None),
    ("slice_axis", dict(axis=2, begin=1, end=3), None),
    ("pick", None, None),
    ("nansum", dict(axis=1), None),
    ("argsort", dict(axis=2), None),
    ("sort", dict(axis=-1, is_ascend=False), None),
    ("topk", dict(axis=2, k=2, ret_typ="value"), None),
    ("rint", {}, None),
    ("trunc", {}, None),
]


@pytest.mark.parametrize("name,kw,shape", FLUENT, ids=[f[0] for f in FLUENT])
def test_fluent_method_matches_jax(name, kw, shape):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 4, 5) if shape == "4d" else rng.randn(2, 3, 4)) * 3
    x = x.astype(np.float32)
    if name == "nansum":
        x[0, 1, 2] = np.nan
    outs = {}
    for pkg, mx in PKG.items():
        arr = mx.nd.array(x)
        if name == "pick":
            out = arr.pick(mx.nd.array(np.array([[1, 0, 3], [2, 2, 0]],
                                                np.float32)), axis=2)
        else:
            out = getattr(arr, name)(**kw)
        outs[pkg] = out.asnumpy()
    assert outs["port"].shape == outs["jax"].shape
    np.testing.assert_allclose(outs["port"], outs["jax"], **TOL)


def test_nd_helpers_match_jax():
    x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    idx = np.array([0, 2, 1], np.float32)
    got = {}
    for name, mx in PKG.items():
        moved = mx.nd.moveaxis(mx.nd.array(x), 0, 2).asnumpy()
        out = mx.nd.zeros((3, 4))
        res = mx.nd.onehot_encode(mx.nd.array(idx), out)
        assert res is out
        got[name] = (moved, out.asnumpy(), mx.nd.array(x).as_np_ndarray())
        arr = mx.nd.array(x)
        assert arr.handle is arr
        with pytest.raises(mx.MXNetError, match="imdecode"):
            mx.nd.imdecode(b"")
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(t, j)


def test_autograd_get_symbol_matches_jax():
    x = np.random.RandomState(4).randn(2, 3).astype(np.float32)
    got = {}
    for name, mx in PKG.items():
        a = mx.nd.array(x)
        w = mx.nd.array(x.T.copy())
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.relu(mx.nd.dot(a, w) + 1.0).sum(axis=1)
        got[name] = mx.autograd.get_symbol(y)
    assert json.loads(got["port"].tojson()) == json.loads(got["jax"].tojson())
    assert got["port"].list_arguments() == ["var0", "var1"]
    with pytest.raises(MXNetError, match="recorded"):
        tmx.autograd.get_symbol(tmx.nd.ones((2,)))


def test_optimizer_test_matches_jax():
    w0 = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    g = np.random.RandomState(6).randn(4, 3).astype(np.float32)
    got = {}
    for name, mx in PKG.items():
        opt = mx.optimizer.create("test", rescale_grad=0.5)
        w = mx.nd.array(w0)
        state = opt.create_state(0, w)
        for _ in range(2):
            opt.update(0, w, mx.nd.array(g), state)
        got[name] = (w.asnumpy(), state.asnumpy())
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(t, j, **TOL)
    assert tmx.optimizer.ccSGD is tmx.optimizer.SGD


def test_hybrid_block_infer_shape_resolves_deferred_parameters():
    net = tmx.gluon.nn.Dense(4)
    net.initialize()
    with pytest.raises(Exception):
        net.weight.data()
    net.infer_shape(tmx.nd.ones((2, 7)))
    assert net.weight.data().shape == (4, 7)
    assert not tmx.autograd.is_recording()


def test_context_and_top_level_names():
    assert tmx.num_gpus() == tmx.context.num_gpus() == 0
    ctx = tmx.cpu_pinned(0)
    assert repr(ctx) == "cpu_pinned(0)" and ctx.device_typeid == 3
    assert str(ctx.torch_device()) == "cpu"
    assert tmx.context.Context.parse("cpu_pinned(0)") == ctx
    with ctx:
        assert tmx.nd.ones((2,)).tensor.device.type == "cpu"
    tmx.cpu().empty_cache()
    assert tmx.rnd is tmx.random and tmx.Executor is tmx.executor.Executor
    assert tmx.load_checkpoint is tmx.model.load_checkpoint
    assert tmx.parallel.DeviceQueueIter is tmx.parallel.feed.DeviceQueueIter
    assert tmx.parallel.place_batch_array is \
        tmx.parallel.feed.place_batch_array
    assert tmx.initializer.init.Xavier is tmx.initializer.Xavier


# ---------------------------------------------------------------------------
# C15: the knobs
# ---------------------------------------------------------------------------
def _mlp(mx):
    h = mx.sym.var("data")
    for i, act in enumerate(("tanh", "sigmoid", "tanh", "sigmoid")):
        h = mx.sym.Activation(mx.sym.FullyConnected(
            h, num_hidden=16, no_bias=i % 2 == 1, name="f%d" % i),
            act_type=act)
    out = mx.sym.FullyConnected(h, num_hidden=5, name="out")
    return mx.sym.SoftmaxOutput(out, name="softmax")


def _jax_grads(sym, vals):
    args = {k: jmx.nd.array(v) for k, v in vals.items()}
    grads = {k: jmx.nd.zeros(v.shape) for k, v in vals.items()
             if k not in ("data", "softmax_label")}
    ex = sym.bind(jmx.cpu(), args, args_grad=grads)
    ex.forward(is_train=True)
    ex.backward()
    return {k: g.asnumpy() for k, g in grads.items()}


def test_backward_do_mirror_matches_jax_and_keeps_less(monkeypatch):
    from mxnet_tpu_torch.executor import residual_probe

    got = _both(_mlp)
    rng = np.random.RandomState(7)
    shapes, _, _ = got["port"].infer_shape(data=(64, 12))
    vals = {n: (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(got["port"].list_arguments(), shapes)}
    vals["softmax_label"] = rng.randint(0, 5, 64).astype(np.float32)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    jg = _jax_grads(got["jax"], vals)
    kept = {}
    for mirror in ("0", "1"):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", mirror)
        args = {k: tmx.nd.array(v) for k, v in vals.items()}
        grads = {k: tmx.nd.zeros(v.shape) for k, v in vals.items()
                 if k not in ("data", "softmax_label")}
        ex = got["port"].bind(tmx.cpu(), args, args_grad=grads)
        with residual_probe() as probe:
            ex.forward_backward()
        kept[mirror] = (probe.stats()["n_residuals"],
                        probe.stats()["residual_bytes"])
        for k in jg:
            np.testing.assert_allclose(grads[k].asnumpy(), jg[k],
                                       err_msg=k, **TOL)
    # only the variables are kept: fewer storages, and fewer bytes
    assert kept["1"][0] < kept["0"][0], kept
    assert kept["1"][1] < kept["0"][1], kept
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "maybe")
    ex = got["port"].bind(tmx.cpu(), {k: tmx.nd.array(v)
                                      for k, v in vals.items()},
                          args_grad={"f0_weight": tmx.nd.zeros((16, 12))})
    with pytest.raises(MXNetError, match="MXNET_BACKWARD_DO_MIRROR"):
        ex.forward_backward()


def test_ir_passes_default_is_the_knob(monkeypatch):
    from mxnet_tpu.ir import passes as jpasses
    from mxnet_tpu_torch.ir import passes as tpasses

    got = _both(_mlp)
    for knob in (None, "residual", "fusion,layout"):
        if knob is None:
            monkeypatch.delenv("MXNET_IR_PASSES", raising=False)
        else:
            monkeypatch.setenv("MXNET_IR_PASSES", knob)
        assert tpasses.PassManager().names == jpasses.PassManager().names
        out = tpasses.apply_passes(got["port"])
        assert out.list_arguments() == got["port"].list_arguments()
    monkeypatch.setenv("MXNET_IR_PASSES", "fusion,nope")
    for passes in (jpasses, tpasses):
        with pytest.raises(Exception, match="MXNET_IR_PASSES"):
            passes.apply_passes(got["port"] if passes is tpasses
                                else got["jax"])


def test_infer_debug_prints_the_failing_node(monkeypatch, capfd):
    def build(mx):
        x = mx.sym.var("x")
        y = mx.sym.var("y")
        return mx.sym.broadcast_add(x, y, name="add")
    got = _both(build)
    for mx, sym in ((jmx, got["jax"]), (tmx, got["port"])):
        monkeypatch.delenv("MXNET_INFER_DEBUG", raising=False)
        with pytest.raises(mx.MXNetError):
            sym.infer_shape(x=(2, 3), y=(4, 5))
        assert "[infer_shape]" not in capfd.readouterr().err
        monkeypatch.setenv("MXNET_INFER_DEBUG", "1")
        with pytest.raises(mx.MXNetError):
            sym.infer_shape(x=(2, 3), y=(4, 5))
        err = capfd.readouterr().err
        assert "[infer_shape] node 'add' (broadcast_add) failed:" in err
        assert "Traceback" in err


def test_row_tile_knob_and_setter_raise_by_name(monkeypatch):
    import torch

    from mxnet_tpu_torch.kernels import fused_block as fb

    x = torch.randn(1, 4, 4, 8)
    w = torch.randn(1, 1, 8, 8)
    fb.conv_fwd(x, w)
    fb.set_row_tile(None)
    with pytest.raises(MXNetError, match="set_row_tile.*row_tile"):
        fb.set_row_tile(8)
    monkeypatch.setenv("MXNET_TPU_FUSED_ROW_TILE", "8")
    with pytest.raises(MXNetError, match="MXNET_TPU_FUSED_ROW_TILE.*tune"):
        fb.conv_fwd(x, w)


# knobs the JAX package honours in files the port has, that the port does
# not list: the reader's part of the file is not ported, or the knob has
# nothing to act on there
KNOB_EXCEPTIONS = {
    "MXNET_TPU_ZERO_WIRE_THRESHOLD": "only the two-bit ZeRO wire reads it, "
    "and that wire raises by name (parallel/spmd.py)",
    "MXNET_SERVE_MAX_EXECUTABLES": "the predictor keeps no compiled program "
    "a bucket (serving/predictor.py)",
    "DMLC_ROLE": "the server entry point raises by name "
    "(kvstore_server.py, item 10)",
    "MXNET_TPU_JAX_TRACE_DIR": "JAX traces",
}


def test_every_honoured_knob_of_a_ported_module_is_listed():
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config as tconfig

    ported = {rel.replace(".", "/") + ".py" for rel in PORT_MODULES}
    ported |= {rel.replace(".", "/") + "/__init__.py"
               for rel in PORT_MODULES}
    missing = []
    for name, (default, status, desc) in jconfig.KNOBS.items():
        if status != "honored" or name in KNOB_EXCEPTIONS:
            continue
        readers = re.findall(r"([\w/]+\.py)", desc)
        if any(r in ported for r in readers) and name not in tconfig.KNOBS:
            missing.append(name)
    assert not missing, missing
    for name in ("MXNET_BACKWARD_DO_MIRROR", "MXNET_IR_PASSES",
                 "MXNET_INFER_DEBUG", "MXNET_TPU_FUSED_ROW_TILE",
                 "MXNET_GLUON_REPO"):
        assert tconfig.KNOBS[name][0] == jconfig.KNOBS[name][0], name
    for name in KNOB_EXCEPTIONS:
        assert jconfig.KNOBS[name][1] == "honored", name


# ---------------------------------------------------------------------------
# C16: the rank tests' rendezvous
# ---------------------------------------------------------------------------
def test_rank_rendezvous_is_a_fresh_file_under_the_test_dir(tmp_path):
    import torch_dp_workers as w

    first, second = w._rendezvous(tmp_path), w._rendezvous(tmp_path)
    assert first != second
    for method in (first, second):
        assert method.startswith("file://" + str(tmp_path))
        assert not os.path.exists(method[len("file://"):])
    assert not hasattr(w, "_free_port")


def test_no_port_file_cites_item_8b():
    """Item 8b (tensor parallelism of symbols) is ported: no file of the
    port, and not chip_smoke.py, refuses anything citing it."""
    hits = []
    for base in ("mxnet_tpu_torch", "chip_smoke.py"):
        path = os.path.join(ROOT, base)
        files = [path] if path.endswith(".py") else [
            os.path.join(d, f) for d, _s, fs in os.walk(path) for f in fs
            if f.endswith(".py")]
        for f in files:
            with open(f) as fh:
                if "item 8b" in fh.read():
                    hits.append(os.path.relpath(f, ROOT))
    assert not hits, hits
