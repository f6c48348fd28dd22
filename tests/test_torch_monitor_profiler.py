"""``Monitor`` and the profiler's trace API of the PyTorch port against the
JAX package's, on the CPU.

- ``Monitor`` on the same net, weights and batch through ``Module``'s
  ``forward``/``backward``/``update``: the same (step, name) rows, with
  equal stats (the default ``norm / sqrt(size)``, rtol 1e-4, atol 1e-5).
- ``fit(monitor=)`` through ``Module`` and ``BucketingModule``: every
  monitored batch logs each argument's stat, equal to the JAX package's,
  and (the port only) each output's. The JAX package's
  ``Executor.forward_backward``, which its ``fit`` calls, never calls the
  monitor callback (``mxnet_tpu/executor.py`` ``forward_backward``); the
  port's calls it after the forward, as MXNet's ``fit`` does.
- The scenarios of ``tests/test_config_profiler.py`` in the port: the
  executor's ``forward``/``backward`` events and an imperative op's in mode
  ``all``, each event complete (``ph`` X, ``ts``, ``dur``), with the set of
  (name, cat) equal to the JAX package's for the same calls, and
  ``MXNET_PROFILER_AUTOSTART`` in a subprocess (with its ``atexit`` dump).
- ``pause``/``resume``/``is_running``, ``maybe_scope``'s mode filter, and
  ``dump_profile()`` writing the file ``set_config`` named with the JAX
  package's top-level keys.
"""
import json
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import profiler as jprof
from mxnet_tpu_torch import profiler as tprof

RTOL, ATOL = 1e-4, 1e-5
PKG = {"jax": jmx, "port": tmx}
PROF = {"jax": jprof, "port": tprof}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, DIM, CLASSES = 8, 12, 4


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(autouse=True)
def _profilers_stopped():
    yield
    for p in PROF.values():
        p.profiler_set_state("stop")
        p.set_config()


def _mlp(mx):
    h = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16, name="fc1")
    h = mx.sym.Activation(h, act_type="tanh", name="act")
    h = mx.sym.FullyConnected(h, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _weights():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(16, DIM) * 0.3, "fc1_bias": rng.randn(16),
            "fc2_weight": rng.randn(CLASSES, 16) * 0.3,
            "fc2_bias": rng.randn(CLASSES)}


def _batches(n):
    rng = np.random.RandomState(1)
    return (rng.randn(n * BATCH, DIM).astype(np.float32),
            rng.randint(0, CLASSES, n * BATCH).astype(np.float32))


def _module(mx, sym=None):
    mod = mx.mod.Module(sym or _mlp(mx), context=mx.cpu())
    mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v.astype(np.float32))
                                for k, v in _weights().items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=dict(learning_rate=0.1,
                                             momentum=0.9))
    return mod


def _rows(rows):
    """``(step, name) -> value`` of ``Monitor.toc`` rows (one scalar a
    row)."""
    out = {}
    for step, name, text in rows:
        vals = text.split("\t")
        assert vals[-1] == "" and len(vals) == 2, text
        out[(step, name)] = float(vals[0])
    return out


def test_monitor_stats_match_jax():
    x, y = _batches(3)
    got = {}
    for key, mx in PKG.items():
        mod = _module(mx)
        mon = mx.mon.Monitor(2)
        mod.install_monitor(mon)
        rows = []
        for i in range(3):
            batch = mx.io.DataBatch([mx.nd.array(x[i * BATCH:(i + 1) * BATCH])],
                                    [mx.nd.array(y[i * BATCH:(i + 1) * BATCH])])
            mon.tic()
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            rows += mon.toc()
        got[key] = rows
    assert [(s, n) for s, n, _ in got["port"]] == \
        [(s, n) for s, n, _ in got["jax"]]
    steps = {s for s, _n, _v in got["port"]}
    assert steps == {1, 3}     # batches 0 and 2 of interval 2
    names = [n for s, n, _ in got["port"] if s == 1]
    assert names == ["softmax_output"] + _mlp(tmx).list_arguments()
    j, t = _rows(got["jax"]), _rows(got["port"])
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL,
                                   err_msg=str(k))
    # the default stat is norm / sqrt(size)
    mod = _module(tmx)
    mon = tmx.mon.Monitor(1, pattern="fc2_weight")
    mod.install_monitor(mon)
    mon.tic()
    (_, name, text), = mon.toc()
    w = _weights()["fc2_weight"].astype(np.float32)
    assert name == "fc2_weight"
    np.testing.assert_allclose(float(text), np.linalg.norm(w) /
                               np.sqrt(w.size), rtol=1e-6)


def _logged(caplog):
    rows = []
    for rec in caplog.records:
        m = re.match(r"Batch: +(\d+) (\S+) +(\S+)\t$", rec.getMessage())
        if m:
            rows.append((int(m.group(1)), m.group(2), float(m.group(3))))
    return rows


class _Bucketed:
    """``NDArrayIter``'s batches, each naming its bucket and shapes (what
    ``BucketingModule.forward_backward`` switches on)."""

    def __init__(self, it):
        self.it = it
        self.provide_data = it.provide_data
        self.provide_label = it.provide_label

    def reset(self):
        self.it.reset()

    def __iter__(self):
        for b in self.it:
            b.bucket_key = DIM
            b.provide_data = self.provide_data
            b.provide_label = self.provide_label
            yield b


def _fit_rows(mx, caplog, bucketing):
    x, y = _batches(3)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    if bucketing:
        it = _Bucketed(it)
        mod = mx.mod.BucketingModule(lambda key: (_mlp(mx), ("data",),
                                                  ("softmax_label",)),
                                     default_bucket_key=DIM,
                                     context=mx.cpu())
    else:
        mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(learning_rate=0.1),
                arg_params={k: mx.nd.array(v.astype(np.float32))
                            for k, v in _weights().items()},
                monitor=mx.mon.Monitor(2))
    return _logged(caplog)


@pytest.mark.parametrize("bucketing", [False, True],
                         ids=["Module", "BucketingModule"])
def test_fit_monitor_matches_jax(caplog, bucketing):
    got = {key: _fit_rows(mx, caplog, bucketing) for key, mx in PKG.items()}
    args = _mlp(tmx).list_arguments()
    for step in (1, 3):
        port = [n for s, n, _ in got["port"] if s == step]
        jax = [n for s, n, _ in got["jax"] if s == step]
        assert port == ["softmax_output"] + args, port
        assert jax == args, jax
    j = {(s, n): v for s, n, v in got["jax"]}
    for s, n, v in got["port"]:
        if n in args:
            np.testing.assert_allclose(v, j[(s, n)], rtol=RTOL, atol=ATOL,
                                       err_msg="%s at %d" % (n, s))


def _profiled_calls(mx, prof, fname):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=4, name="fc")
    args = {n: mx.nd.ones(s) for n, s in zip(
        net.list_arguments(), net.infer_shape(data=(2, 3))[0])}
    grads = {n: mx.nd.zeros(a.shape) for n, a in args.items()}
    exe = net.bind(ctx=mx.cpu(), args=args, args_grad=grads)
    prof.profiler_set_config(mode="all", filename=fname)
    prof.profiler_set_state("run")
    try:
        exe.forward(is_train=True)
        exe.backward([mx.nd.ones((2, 4))])
        mx.nd.relu(mx.nd.array(np.ones((2, 2), np.float32)))
    finally:
        prof.profiler_set_state("stop")
    prof.dump_profile()
    with open(fname) as f:
        return json.load(f)


def test_profiler_records_executor_events_as_jax(tmp_path):
    got = {key: _profiled_calls(mx, PROF[key], str(tmp_path / key))
           for key, mx in PKG.items()}
    trace = got["port"]
    cats = {e["cat"] for e in trace["traceEvents"]}
    names = {e["name"] for e in trace["traceEvents"]}
    assert "forward" in cats and "backward" in cats, cats
    assert "relu" in names, names
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and "ts" in e and "dur" in e
        assert e["dur"] >= 0 and e["pid"] == os.getpid()
    pairs = {key: {(e["name"], e["cat"]) for e in t["traceEvents"]}
             for key, t in got.items()}
    assert pairs["port"] == pairs["jax"], pairs


def test_forward_backward_records_its_two_halves(tmp_path):
    """The port's ``forward_backward`` is a forward and a backward run one
    after the other: each is an event, inside a ``forward_backward`` one
    (the JAX package's one program is the ``forward_backward`` event
    alone)."""
    net = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=4,
                                 name="fc")
    ex = net.simple_bind(tmx.cpu(), data=(2, 3))
    tprof.set_config(mode="symbolic", filename=str(tmp_path / "t.json"))
    tprof.set_state("run")
    ex.forward_backward()
    tmx.nd.relu(tmx.nd.ones((2,)))      # not an event in mode symbolic
    tprof.set_state("stop")
    tprof.dump_profile()
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert [(e["name"], e["cat"]) for e in ev] == [
        ("fc", "forward"), ("fc", "backward"), ("fc", "forward_backward")]
    outer = ev[2]
    for inner in ev[:2]:
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_pause_resume_and_scopes_match_jax(tmp_path):
    got = {}
    for key, prof in PROF.items():
        prof.set_config(mode="symbolic", filename=str(tmp_path / key))
        assert not prof.is_running()
        prof.set_state("run")
        assert prof.is_running()
        with prof.scope("a", "custom"):
            pass
        prof.pause()
        assert not prof.is_running()
        with prof.scope("paused", "custom"):
            pass
        prof.record_event("dropped", "custom", 0, 1)
        prof.resume()
        with prof.maybe_scope("all_only", "operator", mode="all"):
            pass
        with prof.maybe_scope("b", "custom"):
            pass
        prof.record_event("c", "custom", 5, 2, tid=3)
        prof.set_state("stop")
        prof.record_event("stopped", "custom", 0, 1)
        prof.dump_profile()
        ev = json.loads((tmp_path / key).read_text())["traceEvents"]
        got[key] = [(e["name"], e["cat"], e["tid"]) for e in ev]
        # a new run starts from no events
        prof.set_state("run")
        prof.set_state("stop")
        prof.dump_profile()
        assert json.loads((tmp_path / key).read_text())["traceEvents"] == []
    assert got["port"] == got["jax"] == [("a", "custom", 0),
                                         ("b", "custom", 0),
                                         ("c", "custom", 3)]


def _reset_counters(prof):
    for name in dir(prof):
        if name.endswith("_reset"):
            getattr(prof, name)()


def test_dump_profile_writes_the_configured_file_with_jax_keys(tmp_path):
    payload = {}
    for key, prof in PROF.items():
        _reset_counters(prof)
        prof.set_config(filename=str(tmp_path / ("%s.json" % key)))
        prof.set_state("run")
        with prof.scope("s"):
            pass
        prof.set_state("stop")
        prof.serving_record("m", requests=2, batches=1, rows=2, capacity=4)
        prof.health_record(skipped=1)
        assert prof.dump_profile() is None
        payload[key] = json.loads((tmp_path / ("%s.json" % key))
                                  .read_text())
        _reset_counters(prof)
    assert set(payload["port"]) == set(payload["jax"]) == {
        "traceEvents", "displayTimeUnit", "servingStats", "healthStats"}
    assert payload["port"]["displayTimeUnit"] == "ms"
    assert payload["port"]["healthStats"] == payload["jax"]["healthStats"]
    assert [e["name"] for e in payload["port"]["traceEvents"]] == ["s"]
    with pytest.raises(TypeError):
        tprof.dump_profile(str(tmp_path / "x.json"))


def test_profiler_autostart_env(tmp_path):
    """``MXNET_PROFILER_AUTOSTART=1`` in a fresh process: running at import
    in ``MXNET_PROFILER_MODE``, and the trace dumped at exit to the default
    ``profile.json`` of the working directory."""
    script = (
        "import sys; sys.path.insert(0, %r); "
        "import mxnet_tpu_torch as mx; "
        "assert mx.profiler.is_running(); "
        "mx.nd.relu(mx.nd.ones((2,), ctx=mx.cpu())); "
        "print('AUTOSTART_OK')" % ROOT)
    env = {k: v for k, v in os.environ.items() if not k.startswith("MXNET_")}
    env["MXNET_PROFILER_AUTOSTART"] = "1"
    env["MXNET_PROFILER_MODE"] = "all"
    p = subprocess.run([sys.executable, "-c", script], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0 and "AUTOSTART_OK" in p.stdout, p.stderr[-2000:]
    trace = json.loads((tmp_path / "profile.json").read_text())
    assert ("relu", "operator") in {(e["name"], e["cat"])
                                    for e in trace["traceEvents"]}
