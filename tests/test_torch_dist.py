"""The port's multi-process training plane against the JAX package, on the
CPU over gloo.

Port workers are started as users start them: ``tools/launch.py -n 2 -s 0``
(the serverless job of ``mxnet_tpu_torch.dist``) and ``python -m
mxnet_tpu_torch.launch -n 2 -s S`` (the scheduler topology), each running
``tests/torch_dist_workers.py``; ZeRO's 2-bit wire runs on gloo ranks of
``tests/torch_dp_workers.py``. The JAX package runs in pytest's own
process, on the same seeded inputs, meanwhile:

- ``dist``: ``env_spec`` on the same environments; the host collectives;
  a SIGKILLed rank counted dead within the heartbeat bound;
- ``tests/dist_check.py``'s scenarios on ``dist_sync`` stores: each
  worker's values equal the JAX package's ``KVStore`` pushed the two
  workers' values in one process, bit for bit (a sum of two terms); the
  store's optimizer within rtol 1e-6;
- ``tests/test_compression.py``'s four cases on the port, and the 2-bit
  cores bit for bit the JAX ones on fp32 and bf16;
- the fused ``dist_sync`` step (``tests/fused_dist_worker.py``'s MLP,
  ``LOCAL_BATCH`` 8, 5 steps, fed by ``DeviceQueueIter``): weights
  bit-identical across the workers and within rtol 2e-5 / atol 2e-6 of
  the JAX package's single-process run of the global batch; a tiny fused
  ResNet (B1-B3 on their plain versions) against the JAX one with its
  Pallas kernels in interpret mode, at rtol 1e-4 / atol 1e-5 of the
  tensor's largest value;
- ``DeviceQueueIter(distributed=True)``: local rows, and a mid-stream
  change of the local batch raising;
- ``zero_wire="2bit"`` (``tests/test_zero.py``'s case): losses within
  rtol 1e-4 / atol 1e-5 of the JAX run, residual rows of the plan's keys,
  losses apart from the raw wire's and finite;
- the launchers: ``--launcher manual`` output equal to ``tools/launch.py``'s
  but for the two module names; the server role shim; the scheduler
  topology end to end (``dist_async`` from the tracker's rendezvous over
  two servers with ZeRO, ``dist_sync`` refused); a worker killed in a
  barrier raising on the survivor.

Every subprocess has a hard timeout; the serverless workers meet at a free
port, the rank tests at a file under the test's directory.
"""
import contextlib
import io
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
import torch_dist_workers as w
from jax.experimental.pallas import tpu as pltpu
from mxnet_tpu import dist as jdist
from mxnet_tpu_torch import dist as tdist
from mxnet_tpu_torch.base import MXNetError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150


def _clean_env(**kw):
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("DMLC_", "MXNET_TPU_", "MXNET_PS_",
                         "MXNET_CHECKPOINT", "MXNET_KVSTORE_")):
            del env[k]
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    env.update(kw)
    return env


def _launch(args, scenario, out_dir, module=False, **env):
    """A launcher running ``torch_dist_workers.py SCENARIO OUT_DIR``."""
    launcher = [sys.executable, "-m", "mxnet_tpu_torch.launch"] if module \
        else [sys.executable, os.path.join(ROOT, "tools", "launch.py")]
    cmd = launcher + list(args) + [
        "--timeout", str(TIMEOUT - 20), sys.executable,
        os.path.join(ROOT, "tests", "torch_dist_workers.py"), scenario,
        str(out_dir)]
    return subprocess.Popen(cmd, env=_clean_env(**env), cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc, timeout=TIMEOUT):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail("launcher did not end within %d s:\n%s"
                    % (timeout, out[-4000:]))
    return proc.returncode, out


def _load(out_dir, scenario, world=2):
    return [torch.load(os.path.join(str(out_dir), "%s-rank%d.pt"
                                    % (scenario, r)), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
def _jkv_sum(key, per_rank, shape):
    """The JAX local store pushed every rank's value of ``key`` in one
    push (the reduce sums them), pulled."""
    kv = jmx.kv.create("local")
    kv.init(key, jmx.nd.zeros(shape))
    kv.push(key, [jmx.nd.array(v) for v in per_rank])
    out = jmx.nd.zeros(shape)
    kv.pull(key, out=out)
    return out.asnumpy()


def _jax_kv_refs():
    ref = {"dense": _jkv_sum("w", [w.dense_grad(r) for r in (0, 1)], (4, 4))}
    ref["batched"] = {k: _jkv_sum(k, [w.batched_grads(r)[k] for r in (0, 1)],
                                  (3, 5)) for k in w.batched_grads(0)}
    # compression: each worker quantizes its own push (a store each)
    per_rank = []
    for r in (0, 1):
        kv = jmx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("c", jmx.nd.zeros((4, 4)))
        seen = []
        kv._set_updater(lambda k, g, wt, s=seen: s.append(g.asnumpy()))
        for _ in range(2):
            kv.push("c", jmx.nd.array(w.compressed_grad(r)))
        per_rank.append(seen)
    ref["compressed"] = [per_rank[0][i] + per_rank[1][i] for i in (0, 1)]
    from mxnet_tpu.ndarray import sparse as jsparse

    ref["rsp"] = {}
    for k in w.rsp_grads(0):
        kv = jmx.kv.create("local")
        kv.init(k, jmx.nd.zeros(w.RSP_SHAPE))
        kv.push(k, [jsparse.row_sparse_array(w.rsp_grads(r)[k],
                                             shape=w.RSP_SHAPE)
                    for r in (0, 1)])
        out = jmx.nd.zeros(w.RSP_SHAPE)
        kv.pull(k, out=out)
        ref["rsp"][k] = out.asnumpy()
        if k == "rsp":
            o = jsparse.zeros("row_sparse", w.RSP_SHAPE)
            kv.row_sparse_pull(k, out=o,
                               row_ids=jmx.nd.array(np.array([1.0, 3.0])))
            ref["rsp_pull"] = o.tostype("default").asnumpy()
    kv = jmx.kv.create("local")
    kv.set_optimizer(jmx.optimizer.SGD(rescale_grad=0.5, **w.SGD_STORE))
    kv.init("srv_w", jmx.nd.array(w.store_w0()))
    for step in range(3):
        kv.push("srv_w", [jmx.nd.array(w.store_grad(r, step))
                          for r in (0, 1)])
    out = jmx.nd.zeros((4, 3))
    kv.pull("srv_w", out=out)
    ref["store_opt"] = out.asnumpy()
    return ref


def _jax_module(sym, data_shape, args, auxs, opt, steps, x, y):
    mod = jmx.mod.Module(sym, context=jmx.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", (data_shape[0],))])
    mod.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                    aux_params={k: jmx.nd.array(v) for k, v in auxs.items()}
                    or None)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params=dict(opt))
    batch = jmx.io.DataBatch(data=[jmx.nd.array(x)],
                             label=[jmx.nd.array(y)])
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()},
            mod.get_outputs()[0].asnumpy())


def _jax_fused_refs():
    from mxnet_tpu.models import resnet as jresnet

    x, y = w.mlp_data()
    shape = (2 * w.LOCAL_BATCH, 12)
    args, _ = w.init_values(w.mlp_symbol(jmx), (w.LOCAL_BATCH, 12), seed=1)
    mlp = _jax_module(w.mlp_symbol(jmx), shape, args, {}, w.MLP_OPT,
                      w.STEPS, x, y)
    xs, ys = w.resnet_data()
    sym = jresnet.resnet(fused=True, **w.RESNET)
    args, auxs = w.init_values(sym, (w.LOCAL_BATCH, 3, 16, 16), seed=2)
    res = _jax_module(sym, (2 * w.LOCAL_BATCH, 3, 16, 16), args, auxs,
                      w.RESNET_OPT, w.RESNET_STEPS, xs, ys)
    return {"mlp": mlp, "resnet": res}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every subprocess of this file, started together first: the
    serverless plane, the SIGKILLed rank, the scheduler topology (one
    scheduler, two port servers with ZeRO value sharding, two workers, by
    ``python -m mxnet_tpu_torch.launch``), the 2-bit wire's gloo ranks, the
    server role shim and a worker that blocks in a barrier of a server in
    this process; then the JAX references, computed meanwhile."""
    import torch_dp_workers as dw
    from mxnet_tpu_torch import kvstore_server as tks

    dirs = {k: tmp_path_factory.mktemp(k) for k in ("plane", "kill",
                                                     "sched", "zero")}
    with tmx.cpu():
        srv = tks.KVStoreServer(num_workers=2, barrier_timeout=3.0,
                                device="cpu")
    srv.serve_in_background()
    procs = {
        "plane": _launch(["-n", "2", "-s", "0"], "plane", dirs["plane"]),
        "kill": _launch(["-n", "2", "-s", "0"], "kill", dirs["kill"]),
        "sched": _launch(["-n", "2", "-s", "2"], "sched", dirs["sched"],
                         module=True, MXNET_PS_SERVER_DEVICE="cpu",
                         MXNET_TPU_ZERO_SERVER="1",
                         MXNET_TPU_ZERO_MIN_SIZE="8"),
        "shim": subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.kvstore_server"],
            env=_clean_env(DMLC_ROLE="server"), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    barrier = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_dist_workers.py"),
         "barrier", srv.addr], env=_clean_env(), cwd=ROOT,
        stdout=subprocess.PIPE, text=True)
    zero = dw.start_ranks("torch_dist_workers:zero_wire_worker", 2,
                          dirs["zero"])
    try:
        ref = {"kv": _jax_kv_refs(), "zero": _jax_zero_wire()}
        with pytest.MonkeyPatch.context() as mp:
            if not hasattr(pltpu, "TPUCompilerParams"):
                mp.setattr(pltpu, "TPUCompilerParams",
                           pltpu.CompilerParams, raising=False)
            ref.update(_jax_fused_refs())
        done = {k: _finish(p) for k, p in procs.items()}
        done["zero"] = dw.join_ranks(zero, dirs["zero"], TIMEOUT)
        yield dirs, done, ref, (srv, barrier)
    finally:
        barrier.kill()
        barrier.stdout.close()
        srv.shutdown()


@pytest.fixture(scope="module")
def plane(jobs):
    dirs, done, ref, _barrier = jobs
    rc, out = done["plane"]
    assert rc == 0, out[-4000:]
    assert out.count("TORCH_DIST_OK plane") == 2, out[-4000:]
    return _load(dirs["plane"], "plane"), ref


# ---------------------------------------------------------------------------
# dist.py
# ---------------------------------------------------------------------------
ENVS = [
    {},
    {"MXNET_TPU_COORDINATOR": "h:1", "MXNET_TPU_NUM_WORKERS": "2",
     "MXNET_TPU_WORKER_RANK": "1"},
    {"DMLC_PS_ROOT_URI": "h2", "DMLC_PS_ROOT_PORT": "77",
     "DMLC_NUM_WORKER": "3", "DMLC_WORKER_ID": "2"},
    {"DMLC_PS_ROOT_URI": "h2", "DMLC_NUM_WORKER": "3", "DMLC_WORKER_ID": "0"},
    {"MXNET_TPU_COORDINATOR": "h:1", "DMLC_PS_ROOT_URI": "h2",
     "DMLC_PS_ROOT_PORT": "77", "DMLC_NUM_WORKER": "2",
     "MXNET_TPU_NUM_WORKERS": "4", "DMLC_WORKER_ID": "1"},
    # the scheduler topology: the root URI is the tracker's
    {"DMLC_PS_ROOT_URI": "h2", "DMLC_PS_ROOT_PORT": "77",
     "DMLC_NUM_SERVER": "2", "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "0"},
    {"MXNET_TPU_COORDINATOR": "h:1", "DMLC_NUM_SERVER": "2",
     "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "0"},
    {"MXNET_TPU_COORDINATOR": "h:1", "MXNET_TPU_NUM_WORKERS": "2"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_spec_matches_jax(env, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("DMLC_", "MXNET_TPU_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tdist.env_spec() == jdist.env_spec()
    if not env:
        assert tdist.env_spec() is None and not tdist.init_from_env()


def test_single_process_collectives_are_identities():
    x = np.arange(6.0).reshape(2, 3)
    assert tdist.num_workers() == 1 or not tdist.is_initialized()
    np.testing.assert_array_equal(tdist.allreduce(x), x)
    np.testing.assert_array_equal(tdist.allgather(x), x[None])
    assert tdist.broadcast0(x) is x
    assert tdist.get_num_dead_node() == 0 and tdist.exit_barrier()
    assert tdist.live_workers() == {0: True}


def test_host_collectives_on_two_gloo_ranks(plane):
    ranks, _ref = plane
    for r, res in enumerate(ranks):
        h = res["host"]
        assert res["backend"] == "gloo" and res["env"][1:] == (2, r)
        np.testing.assert_array_equal(h["sum"], [3.0, 2.0])
        np.testing.assert_array_equal(h["max"], [1, 0])
        np.testing.assert_array_equal(h["gather"], [[0, 0], [1, 10]])
        zero = w.host_inputs(0)
        # bit for bit rank 0's, every dtype
        assert h["b_i64"].dtype == np.int64
        np.testing.assert_array_equal(h["b_i64"], zero["i64"])
        assert h["b_f64"].tobytes() == zero["f64"].tobytes()
        assert h["b_bf16"].dtype == torch.bfloat16
        assert torch.equal(h["b_bf16"].view(torch.int16),
                           zero["bf16"].view(torch.int16))
        assert h["barrier"] and h["dead"] == 0


def test_dead_node_counted_after_sigkill(jobs):
    """Rank 1 SIGKILLs itself; rank 0's ``get_num_dead_node(timeout=2)``
    reaches 1 within the bound, and its bounded exit barrier fails."""
    dirs, done, _ref, _barrier = jobs
    rc, out = done["kill"]
    assert rc != 0, out[-4000:]   # the launcher reports the killed worker
    res = torch.load(str(dirs["kill"] / "kill-rank0.pt"), weights_only=False)
    assert res["before"] == 0, res
    assert res["dead"] == 1 and res["seconds"] < 10, res
    assert res["live"] == {0: True, 1: False}
    assert res["exit_barrier"] is False


# ---------------------------------------------------------------------------
# the dist_* stores (tests/dist_check.py's scenarios)
# ---------------------------------------------------------------------------
def test_dist_sync_two_workers(plane):
    ranks, ref = plane
    ref = ref["kv"]
    for r, res in enumerate(ranks):
        kv = res["kv"]
        assert (kv["rank"], kv["num_workers"], kv["type"]) == \
            (r, 2, "DistKVStore")
        np.testing.assert_array_equal(kv["dense"], ref["dense"])
        assert (kv["pending"], kv["pending_after"]) == (6, 0)
        for k, v in ref["batched"].items():
            np.testing.assert_array_equal(kv["batched"][k], v)
        # the reused buffer's push kept its snapshot (3 + 3 more)
        np.testing.assert_array_equal(kv["snapshot"], 2 * ref["dense"])
        assert len(kv["compressed"]) == 2
        for got, want in zip(kv["compressed"], ref["compressed"]):
            np.testing.assert_array_equal(got, want)
        assert kv["rsp_tag"] == "rsp"
        for k, v in ref["rsp"].items():
            np.testing.assert_array_equal(kv["rsp"][k], v, err_msg=k)
        np.testing.assert_array_equal(kv["rsp_pull"], ref["rsp_pull"])
        lazy, touched = kv["lazy"]
        want = np.ones(w.RSP_SHAPE, np.float32)
        want[:2] -= 0.1
        np.testing.assert_array_equal(lazy, want)
        assert touched == [[0, 1]]
        np.testing.assert_allclose(kv["store_opt"], ref["store_opt"],
                                   rtol=1e-6, atol=0)
        assert kv["dead"] == 0
    np.testing.assert_array_equal(ranks[0]["kv"]["store_opt"],
                                  ranks[1]["kv"]["store_opt"])


# ---------------------------------------------------------------------------
# 2-bit compression (tests/test_compression.py's cases on the port)
# ---------------------------------------------------------------------------
def _expected_2bit(arr, residual, threshold):
    a = arr + residual
    out = np.zeros_like(arr)
    out[a >= threshold] = threshold
    out[a <= -threshold] = -threshold
    return out, a - out


@pytest.fixture
def on_cpu():
    with tmx.cpu():
        yield


def test_quantize_golden_random(on_cpu):
    kv = tmx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    rng = np.random.RandomState(0)
    residual = np.zeros((8, 16), np.float32)
    kv.init("g", tmx.nd.zeros((8, 16)))
    captured = []
    kv._set_updater(lambda k, g, wt: captured.append(g.asnumpy()))
    for it in range(5):
        grad = rng.uniform(-1.2, 1.2, (8, 16)).astype(np.float32)
        expect, residual = _expected_2bit(grad, residual, 0.5)
        kv.push("g", tmx.nd.array(grad))
        np.testing.assert_allclose(captured[-1], expect, atol=1e-7,
                                   err_msg="iteration %d" % it)


def test_quantize_residual_accumulates_to_threshold(on_cpu):
    kv = tmx.kv.create("local")
    kv.set_gradient_compression({"type": "2bit", "threshold": 1.0})
    kv.init("w", tmx.nd.zeros((4,)))
    seen = []
    kv._set_updater(lambda k, g, wt: seen.append(g.asnumpy().copy()))
    for want in (0.0, 0.0, 1.0):
        kv.push("w", tmx.nd.array(np.full((4,), 0.4, np.float32)))
        assert np.all(seen[-1] == want), seen[-1]
    kv.push("w", tmx.nd.array(np.full((4,), -2.0, np.float32)))
    assert np.all(seen[-1] == -1.0)


def test_deferred_push_snapshots_gradient(on_cpu):
    """A single-process ``dist_sync`` store: the collective is the
    identity, the deferred push keeps a snapshot of the buffer."""
    kv = tmx.kv.create("dist_sync")
    kv.set_barrier_before_exit(False)
    kv.init("w", tmx.nd.zeros((4,)))
    g = tmx.nd.ones((4,)) * 3.0
    kv.push("w", g)
    g[:] = 0.0
    out = tmx.nd.zeros((4,))
    kv.pull("w", out=out)
    np.testing.assert_allclose(out.asnumpy(), 3.0)


def test_unsupported_compression_type_rejected(on_cpu):
    for mx in (tmx, jmx):
        with pytest.raises(mx.MXNetError, match="compression type"):
            mx.kv.create("local").set_gradient_compression({"type": "1bit"})


def test_two_bit_cores_and_compressed_push_match_jax_bit_for_bit(on_cpu):
    """The cores on fp32 and bf16 (values on and around the threshold),
    and the local store's compressed push over 5 rounds."""
    import jax.numpy as jnp
    from mxnet_tpu import kvstore as jkv
    from mxnet_tpu_torch import kvstore as tkv

    rng = np.random.RandomState(1)
    g = rng.uniform(-1.5, 1.5, (7, 9)).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 0.49999997, -0.50000006]
    res = rng.uniform(-0.3, 0.3, (7, 9)).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        gt, rt = (torch.from_numpy(a).to(tdt) for a in (g, res))
        gj, rj = (jnp.asarray(a).astype(jdt) for a in (g, res))
        tp, tq = tkv.two_bit_pack_core(gt + rt, 0.5)
        jp, jq = jkv.two_bit_pack_core(gj + rj, 0.5)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tq.dtype == tdt
        t_out = tkv.two_bit_round_trip_core(gt, rt, 0.5)
        j_out = jkv.two_bit_round_trip_core(gj, rj, 0.5)
        for a, b in zip(t_out, j_out):
            assert torch.equal(a.float(), torch.from_numpy(
                np.asarray(b.astype(jnp.float32)))), tdt
    got = {}
    for name, mx in (("port", tmx), ("jax", jmx)):
        kv = mx.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.4})
        kv.init("g", mx.nd.zeros((5, 6)))
        seen = []
        kv._set_updater(lambda k, gr, wt, s=seen: s.append(gr.asnumpy()))
        r = np.random.RandomState(2)
        for _ in range(5):
            kv.push("g", mx.nd.array(r.randn(5, 6).astype(np.float32)))
        got[name] = seen
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the fused dist_sync step and the feed
# ---------------------------------------------------------------------------
def test_fused_dist_sync_matches_single_process(plane):
    ranks, ref = plane
    jparams, _jaux, _out = ref["mlp"]
    for res in ranks:
        assert res["mlp"]["engaged"] == (True, True, ("dcn", "dp"), (2, 1))
    a, b = (r["mlp"]["params"] for r in ranks)
    # rank 1 started from other weights: rank 0's won, and the optimizer
    # states are the same bytes on both
    assert ranks[0]["mlp"]["states"] == ranks[1]["mlp"]["states"]
    assert sorted(a) == sorted(jparams)
    for k in jparams:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a[k], jparams[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    # each worker's outputs are its own rows of the global batch's
    out = np.concatenate([r["mlp"]["outputs"] for r in ranks])
    assert out.shape == (2 * w.LOCAL_BATCH, 3)


def _close_rel(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


def test_fused_dist_resnet_matches_single_process(plane):
    """The tiny fused ResNet (B1-B3's plain versions on the CPU; batch
    statistics over both workers) against the JAX single-process run of
    the global batch."""
    ranks, ref = plane
    jparams, jaux, _out = ref["resnet"]
    assert all(r["resnet"]["engaged"] for r in ranks)
    a, b = ranks[0]["resnet"], ranks[1]["resnet"]
    for part, want in (("params", jparams), ("aux", jaux)):
        assert sorted(a[part]) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=k)
            _close_rel(a[part][k], want[k], k)


def test_device_queue_distributed_places_local_rows(plane):
    ranks, _ref = plane
    x, _y = w.mlp_data()
    for r, res in enumerate(ranks):
        lo = r * w.LOCAL_BATCH
        placed = res["feed"]["placed"]
        np.testing.assert_array_equal(placed[0], x[lo:lo + 4])
        np.testing.assert_array_equal(placed[1], x[lo + 4:lo + 8])
        assert "changed mid-stream (4 -> 3)" in res["feed"]["error"]


def test_dist_types_rescale_as_jax(plane):
    """C23 with two real workers: 1/8 under dist_sync, 1/(8 * 2) under
    dist_async (which warns that its semantics are synchronous)."""
    ranks, _ref = plane
    for res in ranks:
        sync, asyn = res["rescale"]["dist_sync"], res["rescale"]["dist_async"]
        assert sync[0] == 1.0 / 8 and asyn[0] == 1.0 / 16
        assert any("synchronous semantics" in m for m in asyn[1])


# ---------------------------------------------------------------------------
# ZeRO's 2-bit wire
# ---------------------------------------------------------------------------
def _jax_zero_wire():
    import torch_dp_workers as dw
    from jax.sharding import Mesh
    from mxnet_tpu.parallel.spmd import TrainStep as JTrainStep

    out = {}
    for wire in ("raw", "2bit"):
        ts = JTrainStep(dw.zero_symbol(jmx), dict(w.ZERO_WIRE_OPT),
                        mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)),
                        zero=True, zero_min_size=16, zero_wire=wire)
        carry = ts.place(*ts.init_params(dw.ZERO_SHAPES, seed=3))
        losses = []
        for i in range(w.ZERO_WIRE_STEPS):
            carry, loss = ts(carry, dw.zero_batch(), jax.random.PRNGKey(i))
            losses.append(float(loss))
        out[wire] = losses
    return out


def test_zero_wire_2bit_quantizes_with_sharded_residual(jobs):
    _dirs, done, ref, _barrier = jobs
    ranks, ref = done["zero"], ref["zero"]
    for res in ranks:
        for wire in ("raw", "2bit"):
            np.testing.assert_allclose(res[wire]["losses"], ref[wire],
                                       rtol=1e-4, atol=1e-5, err_msg=wire)
        q, raw = res["2bit"], res["raw"]
        assert raw["residual"] is None
        assert set(q["residual"]) == set(q["plan"]) and q["plan"]
        for k, (_shape, _size, n, chunk) in q["plan"].items():
            assert n == 2 and tuple(q["residual"][k].shape) == (1, chunk)
        assert not np.allclose(raw["losses"][1:], q["losses"][1:])
        assert np.isfinite(q["losses"]).all()
        assert "__zero_wire_residual__" not in q["logical"]
        assert res["dropped"] is False
        assert set(res["restored"]) == set(q["plan"])
        assert all(v == 0.0 for v in res["restored"].values())
    # the residual rows differ by rank (each holds its own shard)
    k = sorted(ranks[0]["2bit"]["plan"])[0]
    assert not torch.equal(ranks[0]["2bit"]["residual"][k],
                           ranks[1]["2bit"]["residual"][k])


def test_fused_dist_step_refuses_mp_with_the_jax_message(monkeypatch):
    """``MXNET_MP_SIZE > 1`` under ``distributed=True`` is refused before
    any process group is made (the per-executor path trains instead, as
    in the JAX package)."""
    import torch.distributed as tdd

    from mxnet_tpu_torch.module.spmd_group import FusedSPMDGroup
    from mxnet_tpu_torch.parallel.spmd import FusedStepUnsupported

    monkeypatch.setenv("MXNET_MP_SIZE", "2")
    sym = w.mlp_symbol(tmx)
    opt = tmx.optimizer.SGD(learning_rate=0.1)
    with pytest.raises(FusedStepUnsupported,
                       match="MXNET_MP_SIZE=2 is single-process only"):
        FusedSPMDGroup(sym, [tmx.cpu()], opt, {}, {}, ["data"],
                       ["softmax_label"], distributed=True)
    assert not tdd.is_initialized()


def test_dist_sync_refused_under_scheduler_topology(monkeypatch):
    """``dist_sync`` under ``-s > 0`` raises the JAX package's message (its
    workers would train unsynchronized copies)."""
    for k in list(os.environ):
        if k.startswith(("DMLC_", "MXNET_TPU_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9")
    monkeypatch.setenv("DMLC_NUM_SERVER", "1")
    msgs = []
    for mx in (tmx, jmx):
        with pytest.raises(mx.MXNetError, match="scheduler topology") as e:
            mx.kv.create("dist_sync")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_zero_knob_validation(monkeypatch):
    from mxnet_tpu_torch.models import resnet as tresnet
    from mxnet_tpu_torch.parallel import TrainStep

    sym = tresnet.resnet(fused=True, **w.RESNET)
    opt = dict(name="sgd")
    for knob, bad in [("MXNET_TPU_ZERO", "banana"),
                      ("MXNET_TPU_ZERO_WIRE", "3bit"),
                      ("MXNET_TPU_ZERO_MIN_SIZE", "-4"),
                      ("MXNET_TPU_ZERO_WIRE_THRESHOLD", "nope")]:
        monkeypatch.setenv(knob, bad)
        with pytest.raises(MXNetError, match=knob):
            TrainStep(sym, opt, device="cpu")
        monkeypatch.delenv(knob)
    with pytest.raises(MXNetError, match="zero_wire"):
        TrainStep(sym, opt, device="cpu", zero_wire="3bit")
    from mxnet_tpu_torch import config

    for knob in ("MXNET_TPU_ZERO", "MXNET_TPU_ZERO_WIRE",
                 "MXNET_TPU_ZERO_WIRE_THRESHOLD",
                 "MXNET_TPU_ZERO_MIN_SIZE", "MXNET_TPU_ZERO_SERVER"):
        assert knob in config.KNOBS


# ---------------------------------------------------------------------------
# the launchers and the scheduler topology
# ---------------------------------------------------------------------------
def _port_manual(args):
    from mxnet_tpu_torch import launch

    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["launch.py"] + args
    try:
        with contextlib.redirect_stdout(buf):
            assert launch.main() == 0
    finally:
        sys.argv = argv
    return buf.getvalue()


@pytest.mark.parametrize("args", [
    ["-n", "4"], ["-n", "2", "-s", "1"],
    ["-n", "2", "-s", "2", "--max-restarts", "1", "--checkpoint-dir", "/ck",
     "--env", "A=1"], ["--serve", "-n", "3"]], ids=range(4))
def test_launch_manual_mode(args, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("DMLC_", "MXNET_TPU_", "MXNET_CHECKPOINT")):
            monkeypatch.delenv(k)
    full = args + ["--launcher", "manual", "--coordinator", "h0:9999",
                   "python", "train.py"]
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py")] + full,
        capture_output=True, text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr
    got = _port_manual(full)
    assert got == ref.stdout.replace("mxnet_tpu.", "mxnet_tpu_torch.")
    if "-s" not in args and "--serve" not in args:
        assert "MXNET_TPU_COORDINATOR=h0:9999" in got
        assert "DMLC_NUM_WORKER=4" in got


def test_kvstore_server_role_shim(jobs):
    """``python -m mxnet_tpu_torch.kvstore_server`` under DMLC_ROLE=server
    without the opt-in exits 0."""
    rc, out = jobs[1]["shim"]
    assert rc == 0 and "listening" not in out, out[-2000:]


def test_launch_dist_async_end_to_end(jobs):
    """One scheduler, two port servers (ZeRO value sharding on) and two
    workers by ``python -m mxnet_tpu_torch.launch``: no server URI in the
    environment; ``dist_sync`` is refused with the JAX message;
    ``Module.fit(kvstore=dist_async)`` from the rendezvous lowers each
    worker's loss, and one more key takes both workers' pushes under the
    servers' SGD."""
    dirs, done, _ref, _barrier = jobs
    rc, out = done["sched"]
    assert rc == 0, out[-4000:]
    ranks = _load(dirs["sched"], "sched")
    w0 = w.store_w0()
    lr = 0.1 / (w.FIT_BATCH * 2)
    want = w0 - lr * w.store_grad(0, 0) - lr * w.store_grad(1, 0)
    for res in ranks:
        assert "scheduler topology" in res["refused"]
        assert (res["type"], res["servers"]) == ("ServerKVStore", 2)
        np.testing.assert_allclose(res["w"], want, rtol=1e-6, atol=1e-6)
        assert res["zero_keys"] and res["fit"][1] < res["fit"][0], res
    assert sorted(r["rank"] for r in ranks) == [0, 1]


def test_killed_worker_mid_barrier_raises_on_survivor(jobs):
    """A port worker SIGKILLed inside a barrier: the survivor's barrier
    raises within the timeout."""
    from mxnet_tpu_torch import kvstore_server as tks

    srv, proc = jobs[3]
    line = proc.stdout.readline()
    assert "IN_BARRIER" in line, line
    time.sleep(0.3)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    time.sleep(0.6)   # the server's liveness probe aborts the round
    with tmx.cpu():
        survivor = tks.ServerKVStore(srv.addr)
        t0 = time.monotonic()
        with pytest.raises(MXNetError, match="barrier (aborted|timed out)"):
            survivor.barrier()
        assert time.monotonic() - t0 < 30
        survivor.close()


def test_no_port_file_cites_item_10c():
    """Item 10c is ported: no file of the port, and not chip_smoke.py,
    refuses anything citing it."""
    hits = []
    for base in ("mxnet_tpu_torch", "chip_smoke.py"):
        path = os.path.join(ROOT, base)
        files = [path] if path.endswith(".py") else [
            os.path.join(d, f) for d, _s, fs in os.walk(path) for f in fs
            if f.endswith(".py")]
        for f in files:
            with open(f) as fh:
                if re.search(r"item 10c|_ITEM10C", fh.read()):
                    hits.append(os.path.relpath(f, ROOT))
    assert not hits, hits


@pytest.mark.slow
def test_recommender_e2e_two_workers_two_servers(tmp_path):
    """``tests/test_embedding.py``'s acceptance on the port: the
    recommender (two tables row-sharded over the servers, records leased
    from the tracker) trains to a lower loss on every worker of
    ``python -m mxnet_tpu_torch.launch -n 2 -s 2``."""
    rc, out = _finish(_launch(["-n", "2", "-s", "2"], "recsys", tmp_path,
                              module=True, MXNET_PS_SERVER_DEVICE="cpu"),
                      timeout=200)
    assert rc == 0, out[-3000:]
    losses = re.findall(r"worker (\d+) loss ([\d.]+) -> ([\d.]+)", out)
    assert sorted(r for r, _a, _b in losses) == ["0", "1"], out[-3000:]
    for _rank, l0, l1 in losses:
        assert float(l1) < float(l0), out[-2000:]
