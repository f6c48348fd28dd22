"""Self-healing training in the port (``health.py``, the chaos worker,
server and rpc hooks, the server tier's rollback) against the JAX
package, on the CPU.

- ``tests/test_self_healing.py``'s cases: the three chaos-engine cases
  (a nan rule fires once for the round about to run, a preempt rule
  signals at its step, the restart gate), the fused tier's NaN skip and
  halt on the fused MLP that both packages train with
  ``Module.fit(kvstore='tpu')``, the seven guard cases (the rollback with
  its lr backoff, the budget, no checkpoint, the spike EMA, the
  preemption's checkpoint and exit 75, ``from_env`` and the knobs), and
  the server rollback's two cases. Each compares with the JAX run of the
  same scenario (``tests/torch_health_workers.py``): weights after the
  rollback, the lr after the backoff, the sentinel's counters, rollback
  counts and error messages.
- The guard inside ``fit``: ``MXNET_CHECKPOINT_DIR`` armed,
  ``callback.elastic_checkpoint`` committing each epoch on a local
  kvstore, ``worker:0:nan@step=5`` poisoning a step: one rollback, the
  weights right after it bit for bit the checkpoint's, as in the JAX run.
- Preemption by a real SIGTERM (``worker:0:preempt@step=4``) in a child
  process with ``DMLC_ROLE=worker``, never in pytest's own: it exits 75
  inside the grace window with a checkpoint naming its epoch and batch,
  as the JAX guard's in-process preemption does; a second child
  (``DMLC_RESTART_COUNT=1``) resumes from ``latest()`` with
  ``begin_epoch`` and finishes, starting from the checkpoint's weights bit
  for bit.

The port's fused runs are children (``python tests/torch_health_workers.py
<mode>``), started before the JAX runs in this process. Tolerance: rtol
1e-5 and atol 1e-6 (fp32, summation order over 8 CPU devices against one
rank); counters, counts, learning rates and messages exact.
"""
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import chaos as jchaos
from mxnet_tpu import health as jhealth
from mxnet_tpu_torch import chaos as tchaos
from mxnet_tpu_torch import health as thealth
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager

import torch_health_workers as hw

RTOL, ATOL = 1e-5, 1e-6
CHILD_TIMEOUT = 240
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _child(mode, out, **env):
    full = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]), **env)
    for k in hw._KNOBS:
        full.pop(k, None)
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_health_workers.py"),
         mode, str(out)], env=full, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _wait(proc, what):
    try:
        text, _ = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("%s did not finish within %d s"
                             % (what, CHILD_TIMEOUT))
    return proc.returncode, text


def _jax_preempt(directory):
    """The JAX guard's preemption at the same step, in this process: the
    chaos rule's signal becomes ``request_preemption`` (no signal reaches
    pytest)."""
    P = hw.package("jax")
    guards = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jhealth.HealthGuard, "install_preemption_handler",
               lambda self: guards.append(self))
    mp.setattr(jchaos.ChaosEngine, "_preempt",
               lambda self, rule: guards[-1].request_preemption())
    try:
        with pytest.raises(SystemExit) as exc:
            hw.preempt_fit(P, directory)
    finally:
        mp.undo()
    return exc.value.code


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("health")
    t0 = time.monotonic()
    os.makedirs(out / "port")
    os.makedirs(out / "pre")
    scen = _child("scenarios", out / "port")
    pre = _child("preempt", out / "pre", DMLC_ROLE="worker",
                 DMLC_RESTART_COUNT="0")
    jax = hw.scenarios(hw.package("jax"), str(out / "jax"))
    jax["preempt_code"] = _jax_preempt(str(out / "jax_pre"))
    jax["preempt_ckpt"] = CheckpointManager(str(out / "jax_pre")).latest()
    rc, text = _wait(pre, "the preempted child")
    port = {"preempt_rc": rc, "preempt_log": text,
            "preempt_seconds": time.monotonic() - t0,
            "preempt_ckpt": CheckpointManager(str(out / "pre" /
                                                  "ckpt")).latest()}
    res = _child("resume", out / "pre", DMLC_ROLE="worker",
                 DMLC_RESTART_COUNT="1")
    for proc, name in ((scen, "scenarios"), (res, "resume")):
        rc, text = _wait(proc, "the %s child" % name)
        assert rc == 0, text[-4000:]
        path = out / ("port" if name == "scenarios" else "pre") / (
            name + ".pkl")
        with open(path, "rb") as f:
            port[name] = pickle.load(f)
    return port, jax


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg="%s %s" % (what, k))


def _same(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg="%s %s" % (what, k))


def _snap_equal(got, want):
    """The sentinel's counters exactly, its last loss to the tolerance."""
    assert {k: v for k, v in got.items() if k != "last_loss"} == \
        {k: v for k, v in want.items() if k != "last_loss"}
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the chaos engine (tests/test_self_healing.py:153-176)
# ---------------------------------------------------------------------------
def _engines(spec, restart=0):
    return [m.ChaosEngine(spec, role="worker", rank=0, restart=restart)
            for m in (tchaos, jchaos)]


def test_chaos_nan_fires_once_for_the_upcoming_round():
    fired = []
    for eng in _engines("worker:0:nan@step=3"):
        seq = []
        for _round in range(5):
            seq.append(eng.nan())   # callers poison before tick_step()
            eng.step()
        fired.append(seq)
    assert fired[0] == fired[1] == [False, False, True, False, False]


def test_chaos_preempt_sigterms_self_at_step():
    got = []
    for eng in _engines("worker:0:preempt@step=2"):
        kills = []
        eng._kill = lambda kills=kills: kills.append(True)
        seq = []
        for _ in range(3):
            eng.step()
            seq.append(len(kills))
        got.append(seq)
    assert got[0] == got[1] == [0, 1, 1]    # at step 2, once


def test_chaos_preempt_restart_gated():
    for eng in _engines("worker:0:preempt@step=1", restart=1):
        kills = []
        eng._kill = lambda: kills.append(True)
        eng.step()
        assert not kills  # the default restart=0: no second fire


@pytest.mark.parametrize("spec,role,rank,restart", [
    ("worker:0:crash@step=3", "worker", 0, 0),
    ("worker:1:crash@step=2,restart=1", "worker", 1, 1),
    ("worker:0:crash@step=2", "worker", 0, 1),        # restart-gated
    ("server:0:crash@step=4", "server", 0, 0),
    ("server:1:preempt@step=2", "server", 1, 0),
    ("server:1:preempt@step=2", "worker", 1, 0),      # another role
    ("worker:0:nan@step=2;worker:0:preempt@step=3", "worker", 0, 0),
])
def test_step_rules_fire_at_the_same_step_as_jax(spec, role, rank, restart):
    """The worker and server step rules (crash, nan, preempt) fire at the
    same step, once, for the same role, rank and incarnation, in both
    packages' engines (the crash's exit and the preemption's signal
    injected)."""
    traces = []
    for mod in (tchaos, jchaos):
        eng = mod.ChaosEngine(spec, role=role, rank=rank, restart=restart)
        trace = []
        eng._exit = lambda code, trace=trace: trace.append(("exit", code))
        eng._kill = lambda trace=trace: trace.append(("kill",))
        for step in range(1, 6):
            if eng.nan():
                trace.append(("nan", step))
            eng.step()
            trace.append(step)
        traces.append(trace)
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------------
# the fused tier (tests/test_self_healing.py:209, :223)
# ---------------------------------------------------------------------------
def test_fused_nan_injection_heals_via_skip(runs):
    port, jax = runs
    got, want = port["scenarios"]["nan_skip"], jax["nan_skip"]
    _snap_equal(got["snap"], want["snap"])
    s = got["snap"]
    assert (s["skipped"], s["unhealthy"], s["nonfinite_grad"],
            s["consec"]) == (1, 1, 1, 0)
    assert got["profiler"]["sentinel"]["skipped"] == 1
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-6)
    assert got["acc"] > 0.7
    _close(got["params"], want["params"], "params")


def test_fused_halt_mode_fails_fast(runs):
    port, jax = runs
    got, want = port["scenarios"]["halt"], jax["halt"]
    assert got is not None and got.startswith("sentinel halt")
    assert got.split("last_loss")[0] == want.split("last_loss")[0]


# ---------------------------------------------------------------------------
# the guard (tests/test_self_healing.py:264-346)
# ---------------------------------------------------------------------------
def test_guard_rolls_back_with_lr_backoff(runs):
    port, jax = runs
    got, want = port["scenarios"]["guard"], jax["guard"]
    _snap_equal(got["poisoned_snap"], want["poisoned_snap"])
    rb, jrb = got["rollback"], want["rollback"]
    assert rb["count"] == jrb["count"] == 1
    assert rb["lr"] == jrb["lr"] == (0.1, 0.05)
    assert rb["profiler"] == jrb["profiler"] == 1
    # the port's weights after the rollback are its checkpoint's, bit for
    # bit; the checkpoint is the JAX one to the tolerance
    _same(rb["params"], {k[4:]: v for k, v in rb["ckpt"].items()
                         if k.startswith("arg:")}, "rollback")
    _close(rb["ckpt"], jrb["ckpt"], "checkpoint")
    _close(rb["params"], jrb["params"], "rollback")
    # the rebuilt step trains healthily, its counters restarted
    _snap_equal(got["after"]["snap"], want["after"]["snap"])
    assert got["after"]["snap"]["unhealthy"] == 0
    assert got["after"]["snap"]["healthy"] == 1
    _close(got["after"]["params"], want["after"]["params"], "after")


def test_guard_budget_exhaustion_fails_loudly(runs):
    port, jax = runs
    got, want = port["scenarios"]["guard"]["budget"], jax["guard"]["budget"]
    assert "rollback budget (0) is exhausted" in got
    assert got == want


def test_guard_without_checkpoint_raises_not_loops(runs):
    port, jax = runs
    got = port["scenarios"]["guard"]["no_checkpoint"]
    want = jax["guard"]["no_checkpoint"]
    assert "no committed checkpoint" in got
    assert got.split("roll back to (")[0] == want.split("roll back to (")[0]


def test_guard_spike_detection(runs):
    port, jax = runs
    got, want = port["scenarios"]["guard"]["spike"], jax["guard"]["spike"]
    # 50 > 5 x EMA(1.0) after the warm-up; 1.2 is a normal fluctuation
    assert got == want == [False] * 5 + [True, False, True]


def test_guard_preemption_checkpoint_and_exit(runs):
    port, jax = runs
    got, want = port["scenarios"]["guard"], jax["guard"]
    assert got["preempt_code"] == want["preempt_code"] == \
        thealth.EXIT_PREEMPTED == 75
    p, jp = got["preempt"], want["preempt"]
    assert (p["epoch"], p["preempted"], p["nbatch"], p["states"],
            p["profiler"]) == (jp["epoch"], jp["preempted"], jp["nbatch"],
                               jp["states"], jp["profiler"]) == \
        (3, True, 5, True, 1)
    _close(p["weights"], jp["weights"], "preemption checkpoint")
    assert all(np.isfinite(v).all() for v in p["weights"].values())


def test_guard_from_env_arming(monkeypatch, tmp_path):
    for mx, H in ((tmx, thealth.HealthGuard),
                  (jmx, jhealth.HealthGuard)):
        mod = object.__new__(mx.mod.Module)  # never touched when disarmed
        monkeypatch.delenv("MXNET_CHECKPOINT_DIR", raising=False)
        monkeypatch.delenv("MXNET_TPU_GUARD", raising=False)
        assert H.from_env(mod) is None
        monkeypatch.setenv("MXNET_CHECKPOINT_DIR", str(tmp_path / "c"))
        guard = H.from_env(mod)
        assert guard is not None and guard.manager is not None
        # the JAX defaults
        assert (guard.consec, guard.spike, guard.backoff, guard.budget,
                guard.interval, guard.grace) == (3, 10.0, 0.5, 2, 10, 15.0)
        monkeypatch.setenv("MXNET_TPU_GUARD", "0")
        assert H.from_env(mod) is None
        monkeypatch.setenv("MXNET_TPU_GUARD", "banana")
        with pytest.raises(Exception, match="MXNET_TPU_GUARD"):
            H.from_env(mod)


@pytest.mark.parametrize("knob,bad", [
    ("MXNET_TPU_GUARD_CONSEC", "0"), ("MXNET_TPU_GUARD_SPIKE", "-1"),
    ("MXNET_TPU_GUARD_BACKOFF", "2.0"), ("MXNET_TPU_GUARD_BUDGET", "-3"),
    ("MXNET_TPU_GUARD_INTERVAL", "zero"), ("MXNET_PREEMPT_GRACE", "0")])
def test_guard_knob_validation(monkeypatch, tmp_path, knob, bad):
    """A malformed knob raises naming it, in both packages."""
    monkeypatch.setenv(knob, bad)
    for mx, H in ((tmx, thealth.HealthGuard),
                  (jmx, jhealth.HealthGuard)):
        mod = object.__new__(mx.mod.Module)
        with pytest.raises(Exception, match=knob):
            H(mod, manager=CheckpointManager(str(tmp_path)))


# ---------------------------------------------------------------------------
# the guard inside fit, and preemption by a signal
# ---------------------------------------------------------------------------
def test_guarded_fit_rolls_back_inside_fit(runs):
    """One rollback at the poisoned step (epoch 1, batch 1): the weights
    and aux right after it are the epoch-1 checkpoint's bit for bit, the
    lr is 0.1 x the backoff, the sentinel restarted; the JAX run agrees,
    and both commit epochs 1 and 2."""
    port, jax = runs
    got, want = port["scenarios"]["guarded_fit"], jax["guarded_fit"]
    assert got["rollbacks"] == want["rollbacks"] == 1
    at, jat = got["at"], want["at"]
    assert (at["epoch"], at["nbatch"], at["ckpt_epoch"]) == \
        (jat["epoch"], jat["nbatch"], jat["ckpt_epoch"]) == (1, 1, 1)
    _same(at["params"], {k[4:]: v for k, v in at["ckpt"].items()
                         if k.startswith("arg:")}, "after rollback")
    assert at["lr"] == jat["lr"] == pytest.approx(0.1 * 0.5)
    _snap_equal(at["snap"], jat["snap"])
    _close(at["ckpt"], jat["ckpt"], "epoch-1 checkpoint")
    _close(got["final"], want["final"], "final")
    _snap_equal(got["snap"], want["snap"])
    assert got["lr"] == want["lr"]
    assert got["committed"] == want["committed"] == [
        "ckpt-00000001", "ckpt-00000002"]
    assert (got["latest"], got["worker"]["epoch"], got["worker"]["nbatch"]) \
        == (want["latest"], want["worker"]["epoch"],
            want["worker"]["nbatch"]) == (2, 2, 0)


def test_preemption_exits_75_in_a_child_and_resumes(runs):
    """The SIGTERM of ``worker:0:preempt@step=4`` in a ``DMLC_ROLE=worker``
    child: exit 75 inside ``MXNET_PREEMPT_GRACE`` (30 s), its checkpoint
    names epoch 1 and batch 0 and holds the JAX guard's weights at the
    same step; the next incarnation resumes from it and finishes."""
    port, jax = runs
    assert port["preempt_rc"] == jax["preempt_code"] == 75, \
        port["preempt_log"][-4000:]
    line = re.search(r"\[health\] event=preempted epoch=(\d+) nbatch=(\d+) "
                     r"checkpoint=True elapsed=([\d.]+)s exit=75",
                     port["preempt_log"])
    assert line, port["preempt_log"][-4000:]
    assert (int(line.group(1)), int(line.group(2))) == (1, 0)
    assert float(line.group(3)) < 30.0
    assert "preemption signal received" in port["preempt_log"]
    ck, jck = port["preempt_ckpt"], jax["preempt_ckpt"]
    state, jstate = ck.worker_state(0), jck.worker_state(0)
    assert (ck.epoch, state["epoch"], state["nbatch"], state["preempted"]) \
        == (jck.epoch, jstate["epoch"], jstate["nbatch"],
            jstate["preempted"]) == (1, 1, 0, True)
    _close(ck.weights(), jck.weights(), "preemption checkpoint")
    res = port["resume"]
    assert res["ckpt_epoch"] == 1 and res["epochs"] == [1]
    _same(res["start"], res["ckpt"], "resumed start")
    assert all(np.isfinite(v).all() for v in res["final"].values())


# ---------------------------------------------------------------------------
# the server rollback (tests/test_self_healing.py:363, :423)
# ---------------------------------------------------------------------------
def _server_rollback(pkg, ckdir):
    """The JAX test's sequence on one package's server and client."""
    if pkg == "port":
        from mxnet_tpu_torch.checkpoint import CheckpointManager as M
        from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore
        srv = KVStoreServer(num_workers=1, device="cpu")
    else:
        from mxnet_tpu.checkpoint import CheckpointManager as M
        from mxnet_tpu.kvstore_server import KVStoreServer, ServerKVStore
        srv = KVStoreServer(num_workers=1)
    srv.serve_in_background()
    kv = ServerKVStore(srv.addr)
    out = {}
    try:
        kv.init("w", np.arange(20, dtype=np.float32))
        kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
        kv.push("w", np.ones(20, np.float32))
        good = np.empty(20, np.float32)
        kv.pull("w", out=good)
        mgr = M(ckdir)
        mgr.begin(1)
        mgr.write_worker_state(1, 0, {"epoch": 1})
        kv.save_optimizer_states(mgr.staged_optimizer_states_path(1))
        mgr.commit(1, weights={"arg:w": good.copy()},
                   optimizer_config=kv.get_optimizer_config(),
                   num_workers=1)
        kv.push("w", np.full(20, np.nan, np.float32))   # the silent fault
        poisoned = np.empty(20, np.float32)
        kv.pull("w", out=poisoned)
        out["poisoned"] = not np.isfinite(poisoned).all()
        out["first"] = kv.rollback_servers(lr_scale=0.5, gen=1)
        out["replay"] = kv.rollback_servers(lr_scale=0.5, gen=1)
        out["config"] = kv.get_optimizer_config()
        restored = np.empty(20, np.float32)
        kv.pull("w", out=restored)
        out["restored"] = np.array_equal(restored, good)
        kv.set_optimizer("sgd", learning_rate=0.1, momentum=0.9)
        out["conflict"] = hw._error(lambda: kv.set_optimizer(
            "sgd", learning_rate=0.1, momentum=0.5))
        out["second"] = kv.rollback_servers(lr_scale=0.5, gen=2)
        out["raise"] = hw._error(lambda: kv.rollback_servers(lr_scale=1.5,
                                                          gen=3))
        kv.push("w", np.ones(20, np.float32))
        after = np.empty(20, np.float32)
        kv.pull("w", out=after)
        out["after"] = after
    finally:
        kv.stop_server()
        kv.close()
    return out


def test_server_rollback_restores_shard_and_backs_off_lr(monkeypatch,
                                                         tmp_path):
    """The restore, the generation-deduped backoff, the recorded config,
    the conflict check and the refused raising scale, step by step as
    the JAX server does; the momentum restored from the checkpoint drives
    the next push alike."""
    runs_ = {}
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        monkeypatch.setenv("MXNET_CHECKPOINT_DIR", d)
        runs_[pkg] = _server_rollback(pkg, d)
    got, want = runs_["port"], runs_["jax"]
    assert got["poisoned"] and got["restored"]
    assert got["first"] == want["first"]
    assert got["first"]["keys"] == 1 and got["first"]["epoch"] == 1
    assert got["first"]["lr"] == pytest.approx(0.05)
    assert got["replay"] == want["replay"] and got["replay"]["lr"] is None
    assert got["config"] == want["config"]
    assert got["config"][1]["learning_rate"] == pytest.approx(0.05)
    assert "conflicting" in got["conflict"]
    assert got["second"] == want["second"]
    assert got["second"]["lr"] == pytest.approx(0.025)
    assert "lr_scale" in got["raise"] and "lr_scale" in want["raise"]
    np.testing.assert_allclose(got["after"], want["after"], rtol=RTOL,
                               atol=ATOL)


def test_server_rollback_without_checkpoint_dir_errors(monkeypatch):
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore

    monkeypatch.delenv("MXNET_CHECKPOINT_DIR", raising=False)
    srv = KVStoreServer(num_workers=1, device="cpu")
    srv.serve_in_background()
    kv = ServerKVStore(srv.addr)
    try:
        with pytest.raises(MXNetError, match="MXNET_CHECKPOINT_DIR"):
            kv.rollback_servers(lr_scale=0.5)
    finally:
        kv.stop_server()
        kv.close()


def test_rollback_counts_ride_the_profiler():
    """``healthStats`` of the port's profiler: the guard's counters land
    where the JAX package's land."""
    tprofiler.health_reset()
    tprofiler.health_record(rollbacks=1)
    tprofiler.health_record(rollbacks=1, preemptions=1)
    assert tprofiler.health_stats(reset=True) == {"rollbacks": 2,
                                                  "preemptions": 1}
    assert tprofiler.health_stats() == {}
