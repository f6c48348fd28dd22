"""Self-healing scenarios run alike by both packages
(``tests/test_torch_self_healing.py``).

Every scenario takes a package handle ``P`` (``P.mx``, ``P.chaos``,
``P.health``, ``P.checkpoint``, ``P.profiler``) and returns plain numpy
results. The test runs each with the JAX package in its own process and
with the port in a child process (``python tests/torch_health_workers.py
<mode> <out dir>``), so this module imports neither package itself and
the child imports no JAX. Inputs and starting weights come from numpy
seeds: the fused MLP of ``tests/test_self_healing.py`` (one
``FullyConnected`` to 10 classes and ``SoftmaxOutput``), trained by
``Module.fit(kvstore='tpu')`` under sgd with momentum.

Modes of the child: ``scenarios`` (all the in-process ones, pickled to
``<out dir>/scenarios.pkl``), ``preempt`` (a guarded fit with
``DMLC_ROLE=worker`` that ``worker:0:preempt@step=4`` stops: exit 75) and
``resume`` (the next incarnation: it restarts from ``latest()`` and
finishes, ``resume.pkl``).
"""
import contextlib
import os
import pickle
import sys
import types

import numpy as np

DIM, CLASSES, BATCH = 16, 10, 32
OPT = {"learning_rate": 0.1, "momentum": 0.9}
GUARD_ENV = {"MXNET_TPU_SENTINEL": "record", "MXNET_TPU_GUARD_CONSEC": "1",
             "MXNET_TPU_GUARD_INTERVAL": "1"}
GUARDED_FAULT = "worker:0:nan@step=5"       # epoch 1, batch 1
PREEMPT_FAULT = "worker:0:preempt@step=4"   # epoch 1, batch 0
EPOCHS, BATCHES = 2, 3
_KNOBS = ("MXNET_TPU_SENTINEL", "MXNET_FAULT_SPEC", "MXNET_CHECKPOINT_DIR",
          "MXNET_TPU_GUARD_CONSEC", "MXNET_TPU_GUARD_INTERVAL",
          "MXNET_PREEMPT_GRACE")


def package(which):
    """The handle of ``"port"`` (or of ``"jax"``, for the test's own
    process)."""
    import importlib

    root = {"port": "mxnet_tpu_torch", "jax": "mxnet_tpu"}[which]
    mods = {n: importlib.import_module("%s.%s" % (root, n))
            for n in ("chaos", "health", "checkpoint", "profiler")}
    return types.SimpleNamespace(mx=importlib.import_module(root), **mods)


@contextlib.contextmanager
def knobs(P, **env):
    """The knobs set as given (the others of ``_KNOBS`` unset) for the
    block; the chaos engine and the health counters start afresh."""
    old = {k: os.environ.get(k) for k in _KNOBS}
    for k in _KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    P.chaos.reset_engine()
    P.profiler.health_reset()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        P.chaos.reset_engine()


def data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, DIM).astype(np.float32)
    y = rng.randint(0, CLASSES, (n,))
    x[np.arange(n), y] += 3.0
    return x, y.astype(np.float32)


def start_params(seed=7):
    rng = np.random.RandomState(seed)
    return {"fc_weight": (rng.randn(CLASSES, DIM) * 0.1).astype(np.float32),
            "fc_bias": np.zeros(CLASSES, np.float32)}


def _symbol(mx):
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=CLASSES,
                              name="fc"), name="softmax")


def _iter(mx, n, seed=0):
    x, y = data(n, seed)
    return mx.io.NDArrayIter(x, y, batch_size=BATCH,
                             label_name="softmax_label")


def _np(d):
    return {k: np.array(v.asnumpy()) for k, v in d.items()}


def fit(P, n, num_epoch, module=None, **kw):
    mx = P.mx
    mod = module or mx.mod.Module(_symbol(mx), context=mx.cpu(0))
    with mx.cpu():
        mod.fit(_iter(mx, n), num_epoch=num_epoch, kvstore="tpu",
                optimizer="sgd", optimizer_params=dict(OPT),
                arg_params={k: mx.nd.array(v) for k, v in
                            start_params().items()}, **kw)
    return mod


def _batch(P, seed, poison=False):
    mx = P.mx
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, DIM).astype(np.float32)
    if poison:
        x = x * np.float32("nan")
    y = rng.randint(0, CLASSES, (BATCH,)).astype(np.float32)
    with mx.cpu():
        return mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)])


def _step(P, mod, seed, poison=False):
    mod.forward_backward(_batch(P, seed, poison))
    mod.update()


# ---------------------------------------------------------------------------
# the scenarios of tests/test_self_healing.py
# ---------------------------------------------------------------------------
def nan_skip(P):
    """``worker:0:nan@step=3`` under ``sentinel=skip`` on 2 epochs of 8
    batches: the step is skipped in the step, the counters, accuracy."""
    with knobs(P, MXNET_TPU_SENTINEL="skip",
               MXNET_FAULT_SPEC="worker:0:nan@step=3"):
        mod = fit(P, 256, 2)
        snap = mod._fused.health_stats()
        with P.mx.cpu():
            acc = dict(mod.score(_iter(P.mx, 256),
                                 P.mx.metric.Accuracy()))["accuracy"]
        return {"snap": snap, "acc": acc, "params": _np(mod.get_params()[0]),
                "profiler": P.profiler.health_stats()}


def halt(P):
    """``worker:0:nan@step=2`` under ``sentinel=halt``: fit raises."""
    with knobs(P, MXNET_TPU_SENTINEL="halt",
               MXNET_FAULT_SPEC="worker:0:nan@step=2"):
        try:
            fit(P, 128, 1)
        except P.mx.base.MXNetError as e:
            return str(e)
    return None


def _checkpointed(P, directory):
    """A fused module one epoch in (sentinel record) and a committed
    checkpoint of it."""
    mod = fit(P, BATCH * BATCHES, 1)
    mgr = P.checkpoint.CheckpointManager(directory)
    arg, aux = mod.get_params()
    weights = {"arg:%s" % k: v.asnumpy() for k, v in arg.items()}
    weights.update({"aux:%s" % k: v.asnumpy() for k, v in aux.items()})
    mgr.begin(1)
    mgr.write_worker_state(1, 0, {"epoch": 1})
    mod.save_optimizer_states(mgr.staged_optimizer_states_path(1))
    mgr.commit(1, weights=weights)
    return mod, mgr


def _error(fn):
    try:
        fn()
    except Exception as e:
        return "%s: %s" % (type(e).__name__, e)
    return None


def guard_cases(P, directory):
    """The guard on a checkpointed fused module: a rollback with the lr
    backoff (weights, lr, counters, the healthy step after), the budget
    exhausted, no checkpoint to roll back to, the spike EMA and the
    in-process preemption's checkpoint."""
    H = P.health.HealthGuard
    out = {}
    with knobs(P, MXNET_TPU_SENTINEL="record"):
        mod, mgr = _checkpointed(P, os.path.join(directory, "rb"))
        ckpt = {k: np.array(v) for k, v in mgr.latest().weights().items()}
        _step(P, mod, 11, poison=True)   # record lets the NaN update land
        out["poisoned_snap"] = mod._fused.health_stats()
        guard = H(mod, manager=mgr, consec=1, interval=1, budget=2, spike=0)
        lr0 = mod._optimizer.lr
        guard.on_batch(1, 0)
        arg, aux = mod.get_params()
        out["rollback"] = {
            "count": guard.rollbacks, "lr": (lr0, mod._optimizer.lr),
            "params": _np(arg), "aux": _np(aux), "ckpt": ckpt,
            "profiler": P.profiler.health_stats().get("rollbacks")}
        _step(P, mod, 12)
        out["after"] = {"snap": mod._fused.health_stats(),
                        "params": _np(mod.get_params()[0])}

        mod, mgr = _checkpointed(P, os.path.join(directory, "budget"))
        _step(P, mod, 11, poison=True)
        out["budget"] = _error(lambda: H(mod, manager=mgr, consec=1,
                                         interval=1, budget=0,
                                         spike=0).on_batch(1, 0))
        empty = P.checkpoint.CheckpointManager(
            os.path.join(directory, "empty"))
        out["no_checkpoint"] = _error(lambda: H(
            mod, manager=empty, consec=1, interval=1, budget=2,
            spike=0).on_batch(1, 0))

        spike = H(mod, manager=mgr, consec=100, interval=1, budget=2,
                  spike=5.0)
        out["spike"] = [spike._spiked(v) for v in
                        [1.0] * H._SPIKE_WARMUP + [50.0, 1.2, 60.0]]

        mod, mgr = _checkpointed(P, os.path.join(directory, "pre"))
        guard = H(mod, manager=mgr)
        guard.request_preemption()
        try:
            guard.on_batch(3, 5)
            out["preempt_code"] = None
        except SystemExit as e:
            out["preempt_code"] = e.code
        ck = mgr.latest()
        state = ck.worker_state(0)
        out["preempt"] = {
            "epoch": ck.epoch, "preempted": state["preempted"],
            "nbatch": state["nbatch"], "weights": ck.weights(),
            "states": ck.optimizer_states() is not None,
            "profiler": P.profiler.health_stats().get("preemptions")}
    return out


def guarded_fit(P, directory, fault=GUARDED_FAULT):
    """The chip's phase (a) at the MLP's size: ``Module.fit`` with
    ``MXNET_CHECKPOINT_DIR`` armed, ``elastic_checkpoint`` on a local
    kvstore committing each epoch, and ``fault`` poisoning one step;
    the state right after the rollback, and at the end."""
    mx = P.mx
    seen = {"rollbacks": 0, "at": None}
    with knobs(P, MXNET_CHECKPOINT_DIR=directory, MXNET_FAULT_SPEC=fault,
               **GUARD_ENV):
        mod = mx.mod.Module(_symbol(mx), context=mx.cpu(0))
        mgr = P.checkpoint.CheckpointManager(directory)
        with mx.cpu():
            kv = mx.kv.create("local")
        ckpt = mx.callback.elastic_checkpoint(mgr, mod, kv)

        def on_batch(param):
            n = P.profiler.health_stats().get("rollbacks", 0)
            if n != seen["rollbacks"]:
                seen["rollbacks"] = n
                arg, aux = mod.get_params()
                seen["at"] = {
                    "epoch": param.epoch, "nbatch": param.nbatch,
                    "params": _np(arg), "aux": _np(aux),
                    "lr": mod._optimizer.lr,
                    "snap": mod._fused.health_stats(),
                    "ckpt": {k: np.array(v) for k, v in
                             mgr.latest().weights().items()},
                    "ckpt_epoch": mgr.latest().epoch}

        fit(P, BATCH * BATCHES, EPOCHS, module=mod, epoch_end_callback=ckpt,
            batch_end_callback=on_batch)
        ck = mgr.latest()
        return {"rollbacks": seen["rollbacks"], "at": seen["at"],
                "final": _np(mod.get_params()[0]),
                "snap": mod._fused.health_stats(), "lr": mod._optimizer.lr,
                "latest": ck.epoch, "worker": ck.worker_state(0),
                "committed": sorted(n for n in os.listdir(directory)
                                    if n.startswith("ckpt-"))}


def preempt_fit(P, directory):
    """The guarded fit stopped by ``PREEMPT_FAULT``: raises
    ``SystemExit(75)`` after its checkpoint."""
    with knobs(P, MXNET_CHECKPOINT_DIR=directory,
               MXNET_FAULT_SPEC=PREEMPT_FAULT, MXNET_PREEMPT_GRACE="30",
               **GUARD_ENV):
        fit(P, BATCH * BATCHES, EPOCHS)


def resume_fit(P, directory):
    """The next incarnation: the newest checkpoint's weights and aux
    loaded, then ``fit(begin_epoch=checkpoint epoch)`` to the end."""
    mx = P.mx
    with knobs(P, MXNET_CHECKPOINT_DIR=directory, **GUARD_ENV):
        ck = P.checkpoint.CheckpointManager(directory).latest()
        arg, aux = ck.split_weights()
        mod = mx.mod.Module(_symbol(mx), context=mx.cpu(0))
        it = _iter(mx, BATCH * BATCHES)
        with mx.cpu():
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in arg.items()},
                            aux_params={k: mx.nd.array(v)
                                        for k, v in aux.items()})
            start = _np(mod.get_params()[0])
            epochs = []
            mod.fit(it, begin_epoch=ck.epoch, num_epoch=EPOCHS,
                    kvstore="tpu", optimizer="sgd",
                    optimizer_params=dict(OPT),
                    epoch_end_callback=lambda e, *a: epochs.append(e))
        return {"ckpt_epoch": ck.epoch, "ckpt": arg, "start": start,
                "epochs": epochs, "final": _np(mod.get_params()[0])}


def scenarios(P, directory):
    return {"nan_skip": nan_skip(P), "halt": halt(P),
            "guard": guard_cases(P, os.path.join(directory, "guard")),
            "guarded_fit": guarded_fit(P, os.path.join(directory, "fit"))}


def main(mode, out_dir):
    import torch

    torch.set_num_threads(2)   # beside the suite's other workers
    P = package("port")
    if mode == "scenarios":
        res = scenarios(P, out_dir)
    elif mode == "preempt":
        preempt_fit(P, os.path.join(out_dir, "ckpt"))
        return 0                   # not reached: the guard exits 75
    elif mode == "resume":
        res = resume_fit(P, os.path.join(out_dir, "ckpt"))
    else:
        raise SystemExit("unknown mode %r" % mode)
    with open(os.path.join(out_dir, mode + ".pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
