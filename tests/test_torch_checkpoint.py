"""The port's ``CheckpointManager`` (``mxnet_tpu_torch/checkpoint.py``)
against the JAX package's, on the CPU.

- ``tests/test_checkpoint.py``'s ten cases on the port: the bit-exact
  round trip through a fresh manager (a respawned process's view), torn
  staging invisible and swept, retention, the period and its validation,
  the atomic write under a failing rename, the kvstore's and the module's
  ``save_optimizer_states`` through it, a re-checkpoint of one epoch,
  ``meta.json`` required, ``split_weights`` and the shard files merged on
  read.
- The layout byte for byte: the same inputs saved by both packages give
  the same file names and the same bytes in every file.
- Both directions: a checkpoint either package's manager writes is read
  by the other's, with bit-identical weights, ``split_weights``, merged
  optimizer shards, optimizer config, worker state and ``latest``.
- Every pickle is read through the restricted unpickler: a file naming a
  callable is refused.

No tolerance: every comparison is bit for bit.
"""
import os
import pickle

import numpy as np
import pytest

from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint as tck
from mxnet_tpu_torch.base import MXNetError

PKGS = {"jax": jck, "port": tck}


def _bits(a):
    return (str(np.asarray(a).dtype), np.asarray(a).shape,
            np.asarray(a).tobytes())


def _inputs():
    """tests/test_checkpoint.py's round-trip inputs (the JAX PRNG key
    there is a uint32 pair; here the same pair from numpy)."""
    rng = np.random.RandomState(0)
    weights = {
        "arg:fc1_weight": rng.randn(8, 5).astype(np.float32),
        "arg:fc1_bias": rng.randn(5).astype(np.float16),
        "arg:step": np.arange(7, dtype=np.int64),
        "aux:bn_moving_mean": rng.randn(3).astype(np.float64),
    }
    opt_states = pickle.dumps({"fc1_weight": rng.randn(8, 5)
                               .astype(np.float32)}, protocol=4)
    config = ("sgd", {"learning_rate": 0.1, "momentum": 0.9},
              {"idx2name": {0: "fc1_weight"}})
    workers = {0: {"epoch": 3, "nbatch": 0,
                   "rng_key": np.array([0, 42], np.uint32),
                   "numpy_rng": np.random.RandomState(123).get_state()},
               1: {"epoch": 3, "nbatch": 0}}
    return weights, opt_states, config, workers


def _save(mod, directory):
    weights, opt_states, config, workers = _inputs()
    return mod.CheckpointManager(directory, period=1, retain=2).save(
        3, weights=weights, optimizer_states=opt_states,
        optimizer_config=config, worker_states=workers, num_workers=2)


def _hold_read(ck):
    """``ck`` (either package's handle) gives back exactly the inputs."""
    weights, opt_states, config, _workers = _inputs()
    assert ck is not None and ck.epoch == 3
    got = ck.weights()
    assert set(got) == set(weights)
    for name in weights:
        assert _bits(got[name]) == _bits(weights[name]), name
    arg, aux = ck.split_weights()
    assert set(arg) == {"fc1_weight", "fc1_bias", "step"}
    assert set(aux) == {"bn_moving_mean"}
    assert _bits(aux["bn_moving_mean"]) == \
        _bits(weights["aux:bn_moving_mean"])
    assert ck.optimizer_states() == opt_states
    assert ck.optimizer_config() == config
    st = ck.worker_state(0)
    assert _bits(st["rng_key"]) == _bits(np.array([0, 42], np.uint32))
    a = np.random.RandomState(0)
    a.set_state(st["numpy_rng"])
    assert a.randint(0, 2 ** 31, 16).tolist() == \
        np.random.RandomState(123).randint(0, 2 ** 31, 16).tolist()
    assert ck.worker_state(1) == {"epoch": 3, "nbatch": 0}
    assert ck.worker_state(7) is None
    assert ck.meta == {"epoch": 3, "format": 1, "num_workers": 2}


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------
def test_roundtrip_bit_exact_through_respawn(tmp_path):
    path = _save(tck, tmp_path / "ck")
    assert os.path.isdir(path)
    _hold_read(tck.CheckpointManager(tmp_path / "ck").latest())


def test_torn_staging_is_invisible_and_cleaned(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "ck", retain=2)
    mgr.save(1, weights={"arg:w": np.ones((2,), np.float32)})
    mgr.begin(2)
    mgr.write_worker_state(2, 0, {"epoch": 2})
    fresh = tck.CheckpointManager(tmp_path / "ck")
    assert fresh.latest().epoch == 1
    os.makedirs(tmp_path / "ck" / "ckpt-00000005")   # no meta.json: torn
    assert fresh.latest().epoch == 1
    fresh.save(3, weights={"arg:w": np.full((2,), 3.0, np.float32)})
    assert fresh.latest().epoch == 3
    assert [n for n in os.listdir(tmp_path / "ck")
            if n.startswith(".tmp-")] == []


def test_retention_keeps_newest(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "ck", retain=2)
    for epoch in (1, 2, 3, 4):
        mgr.save(epoch, weights={"arg:w": np.full((1,), float(epoch),
                                                  np.float32)})
    names = sorted(n for n in os.listdir(tmp_path / "ck")
                   if n.startswith("ckpt-"))
    assert names == ["ckpt-00000003", "ckpt-00000004"]
    assert mgr.latest().epoch == 4
    assert (tmp_path / "ck" / "LATEST").read_bytes() == b"ckpt-00000004"


def test_period_and_validation(tmp_path, monkeypatch):
    mgr = tck.CheckpointManager(tmp_path / "ck", period=2)
    assert [mgr.due(e) for e in (1, 2, 3, 4)] == [False, True, False, True]
    with pytest.raises(MXNetError, match="period"):
        tck.CheckpointManager(tmp_path / "p0", period=0)
    with pytest.raises(MXNetError, match="retain"):
        tck.CheckpointManager(tmp_path / "r0", retain=0)
    with pytest.raises(MXNetError, match="begin"):
        mgr.write_worker_state(9, 0, {})
    with pytest.raises(MXNetError, match="begin"):
        mgr.commit(9)
    # from_env: the knobs and their JAX defaults
    monkeypatch.delenv("MXNET_CHECKPOINT_DIR", raising=False)
    assert tck.CheckpointManager.from_env() is None
    monkeypatch.setenv("MXNET_CHECKPOINT_DIR", str(tmp_path / "env"))
    got, want = (m.CheckpointManager.from_env() for m in (tck, jck))
    assert (got.directory, got.period, got.retain) == \
        (want.directory, want.period, want.retain) == \
        (str(tmp_path / "env"), 1, 2)
    monkeypatch.setenv("MXNET_CHECKPOINT_PERIOD", "3")
    monkeypatch.setenv("MXNET_CHECKPOINT_RETAIN", "5")
    got = tck.CheckpointManager.from_env()
    assert (got.period, got.retain) == (3, 5)
    monkeypatch.setenv("MXNET_CHECKPOINT_RETAIN", "x")
    with pytest.raises(MXNetError, match="MXNET_CHECKPOINT_RETAIN"):
        tck.CheckpointManager.from_env()


def test_atomic_write_keeps_old_file_on_failure(tmp_path, monkeypatch):
    target = tmp_path / "opt.states"
    tck.atomic_write_bytes(target, b"generation-1")
    real_replace = os.replace

    def boom(src, dst):
        raise OSError("simulated crash at rename")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="simulated"):
        tck.atomic_write_bytes(target, b"generation-2-torn")
    monkeypatch.setattr(os, "replace", real_replace)
    assert target.read_bytes() == b"generation-1"
    assert not (tmp_path / "opt.states.tmp").exists()
    tck.atomic_write_bytes(target, b"generation-2")
    assert target.read_bytes() == b"generation-2"


@pytest.mark.parametrize("writer", ["kvstore", "module"])
def test_kvstore_save_optimizer_states_is_atomic(tmp_path, monkeypatch,
                                                 writer):
    """The local kvstore's and the Module's ``save_optimizer_states`` go
    through ``atomic_write_bytes``: a crash at the rename keeps the old
    file, which still loads."""
    import mxnet_tpu_torch as mx

    with mx.cpu():
        if writer == "kvstore":
            obj = mx.kv.create("local")
            obj.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                                  momentum=0.9))
            obj.init("w", mx.nd.zeros((3,)))
            obj.push("w", mx.nd.ones((3,)))
        else:
            it = mx.io.NDArrayIter(np.ones((4, 3), np.float32),
                                   np.zeros((4,), np.float32), batch_size=4)
            net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                mx.sym.var("data"), num_hidden=2, name="fc"), name="softmax")
            obj = mx.mod.Module(net, context=mx.cpu())
            obj.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        fname = str(tmp_path / "kv.states")
        obj.save_optimizer_states(fname)
        good = open(fname, "rb").read()
        assert good

        def boom(src, dst):
            raise OSError("simulated crash at rename")

        monkeypatch.setattr(os, "replace", boom)
        with pytest.raises(OSError, match="simulated"):
            obj.save_optimizer_states(fname)
        monkeypatch.undo()
        assert open(fname, "rb").read() == good
        assert not os.path.exists(fname + ".tmp")
        obj.load_optimizer_states(fname)


def test_recheckpoint_same_epoch_replaces(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "ck")
    mgr.save(2, weights={"arg:w": np.zeros((2,), np.float32)})
    mgr.save(2, weights={"arg:w": np.full((2,), 9.0, np.float32)})
    np.testing.assert_array_equal(mgr.latest().weights()["arg:w"], 9.0)


def test_checkpoint_read_handle_requires_meta(tmp_path):
    os.makedirs(tmp_path / "nometa")
    with pytest.raises(OSError):
        tck.Checkpoint(tmp_path / "nometa")


def test_split_weights_partitions_arg_and_aux(tmp_path):
    mgr = tck.CheckpointManager(tmp_path / "ck")
    mgr.save(1, weights={"arg:fc_w": np.ones((2,), np.float32),
                         "aux:bn_mean": np.full((2,), 7.0, np.float32)})
    arg, aux = mgr.latest().split_weights()
    assert set(arg) == {"fc_w"} and set(aux) == {"bn_mean"}
    np.testing.assert_array_equal(aux["bn_mean"], 7.0)


def _sharded(mod, directory):
    mgr = mod.CheckpointManager(str(directory))
    mgr.begin(3)
    mod.atomic_write_bytes(mgr.staged_optimizer_shard_path(3, 0),
                           pickle.dumps({"a": np.ones((2,), np.float32)}))
    mod.atomic_write_bytes(mgr.staged_optimizer_shard_path(3, 1),
                           pickle.dumps({"b": np.zeros((3,), np.float32)}))
    mgr.commit(3, weights={"arg:a": np.ones((2,))}, num_workers=2)
    return mgr


def test_optimizer_state_shard_files_merge_on_read(tmp_path):
    mgr = _sharded(tck, tmp_path)
    ck = mgr.latest()
    assert ck.optimizer_states_path() is None
    assert [os.path.basename(p) for p in ck.optimizer_state_shard_paths()] \
        == ["optimizer-shard-00000.states", "optimizer-shard-00001.states"]
    merged = pickle.loads(ck.optimizer_states())
    assert set(merged) == {"a", "b"}
    np.testing.assert_array_equal(merged["a"], np.ones((2,)))
    tck.atomic_write_bytes(os.path.join(ck.path, "optimizer.states"),
                           pickle.dumps({"c": 1}))
    assert set(pickle.loads(mgr.latest().optimizer_states())) == {"c"}


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("case", ["single", "shards"])
def test_layout_is_the_jax_packages_byte_for_byte(tmp_path, case):
    """The same inputs through both managers: the same files (``LATEST``,
    ``ckpt-00000003/meta.json``, ``weights.pkl``, ``optimizer.states`` or
    the shard files, ``optimizer.pkl``, ``worker-<rank>.pkl``) with the
    same bytes, and no staging directory left."""
    trees = {}
    for name, mod in PKGS.items():
        if case == "single":
            _save(mod, tmp_path / name)
        else:
            _sharded(mod, tmp_path / name)
        trees[name] = _tree(tmp_path / name)
    assert trees["port"].keys() == trees["jax"].keys()
    for f in trees["jax"]:
        assert trees["port"][f] == trees["jax"][f], f
    want = {"single": {"optimizer.states", "optimizer.pkl", "worker-0.pkl",
                       "worker-1.pkl"},
            "shards": {"optimizer-shard-00000.states",
                       "optimizer-shard-00001.states"}}[case]
    assert set(trees["port"]) == {"LATEST"} | {
        "ckpt-00000003/" + f for f in want | {"meta.json", "weights.pkl"}}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_crosses_over(tmp_path, writer, reader):
    """A checkpoint one package's manager writes, the other's reads: the
    weights, ``split_weights``, optimizer states and config, worker state
    and ``latest`` bit for bit, and the merged optimizer shards."""
    _save(PKGS[writer], tmp_path / "ck")
    _hold_read(PKGS[reader].CheckpointManager(tmp_path / "ck").latest())
    _sharded(PKGS[writer], tmp_path / "sh")
    merged = pickle.loads(PKGS[reader].CheckpointManager(
        str(tmp_path / "sh")).latest().optimizer_states())
    assert set(merged) == {"a", "b"}
    assert _bits(merged["a"]) == _bits(np.ones((2,), np.float32))
    assert _bits(merged["b"]) == _bits(np.zeros((3,), np.float32))
    # and the reader's retention and re-commit run over the writer's
    mgr = PKGS[reader].CheckpointManager(tmp_path / "ck", retain=1)
    mgr.save(4, weights={"arg:w": np.ones((1,), np.float32)})
    assert [n for n in os.listdir(tmp_path / "ck")
            if n.startswith("ckpt-")] == ["ckpt-00000004"]


class _Callable:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("what", ["weights.pkl", "worker-0.pkl",
                                  "optimizer.pkl", "optimizer-shard"])
def test_pickles_are_read_with_the_restricted_unpickler(tmp_path, what):
    """A checkpoint file that names a callable is refused, whichever file
    it is; numpy arrays, scalars and plain containers load."""
    mgr = tck.CheckpointManager(tmp_path / "ck")
    if what == "optimizer-shard":
        mgr.begin(1)
        tck.atomic_write_bytes(mgr.staged_optimizer_shard_path(1, 0),
                               pickle.dumps({"a": _Callable()}))
        mgr.commit(1)
        with pytest.raises(MXNetError, match="refusing to load posix"):
            mgr.latest().optimizer_states()
        return
    kw = {"weights.pkl": dict(weights={"arg:w": _Callable()}),
          "worker-0.pkl": dict(worker_states={0: {"f": _Callable()}}),
          "optimizer.pkl": dict(optimizer_config=("sgd", {"x":
                                                          _Callable()}, {}))}
    mgr.save(1, **kw[what])
    ck = mgr.latest()
    read = {"weights.pkl": ck.weights, "worker-0.pkl":
            lambda: ck.worker_state(0),
            "optimizer.pkl": ck.optimizer_config}[what]
    with pytest.raises(MXNetError, match="refusing to load posix.getcwd"):
        read()
    plain = tck.loads_plain(pickle.dumps(
        {"a": [np.float32(1.5), (np.arange(3), None)], "b": {1, 2}}))
    assert plain["a"][0] == np.float32(1.5) and plain["b"] == {1, 2}
    np.testing.assert_array_equal(plain["a"][1][0], np.arange(3))
