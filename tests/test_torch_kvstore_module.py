"""The port's kvstore and ``Module.fit(kvstore='tpu')`` against the JAX
package, on the CPU.

- The kvstore API (``create``, ``init``, ``push`` summing a list, ``pull``,
  an updater, ``set_optimizer``, the optimizer states, ``rank`` and
  ``num_workers``) against the JAX store on the same values;
  ``_create_kvstore`` for each type against the JAX function; the
  ``'tpu'`` store on 2 gloo ranks: rank 0's ``init`` value on both, a push
  summed over the ranks.
- ``Module.fit(kvstore='tpu')`` of an MLP with a BatchNorm (64 seeded
  rows, batches of 16, 2 epochs) on 2 gloo ranks, one context each,
  against the JAX ``Module.fit`` on 2 CPU devices, batch by batch: params,
  moving statistics and the metric after every batch. Cases: the fused
  group (sgd with momentum and wd), the fused group under adam with ZeRO,
  and the per-executor path an ``lr_scheduler`` forces (each rank's
  executor on its rows with its own BatchNorm statistics, the kvstore
  summing the gradients and running the optimizer; params and moving
  statistics are the mean over ranks as JAX's are over devices). Both
  ranks' records are bit for bit equal. Tolerance: rtol 1e-5 and an atol of
  1e-6 of the reference's largest |value| (fp32, summation order), the
  metric exactly.
- The fused group's ``.states`` bytes of either package load in the other.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import model as jmodel
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.base import MXNetError

import torch_dp_workers as w

RTOL, ATOL = 1e-5, 1e-6
RANK_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The port's ranks (started first) and the JAX fits meanwhile:
    ``(port results by rank, {case: JAX record}, {case: JAX module})``."""
    out = tmp_path_factory.mktemp("kv_ranks")
    ctx = w.start_ranks("module_worker", 2, out, str(out))
    jrec, jmods = {}, {}
    for case in w.FIT_CASES:
        jrec[case] = []
        jmods[case] = w.fit_case(jmx, case, jrec[case])
    return w.join_ranks(ctx, out, RANK_TIMEOUT), jrec, jmods


# ---------------------------------------------------------------------------
# the kvstore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kvstore", [None, "local", "device", "nccl",
                                     "local_allreduce_cpu", "tpu"])
def test_create_kvstore_matches_jax(kvstore):
    args = {"w": np.zeros((3, 4), np.float32)}
    tkv, tupd = tmodel._create_kvstore(
        kvstore, 1, {k: mx.nd.array(v) for k, v in args.items()})
    jkv, jupd = jmodel._create_kvstore(
        kvstore, 1, {k: jmx.nd.array(v) for k, v in args.items()})
    assert (tkv is None) == (jkv is None) and tupd == jupd
    if jkv is not None:
        assert tkv.type == jkv.type
        assert type(tkv).__name__ == type(jkv).__name__


def test_create_kvstore_refuses_what_is_not_ported():
    with pytest.raises(MXNetError, match="kvstore='dist_sync' is not ported"):
        tmodel._create_kvstore("dist_sync", 1, {})
    with pytest.raises(MXNetError, match="more than one context"):
        tmodel._create_kvstore("tpu", 2, {})
    with pytest.raises(MXNetError, match="not ported"):
        mx.kv.create("local").set_gradient_compression({"type": "2bit"})
    with pytest.raises(MXNetError, match="unknown kvstore"):
        mx.kv.create("nonsense")


@pytest.mark.parametrize("kind", ["local", "device", "tpu"])
def test_kvstore_api_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]
    results = []
    with mx.cpu():
        for pkg in (mx, jmx):
            kv = pkg.kv.create(kind)
            assert (kv.type, kv.rank, kv.num_workers) == (kind, 0, 1)
            kv.init("w", pkg.nd.array(w0))
            kv.push("w", [pkg.nd.array(g) for g in grads])
            summed = pkg.nd.zeros((4, 3))
            kv.pull("w", out=summed)
            kv.set_optimizer(pkg.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9))
            for g in grads:
                kv.push("w", pkg.nd.array(g))
            updated = pkg.nd.zeros((4, 3))
            kv.pull("w", out=[updated])
            path = str(tmp_path / ("%s.states" % pkg.__name__))
            kv.save_optimizer_states(path)
            kv.load_optimizer_states(path)
            kv.barrier()
            results.append((summed.asnumpy(), updated.asnumpy()))
    (ts, tu), (js, ju) = results
    np.testing.assert_array_equal(ts, js)
    _close(tu, ju, "updated")
    # each package's states file loads in the other's updater
    tstates = pickle.loads(open(tmp_path / "mxnet_tpu_torch.states",
                                "rb").read())
    jstates = pickle.loads(open(tmp_path / "mxnet_tpu.states", "rb").read())
    assert set(tstates) == set(jstates) == {"w"}
    _close(tstates["w"], jstates["w"], "momentum")


def test_tpu_kvstore_sums_over_the_ranks(fits):
    ranks, _jrec, _jmods = fits
    for r, res in enumerate(ranks):
        kv = res["kv"]
        assert (kv["rank"], kv["num_workers"]) == (r, 2)
        # init takes rank 0's value; a push sums each rank's list
        # (rank + 1, 10) over both ranks: 1 + (11 + 12)
        np.testing.assert_array_equal(kv["init"], np.ones(3))
        np.testing.assert_array_equal(kv["after_push"], np.full(3, 24.0))


# ---------------------------------------------------------------------------
# Module.fit(kvstore='tpu')
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(w.FIT_CASES))
def test_fit_tpu_kvstore_matches_jax_every_batch(fits, case):
    ranks, jrec, jmods = fits
    assert ranks[0][case]["fused"] == (jmods[case]._fused is not None) \
        == (case != "fallback")
    assert ranks[0][case]["mesh"] == (case != "fallback")
    rec0, rec1 = ranks[0][case]["record"], ranks[1][case]["record"]
    assert len(rec0) == len(jrec[case]) == \
        w.MLP_EPOCHS * 64 // w.MLP_BATCH
    for b, (t0, t1, j) in enumerate(zip(rec0, rec1, jrec[case])):
        for part in ("params", "aux"):
            assert set(t0[part]) == set(j[part])
            for k in j[part]:
                assert np.array_equal(t0[part][k], t1[part][k]), (b, k)
                _close(t0[part][k], j[part][k], "batch %d %s" % (b, k))
        assert t0["metric"] == t1["metric"] == j["metric"], b


@pytest.mark.parametrize("case", ["fused", "fused-adam-zero"])
def test_fused_states_load_in_both_packages(fits, case, tmp_path):
    ranks, _jrec, jmods = fits
    tpath = ranks[0][case]["states"]
    jpath = str(tmp_path / "jax.states")
    jmods[case].save_optimizer_states(jpath)
    tblob, jblob = (pickle.loads(open(p, "rb").read())
                    for p in (tpath, jpath))
    assert tblob["format"] == jblob["format"] == "fused-spmd-v1"
    assert tblob["step"] == jblob["step"]
    assert tblob["zero"] == jblob["zero"] == (case == "fused-adam-zero")
    assert set(tblob["opt_state"]) == set(jblob["opt_state"])
    for k, jv in jblob["opt_state"].items():
        for t, j in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (tblob["opt_state"][k], jv))):
            _close(t, j, k)
    # the port's bytes load in the JAX group and come back unchanged
    jmods[case].load_optimizer_states(tpath)
    back = pickle.loads(jmods[case]._fused.get_states())
    for k, v in tblob["opt_state"].items():
        for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (back["opt_state"][k], v))):
            np.testing.assert_array_equal(np.asarray(a), b)


def _one_rank_module(**opt_params):
    """A bound and initialised MLP ``Module`` in this process, then
    ``init_optimizer(kvstore='tpu')`` under sgd with momentum and
    ``opt_params`` (the fused group makes a process group of one rank)."""
    x, y = w.mlp_data()
    it = mx.io.NDArrayIter(x, y, batch_size=w.MLP_BATCH)
    mod = mx.mod.Module(w.mlp_symbol(mx), context=mx.cpu())
    mod.bind(it.provide_data, it.provide_label)
    args, aux = w.mlp_init()
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in args.items()},
                    aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params=dict(learning_rate=0.1, momentum=0.9,
                                             **opt_params))
    return mod


@pytest.fixture
def own_group():
    """Destroys the process group a test made in this process."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_fused_states_of_jax_load_in_the_port(fits, tmp_path, own_group):
    """The JAX group's ``.states`` bytes load in the port's group (one
    process, a mesh of one rank) and come back bit for bit."""
    _ranks, _jrec, jmods = fits
    jpath = str(tmp_path / "jax.states")
    jmods["fused"].save_optimizer_states(jpath)
    jblob = pickle.loads(open(jpath, "rb").read())
    mod = _one_rank_module()
    assert mod._fused is not None
    mod.load_optimizer_states(jpath)
    back = pickle.loads(mod._fused.get_states())
    assert back["step"] == jblob["step"]
    for k, v in jblob["opt_state"].items():
        np.testing.assert_array_equal(back["opt_state"][k], np.asarray(v))


@pytest.mark.parametrize("fault", ["device", "mp"])
def test_tpu_kvstore_raises_on_a_mesh_or_device_fault(fault, monkeypatch,
                                                      own_group):
    """Only what the fused step cannot mirror falls back to the
    per-executor path: a context that is not the rank's mesh device, or a
    mesh the process group cannot hold (``MXNET_MP_SIZE=2`` over one
    rank), raises from ``init_optimizer`` and trains nowhere."""
    from mxnet_tpu_torch.parallel import mesh as mesh_mod

    if fault == "device":
        monkeypatch.setattr(mesh_mod, "mesh_device",
                            lambda mesh: torch.device("meta"))
        match = "mesh device is meta"
    else:
        monkeypatch.setenv("MXNET_MP_SIZE", "2")
        match = "MXNET_MP_SIZE=2 must divide the world size 1"
    with pytest.raises(MXNetError, match=match):
        _one_rank_module()


def test_tpu_kvstore_falls_back_only_on_what_the_step_cannot_mirror(
        own_group):
    """An ``lr_scheduler`` is refused before any mesh is built: the module
    trains on the per-executor path with no process group."""
    import torch.distributed as dist

    mod = _one_rank_module(
        lr_scheduler=mx.lr_scheduler.FactorScheduler(step=2, factor=0.5))
    assert mod._fused is None and mod._kvstore.mesh is None
    assert not dist.is_initialized()
