"""The port's sparse paths on the card against its own CPU path.

Marked ``cuda``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs on the card's machine
without the JAX-setting conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_sparse_cuda.py

``csr·dense`` and ``csrᵀ·dense`` (matrix and vector rhs) within 1e-4
relative of the CPU's; the lazy SGD, SGD with momentum and Adam within
1e-5 relative on the touched rows, every other row bit for bit unchanged;
two runs of the card's products and updates bit-identical (segment sums in
a fixed order, no atomics); a parameter server built without ``device=``
keeps its values on the card, and so does the ``local`` store of a
``Module`` bound on the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ndarray import sparse


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _csr_parts(rows, cols, nnz_row, seed=0):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(cols, nnz_row, replace=False)
                    for _ in range(rows)]).reshape(-1)
    vals = rng.rand(idx.size).astype(np.float32)
    ptr = np.arange(rows + 1, dtype=np.int64) * nnz_row
    return vals, idx.astype(np.int64), ptr


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_csr_dot_on_the_card(transpose, vector):
    _card()
    rows, cols = 512, 20000
    vals, idx, ptr = _csr_parts(rows, cols, 39)
    n = rows if transpose else cols
    rng = np.random.RandomState(1)
    rhs = rng.randn(*((n,) if vector else (n, 8))).astype(np.float32)
    outs = {}
    for dev in ("cpu", "gpu"):
        ctx = getattr(mx, dev)()
        csr = mx.nd.sparse.csr_matrix((vals, idx, ptr), shape=(rows, cols),
                                      ctx=ctx)
        r = mx.nd.array(rhs, ctx=ctx)
        outs[dev] = [mx.nd.dot(csr, r, transpose_a=transpose).asnumpy()
                     for _ in range(2)]
    assert _rel(outs["gpu"][0], outs["cpu"][0]) <= 1e-4
    np.testing.assert_array_equal(outs["gpu"][0], outs["gpu"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.001))])
def test_lazy_updates_on_the_card(name, kw):
    _card()
    rng = np.random.RandomState(2)
    w0 = rng.randn(5000, 16).astype(np.float32)
    idx = rng.randint(0, 5000, 900)               # duplicates included
    vals = rng.randn(idx.size, 16).astype(np.float32)
    got = {}
    for dev in ("cpu", "gpu", "gpu"):
        ctx = getattr(mx, dev)()
        opt = mx.optimizer.create(name, **kw)
        w = mx.nd.array(w0, ctx=ctx)
        st = opt.create_state(0, w)
        for step in range(3):
            g = mx.nd.sparse.row_sparse_array((vals * (step + 1), idx),
                                              shape=w0.shape, ctx=ctx)
            opt.update(0, w, g, st)
        got.setdefault(dev, []).append(w.asnumpy())
    touched = np.unique(idx)
    untouched = np.setdiff1d(np.arange(w0.shape[0]), touched)
    card = got["gpu"][0]
    assert (card[untouched] == w0[untouched]).all()
    assert _rel(card[touched], got["cpu"][0][touched]) <= 1e-5
    np.testing.assert_array_equal(card, got["gpu"][1])


@pytest.mark.cuda
def test_canonicalize_sums_duplicates_in_order_on_the_card():
    _card()
    vals = torch.randn(3000, 4, device="cuda")
    idx = torch.randint(0, 200, (3000,), device="cuda")
    a = sparse._canonicalize(vals, idx)
    b = sparse._canonicalize(vals, idx)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    ref_v, ref_i = sparse._canonicalize(vals.cpu(), idx.cpu())
    assert torch.equal(a[1].cpu(), ref_i)
    assert torch.allclose(a[0].cpu(), ref_v, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_server_store_lives_on_the_card():
    _card()
    from mxnet_tpu_torch.kvstore_server import KVStoreServer, ServerKVStore

    srv = KVStoreServer()
    srv.serve_in_background()
    try:
        kv = ServerKVStore(srv.addr)
        kv.init("w", np.zeros((4, 3), np.float32))
        kv.set_optimizer("sgd", learning_rate=0.5, momentum=0.9)
        kv.row_push(0, "w", np.array([2, 0, 2]), np.ones((3, 3), np.float32))
        kv.wait_outstanding()
        out = np.empty((4, 3), np.float32)
        kv.pull("w", out=out)
        np.testing.assert_allclose(out[2], -1.0)
        np.testing.assert_allclose(out[0], -0.5)
        assert (out[[1, 3]] == 0).all()
        assert all(d.type == "cuda" for d in srv.stored_devices().values())
        state = srv._updater.states["w"]
        assert state.tensor.is_cuda
        kv.close()
    finally:
        srv.shutdown()


@pytest.mark.cuda
def test_module_local_store_lives_with_the_bound_arrays():
    """``Module.fit`` on the card with a ``local`` store instance and
    ``sparse_row_id_fn``: the store holds its values on the card (it sums
    and updates where the module computes), and the parameters equal the
    CPU run's within 1e-5 relative."""
    _card()
    rng = np.random.RandomState(0)
    users, items, n, batch = 50, 30, 128, 32
    u = rng.randint(0, users, n).astype(np.float32)
    i = rng.randint(0, items, n).astype(np.float32)
    score = rng.randn(n).astype(np.float32)
    init = {"user_embed_weight": rng.randn(users, 4).astype(np.float32),
            "item_embed_weight": rng.randn(items, 4).astype(np.float32)}
    out = {}
    for dev in ("cpu", "gpu"):
        ctx = getattr(mx, dev)()
        user, item = mx.sym.var("user"), mx.sym.var("item")
        ue = mx.sym.Embedding(data=user, input_dim=users, output_dim=4,
                              name="user_embed")
        ie = mx.sym.Embedding(data=item, input_dim=items, output_dim=4,
                              name="item_embed")
        net = mx.sym.LinearRegressionOutput(
            data=mx.sym.sum(ue * ie, axis=1), label=mx.sym.var("score"),
            name="lro")
        it = mx.io.NDArrayIter({"user": u, "item": i}, {"score": score},
                               batch, shuffle=False)
        mod = mx.mod.Module(net, context=ctx, data_names=("user", "item"),
                            label_names=("score",))
        kv = mx.kv.create("local")
        mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in init.items()},
                sparse_row_id_fn=lambda b: {"user_embed_weight": b.data[0],
                                            "item_embed_weight": b.data[1]})
        assert {v.tensor.device.type for v in kv._store.values()} == {
            "cuda" if dev == "gpu" else "cpu"}
        out[dev] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in init:
        assert _rel(out["gpu"][k], out["cpu"][k]) <= 1e-5, k
