"""The port's sparse arrays (``mxnet_tpu_torch/ndarray/sparse.py``), their
kvstore paths and optimizers against the JAX package, on the CPU.

Every scenario of ``tests/test_sparse.py`` (all but the C API version,
ROADMAP.md Queue A item 13) runs the same seeded numpy inputs through both
packages: round trips, the constructors and duplicate canonicalization,
``dot`` and ``dot(transpose_a=True)`` with matrix and vector right-hand
sides, ``_sparse_retain``, the sparse aggregation, ``row_sparse_pull``
(duplicate ids, a dense out scattered into zeros), and the lazy SGD, SGD
with momentum and Adam, whose untouched rows stay bit for bit. Also:
``SGLD`` (noise from each package's seeded stream, held in distribution),
``DCASGD``, ``attach_grad(stype=)`` (C13: a dense buffer, as the JAX
package gives), the index dtype, and a two-embedding matrix
factorization through ``Module.fit(sparse_row_id_fn=...)``.

Index dtype: the port keeps int64 as asked (torch holds 64-bit integers);
the JAX package, x64 off, stores int32. The index values agree exactly.

Tolerance: fp32 on both sides, rtol 1e-4 and atol 1e-5 (the order of
sums only); indices, counts and untouched rows exact.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _value(got, want):
    """``got`` against an exact expectation (broadcast)."""
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=RTOL, atol=ATOL)


def _both(fn):
    """``fn(mx)`` in the port and in the JAX package."""
    return fn(tmx), fn(jmx)


def _dense_with_zero_rows(shape=(6, 4), nz_rows=(1, 4), seed=0):
    rng = np.random.RandomState(seed)
    out = np.zeros(shape, np.float32)
    for r in nz_rows:
        out[r] = rng.randn(shape[1])
    return out


def _csr_dense(rows, cols, seed=0, cut=0.6):
    rng = np.random.RandomState(seed)
    d = rng.rand(rows, cols).astype(np.float32)
    d[d < cut] = 0
    return d


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def test_row_sparse_roundtrip():
    dense = _dense_with_zero_rows()

    def run(mx):
        rsp = mx.nd.sparse.cast_storage(mx.nd.array(dense), "row_sparse")
        return (rsp.stype, rsp.indices.asnumpy(), rsp.data.asnumpy(),
                rsp.asnumpy(), rsp.tostype("default").asnumpy(),
                mx.nd.array(dense).tostype("row_sparse").asnumpy())

    t, j = _both(run)
    assert t[0] == j[0] == "row_sparse"
    assert t[1].tolist() == j[1].tolist() == [1, 4]
    for a, b in zip(t[2:], j[2:]):
        _close(a, b)
    _close(t[3], dense)


def test_csr_roundtrip():
    rng = np.random.RandomState(0)
    dense = ((rng.rand(5, 7) > 0.7) * rng.randn(5, 7)).astype(np.float32)

    def run(mx):
        csr = mx.nd.sparse.cast_storage(mx.nd.array(dense), "csr")
        return (csr.stype, csr.indptr.asnumpy(), csr.indices.asnumpy(),
                csr.data.asnumpy(), csr.asnumpy(),
                csr.tostype("default").asnumpy())

    t, j = _both(run)
    assert t[0] == j[0] == "csr"
    assert t[1].tolist() == j[1].tolist()
    assert t[2].tolist() == j[2].tolist()
    for a, b in zip(t[3:], j[3:]):
        _close(a, b)
    _close(t[4], dense)


def test_row_sparse_array_constructor():
    data = np.arange(8, dtype=np.float32).reshape(2, 4)
    idx = np.array([0, 3], np.int64)

    def run(mx):
        rsp = mx.nd.sparse.row_sparse_array(
            (mx.nd.array(data), mx.nd.array(idx)), shape=(5, 4))
        return rsp.shape, rsp.asnumpy()

    (ts, t), (js, j) = _both(run)
    assert ts == js == (5, 4)
    _close(t, j)
    _close(t[3], data[1])
    assert t[1].sum() == 0


def test_row_sparse_array_duplicate_indices_canonicalized():
    data = np.array([[1., 2.], [10., 20.], [3., 4.]], np.float32)
    idx = np.array([1, 0, 1], np.int64)

    def run(mx):
        rsp = mx.nd.sparse.row_sparse_array((data, idx), shape=(3, 2))
        return (rsp.indices.asnumpy(), rsp.data.asnumpy(),
                rsp.tostype("default").asnumpy())

    t, j = _both(run)
    assert t[0].tolist() == j[0].tolist() == [0, 1]
    _close(t[1], j[1])
    _close(t[1], [[10., 20.], [4., 6.]])
    _close(t[2], j[2])


def test_index_dtype_is_int64_in_the_port_int32_in_jax():
    """The port keeps the int64 asked for; the JAX package (x64 off)
    stores int32. Values equal."""
    def run(mx):
        rsp = mx.nd.sparse.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([4, 1])), shape=(6, 3))
        csr = mx.nd.sparse.csr_matrix(_csr_dense(3, 4))
        return (rsp.indices.dtype, rsp.indices.asnumpy(), csr.indices.dtype,
                csr.indptr.dtype, csr.indptr.asnumpy(),
                mx.nd.sparse.zeros("row_sparse", (4, 2)).indices.dtype)

    t, j = _both(run)
    assert (t[0], t[2], t[3], t[5]) == (np.int64,) * 4
    assert (np.dtype(j[0]), np.dtype(j[2]), np.dtype(j[3]),
            np.dtype(j[5])) == (np.dtype(np.int32),) * 4
    assert t[1].tolist() == j[1].tolist() == [1, 4]
    assert t[4].tolist() == j[4].tolist()


def test_zeros_of_every_stype():
    def run(mx):
        out = []
        for stype in ("default", "row_sparse", "csr"):
            z = mx.nd.sparse.zeros(stype, (4, 3))
            out.append((z.stype, z.shape, z.asnumpy()))
        return out

    t, j = _both(run)
    for (ts, tsh, tv), (js, jsh, jv) in zip(t, j):
        assert (ts, tsh) == (js, jsh)
        assert (tv == jv).all() and not tv.any()


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------
def test_csr_dot_dense():
    rng = np.random.RandomState(0)
    dense_a = ((rng.rand(4, 6) > 0.5) * rng.randn(4, 6)).astype(np.float32)
    b = rng.randn(6, 3).astype(np.float32)

    def run(mx):
        csr = mx.nd.sparse.cast_storage(mx.nd.array(dense_a), "csr")
        return mx.nd.dot(csr, mx.nd.array(b)).asnumpy()

    t, j = _both(run)
    _close(t, j)
    _close(t, dense_a @ b)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("vector", [False, True])
def test_csr_dot_segment_sum_kernel(transpose, vector):
    """``nd.dot``, ``NDArray.dot`` and ``sparse.dot`` of a CSR lhs, with a
    matrix and a vector rhs, with and without ``transpose_a``; an empty
    row and a column no row touches included."""
    dense_l = _csr_dense(9, 11, seed=3)
    dense_l[4] = 0
    dense_l[:, 7] = 0
    rng = np.random.RandomState(1)
    n = 9 if transpose else 11
    rhs = rng.rand(*((n,) if vector else (n, 3))).astype(np.float32)

    def run(mx):
        csr = mx.nd.sparse.csr_matrix(dense_l)
        r = mx.nd.array(rhs)
        return (mx.nd.dot(csr, r, transpose_a=transpose).asnumpy(),
                csr.dot(r, transpose_a=transpose).asnumpy(),
                mx.nd.sparse.dot(csr, r, transpose_a=transpose).asnumpy())

    t, j = _both(run)
    want = (dense_l.T if transpose else dense_l) @ rhs
    for a, b in zip(t, j):
        _close(a, b)
        _close(a, want)


def test_csr_dot_vector_rhs():
    dense_l = np.array([[1, 0, 2], [0, 3, 0]], np.float32)

    def run(mx):
        csr = mx.nd.sparse.csr_matrix(dense_l)
        v = mx.nd.array(np.array([1, 2, 3], np.float32))
        return (mx.nd.dot(csr, v).asnumpy(), csr.dot(v).asnumpy(),
                csr.dot(mx.nd.array(np.array([1., 2.], np.float32)),
                        transpose_a=True).asnumpy())

    t, j = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    _close(t[0], dense_l @ [1, 2, 3])
    _close(t[2], dense_l.T @ [1, 2])


def test_csr_from_triples_and_dense_dot_fallback():
    """A CSR made from (data, indices, indptr) equals the one cast from
    the dense matrix; a row-sparse operand of ``dot`` takes the dense
    product."""
    dense_l = _csr_dense(5, 6, seed=4)
    rows, cols = np.nonzero(dense_l)
    ptr = np.concatenate([[0], np.cumsum((dense_l != 0).sum(1))])
    rsp_d = _dense_with_zero_rows((6, 2), (0, 5))

    def run(mx):
        csr = mx.nd.sparse.csr_matrix(
            (dense_l[rows, cols], cols, ptr), shape=dense_l.shape)
        rsp = mx.nd.sparse.row_sparse_array(rsp_d)
        return (csr.asnumpy(),
                mx.nd.dot(csr, mx.nd.array(rsp_d)).asnumpy(),
                mx.nd.sparse.dot(mx.nd.array(dense_l), rsp).asnumpy())

    t, j = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    _close(t[0], dense_l)
    _close(t[2], dense_l @ rsp_d)


# ---------------------------------------------------------------------------
# retain, cast_storage through mx.nd
# ---------------------------------------------------------------------------
def test_sparse_retain():
    dense = _dense_with_zero_rows(nz_rows=(1, 2, 4))

    def run(mx):
        rsp = mx.nd.sparse.cast_storage(mx.nd.array(dense), "row_sparse")
        kept = mx.nd._sparse_retain(rsp.data, rsp.indices)
        kept_rsp = mx.nd.sparse.retain(rsp, mx.nd.array([4, 1]))
        as_csr = mx.nd.cast_storage(mx.nd.array(dense), stype="csr")
        return (kept.shape, kept.asnumpy(), kept_rsp.asnumpy(),
                as_csr.asnumpy())

    t, j = _both(run)
    assert t[0] == j[0] == (3, 4)
    for a, b in zip(t[1:], j[1:]):
        _close(a, b)
    kept = tmx.nd.sparse.retain(
        tmx.nd.sparse.cast_storage(tmx.nd.array(dense), "row_sparse"),
        tmx.nd.array([4, 1]))
    assert kept.stype == "row_sparse"
    assert kept.indices.asnumpy().tolist() == [1, 4]


# ---------------------------------------------------------------------------
# kvstore
# ---------------------------------------------------------------------------
def test_kvstore_row_sparse_pull():
    weight = np.random.RandomState(0).randn(8, 3).astype(np.float32)

    def run(mx):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(weight))
        out = mx.nd.zeros((8, 3))
        kv.row_sparse_pull("emb", out=out,
                           row_ids=mx.nd.array(np.array([1, 5], np.int64)))
        rsp = mx.nd.sparse.zeros("row_sparse", (8, 3))
        kv.row_sparse_pull("emb", out=rsp, row_ids=mx.nd.array([5, 1, 5]))
        return out.asnumpy(), rsp.indices.asnumpy(), rsp.data.asnumpy()

    t, j = _both(run)
    # the dense out: the rows asked for, every other row 0
    _close(t[0], j[0])
    want = np.zeros_like(weight)
    want[[1, 5]] = weight[[1, 5]]
    assert (t[0] == want).all()
    assert t[1].tolist() == j[1].tolist() == [1, 5]
    _close(t[2], j[2])


def test_row_sparse_pull_duplicate_row_ids():
    w = np.arange(6, dtype=np.float32).reshape(3, 2)

    def run(mx):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.array(w))
        out = mx.nd.sparse.zeros("row_sparse", (3, 2))
        kv.row_sparse_pull("w", out=out, row_ids=mx.nd.array(
            np.array([2, 2], np.float32)))
        return out.asnumpy()

    t, j = _both(run)
    _close(t, j)
    _close(t[2], w[2])


def test_row_sparse_pull_per_key_broadcast_and_range():
    wa = np.arange(6, dtype=np.float32).reshape(2, 3)

    def run(mx):
        kv = mx.kv.create("local")
        kv.init(["a", "b"], [mx.nd.array(wa), mx.nd.array(wa + 100)])
        outs_a = [mx.nd.zeros((2, 3)) for _ in range(2)]
        outs_b = [mx.nd.zeros((2, 3)) for _ in range(3)]
        kv.row_sparse_pull(["a", "b"], out=[outs_a, outs_b],
                           row_ids=[mx.nd.array([1])])
        with pytest.raises(mx.base.MXNetError, match="out of range"):
            kv.row_sparse_pull("a", out=mx.nd.zeros((2, 3)),
                               row_ids=mx.nd.array([0, 2]))
        return [o.asnumpy() for o in outs_a + outs_b]

    t, j = _both(run)
    assert len(t) == len(j) == 5
    for a, b in zip(t, j):
        _close(a, b)
    _close(t[4][1], wa[1] + 100)


def test_row_sparse_aggregate_preserves_sparsity():
    def run(mx):
        a = mx.nd.sparse.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([0, 2])), shape=(5, 3))
        b = mx.nd.sparse.row_sparse_array(
            (2 * np.ones((2, 3), np.float32), np.array([2, 4])),
            shape=(5, 3))
        tot = mx.nd.sparse.add(a, b)
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.zeros((5, 3)))
        kv.push("w", [a, b])
        out = mx.nd.zeros((5, 3))
        kv.pull("w", out=out)
        reduced = kv._reduce([a, b])
        return (type(tot).__name__, tot.indices.asnumpy(), tot.asnumpy(),
                out.asnumpy(), type(reduced).__name__)

    t, j = _both(run)
    assert t[0] == j[0] == t[4] == j[4] == "RowSparseNDArray"
    assert t[1].tolist() == j[1].tolist() == [0, 2, 4]
    expect = np.zeros((5, 3), np.float32)
    expect[0], expect[2], expect[4] = 1, 3, 2
    for a, b in zip(t[2:4], j[2:4]):
        _close(a, b)
        _close(a, expect)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def test_sgd_lazy_update_semantics():
    """The dense ``sgd_update`` applies wd to every row."""
    g = _dense_with_zero_rows((4, 2), nz_rows=(2,))

    def run(mx):
        w = mx.nd.array(np.ones((4, 2), np.float32))
        w2 = mx.nd.array(np.ones((4, 2), np.float32))
        mx.nd.sgd_update(w, mx.nd.array(g), lr=0.1, wd=0.0, out=w)
        mx.nd.sgd_update(w2, mx.nd.array(g), lr=0.1, wd=0.1, out=w2)
        return w.asnumpy(), w2.asnumpy()

    t, j = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    _close(t[0], 1.0 - 0.1 * g)
    assert not np.allclose(t[1][0], 1.0)


def _lazy_case(seed=0, rows=40, width=5, touched=12):
    rng = np.random.RandomState(seed)
    w0 = rng.randn(rows, width).astype(np.float32)
    idx = rng.choice(rows, touched, replace=False)
    idx = np.concatenate([idx, idx[:3]])          # duplicates sum
    vals = rng.randn(idx.size, width).astype(np.float32)
    return w0, idx, vals


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                 clip_gradient=0.8, rescale_grad=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.001)),
    ("adam", dict(learning_rate=0.01, clip_gradient=0.5)),
])
def test_lazy_updates_match_jax_and_keep_untouched_rows(name, kw):
    """Three lazy updates (the same rows each time): the touched rows
    match the JAX package, every other row of the weight and of the
    states is bit for bit what it was."""
    w0, idx, vals = _lazy_case()

    def run(mx):
        opt = mx.optimizer.create(name, **kw)
        w = mx.nd.array(w0)
        state = opt.create_state(0, w)
        for step in range(3):
            g = mx.nd.sparse.row_sparse_array((vals * (step + 1), idx),
                                              shape=w0.shape)
            opt.update(0, w, g, state)
        states = state if isinstance(state, tuple) else (state,)
        return w.asnumpy(), [s.asnumpy() for s in states if s is not None]

    (tw, ts), (jw, js) = _both(run)
    _close(tw, jw, name)
    for a, b in zip(ts, js):
        _close(a, b, name + " state")
    untouched = np.setdiff1d(np.arange(w0.shape[0]), idx)
    assert (tw[untouched] == w0[untouched]).all()
    for s in ts:
        assert not s[untouched].any()
    assert not np.allclose(tw[idx], w0[idx])


def test_sparse_sgd_update_lazy_rows():
    def run(mx):
        w = mx.nd.array(np.ones((5, 2), np.float32))
        g = mx.nd.sparse.row_sparse_array(
            (np.full((2, 2), 0.5, np.float32), np.array([1, 3])),
            shape=(5, 2))
        sgd = mx.optimizer.SGD(learning_rate=0.1, wd=0.01, rescale_grad=1.0)
        sgd.update(0, w, g, sgd.create_state(0, w))
        w2 = mx.nd.array(np.ones((5, 2), np.float32))
        sgd_m = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        st = sgd_m.create_state(0, w2)
        sgd_m.update(0, w2, g, st)
        sgd_m.update(0, w2, g, st)
        return w.asnumpy(), w2.asnumpy(), st.asnumpy()

    t, j = _both(run)
    for a, b in zip(t, j):
        _close(a, b)
    assert (t[0][[0, 2, 4]] == 1.0).all()
    _value(t[0][1], 1.0 - 0.1 * (0.5 + 0.01 * 1.0))
    step1 = -0.1 * 0.5
    _value(t[1][1], 1.0 + step1 + (0.9 * step1 - 0.1 * 0.5))
    assert (t[1][0] == 1.0).all()


def test_sparse_adam_update_lazy_rows():
    def run(mx):
        w = mx.nd.array(np.ones((4, 2), np.float32))
        g = mx.nd.sparse.row_sparse_array(
            (np.full((1, 2), 0.3, np.float32), np.array([2])), shape=(4, 2))
        adam = mx.optimizer.Adam(learning_rate=0.01)
        adam.update(0, w, g, adam.create_state(0, w))
        return w.asnumpy()

    t, j = _both(run)
    _close(t, j)
    assert (t[[0, 1, 3]] == 1.0).all()
    lr_t = 0.01 * np.sqrt(1 - 0.999) / (1 - 0.9)
    _value(t[2], 1.0 - lr_t * (0.1 * 0.3) / (np.sqrt(0.001 * 0.09) + 1e-8))


def test_row_sparse_canonical_duplicates():
    def run(mx):
        a = mx.nd.sparse.row_sparse_array(
            (np.full((1, 2), 0.25, np.float32), np.array([1])), shape=(4, 2))
        g = mx.nd.sparse.add(a, a.copy())
        w = mx.nd.array(np.ones((4, 2), np.float32))
        sgd = mx.optimizer.SGD(learning_rate=0.1, wd=0.5)
        sgd.update(0, w, g, sgd.create_state(0, w))
        w2 = mx.nd.array(np.ones((4, 2), np.float32))
        sgd_m = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        st = sgd_m.create_state(0, w2)
        sgd_m.update(0, w2, g, st)
        return g.indices.asnumpy(), g.data.asnumpy(), w.asnumpy(), \
            st.asnumpy()

    t, j = _both(run)
    assert t[0].tolist() == j[0].tolist() == [1]
    for a, b in zip(t[1:], j[1:]):
        _close(a, b)
    _value(t[2][1], 1 - 0.1 * (0.5 + 0.5))
    _value(t[3][1], -0.1 * 0.5)


def test_lazy_update_off_takes_the_dense_update():
    """``lazy_update=False`` updates every row (wd decays untouched
    ones), in both packages."""
    w0, idx, vals = _lazy_case(seed=2)

    def run(mx):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, wd=0.1,
                                  lazy_update=False)
        w = mx.nd.array(w0)
        g = mx.nd.sparse.row_sparse_array((vals, idx), shape=w0.shape)
        opt.update(0, w, g, opt.create_state(0, w))
        return w.asnumpy()

    t, j = _both(run)
    _close(t, j)
    untouched = np.setdiff1d(np.arange(w0.shape[0]), idx)
    assert not np.allclose(t[untouched], w0[untouched])


def test_dcasgd_matches_jax():
    rng = np.random.RandomState(5)
    w0 = rng.randn(6, 4).astype(np.float32)
    grads = [rng.randn(6, 4).astype(np.float32) for _ in range(3)]

    for kw in (dict(learning_rate=0.1, momentum=0.9, wd=0.01, lamda=0.5),
               dict(learning_rate=0.05, lamda=0.04, clip_gradient=1.0)):
        def run(mx, kw=kw):
            opt = mx.optimizer.create("dcasgd", **kw)
            w = mx.nd.array(w0)
            state = opt.create_state(0, w)
            for g in grads:
                opt.update(0, w, mx.nd.array(g), state)
                w += mx.nd.array(g) * 0.01   # a stale copy drifts
            return w.asnumpy(), state[1].asnumpy()

        t, j = _both(run)
        for a, b in zip(t, j):
            _close(a, b, str(kw))


def test_sgld_noise_in_distribution_and_seeded():
    """SGLD: half a gradient step plus N(0, lr) noise from each package's
    seeded stream. With a zero gradient the step is the noise: both
    packages' draws have mean 0 and std sqrt(lr) (5 sigma of 20000
    draws); the port's draws repeat under the same seed."""
    lr, n = 0.04, 20000

    def run(mx, seed=7):
        mx.random.seed(seed)
        opt = mx.optimizer.create("sgld", learning_rate=lr)
        w = mx.nd.zeros((n,))
        opt.update(0, w, mx.nd.zeros((n,)), opt.create_state(0, w))
        return w.asnumpy()

    t, j = _both(run)
    sd = np.sqrt(lr)
    for draws in (t, j):
        assert abs(draws.mean()) < 5 * sd / np.sqrt(n)
        assert abs(draws.std() / sd - 1) < 5 / np.sqrt(2 * n)
    assert (run(tmx) == t).all()
    assert not (run(tmx, seed=8) == t).all()

    # with a gradient: w -= lr/2 * (g + wd w), then the noise
    rng = np.random.RandomState(3)
    w0 = rng.randn(n).astype(np.float32)
    g0 = rng.randn(n).astype(np.float32)

    def step(mx):
        mx.random.seed(11)
        opt = mx.optimizer.create("sgld", learning_rate=lr, wd=0.1)
        w = mx.nd.array(w0)
        opt.update(0, w, mx.nd.array(g0), opt.create_state(0, w))
        return w.asnumpy() - (w0 - lr / 2 * (g0 + 0.1 * w0))

    for noise in _both(step):
        assert abs(noise.mean()) < 5 * sd / np.sqrt(n)
        assert abs(noise.std() / sd - 1) < 5 / np.sqrt(2 * n)


def test_attach_grad_row_sparse_gives_a_dense_buffer():
    """C13: ``attach_grad(stype='row_sparse')`` takes a dense zero buffer
    and differentiates as ``stype=None`` does, in both packages."""
    x0 = np.random.RandomState(1).randn(4, 3).astype(np.float32)

    def run(mx):
        x = mx.nd.array(x0)
        x.attach_grad(stype="row_sparse")
        before = (x.grad.stype, x.grad.shape, x.grad.asnumpy())
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        return before, x.grad.asnumpy()

    (tb, tg), (jb, jg) = _both(run)
    assert tb[:2] == jb[:2] == ("default", (4, 3))
    assert not tb[2].any() and not jb[2].any()
    _close(tg, jg)
    _close(tg, 2 * x0)


# ---------------------------------------------------------------------------
# Module.fit(sparse_row_id_fn=...)
# ---------------------------------------------------------------------------
MF = dict(users=30, items=20, factor=4, n=96, batch=16)


def _mf_net(mx):
    user, item = mx.sym.var("user"), mx.sym.var("item")
    u = mx.sym.Embedding(data=user, input_dim=MF["users"],
                         output_dim=MF["factor"], name="user_embed")
    i = mx.sym.Embedding(data=item, input_dim=MF["items"],
                         output_dim=MF["factor"], name="item_embed")
    pred = mx.sym.sum(u * i, axis=1)
    return mx.sym.LinearRegressionOutput(data=pred,
                                         label=mx.sym.var("score"),
                                         name="lro")


def _mf_data(seed=0):
    rng = np.random.RandomState(seed)
    gu = rng.randn(MF["users"], 2).astype(np.float32)
    gi = rng.randn(MF["items"], 2).astype(np.float32)
    users = rng.randint(0, MF["users"], MF["n"])
    items = rng.randint(0, MF["items"], MF["n"])
    score = (gu[users] * gi[items]).sum(1).astype(np.float32)
    params = {"user_embed_weight": rng.randn(
                  MF["users"], MF["factor"]).astype(np.float32) * 0.3,
              "item_embed_weight": rng.randn(
                  MF["items"], MF["factor"]).astype(np.float32) * 0.3}
    return users.astype(np.float32), items.astype(np.float32), score, params


def _mf_fit(mx, epochs=2):
    users, items, score, params = _mf_data()
    it = mx.io.NDArrayIter({"user": users, "item": items},
                           {"score": score}, MF["batch"], shuffle=False)
    mod = mx.mod.Module(_mf_net(mx), context=mx.cpu(),
                        data_names=("user", "item"), label_names=("score",))
    pulls = []
    kv = mx.kv.create("local")

    def row_ids(batch):
        pulls.append(1)
        return {"user_embed_weight": batch.data[0],
                "item_embed_weight": batch.data[1]}

    mod.fit(it, num_epoch=epochs, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            eval_metric="mse", sparse_row_id_fn=row_ids)
    arg, _aux = mod.get_params()
    bound = {n: mod._exec_group.param_arrays[i][0].asnumpy()
             for i, n in enumerate(mod._exec_group.param_names)}
    return ({k: v.asnumpy() for k, v in arg.items()}, len(pulls), bound,
            mod._update_on_kvstore)


def test_module_fit_with_sparse_row_id_fn_matches_jax():
    """The two-embedding MF model, SGD with momentum on a ``local``
    store instance (so the store runs the optimizer and ``prepare`` pulls
    each next batch's rows): parameters, the bound arrays (the rows not
    pulled are 0 there) and the number of prepares equal the JAX run."""
    (tp, tn, tb, tu), (jp, jn, jb, ju) = _both(_mf_fit)
    assert tu and ju
    per_epoch = MF["n"] // MF["batch"]
    assert tn == jn == 2 * (per_epoch - 1)
    assert sorted(tp) == sorted(jp)
    for k in tp:
        _close(tp[k], jp[k], k)
        _close(tb[k], jb[k], "bound " + k)
    _users, _items, _score, params = _mf_data()
    assert not np.allclose(tp["user_embed_weight"],
                           params["user_embed_weight"])


def test_refusals_that_stay():
    # the Test optimizer, refused here until it was ported, now runs
    # (tests/test_torch_surface.py holds it against the JAX package)
    assert type(tmx.optimizer.create("test")).__name__ == "Test"
    with pytest.raises(MXNetError, match="cannot convert"):
        tmx.nd.sparse.zeros("csr", (2, 2)).tostype("row_sparse")


@pytest.mark.parametrize("verbose", ["1", "0"])
def test_storage_fallback_logs_once_unless_silenced(monkeypatch, caplog,
                                                    verbose):
    """A dense op on a row-sparse array densifies it (the values are the
    JAX package's); the first such fallback logs a warning naming the
    storage type, later ones do not, and
    ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE=0`` silences it."""
    from mxnet_tpu_torch.ndarray import sparse as tsparse

    monkeypatch.setattr(tsparse, "_FALLBACK_LOGGED", set())
    monkeypatch.setenv("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", verbose)
    vals = np.arange(6, dtype=np.float32).reshape(2, 3)
    with tmx.cpu():
        a = tmx.nd.sparse.row_sparse_array((vals, [0, 2]), shape=(4, 3))
        with caplog.at_level("WARNING", logger=tsparse.__name__):
            got = [(a + 1).asnumpy(), (a * 2).asnumpy()]
    ja = jmx.nd.sparse.row_sparse_array((vals, [0, 2]), shape=(4, 3))
    _close(got[0], (ja + 1).asnumpy())
    _close(got[1], (ja * 2).asnumpy())
    logged = [r.getMessage() for r in caplog.records
              if "storage fallback" in r.getMessage()]
    if verbose == "1":
        assert len(logged) == 1 and "row_sparse" in logged[0]
    else:
        assert not logged
