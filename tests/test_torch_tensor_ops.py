"""The tensor ops of the port's 7b slice against the JAX package's, on the
CPU.

Each of the 95 names of ``mxnet_tpu/ops/tensor.py`` is run on
``tests/test_op_sweep.py``'s spec for it: the same numpy inputs through
the JAX op (its registry function) and the port's, outputs held together,
then the gradient of every float input the spec differentiates, for one
seeded cotangent a float output, against ``jax.vjp`` of the JAX op, for
every name the JAX registry does not mark ``nondiff``. fp32 on both
sides: rtol 1e-4, atol 1e-5. Two stated exceptions: ``_linalg_syevd`` and
``_linalg_gelqf`` are unique only up to the signs of their rows, so their
outputs are compared sign-normalised and their gradients through
functions the signs do not change; ``shuffle`` draws from a
``torch.Generator``, not threefry, so it is held by distribution.

Then one case for each place the two packages are known to differ from
MXNet or from torch's own defaults (the port follows the JAX package):
``Embedding``'s NaN rows, ``batch_take``/``gather_nd``'s clamped and
wrapped indices, tie order in ``argsort``/``topk``, ``hypot``'s gradient
at (0, 0), ``gamma`` as |Gamma|, the cube roots of negatives, and the
reference's own quirks (ROADMAP.md Queue C). Then the registry's
``nondiff`` rule under ``autograd.record``, the aliases, and each op's
Symbol JSON against the JAX package's.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_op_sweep import ALIAS_SPECS, SPECS
from test_torch_ops_coverage import TENSOR_7B, TENSOR_7B_ALIASES

RTOL, ATOL = 1e-4, 1e-5
# outputs unique only up to the sign of each row (of U; of L's columns and
# Q's rows), and the op held by distribution
SIGNED = ("_linalg_syevd", "_linalg_gelqf")
BY_DISTRIBUTION = ("shuffle",)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _spec(name):
    return SPECS.get(name) or SPECS[ALIAS_SPECS[name]]


def _outputs(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _jax_call(op, arrays, attrs):
    if op.needs_rng:
        return op.fn(jax.random.PRNGKey(0), *arrays, **attrs)
    return op.fn(*arrays, **attrs)


def _torch_call(op, tensors, attrs):
    if op.needs_rng:
        gen = torch.Generator()
        gen.manual_seed(0)
        return op.fn(gen, *tensors, **attrs)
    return op.fn(*tensors, **attrs)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _sign_rows(u):
    """Each row (last axis) times the sign of its largest-magnitude entry."""
    u = np.asarray(u)
    pick = np.take_along_axis(u, np.abs(u).argmax(-1)[..., None], -1)
    return u * np.sign(pick)


def _normalise(name, outs):
    outs = [np.asarray(o) for o in outs]
    if name == "_linalg_syevd":
        return [_sign_rows(outs[0]), outs[1]]
    if name == "_linalg_gelqf":
        # A = L Q: flip L's columns with Q's rows
        q = outs[1]
        s = np.sign(np.take_along_axis(q, np.abs(q).argmax(-1)[..., None],
                                       -1))
        return [outs[0] * np.swapaxes(s, -1, -2), q * s]
    return outs


def _diff_args(spec, inputs):
    d = spec.get("diff_args")
    if d is None:
        d = tuple(i for i, a in enumerate(inputs)
                  if np.asarray(a).dtype == np.float32)
    return d


FORWARD = [n for n in TENSOR_7B if n not in BY_DISTRIBUTION]
GRAD = [n for n in TENSOR_7B if not jreg.get(n).nondiff
        and n not in SIGNED and _diff_args(_spec(n), _spec(n)["inputs"])]


def test_every_name_has_a_spec_and_the_gradient_list_is_what_it_says():
    assert len(TENSOR_7B) == 95
    for name in TENSOR_7B:
        _spec(name)
    nondiff = [n for n in TENSOR_7B if jreg.get(n).nondiff]
    assert len(nondiff) == 19
    assert set(TENSOR_7B) == set(GRAD) | set(nondiff) | set(SIGNED)
    assert len(GRAD) == 95 - 19 - 2


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(name):
    spec = _spec(name)
    jop, top = jreg.get(name), treg.get(name)
    attrs = jop.parse_attrs(dict(spec["attrs"]))
    assert top.parse_attrs(dict(spec["attrs"])) == attrs
    assert jop.n_outputs(attrs) == top.n_outputs(attrs)
    jouts = _outputs(_jax_call(jop, [jnp.asarray(x) for x in spec["inputs"]],
                               attrs))
    touts = _outputs(_torch_call(top, [torch.tensor(x)
                                       for x in spec["inputs"]], attrs))
    assert len(touts) == len(jouts)
    jouts = _normalise(name, jouts)
    touts = _normalise(name, [t.numpy() for t in touts])
    for k, (t, j) in enumerate(zip(touts, jouts)):
        _close(t, j, "%s output %d" % (name, k))


def _grad_pair(name, inputs, attrs, diff, cot_seed=1234):
    """``(port gradients, JAX gradients)`` of ``<cotangent, outputs>``."""
    jop, top = jreg.get(name), treg.get(name)
    jouts = _outputs(_jax_call(jop, [jnp.asarray(x) for x in inputs], attrs))
    rng = np.random.RandomState(cot_seed)
    cots = [np.asarray(rng.randn(*np.shape(j)), np.float32) for j in jouts]

    def jfn(*diffed):
        full = [jnp.asarray(x) for x in inputs]
        for i, d in zip(diff, diffed):
            full[i] = d
        return _outputs(_jax_call(jop, full, attrs))

    _, vjp = jax.vjp(jfn, *[jnp.asarray(inputs[i]) for i in diff])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    tens = [torch.tensor(x, requires_grad=i in diff)
            for i, x in enumerate(inputs)]
    touts = _outputs(_torch_call(top, tens, attrs))
    heads = [(t, torch.from_numpy(c)) for t, c in zip(touts, cots)
             if t.requires_grad]
    tgrads = torch.autograd.grad([h for h, _ in heads],
                                 [tens[i] for i in diff],
                                 [c for _, c in heads], allow_unused=True)
    tgrads = [np.zeros(np.shape(inputs[i]), np.float32) if g is None
              else g.numpy() for i, g in zip(diff, tgrads)]
    return tgrads, [np.asarray(g) for g in jgrads]


@pytest.mark.parametrize("name", GRAD)
def test_gradient_matches_jax(name):
    spec = _spec(name)
    attrs = jreg.get(name).parse_attrs(dict(spec["attrs"]))
    diff = _diff_args(spec, spec["inputs"])
    tg, jg = _grad_pair(name, spec["inputs"], attrs, diff)
    for i, t, j in zip(diff, tg, jg):
        _close(t, j, "%s gradient of input %d" % (name, i))


# ---------------------------------------------------------------------------
# the two ops unique up to sign: gradients through sign-free functions
# ---------------------------------------------------------------------------
def _signfree(name, lib):
    """A scalar of the op's outputs that the rows' signs do not change."""
    rng = np.random.RandomState(7)
    w = [rng.randn(*s).astype(np.float32)
         for s in ((1, 3, 3), (1, 2, 2), (1, 3, 3), (1, 2, 3))]
    c = rng.randn(1, 3).astype(np.float32)
    mt = (lambda a: jnp.swapaxes(a, -1, -2)) if lib is jnp else \
        (lambda a: a.transpose(-1, -2))
    w = [lib.asarray(x) if lib is jnp else torch.from_numpy(x) for x in w]
    c = lib.asarray(c) if lib is jnp else torch.from_numpy(c)

    def f(outs):
        if name == "_linalg_syevd":
            u, ev = outs
            proj = lib.matmul(mt(u), u * c[..., :, None])
            return (ev * c).sum() + (proj * w[0]).sum()
        lo, q = outs
        return (lib.matmul(lo, mt(lo)) * w[1]).sum() + \
            (lib.matmul(mt(q), q) * w[2]).sum() + \
            (lib.matmul(lo, q) * w[3]).sum()

    return f


@pytest.mark.parametrize("name", SIGNED)
def test_sign_free_gradients_match_jax(name):
    x = _spec(name)["inputs"][0]
    jf, tf = _signfree(name, jnp), _signfree(name, torch)
    jg = jax.grad(lambda a: jf(jreg.get(name).fn(a)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (tg,) = torch.autograd.grad(tf(treg.get(name).fn(t)), t)
    _close(tg.numpy(), jg, name)


def test_gelqf_and_syevd_rebuild_their_input():
    a = _spec("_linalg_gelqf")["inputs"][0]
    lo, q = treg.get("_linalg_gelqf").fn(torch.tensor(a))
    _close((lo @ q).numpy(), a, "L Q", atol=1e-5)
    _close((q @ q.transpose(-1, -2)).numpy(), np.eye(2, dtype=np.float32)[None],
           "Q Q^T")
    s = _spec("_linalg_syevd")["inputs"][0]
    u, w = treg.get("_linalg_syevd").fn(torch.tensor(s))
    rebuilt = u.transpose(-1, -2) @ torch.diag_embed(w) @ u
    _close(rebuilt.numpy(), s, "U^T diag(w) U", atol=1e-5)


# ---------------------------------------------------------------------------
# shuffle: by distribution
# ---------------------------------------------------------------------------
def test_shuffle_permutes_rows_uniformly_and_repeats_from_a_seed():
    x = torch.arange(4.0).reshape(4, 1).expand(4, 3).contiguous()
    op = treg.get("shuffle")
    counts = np.zeros((4, 4))
    gen = torch.Generator()
    gen.manual_seed(3)
    draws = 2400
    for _ in range(draws):
        out = op.fn(gen, x)
        assert sorted(out[:, 0].tolist()) == [0.0, 1.0, 2.0, 3.0]
        assert torch.equal(out, out[:, :1].expand(4, 3))
        counts[np.arange(4), out[:, 0].long().numpy()] += 1
    # each row lands at each position with probability 1/4: chi-square
    # with 9 degrees of freedom, 99.9% point 27.9
    expect = draws / 4
    assert ((counts - expect) ** 2 / expect).sum() < 27.9
    a, b = torch.Generator(), torch.Generator()
    a.manual_seed(5)
    b.manual_seed(5)
    assert torch.equal(op.fn(a, x), op.fn(b, x))
    assert op.needs_rng and op.nondiff


# ---------------------------------------------------------------------------
# where the two packages follow the reference and not MXNet or torch
# ---------------------------------------------------------------------------
def _both(name, inputs, **attrs):
    j = _outputs(jreg.get(name).fn(*[jnp.asarray(x) for x in inputs],
                                   **attrs))
    t = _outputs(treg.get(name).fn(*[torch.tensor(x) for x in inputs],
                                   **attrs))
    return [x.detach().numpy() for x in t], [np.asarray(x) for x in j]


def test_embedding_wraps_negative_rows_and_gives_nan_past_the_end():
    w = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    data = np.array([[-1.0, 5.0, 1.7], [7.0, 0.0, -5.0]], np.float32)
    (t,), (j,) = _both("Embedding", [data, w], input_dim=5, output_dim=3)
    _close(t, j, "Embedding")
    assert np.array_equal(t[0, 0], w[4]) and np.array_equal(t[0, 2], w[1])
    assert np.isnan(t[0, 1]).all() and np.isnan(t[1, 0]).all()
    assert np.array_equal(t[1, 2], w[0])
    tg, jg = _grad_pair("Embedding", [data, w], {"input_dim": 5,
                                                 "output_dim": 3}, (1,))
    _close(tg[0], jg[0], "Embedding weight gradient")


def test_gather_nd_and_batch_take_clamp_and_wrap():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[9, -1], [0, 7]], np.int32)
    (t,), (j,) = _both("gather_nd", [w, idx])
    _close(t, j, "gather_nd")
    assert t.tolist() == [w[3, 0], w[3, 2]]
    a = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    bidx = np.array([-1, 7, -9, 2], np.float32)
    (t,), (j,) = _both("batch_take", [a, bidx])
    _close(t, j, "batch_take")
    tg, jg = _grad_pair("gather_nd", [w, idx], {}, (0,))
    _close(tg[0], jg[0], "gather_nd gradient")
    tg, jg = _grad_pair("batch_take", [a, bidx], {}, (0,))
    _close(tg[0], jg[0], "batch_take gradient")


def test_scatters_drop_out_of_range_and_wrap_negative_indices():
    d = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    idx = np.array([[0, -1, 5, 1]], np.int32)
    (t,), (j,) = _both("scatter_nd", [d, idx], shape=(3, 3))
    _close(t, j, "scatter_nd")
    lhs = np.random.RandomState(3).randn(3, 3).astype(np.float32)
    (t,), (j,) = _both("_scatter_set_nd", [lhs, d, idx], shape=(3, 3))
    _close(t, j, "_scatter_set_nd")
    tg, jg = _grad_pair("_scatter_set_nd", [lhs, d, idx], {"shape": (3, 3)},
                        (0, 1))
    for a, b in zip(tg, jg):
        _close(a, b, "_scatter_set_nd gradient")
    ret = np.random.RandomState(4).randn(4, 2).astype(np.float32)
    (t,), (j,) = _both("_sparse_retain", [ret, np.array([-1, 9, 1],
                                                        np.float32)])
    _close(t, j, "_sparse_retain")


def test_tie_order_of_argsort_and_topk():
    x = np.array([[1.0, 2.0, 1.0, 2.0]], np.float32)
    (t,), (j,) = _both("argsort", [x], is_ascend=False)
    _close(t, j, "argsort descending")
    assert t.tolist() == [[3.0, 1.0, 2.0, 0.0]]
    (t,), (j,) = _both("argsort", [x])
    assert t.tolist() == j.tolist() == [[0.0, 2.0, 1.0, 3.0]]
    (t,), (j,) = _both("topk", [x], k=3)
    assert t.tolist() == j.tolist() == [[1.0, 3.0, 0.0]]
    for ret in ("value", "mask", "both"):
        t, j = _both("topk", [x], k=3, ret_typ=ret, is_ascend=True)
        for a, b in zip(t, j):
            _close(a, b, "topk %s" % ret)
    # the sort's gradient goes to the tied elements in the stable order
    tg, jg = _grad_pair("sort", [x], {"is_ascend": False}, (0,))
    _close(tg[0], jg[0], "sort gradient at ties")
    tg, jg = _grad_pair("topk", [x], {"k": 3, "ret_typ": "value"}, (0,))
    _close(tg[0], jg[0], "topk value gradient at ties")


def test_hypot_gradient_at_the_origin_and_infinities():
    z = np.zeros((2,), np.float32)
    tg, jg = _grad_pair("broadcast_hypot", [z, z], {}, (0, 1))
    for a, b in zip(tg, jg):
        _close(a, b, "hypot gradient at (0, 0)")
    a = np.array([0.0, -3.0, np.inf, -np.inf, 2.0], np.float32)
    b = np.array([0.0, 4.0, 1.0, 0.0, np.nan], np.float32)
    (t,), (j,) = _both("broadcast_hypot", [a, b])
    _close(t, j, "hypot")
    tg, jg = _grad_pair("_hypot_scalar", [np.array([0.0, -2.0], np.float32)],
                        {"scalar": 0.0}, (0,))
    _close(tg[0], jg[0], "_hypot_scalar gradient")


def test_hypot_at_the_origin_splits_the_gradient_in_half():
    x = torch.zeros(1, requires_grad=True)
    y = torch.zeros(1, requires_grad=True)
    out = treg.get("broadcast_hypot").fn(x, y)
    gx, gy = torch.autograd.grad(out.sum(), [x, y])
    assert gx.item() == gy.item() == 0.5


def test_gamma_is_the_magnitude_and_cube_roots_keep_the_sign():
    x = np.array([-0.5, -1.5, 0.5, 3.0], np.float32)
    (t,), (j,) = _both("gamma", [x])
    _close(t, j, "gamma")
    assert abs(t[0] - 3.5449078) < 1e-5
    x = np.array([-8.0, -0.3, 0.2, 27.0], np.float32)
    for name in ("cbrt", "rcbrt"):
        (t,), (j,) = _both(name, [x])
        _close(t, j, name)
        tg, jg = _grad_pair(name, [x], {}, (0,))
        _close(tg[0], jg[0], name + " gradient")


# the reference's own behaviours (ROADMAP.md Queue C): each case holds the
# port to the JAX package
QUIRKS = [
    ("trsm-rightside-lower", "_linalg_trsm",
     [np.linalg.cholesky(np.eye(3) * 3 + 0.5).astype(np.float32)[None],
      np.random.RandomState(5).randn(1, 2, 3).astype(np.float32)],
     {"rightside": True, "alpha": 2.0}),
    ("trsm-rightside-upper-transpose", "_linalg_trsm",
     [np.triu(np.eye(3) * 2 + 0.3).astype(np.float32)[None],
      np.random.RandomState(6).randn(1, 2, 3).astype(np.float32)],
     {"rightside": True, "lower": False, "transpose": True}),
    ("trsm-transpose", "_linalg_trsm",
     [np.linalg.cholesky(np.eye(3) * 3 + 0.5).astype(np.float32)[None],
      np.random.RandomState(7).randn(1, 3, 2).astype(np.float32)],
     {"transpose": True}),
    ("trmm-ignores-lower", "_linalg_trmm",
     [np.random.RandomState(8).randn(1, 3, 3).astype(np.float32),
      np.random.RandomState(9).randn(1, 3, 2).astype(np.float32)],
     {"lower": False, "transpose": True}),
    ("trmm-rightside", "_linalg_trmm",
     [np.random.RandomState(10).randn(3, 3).astype(np.float32),
      np.random.RandomState(11).randn(2, 3).astype(np.float32)],
     {"rightside": True, "alpha": 0.5}),
    ("square-sum-ignores-exclude", "_square_sum",
     [np.random.RandomState(12).randn(2, 3, 4).astype(np.float32)],
     {"axis": 1, "exclude": True, "keepdims": True}),
    ("sequence-reverse-ignores-axis", "SequenceReverse",
     [np.random.RandomState(13).randn(4, 2, 3).astype(np.float32),
      np.array([2, 4], np.float32)],
     {"use_sequence_length": True, "axis": 1}),
    ("sequence-reverse-no-length", "SequenceReverse",
     [np.random.RandomState(14).randn(4, 2, 3).astype(np.float32)], {}),
    ("sequence-last-zero-wraps", "SequenceLast",
     [np.random.RandomState(15).randn(4, 3, 2).astype(np.float32),
      np.array([0, 4, 2], np.float32)],
     {"use_sequence_length": True}),
    ("sequence-last-past-the-end-clamps", "SequenceLast",
     [np.random.RandomState(39).randn(4, 3, 2).astype(np.float32),
      np.array([9, -2, 3], np.float32)],
     {"use_sequence_length": True}),
    ("sequence-reverse-past-the-end-clamps", "SequenceReverse",
     [np.random.RandomState(40).randn(4, 3, 2).astype(np.float32),
      np.array([6, 2, 0], np.float32)],
     {"use_sequence_length": True}),
    ("sequence-last-batch-major", "SequenceLast",
     [np.random.RandomState(16).randn(3, 5, 2).astype(np.float32),
      np.array([5, 1, 3], np.float32)],
     {"use_sequence_length": True, "axis": 1}),
    ("sequence-last-no-length", "SequenceLast",
     [np.random.RandomState(17).randn(3, 5, 2).astype(np.float32)],
     {"axis": 1}),
    ("sequence-mask-batch-major", "SequenceMask",
     [np.random.RandomState(18).randn(3, 5, 2).astype(np.float32),
      np.array([5, 1, 0], np.float32)],
     {"use_sequence_length": True, "axis": 1, "value": -2.5}),
    ("diag-of-3d-takes-the-last-two-axes", "diag",
     [np.random.RandomState(19).randn(2, 3, 4).astype(np.float32)],
     {"k": 1}),
    ("diag-of-a-vector", "diag",
     [np.random.RandomState(20).randn(3).astype(np.float32)], {"k": -1}),
    ("cumsum-none-flattens", "cumsum",
     [np.random.RandomState(21).randn(2, 3).astype(np.float32)], {}),
    ("slice-negative-step", "slice",
     [np.random.RandomState(22).randn(5, 4).astype(np.float32)],
     {"begin": (None, 3), "end": (None, 0), "step": (None, -2)}),
    ("slice-assign-negative-step", "_slice_assign",
     [np.random.RandomState(23).randn(3, 5).astype(np.float32),
      np.random.RandomState(24).randn(3, 2).astype(np.float32)],
     {"begin": (None, -1), "end": (None, 1), "step": (1, -2)}),
    ("slice-axis-negative", "slice_axis",
     [np.random.RandomState(25).randn(3, 5).astype(np.float32)],
     {"axis": -1, "begin": -3, "end": -1}),
    ("pad-edge", "pad",
     [np.random.RandomState(26).randn(1, 2, 3, 3).astype(np.float32)],
     {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}),
    ("pad-reflect-wider-than-the-axis", "pad",
     [np.random.RandomState(27).randn(1, 2, 3, 3).astype(np.float32)],
     {"mode": "reflect", "pad_width": (0, 0, 1, 0, 4, 1, 2, 2)}),
    ("tile-more-reps-than-axes", "tile",
     [np.random.RandomState(28).randn(2, 3).astype(np.float32)],
     {"reps": (2, 1, 3)}),
    ("repeat-none-flattens", "repeat",
     [np.random.RandomState(29).randn(2, 3).astype(np.float32)],
     {"repeats": 3}),
    ("topk-mask-axis0", "topk",
     [np.random.RandomState(30).randn(4, 3).astype(np.float32)],
     {"axis": 0, "k": 2, "ret_typ": "mask"}),
    ("sort-descending", "sort",
     [np.random.RandomState(31).randn(3, 4).astype(np.float32)],
     {"axis": 0, "is_ascend": False}),
    ("where-row-condition", "where",
     [np.array([1, 0, 1], np.float32),
      np.random.RandomState(32).randn(3, 2).astype(np.float32),
      np.random.RandomState(33).randn(3, 2).astype(np.float32)], {}),
    ("pick-clips-negative", "pick",
     [np.random.RandomState(34).randn(3, 4).astype(np.float32),
      np.array([-1, 9, 2], np.float32)], {"axis": 1, "keepdims": True}),
    ("smooth-l1-scalar", "smooth_l1",
     [np.random.RandomState(35).randn(3, 4).astype(np.float32)],
     {"scalar": 2.0}),
    ("split-squeeze", "SliceChannel",
     [np.random.RandomState(36).randn(2, 3, 4).astype(np.float32)],
     {"num_outputs": 3, "axis": 1, "squeeze_axis": True}),
    ("makediag-batch-offset", "_linalg_makediag",
     [np.random.RandomState(37).randn(2, 3).astype(np.float32)],
     {"offset": 1}),
    ("extracttrian-upper-offset", "_linalg_extracttrian",
     [np.random.RandomState(38).randn(2, 4, 4).astype(np.float32)],
     {"offset": 1, "lower": False}),
    ("nansum-with-nan", "nansum",
     [np.array([[1.0, np.nan, 2.0], [np.nan, 3.0, -1.0]], np.float32)],
     {"axis": 1}),
    ("nanprod-with-nan", "nanprod",
     [np.array([[1.5, np.nan, 2.0], [np.nan, 3.0, -1.0]], np.float32)],
     {"axis": -1, "keepdims": True}),
]


_ALL_FLOAT_INPUTS = ("_linalg_trsm", "_linalg_trmm", "_slice_assign")


@pytest.mark.parametrize("case", QUIRKS, ids=[q[0] for q in QUIRKS])
def test_reference_behaviour_is_kept(case):
    _id, name, inputs, attrs = case
    t, j = _both(name, inputs, **attrs)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _close(a, b, _id)
    if not jreg.get(name).nondiff:
        # the data inputs; not the lengths, indices or condition
        diff = (1, 2) if name == "where" else \
            tuple(range(len(inputs))) if name in _ALL_FLOAT_INPUTS else (0,)
        tg, jg = _grad_pair(name, inputs, attrs, diff)
        for i, a, b in zip(diff, tg, jg):
            _close(a, b, "%s gradient of input %d" % (_id, i))


def test_creation_quirks():
    for name, attrs in (("_eye", {"N": 3, "M": 0, "k": 1}),
                        ("_eye", {"N": 2, "M": 4, "k": -1}),
                        ("_arange", {"start": 4.0}),
                        ("_arange", {"start": 1.0, "stop": 2.0, "step": 0.25,
                                     "repeat": 2}),
                        ("_full", {"shape": (2, 2), "value": -1.5,
                                   "dtype": "float16"}),
                        ("_zeros", {"shape": (3,), "dtype": "int32"})):
        (t,), (j,) = _both(name, [], **attrs)
        _close(t, j, "%s %s" % (name, attrs))


def test_creation_ops_place_their_output_on_the_context():
    z = mx.nd._zeros(shape=(2, 3))
    assert z.context == mx.cpu() and z.tensor.device.type == "cpu"
    a = mx.nd._arange(start=5.0, ctx=mx.cpu())
    assert a.asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    sym = mx.sym._ones(shape=(2, 2)) + mx.sym.var("x")
    ex = sym.bind(mx.cpu(), {"x": mx.nd.ones((2, 2))})
    ex.forward()
    assert ex.outputs[0].asnumpy().tolist() == [[2.0, 2.0], [2.0, 2.0]]
    assert sym.infer_shape(x=(2, 2))[1] == [(2, 2)]


# ---------------------------------------------------------------------------
# the registry's nondiff rule under autograd.record
# ---------------------------------------------------------------------------
NONDIFF_CASES = [
    ("topk-value", lambda nd, x: nd.topk(x, ret_typ="value", k=2)),
    ("cast-storage", lambda nd, x: nd.cast_storage(x)),
    ("argsort", lambda nd, x: nd.argsort(x)),
    ("round", lambda nd, x: nd.round(x)),
]


def _record(pkg, fn, x):
    arr = pkg.nd.array(x)
    arr.attach_grad()
    try:
        with pkg.autograd.record():
            y = fn(pkg.nd, arr)
        y.backward()
    except Exception as e:     # noqa: BLE001: the message is compared
        return "raised", str(e)
    return "grad", arr.grad.asnumpy()


@pytest.mark.parametrize("case", NONDIFF_CASES,
                         ids=[c[0] for c in NONDIFF_CASES])
def test_nondiff_ops_are_not_recorded_as_in_jax(case):
    _id, fn = case
    x = np.array([[1.0, 3.0, 2.0], [4.0, 0.0, 5.0]], np.float32)
    got, want = _record(mx, fn, x), _record(jmx, fn, x)
    assert got[0] == want[0] == "raised", (got, want)
    assert got[1] == want[1]


def test_a_differentiable_op_beside_a_nondiff_one_records_as_in_jax():
    """``topk`` contributes nothing; ``sort`` beside it is recorded."""
    x = np.array([[1.0, 3.0, 2.0], [4.0, 0.0, 5.0]], np.float32)

    def fn(nd, a):
        return nd.sort(a) * 2 + nd.topk(a, ret_typ="value", k=3)

    got, want = _record(mx, fn, x), _record(jmx, fn, x)
    assert got[0] == want[0] == "grad"
    _close(got[1], want[1], "sort beside topk")


def test_the_executor_still_differentiates_a_nondiff_op():
    """The symbolic path differentiates the whole graph (the JAX package's
    ``jax.vjp``): topk's values pass their gradient."""
    x = np.array([[1.0, 3.0, 2.0], [4.0, 0.0, 5.0]], np.float32)
    grads = []
    for pkg in (mx, jmx):
        s = pkg.sym.topk(pkg.sym.var("x"), k=2, ret_typ="value")
        ex = s.bind(pkg.cpu(), {"x": pkg.nd.array(x)},
                    args_grad={"x": pkg.nd.zeros(x.shape)})
        ex.forward(is_train=True)
        ex.backward(pkg.nd.ones((2, 2)))
        grads.append(ex.grad_dict["x"].asnumpy())
    _close(grads[0], grads[1], "executor topk gradient")
    assert grads[0].tolist() == [[0.0, 1.0, 1.0], [1.0, 0.0, 1.0]]


# ---------------------------------------------------------------------------
# the generated functions, aliases and Symbol JSON
# ---------------------------------------------------------------------------
def test_aliases_and_signatures_match_jax():
    for a in TENSOR_7B_ALIASES:
        assert treg.get(a) is treg.get(jreg.get(a).name), a
        assert hasattr(mx.nd, a) and hasattr(mx.sym, a), a
    for name in TENSOR_7B:
        jop, top = jreg.get(name), treg.get(name)
        assert top.input_names == jop.input_names, name
        assert top.var_inputs == jop.var_inputs, name
        assert top.optional_inputs == jop.optional_inputs, name
        want = {k: v for k, v in jop.attr_defaults.items() if k != "_fn"}
        assert top.attr_defaults == want, name


def _sym_json(pkg, name, spec):
    from mxnet_tpu.name import NameManager as JNM
    from mxnet_tpu_torch.name import NameManager as TNM

    nm = TNM if pkg is mx else JNM
    attrs = dict(spec["attrs"])
    op = treg.get(name)
    with nm():
        ins = [pkg.sym.var("in%d" % i) for i in range(len(spec["inputs"]))]
        if op.var_inputs:
            out = getattr(pkg.sym, name)(*ins, name="op", **attrs)
        else:
            kw = dict(zip(op.input_names, ins))
            out = getattr(pkg.sym, name)(name="op", **kw, **attrs)
    return json.loads(out.tojson())


@pytest.mark.parametrize("name", TENSOR_7B)
def test_symbol_json_matches_jax(name):
    spec = _spec(name)
    assert _sym_json(mx, name, spec) == _sym_json(jmx, name, spec)


def test_outputs_of_the_multi_output_ops_and_embedding_shapes():
    for pkg in (mx, jmx):
        x = pkg.sym.var("x")
        assert len(pkg.sym.SliceChannel(x, num_outputs=3).list_outputs()) == 3
        assert len(pkg.sym.topk(x, ret_typ="both").list_outputs()) == 2
        assert len(pkg.sym.topk(x).list_outputs()) == 1
        assert len(pkg.sym._linalg_syevd(x).list_outputs()) == 2
        assert len(pkg.sym._linalg_gelqf(x).list_outputs()) == 2
    shapes = []
    for pkg in (mx, jmx):
        e = pkg.sym.Embedding(pkg.sym.var("data"), input_dim=11,
                              output_dim=6, name="embed")
        m = pkg.sym.SequenceMask(e, pkg.sym.var("len"),
                                 use_sequence_length=True, axis=1)
        args, outs, _ = m.infer_shape(data=(4, 7), len=(4,))
        shapes.append((m.list_arguments(), args, outs))
    assert shapes[0] == shapes[1]
    assert shapes[0][1][1] == (11, 6)


def _infer(pkg, name, spec):
    from mxnet_tpu.name import NameManager as JNM
    from mxnet_tpu_torch.name import NameManager as TNM

    op = treg.get(name)
    shapes = {"in%d" % i: np.shape(x) for i, x in enumerate(spec["inputs"])}
    with (TNM if pkg is mx else JNM)():
        ins = [pkg.sym.var(k) for k in shapes]
        if op.var_inputs:
            out = getattr(pkg.sym, name)(*ins, **spec["attrs"])
        else:
            out = getattr(pkg.sym, name)(**dict(zip(op.input_names, ins)),
                                         **spec["attrs"])
    return out.infer_shape(**shapes)


@pytest.mark.parametrize("name", TENSOR_7B)
def test_shape_inference_matches_jax(name):
    """The executor infers each op's output shapes on ``meta`` tensors, as
    the JAX package does abstractly."""
    spec = _spec(name)
    got, want = _infer(mx, name, spec), _infer(jmx, name, spec)
    assert [list(map(tuple, g)) for g in got] == \
        [list(map(tuple, w)) for w in want]
