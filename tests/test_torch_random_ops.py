"""The random samplers of the port's 7c slice against the JAX package's, on
the CPU.

The port draws from ``torch.Generator`` streams, the JAX package from
threefry keys, so the two agree by distribution, not draw for draw. Each
of the 14 names of ``mxnet_tpu/ops/random_ops.py``: on
``tests/test_op_sweep.py``'s spec, the same output shape and dtype as the
JAX op (and the same inferred shape); at 20000 draws a parameter row
(chip_smoke.py's ``random_moment_cases``, the table the card is held
to), each row's mean within 6 standard errors and its standard deviation
within 5% of the distribution's, in both packages, for the
parametrisations the JAX package uses (gamma scaled by ``beta``,
exponential over ``lam``, the negative binomials as gamma-Poisson
mixtures, ``randint``'s exclusive ``high``, the multinomial's floor at
1e-37). Then one seed reruns bit for bit through the imperative invoke
and the executor; ``nd.random``/``sym.random`` dispatch scalar parameters
to ``_random_*`` and tensor ones to ``_sample_*``; ``get_prob``'s
log-probabilities; the ops are ``nondiff`` under ``autograd.record``;
on 2 gloo ranks under a data-parallel scope a graph's random nodes draw
different streams on each rank at one step seed.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_op_sweep import SPECS
from test_torch_ops_coverage import RANDOM_7C
from test_torch_tensor_ops import _infer, _sym_json

import torch_dp_workers as w

MOMENTS = cs.random_moment_cases(np)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _port(name, inputs, attrs, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = treg.get(name).fn(gen, *[torch.tensor(x) for x in inputs],
                            **treg.get(name).parse_attrs(dict(attrs)))
    return out


def _jax(name, inputs, attrs, seed=0):
    op = jreg.get(name)
    return op.fn(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs],
                 **op.parse_attrs(dict(attrs)))


def test_every_name_has_a_spec_and_a_moment_case():
    assert len(RANDOM_7C) == 14
    assert sorted(MOMENTS) == sorted(RANDOM_7C)
    for name in RANDOM_7C:
        assert name in SPECS


@pytest.mark.parametrize("name", RANDOM_7C)
def test_shape_and_dtype_match_jax(name):
    spec = SPECS[name]
    got, want = _port(name, spec["inputs"], spec["attrs"]), \
        _jax(name, spec["inputs"], spec["attrs"])
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.numpy().dtype) == str(np.asarray(want).dtype)
    assert np.isfinite(got.numpy().astype(np.float64)).all()


@pytest.mark.parametrize("name", RANDOM_7C)
def test_moments_match_the_distribution_in_both_packages(name):
    inputs, attrs, mean, std = MOMENTS[name]
    for pkg, draws in (("port", _port(name, inputs, attrs).numpy()),
                       ("jax", np.asarray(_jax(name, inputs, attrs)))):
        dm, ds = cs.moment_errors(np, draws, mean, std)
        assert max(dm) <= cs.RANDOM_SIGMAS, (pkg, name, dm)
        assert max(ds) <= cs.RANDOM_STD_TOL, (pkg, name, ds)


def test_supports_and_integer_draws():
    n = (5000,)
    ri = _port("_random_randint", [], dict(low=-2, high=3, shape=n)).numpy()
    assert ri.dtype == np.int32 and set(np.unique(ri)) == set(range(-2, 3))
    for name, attrs in (("_random_poisson", dict(lam=3.0)),
                        ("_random_negative_binomial", dict(k=2, p=0.5)),
                        ("_random_generalized_negative_binomial",
                         dict(mu=3.0, alpha=0.2))):
        d = _port(name, [], dict(attrs, shape=n)).numpy()
        assert (d >= 0).all() and np.array_equal(d, np.round(d)), name
    u = _port("_random_uniform", [], dict(low=1.0, high=2.0, shape=n))
    assert 1.0 <= float(u.min()) and float(u.max()) < 2.0
    for name, inputs in (("_random_gamma", []), ("_random_exponential", []),
                         ("_sample_gamma", [np.ones(3, np.float32)] * 2),
                         ("_sample_exponential", [np.ones(3, np.float32)])):
        assert (_port(name, inputs, dict(shape=(100,))).numpy() > 0).all()
    # a zero probability is floored at 1e-37 and never drawn
    m = _port("_sample_multinomial", [np.array([[0.5, 0.0, 0.5]],
                                               np.float32)],
              dict(shape=(4000,))).numpy()
    assert not (m == 1).any()


def test_sample_ops_append_shape_to_the_parameter_shape():
    mu = np.zeros((2, 3), np.float32)
    for name, inputs in (("_sample_normal", [mu, mu + 1]),
                         ("_sample_uniform", [mu, mu + 1]),
                         ("_sample_gamma", [mu + 1, mu + 1]),
                         ("_sample_exponential", [mu + 1]),
                         ("_sample_poisson", [mu + 1])):
        for shape, want in (((), (2, 3)), ((4,), (2, 3, 4)),
                            ((4, 5), (2, 3, 4, 5))):
            got = _port(name, inputs, dict(shape=shape)).shape
            assert tuple(got) == want == \
                tuple(_jax(name, inputs, dict(shape=shape)).shape), name
    p = np.full((2, 3, 4), 0.25, np.float32)
    for shape, want in (((), (2, 3)), ((5,), (2, 3, 5))):
        assert tuple(_port("_sample_multinomial", [p],
                           dict(shape=shape)).shape) == want


def test_multinomial_get_prob_is_the_log_softmax_of_each_draw():
    data = np.array([[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]], np.float32)
    draws, logp = _port("_sample_multinomial", [data],
                        dict(shape=(7,), get_prob=True))
    jdraws, jlogp = _jax("_sample_multinomial", [data],
                         dict(shape=(7,), get_prob=True))
    assert draws.shape == jdraws.shape and logp.shape == jlogp.shape
    assert logp.dtype == torch.float32 and np.asarray(jlogp).dtype == \
        np.float32
    want = np.log(data / data.sum(1, keepdims=True))
    np.testing.assert_allclose(
        logp.numpy(), np.take_along_axis(want, draws.numpy().astype(int), 1),
        rtol=1e-6)


def test_a_seed_reruns_bit_for_bit_and_another_differs():
    for name, (inputs, attrs, _m, _s) in MOMENTS.items():
        a = _port(name, inputs, attrs, seed=5).numpy()
        b = _port(name, inputs, attrs, seed=5).numpy()
        c = _port(name, inputs, attrs, seed=6).numpy()
        assert np.array_equal(a, b), name
        assert not np.array_equal(a, c), name


def test_nd_random_dispatches_scalars_and_tensors_as_jax():
    """``nd.random.<dist>`` with scalar parameters draws from
    ``_random_<dist>``, with NDArray parameters from ``_sample_<dist>``;
    ``multinomial``, ``randint`` and ``shuffle`` are there too; one
    ``random.seed`` reruns the context's stream bit for bit."""
    for pkg in (mx, jmx):
        r = pkg.nd.random
        pkg.random.seed(3)
        a = r.normal(loc=1.0, scale=2.0, shape=(6,))
        assert a.shape == (6,)
        mu = pkg.nd.array(np.zeros(3, np.float32))
        b = r.normal(mu, mu + 1, shape=(4,))
        assert b.shape == (3, 4)
        assert r.uniform(mu, mu + 1).shape == (3,)
        assert r.uniform(0, 1, shape=(2, 2)).shape == (2, 2)
        for dist in ("gamma", "exponential", "poisson", "negative_binomial",
                     "generalized_negative_binomial"):
            assert getattr(r, dist)(shape=(5,)).shape == (5,), dist
        assert r.multinomial(pkg.nd.array(np.full((2, 3), 1 / 3.0)),
                             shape=(4,)).shape == (2, 4)
        assert r.randint(0, 5, shape=(3,)).dtype == np.int32
        assert r.shuffle(pkg.nd.array(np.arange(6.0))).shape == (6,)
        pkg.random.seed(3)
        again = r.normal(loc=1.0, scale=2.0, shape=(6,))
        np.testing.assert_array_equal(a.asnumpy(), again.asnumpy())
        assert pkg.nd._random_uniform is not None
        assert pkg.nd.random_uniform is not None
    # the port's eager mx.random.uniform/normal keep their own signature
    assert mx.random.uniform(0, 1, shape=(2,)).shape == (2,)


def test_the_ops_are_not_recorded():
    x = mx.nd.array(np.ones(3, np.float32))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.random.normal(x, x, shape=(2,))
    assert not y.tensor.requires_grad


def test_executor_draws_from_the_node_generators_bit_for_bit():
    """A graph of ``_random_uniform`` (no input: made on the graph's
    device) and ``_sample_gamma``: one step seed reruns bit for bit,
    another differs; shape inference draws nothing."""
    from mxnet_tpu_torch.executor import _graph_closure

    a = mx.sym.var("a")
    g = mx.sym.Group([mx.sym.random.uniform(low=2.0, high=3.0,
                                            shape=(3, 4)),
                      mx.sym.random.gamma(a, a, shape=(5,))])
    _, outs, _ = g.infer_shape(a=(2,))
    assert outs == [(3, 4), (2, 5)]
    fn = _graph_closure(g, is_train=False)
    vals = {"a": torch.ones(2)}
    one, _ = fn(vals, seed=7)
    two, _ = fn(vals, seed=7)
    three, _ = fn(vals, seed=8)
    for x, y, z in zip(one, two, three):
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert ((one[0] >= 2) & (one[0] < 3)).all()
    ex = g.simple_bind(mx.cpu(), grad_req="null", a=(2,))
    ex.arg_dict["a"][:] = np.ones(2, np.float32)
    ex.forward()
    assert ex.outputs[0].shape == (3, 4)


@pytest.mark.parametrize("name", RANDOM_7C)
def test_symbol_json_and_shape_inference_match_jax(name):
    spec = SPECS[name]
    assert _sym_json(mx, name, spec) == _sym_json(jmx, name, spec)
    if spec["inputs"]:
        got, want = _infer(mx, name, spec), _infer(jmx, name, spec)
        assert [list(map(tuple, x)) for x in got] == \
            [list(map(tuple, x)) for x in want]


def test_sym_random_namespace_builds_the_jax_json():
    """Scalar parameters build ``_random_*`` nodes in both packages. With
    Symbol parameters the port's ``sym.random.<dist>`` builds the
    ``_sample_*`` node, which the JAX package's builds only by its name
    (its dispatcher looks for NDArrays, so Symbol parameters raise there:
    ROADMAP.md Queue C)."""
    docs = []
    for pkg in (mx, jmx):
        with pkg.name.NameManager():
            mu = pkg.sym.var("mu")
            normal = pkg.sym.random.normal if pkg is mx else \
                pkg.sym._sample_normal
            g = pkg.sym.Group([
                pkg.sym.random.uniform(low=0.0, high=2.0, shape=(2, 3),
                                       name="u"),
                normal(mu, mu, shape=(4,), name="n"),
                pkg.sym.random.randint(low=0, high=9, shape=(3,),
                                       name="i")])
        docs.append(json.loads(g.tojson()))
    assert docs[0] == docs[1]
    with pytest.raises(jmx.MXNetError, match="positional"):
        jmx.sym.random.normal(jmx.sym.var("mu"), jmx.sym.var("mu"))


def test_two_dp_ranks_draw_different_streams(tmp_path):
    """Each rank folds its index into its nodes' generators
    (``random.node_generator``): at one step seed the two ranks' draws
    differ, and outside the scope both draw the single device's."""
    ctx = w.start_ranks("random_streams_worker", 2, tmp_path)
    (a, a_alone), (b, b_alone) = w.join_ranks(ctx, tmp_path, 120)
    assert [x.shape for x in a] == [(4, 5), (2, 3)]
    for x, y in zip(a, b):
        assert not torch.equal(x, y)
    for x, y in zip(a_alone, b_alone):
        assert torch.equal(x, y)
