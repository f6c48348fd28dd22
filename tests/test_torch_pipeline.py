"""The GPipe schedule of the port (``parallel/pipeline.py``) against the
JAX package's ``pipeline`` and the serial run of its stages:
``tests/test_transformer.py``'s tanh MLP (width 16, 8 microbatches of 4
rows) over ``{"pp": 2}`` and ``{"pp": 4}``, the port's stages as gloo
ranks on the CPU (``tests/torch_sp_workers.py``), started before the JAX
references are computed.

Every rank returns the same outputs; a rank's gradient is its share (its
stage's row of the stacked params, and x's on stage 0), and the shares
are summed here. Outputs atol 1e-6, gradients rtol 1e-4 / atol 1e-4, as
the JAX test holds its own. A planted output sum whose backward sums too
gives the gradients ``n_stages`` times over and fails the check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mxnet_tpu.parallel.pipeline import pipeline as jpipeline
from mxnet_tpu_torch.parallel import pipeline_apply

import torch_dp_workers as w
import torch_sp_workers as sw

RANK_TIMEOUT = 240
OUT_TOL = dict(rtol=0, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
STAGES = (2, 4)


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _references(n):
    params, x = sw.pipe_inputs(n)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jx = jnp.asarray(x)
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))

    def serial(p, x):
        h = x
        for s in range(n):
            h = jnp.tanh(h @ p["w"][s] + p["b"][s])
        return h

    g_pipe = jax.grad(lambda p, x: (jpipeline(_jax_stage, p, x, mesh)
                                    ** 2).sum(), argnums=(0, 1))(jp, jx)
    g_serial = jax.grad(lambda p, x: (serial(p, x) ** 2).sum(),
                        argnums=(0, 1))(jp, jx)

    def flat(g):
        return dict({k: np.asarray(v) for k, v in g[0].items()},
                    x=np.asarray(g[1]))

    return {"out": np.asarray(jpipeline(_jax_stage, jp, jx, mesh)),
            "serial": np.asarray(serial(jp, jx)),
            "grads": flat(g_pipe), "serial_grads": flat(g_serial)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = {}
    for n in STAGES:
        out = tmp_path_factory.mktemp("pp_ranks_%d" % n)
        started[n] = (w.start_ranks("torch_sp_workers:pipe_worker", n, out),
                      out)
    ref = {n: _references(n) for n in STAGES}
    ranks = {n: w.join_ranks(ctx, out, RANK_TIMEOUT)
             for n, (ctx, out) in started.items()}
    return ranks, ref


def _summed(ranks):
    return {k: sum(r["grads"][k] for r in ranks) for k in ranks[0]["grads"]}


@pytest.mark.parametrize("n", STAGES)
def test_outputs_match_jax_and_serial_on_every_rank(runs, n):
    ranks, ref = runs
    for r in ranks[n]:
        np.testing.assert_allclose(r["out"], ref[n]["out"], **OUT_TOL)
        np.testing.assert_allclose(r["out"], ref[n]["serial"], **OUT_TOL)


@pytest.mark.parametrize("n", STAGES)
def test_gradient_shares_sum_to_jax_and_serial(runs, n):
    ranks, ref = runs
    got = _summed(ranks[n])
    for want in (ref[n]["grads"], ref[n]["serial_grads"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **GRAD_TOL,
                                       err_msg=k)
    # each rank's share of the stacked params is its stage's row
    for r in ranks[n]:
        s = r["coords"]["pp"]
        for k in ("w", "b"):
            others = np.delete(r["grads"][k], s, axis=0)
            assert not others.any(), (s, k)


@pytest.mark.parametrize("n", STAGES)
def test_schedule_collectives(runs, n):
    """One ppermute a tick (n_micro + n_stages - 1 ticks) and one sum of
    the outputs over the stages."""
    ranks, _ref = runs
    for r in ranks[n]:
        c = r["counts"]
        assert c["ppermute"] == sw.PIPE_MICRO + n - 1, c
        assert c["reduce_from_mp"] == 1, c


def test_planted_output_sum_fails_the_gradient_check(runs):
    ranks, ref = runs
    np.testing.assert_allclose(_summed(ranks[2])["w"],
                               ref[2]["serial_grads"]["w"], **GRAD_TOL)
    fault = [r["fault"] for r in ranks[2]]
    for r in fault:
        np.testing.assert_allclose(r["out"], ref[2]["serial"], **OUT_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_summed(fault)["w"],
                                   ref[2]["serial_grads"]["w"], **GRAD_TOL)


def test_one_stage_runs_the_microbatches_in_turn():
    """Without a pp axis the schedule is the stage over each microbatch."""
    params, x = sw.pipe_inputs(1)
    p = {k: torch.from_numpy(v[0]) for k, v in params.items()}
    got = pipeline_apply(sw.pipe_stage, p, torch.from_numpy(x))
    want = torch.stack([sw.pipe_stage(p, m) for m in torch.from_numpy(x)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
