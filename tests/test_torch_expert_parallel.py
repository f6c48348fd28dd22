"""Expert parallelism in the port (the MoE transformer on meshes with an
``ep`` axis) against the JAX package's ``shard_map`` transformer on CPU
device meshes of the same shapes: ``{"ep": 2}`` and ``{"ep": 2, "mp": 2}``,
2 layers, d_model 32, 4 heads, d_ff 64, vocab 64, 4 experts, fp32.

- ``param_specs`` equal the JAX package's; a rank holds ``n_experts / ep``
  experts and ``shard_params``/``unshard`` round-trip bit for bit.
- The loss and every gradient (each rank's unsharded share: the ep and mp
  ranks all hold the whole gradient) and 3 train steps against JAX; the
  gate's gradient bit for bit equal on the ranks;
  ``block_collective_counts`` equal to JAX's.
- The planted MoE branch whose gate lacks its conjugate pair over the ep
  group (each rank's gate cotangent stays its experts' columns) fails the
  gate's gradient.

The port's ranks run as gloo processes on the CPU
(``tests/torch_sp_workers.py``), started before the JAX references are
computed. Tolerance rtol 1e-4 / atol 1e-5 (fp32, summation order only).
"""
import numpy as np
import pytest

from mxnet_tpu.models import transformer as jtfm

import torch_dp_workers as w
import torch_sp_workers as sw
from test_torch_sequence_parallel import (TOL, _jmesh, hold,
                                          jax_loss_and_grads, jax_steps)

RANK_TIMEOUT = 240
MESHES = {"ep2": sw.EP2, "ep_mp": sw.EP_MP}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = {}
    for name, axes in MESHES.items():
        out = tmp_path_factory.mktemp("ep_ranks_" + name)
        started[name] = (w.start_ranks("torch_sp_workers:%s_worker" % name,
                                       int(np.prod(list(axes.values()))),
                                       out), out)
    cfg = jtfm.TransformerConfig(**sw.MOE_CFG)
    ref = {name: {"run": jax_loss_and_grads(sw.MOE_CFG, axes, sw.tokens()),
                  "steps": jax_steps(sw.MOE_CFG, axes),
                  "specs": jtfm.param_specs(cfg, _jmesh(axes)),
                  "counts": jtfm.block_collective_counts(cfg, _jmesh(axes))}
           for name, axes in MESHES.items()}
    ref["dense_counts"] = jtfm.block_collective_counts(
        jtfm.TransformerConfig(**sw.CFG), _jmesh(sw.EP2))
    ranks = {name: w.join_ranks(ctx, out, RANK_TIMEOUT)
             for name, (ctx, out) in started.items()}
    return ranks, ref


@pytest.mark.parametrize("name", MESHES)
def test_param_specs_match_jax(runs, name):
    ranks, ref = runs
    specs = ranks[name][0]["specs"]
    assert set(specs) == set(ref[name]["specs"])
    for k, spec in specs.items():
        assert tuple(ref[name]["specs"][k]) == spec, k


@pytest.mark.parametrize("name", MESHES)
def test_a_rank_holds_its_experts(runs, name):
    ranks, _ref = runs
    mp = MESHES[name].get("mp", 1)
    for r in ranks[name]:
        shapes = r["shard_shapes"]
        assert shapes["moe_gate_weight"] == (2, 32, 4)
        assert shapes["ffn_up_weight"] == (2, 2, 32, 64 // mp)
        assert shapes["ffn_down_weight"] == (2, 2, 64 // mp, 32)
        assert r["roundtrip"]


@pytest.mark.parametrize("name", MESHES)
def test_loss_and_every_gradient_match_jax(runs, name):
    ranks, ref = runs
    loss, grads = ref[name]["run"]
    for r in ranks[name]:
        assert r["run"]["loss"] == pytest.approx(loss, rel=1e-5)
        hold(r["run"]["grads"], grads, "%s rank %s" % (name, r["coords"]))


@pytest.mark.parametrize("name", MESHES)
def test_gate_gradient_bit_for_bit_on_the_ranks(runs, name):
    ranks, _ref = runs
    gates = [r["run"]["gate"] for r in ranks[name]]
    assert all(np.array_equal(g, gates[0]) for g in gates[1:])


def test_gate_without_its_ep_pair_fails_parity(runs):
    ranks, ref = runs
    loss, grads = ref["ep2"]["run"]
    for r in ranks["ep2"]:
        # the forward is the same; the gate's gradient is not
        assert r["fault"]["loss"] == pytest.approx(loss, rel=1e-5)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(r["fault"]["grads"]["moe_gate_weight"],
                                       grads["moe_gate_weight"], **TOL)


@pytest.mark.parametrize("name", MESHES)
def test_block_collective_counts_match_jax(runs, name):
    ranks, ref = runs
    got = ranks[name][0]["counts"]
    assert got == ref[name]["counts"]
    fwd = ranks[name][0]["run"]["forward"]
    n = got["n_blocks"]
    assert fwd["reduce_from_mp"] + fwd["reduce_from_data"] == \
        got["psum_per_block"] * n + got["psum_outside"]
    if name == "ep2":
        assert ranks[name][0]["dense_counts"] == ref["dense_counts"]


@pytest.mark.parametrize("name", MESHES)
def test_train_steps_match_jax(runs, name):
    ranks, ref = runs
    losses, params, momentum = ref[name]["steps"]
    for r in ranks[name]:
        steps = r["steps"]
        np.testing.assert_allclose(steps["losses"], losses, **TOL)
        hold(steps["params"], params, "params")
        hold(steps["momentum"], momentum, "momentum")
