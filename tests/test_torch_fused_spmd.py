"""The fused unit's data-parallel wrappers in the port against the JAX
package's ``shard_map`` wrappers, on the CPU.

``bottleneck_train_spmd`` on 2 gloo ranks, each given its half of a
global batch of 8 (NHWC 8x8, 16 -> 8 -> 16 channels, nonzero BN betas),
against the JAX ``bottleneck_train_spmd`` on a 2-device mesh in interpret
mode, for stride 1 and 2, with and without the downsample shortcut: the
rows of out, the six batch statistics and all 11 gradients of
``sum(out ** 2) * 1e-3`` (data's rows; the ten parameter gradients, summed
over the ranks, the same bit for bit on both ranks) at rtol 1e-4 and an
atol of 1e-5 of the reference's largest |value| (fp32, summation order).
``bottleneck_infer_spmd`` likewise. The same comparison fails when the
unit's weight-gradient all-reduce is planted dropped or doubled.

The JAX fused kernels name ``pltpu.TPUCompilerParams``, which this JAX
calls ``pltpu.CompilerParams``: the alias is set with ``monkeypatch``.
"""
import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

from mxnet_tpu.kernels import fused_block as jfb

import torch_dp_workers as w

RTOL, ATOL = 1e-4, 1e-5
RANK_TIMEOUT = 180


@pytest.fixture(autouse=True)
def _pallas_params_alias(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(float(np.abs(want).max()), 1.0),
        err_msg=what)


def _jax_case(stride, shortcut):
    """The JAX wrappers on a 2-device mesh: out, stats, the 11 gradients by
    name, the inference output (numpy)."""
    x = w.unit_inputs(stride, shortcut)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    names = [k for k in w.UNIT_ARGS if x[k] is not None]

    def loss(*vals):
        v = dict(zip(names, vals))
        out, stats = jfb.bottleneck_train_spmd(
            *[v.get(k) for k in w.UNIT_ARGS], stride, 1e-5, None, mesh,
            ("dp",))
        return jax.numpy.sum(out ** 2) * 1e-3, (out, stats)

    (_l, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(
            *[x[k] for k in names])
    inf = jfb.bottleneck_infer_spmd(
        *[x[k] for k in w.UNIT_ARGS],
        *[x[k] for k in ("mm1", "mv1", "mm2", "mv2", "mm3", "mv3")],
        stride=stride, eps=1e-5, mesh=mesh, axes=("dp",))
    return {"out": np.asarray(out), "stats": [np.asarray(s) for s in stats],
            "grads": {k: np.asarray(g) for k, g in zip(names, grads)},
            "infer": np.asarray(inf)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port results by rank, {case: JAX results})``: the ranks start
    first and the JAX cases run meanwhile."""
    out = tmp_path_factory.mktemp("unit_ranks")
    ctx = w.start_ranks("fused_unit_worker", 2, out)
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        jax_res = {case: _jax_case(*case) for case in w.UNIT_CASES}
    return w.join_ranks(ctx, out, RANK_TIMEOUT), jax_res


def _hold(ranks, ref):
    """Rank rows concatenated against the global reference; what is
    summed over the ranks equal bit for bit on both and to the
    reference."""
    r0, r1 = ranks
    _close(np.concatenate([r0["out"].numpy(), r1["out"].numpy()]),
           ref["out"], "out")
    _close(np.concatenate([r0["infer"].numpy(), r1["infer"].numpy()]),
           ref["infer"], "infer")
    for i, (a, b, s) in enumerate(zip(r0["stats"], r1["stats"],
                                      ref["stats"])):
        assert np.array_equal(a.numpy(), b.numpy()), "stats %d" % i
        _close(a.numpy(), s, "stats %d" % i)
    assert set(r0["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        if k == "data":
            _close(np.concatenate([r0["grads"][k].numpy(),
                                   r1["grads"][k].numpy()]), g, k)
            continue
        assert np.array_equal(r0["grads"][k].numpy(),
                              r1["grads"][k].numpy()), k
        _close(r0["grads"][k].numpy(), g, k)


@pytest.mark.parametrize("case", w.UNIT_CASES,
                         ids=["s1", "s1-shortcut", "s2-shortcut"])
def test_bottleneck_spmd_matches_jax(runs, case):
    ranks, jax_res = runs
    _hold([r[None][case] for r in ranks], jax_res[case])


@pytest.mark.parametrize("fault", ["drop", "double"])
@pytest.mark.parametrize("case", w.UNIT_CASES,
                         ids=["s1", "s1-shortcut", "s2-shortcut"])
def test_parity_catches_a_planted_weight_grad_reduction(runs, fault, case):
    ranks, jax_res = runs
    with pytest.raises(AssertionError):
        _hold([r[fault][case] for r in ranks], jax_res[case])


def test_spmd_scope_nests_and_restores():
    import mxnet_tpu_torch.kernels.fused_block as tfb

    assert tfb.current_spmd_scope() is None
    with tfb.spmd_scope("mesh-a", ("dp",)):
        with tfb.spmd_scope("mesh-b", ("dcn", "dp")):
            assert tfb.current_spmd_scope() == ("mesh-b", ("dcn", "dp"))
        assert tfb.current_spmd_scope() == ("mesh-a", ("dp",))
    assert tfb.current_spmd_scope() is None
