"""Megatron tensor parallelism in the port (the (dp, mp) mesh,
``shard_params``/``unshard``, the sharded ``make_loss_fn`` and
``make_train_step``, ``block_collective_counts``) against the JAX package's
``shard_map`` transformer on CPU device meshes of the same shapes, and
against the port on one device.

The port's ranks run as gloo processes on the CPU
(``tests/torch_mp_workers.py``), 2 ranks for the ``(dp 1, mp 2)`` mesh and
4 for ``(dp 2, mp 2)``, started before the JAX references are computed.
Each rank's gradient is its data rank's share (``make_loss_fn``'s
contract): the shares of one mp index are summed here before the
comparison. Tolerance rtol 1e-4 / atol 1e-5 (fp32, summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import transformer as ttfm

import torch_dp_workers as w
import torch_mp_workers as mw

RANK_TIMEOUT = 240
TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = {"mp": (1, 2), "dpxmp": (2, 2)}


def _jmesh(shape, names=("dp", "mp")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _params():
    return {k: v.numpy() for k, v in
            ttfm.init_params(ttfm.TransformerConfig(**mw.CFG)).items()}


def _jax_loss_and_grads(mesh):
    cfg = jtfm.TransformerConfig(**mw.CFG)
    loss_fn, specs = jtfm.make_loss_fn(cfg, mesh)
    pp = {k: jax.device_put(v, NamedSharding(mesh, specs.get(k, P())))
          for k, v in _params().items()}
    tt = jax.device_put(jnp.asarray(mw.tokens()), NamedSharding(mesh, P("dp")))
    val, grads = jax.jit(jax.value_and_grad(loss_fn))(pp, tt)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def _jax_steps(mesh):
    cfg = jtfm.TransformerConfig(**mw.CFG)
    step, place = jtfm.make_train_step(cfg, mesh, optimizer=dict(mw.OPT))
    carry = place({k: jnp.asarray(v) for k, v in _params().items()})
    losses = []
    for i in range(mw.STEPS):
        carry, loss = step(carry, jnp.asarray(mw.tokens(10 + i)))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in carry[0].items()}, \
        {k: np.asarray(v) for k, v in carry[1].items()}


def _one_device():
    cfg = ttfm.TransformerConfig(**mw.CFG)
    loss_fn, _ = ttfm.make_loss_fn(cfg, device="cpu")
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in
         _params().items()}
    loss = loss_fn(p, mw.tokens())
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(p, grads)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's ranks (started first), the JAX references on the same
    mesh shapes (computed meanwhile) and the port on one device."""
    started = {}
    for name, shape in SHAPES.items():
        out = tmp_path_factory.mktemp("mp_ranks_" + name)
        started[name] = (w.start_ranks("torch_mp_workers:mp_train_worker",
                                       int(np.prod(shape)), out, shape[1]),
                         out)
    ref = {name: {"grad": _jax_loss_and_grads(_jmesh(shape))}
           for name, shape in SHAPES.items()}
    ref["dpxmp"]["steps"] = _jax_steps(_jmesh(SHAPES["dpxmp"]))
    ref["counts"] = {name: jtfm.block_collective_counts(
        jtfm.TransformerConfig(**mw.CFG), _jmesh(shape))
        for name, shape in SHAPES.items()}
    ref["counts"]["dp"] = jtfm.block_collective_counts(
        jtfm.TransformerConfig(**mw.CFG), _jmesh((2,), ("dp",)))
    ref["one"] = _one_device()
    ranks = {name: w.join_ranks(ctx, out, RANK_TIMEOUT)
             for name, (ctx, out) in started.items()}
    return ranks, ref


def _summed_grads(ranks, key="grads"):
    """The data ranks' shares of mp index 0 summed: the global gradient."""
    mp = len({r["model"] for r in ranks})
    shares = [r[key] for r in ranks[::mp]]
    return {k: sum(s[k] for s in shares) for k in shares[0]}


def _hold(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **TOL,
                                   err_msg="%s: %s" % (what, k))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def own_group():
    """Destroys the process group a test made in this process."""
    import torch.distributed as dist

    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_mp_knob_validation(monkeypatch, own_group):
    """As tests/test_model_parallel.py's: a malformed MXNET_MP_SIZE names
    the knob; mp must divide the world size (one rank here)."""
    from mxnet_tpu_torch.parallel.mesh import mp_size, train_mesh

    for bad in ("0", "-3", "x", "1.5", ""):
        monkeypatch.setenv("MXNET_MP_SIZE", bad)
        with pytest.raises(MXNetError, match="MXNET_MP_SIZE"):
            mp_size()
    monkeypatch.delenv("MXNET_MP_SIZE", raising=False)
    for mp in (2, 3):
        with pytest.raises(MXNetError, match="divide"):
            train_mesh(mp=mp, device="cpu")
    assert train_mesh(mp=1, device="cpu").mesh_dim_names == ("dp",)


def test_mp_size_knob_builds_the_mesh(tmp_path):
    """``MXNET_MP_SIZE=2`` alone gives ``train_mesh()`` its (dp 1, mp 2)
    mesh on 2 ranks, as the knob's doc says."""
    from mxnet_tpu_torch import config

    doc = config.KNOBS["MXNET_MP_SIZE"][1]
    assert "train_mesh" in doc and "only 1" not in doc
    ctx = w.start_ranks("torch_mp_workers:mp_knob_worker", 2, tmp_path)
    for r, out in enumerate(w.join_ranks(ctx, tmp_path, RANK_TIMEOUT)):
        assert out["axes"] == ("dp", "mp")
        assert out["model"] == (2, r)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_train_mesh_groups(runs, name):
    """``train_mesh(mp=2)`` is ``(dp, mp)`` with mp innermost: rank r is
    mp index r % 2 and data index r // 2; ``data_group`` on the 2-D mesh
    is the dp axis alone."""
    ranks, _ref = runs
    dp = SHAPES[name][0]
    for r, out in enumerate(ranks[name]):
        assert out["axes"] == ("dp", "mp")
        assert out["model"] == (2, r % 2)
        assert out["data"] == ((dp, r // 2) if dp > 1 else (1, 0))


@pytest.mark.parametrize("axis", ["mp", "tp"])
def test_param_and_kv_specs_match_jax(runs, axis):
    ranks, _ref = runs
    mesh = _jmesh((1, 2), ("dp", axis))
    specs, kv = ranks["mp"][0]["specs" if axis == "mp" else "tp_specs"]
    want = jtfm.param_specs(jtfm.TransformerConfig(**mw.CFG), mesh)
    assert specs == {k: tuple(v) for k, v in want.items()}
    assert kv == tuple(jtfm.kv_cache_spec(mesh))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shard_params_unshard_bit_for_bit(runs, name):
    ranks, _ref = runs
    cfg = ttfm.TransformerConfig(**mw.CFG)
    for out in ranks[name]:
        assert out["roundtrip"]
        assert out["shard_shapes"]["attn_qkv_weight"] == (
            cfg.n_layers, cfg.d_model, 3, cfg.n_heads // 2,
            cfg.d_model // cfg.n_heads)
        assert out["shard_shapes"]["embed_weight"] == (cfg.vocab // 2,
                                                       cfg.d_model)
        assert out["shard_shapes"]["pos_embed_weight"] == (cfg.max_len,
                                                           cfg.d_model)


def test_shard_params_raises_when_a_dim_does_not_divide():
    from mxnet_tpu_torch.parallel.spmd import ShardingRuleError

    class FakeMesh:          # model_group reads the axes and sizes alone
        mesh_dim_names = ("dp", "mp")

    cfg = ttfm.TransformerConfig(**dict(mw.CFG, n_heads=3, d_model=33))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttfm, "model_group", lambda mesh: (None, 2, 0))
        with pytest.raises(ShardingRuleError, match="attn_qkv_weight"):
            ttfm.shard_params(ttfm.init_params(cfg), cfg, FakeMesh(),
                              device="cpu")


# ---------------------------------------------------------------------------
# loss, gradients, steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_loss_and_grads_match_jax_and_one_device(runs, name):
    ranks, ref = runs
    jloss, jgrads = ref[name]["grad"]
    one_loss, one_grads = ref["one"]
    for out in ranks[name]:
        np.testing.assert_allclose(out["loss"], jloss, **TOL)
        np.testing.assert_allclose(out["loss"], one_loss, **TOL)
    got = _summed_grads(ranks[name])
    _hold(got, jgrads, "vs JAX")
    _hold(got, one_grads, "vs one device")


def test_tp_alias_is_the_mp_axis(runs):
    ranks, _ref = runs
    for out in ranks["mp"]:
        assert out["tp_loss"] == out["loss"]
        for k, g in out["grads"].items():
            np.testing.assert_array_equal(out["tp_grads"][k], g, err_msg=k)


def test_three_train_steps_match_jax(runs):
    """(dp 2, mp 2), sgd with momentum: losses, params and momentum."""
    ranks, ref = runs
    jlosses, jparams, jmom = ref["dpxmp"]["steps"]
    for out in ranks["dpxmp"]:
        np.testing.assert_allclose(out["losses"], jlosses, **TOL)
        _hold(out["params"], jparams, "params")
        _hold(out["momentum"], jmom, "momentum")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_replicated_params_bit_for_bit_across_ranks(runs, name):
    ranks, _ref = runs
    first = ranks[name][0]["replicated"]
    assert set(first) == {"pos_embed_weight", "final_ln_gamma",
                          "final_ln_beta", "ln1_gamma", "ln1_beta",
                          "ln2_gamma", "ln2_beta"}
    for out in ranks[name][1:]:
        for k, v in first.items():
            np.testing.assert_array_equal(out["replicated"][k], v, err_msg=k)
        for k, v in ranks[name][0]["params"].items():
            np.testing.assert_array_equal(out["params"][k], v, err_msg=k)


@pytest.mark.parametrize("name", ["mp", "dpxmp", "dp"])
def test_block_collective_counts_match_jax(runs, name):
    ranks, ref = runs
    got = ranks["dpxmp" if name == "dpxmp" else "mp"][0]["counts"][
        "dp" if name == "dp" else "mesh"]
    assert got == ref["counts"][name]
    assert got["psum_per_block"] == (0 if name == "dp" else 2)


def test_parity_catches_planted_reduce(runs):
    """The row-parallel sums' backward summing too (``all_reduce_autograd``,
    right for a batch statistic) must fail the gradient check."""
    ranks, ref = runs
    _hold(ranks["mp"][0]["grads"], ref["mp"]["grad"][1], "control")
    with pytest.raises(AssertionError):
        _hold(ranks["mp"][0]["fault_grads"], ref["mp"]["grad"][1], "fault")


def test_sp_ep_and_moe_raise_by_name(runs):
    """The ``sp`` and ``ep`` axes still raise by name. MoE, refused before
    it was ported, now takes the mp specs of the JAX package (replicated
    gate, each expert's d_ff sharded, the expert axis whole); its mp runs
    are in tests/test_torch_moe.py."""
    ranks, _ref = runs
    refusals = ranks["mp"][0]["refusals"]
    assert len(refusals) == 2
    assert "'sp'" in refusals[0] and "'ep'" in refusals[1]
    assert all("item 8c" in r for r in refusals)
    cfg = dict(mw.CFG, n_experts=2)
    jspecs = jtfm.param_specs(jtfm.TransformerConfig(**cfg),
                              _jmesh(SHAPES["mp"]))
    specs = ranks["mp"][0]["moe_specs"]
    assert set(specs) == set(jspecs)
    for k, spec in specs.items():
        assert tuple(jspecs[k]) == spec, k


def test_mp_stats_gauge():
    profiler.mp_reset()
    try:
        profiler.mp_record(mp_size=2, dp_size=2, psum_per_block=2)
        profiler.mp_record(all_gather_per_step=1)
        with pytest.raises(ValueError, match="unknown counter"):
            profiler.mp_record(bogus=1)
        assert profiler.mp_stats(reset=True) == {
            "mp_size": 2, "dp_size": 2, "psum_per_block": 2,
            "all_gather_per_step": 1}
        assert profiler.mp_stats() == {}
    finally:
        profiler.mp_reset()
