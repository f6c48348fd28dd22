"""Sequence parallelism in the port (``parallel/ring.py`` and the
transformer on meshes with an ``sp`` axis) against the JAX package on CPU
device meshes of the same shapes.

- ``full_attention`` against the JAX one, offsets included; ring and
  Ulysses attention on ``{"sp": 4}``, causal and not, and the ring on
  ``{"dp": 2, "sp": 2}`` with its gradient: ``tests/test_attention.py``'s
  cases. A rank returns its output shard and its share of the gradient
  (``parallel/ring.py``'s convention); the shards are assembled and the
  shares summed here.
- The transformer's loss and every gradient on ``{"sp": 2}`` under
  ``attn`` ring, ulysses and full, on ``{"dp": 2, "sp": 2}`` and on
  ``{"mp": 2, "sp": 2}``, 3 train steps on ``{"mp": 2, "sp": 2}``,
  ``block_collective_counts`` on each mesh, and ``attn="flash"`` raising
  as the JAX package does.
- A planted ring whose chunks are masked with the wrong key offset fails
  the parity.

The port's ranks run as gloo processes on the CPU
(``tests/torch_sp_workers.py``), started before the JAX references are
computed. Tolerance rtol 1e-4 / atol 1e-5 (fp32, summation order only);
attention against ``tests/test_attention.py``'s 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel import ring as jring
from mxnet_tpu_torch.parallel import ring as tring

import torch_dp_workers as w
import torch_sp_workers as sw

RANK_TIMEOUT = 240
TOL = dict(rtol=1e-4, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(axes.values())),
                tuple(axes))


def jax_loss_and_grads(cfg_kw, axes, toks):
    """The JAX package's loss and gradients on a mesh of ``axes``."""
    cfg = jtfm.TransformerConfig(**cfg_kw)
    mesh = _jmesh(axes)
    loss_fn, specs = jtfm.make_loss_fn(cfg, mesh)
    pp = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
          for k, v in jtfm.init_params(cfg, seed=0).items()}
    data = P("dp") if "dp" in axes else P()
    tt = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, data))
    val, grads = jax.jit(jax.value_and_grad(loss_fn))(pp, tt)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def jax_steps(cfg_kw, axes):
    cfg = jtfm.TransformerConfig(**cfg_kw)
    step, place = jtfm.make_train_step(cfg, _jmesh(axes),
                                       optimizer=dict(sw.OPT))
    carry = place(jtfm.init_params(cfg, seed=0))
    losses = []
    for i in range(sw.STEPS):
        carry, loss = step(carry, jnp.asarray(sw.tokens(10 + i)))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in carry[0].items()}, \
        {k: np.asarray(v) for k, v in carry[1].items()}


def shares(ranks, fixed=()):
    """The gradient shares of the ranks at index 0 of each axis in
    ``fixed`` (the mp or ep copies), summed: the global gradient."""
    picked = [r for r in ranks if all(r["coords"][a] == 0 for a in fixed)]
    return {k: sum(r["grads"][k] for r in picked)
            for k in picked[0]["grads"]}


def hold(got, want, what, tol=TOL):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **tol,
                                   err_msg="%s: %s" % (what, k))


def _jax_attention(axes, causal, heads=None, batch_axis=None):
    q, k, v = (jnp.asarray(a) for a in sw.qkv(0, **(
        {"H": heads} if heads else {})))
    mesh = _jmesh(axes)
    if heads:
        return np.asarray(jring.ulysses_attention(q, k, v, mesh,
                                                  causal=causal))
    return np.asarray(jring.ring_attention(q, k, v, mesh, causal=causal,
                                           batch_axis=batch_axis))


def _assemble(ranks, key, axes, batch_axis=None):
    """The global output from the ranks' shards."""
    n_b = axes.get(batch_axis, 1) if batch_axis else 1
    rows = []
    for b in range(n_b):
        chunks = sorted((r for r in ranks if not batch_axis
                         or r["coords"][batch_axis] == b),
                        key=lambda r: r["coords"]["sp"])
        rows.append(np.concatenate([r[key]["out"] for r in chunks], axis=2))
    return np.concatenate(rows, axis=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = {}
    for name, world in (("sp2", 2), ("sp4", 4)):
        out = tmp_path_factory.mktemp("sp_ranks_" + name)
        started[name] = (w.start_ranks("torch_sp_workers:%s_worker" % name,
                                       world, out), out)
    toks = sw.tokens()
    ref = {"sp2": {m: jax_loss_and_grads(dict(sw.CFG, attn=m), sw.SP2, toks)
                   for m in sw.SP_MODES},
           "dp_sp": jax_loss_and_grads(sw.CFG, sw.DP_SP, toks),
           "mp_sp": jax_loss_and_grads(sw.CFG, sw.MP_SP, toks),
           "steps": jax_steps(sw.CFG, sw.MP_SP)}
    ref["counts"] = {
        ("sp2", m): jtfm.block_collective_counts(
            jtfm.TransformerConfig(**dict(sw.CFG, attn=m)), _jmesh(sw.SP2))
        for m in sw.SP_MODES}
    for name in ("dp_sp", "mp_sp"):
        ref["counts"][name] = jtfm.block_collective_counts(
            jtfm.TransformerConfig(**sw.CFG),
            _jmesh(getattr(sw, name.upper())))
    for causal in (False, True):
        ref["ring", causal] = _jax_attention(sw.SP4, causal)
        ref["ulysses", causal] = _jax_attention(sw.SP4, causal,
                                                heads=sw.ULYSSES_H)
    q, k, v = (jnp.asarray(a) for a in sw.qkv(0))
    mesh = _jmesh(sw.DP_SP)
    ref["dp_sp_ring"] = _jax_attention(sw.DP_SP, True, batch_axis="dp")
    ref["dp_sp_grads"] = [np.asarray(g) for g in jax.grad(
        lambda *a: jring.ring_attention(*a, mesh, causal=True,
                                        batch_axis="dp").sum(),
        argnums=(0, 1, 2))(q, k, v)]
    cfg = jtfm.TransformerConfig(**dict(sw.CFG, attn="flash"))
    with pytest.raises(ValueError) as err:
        jtfm.make_loss_fn(cfg, _jmesh(sw.SP2))[0](
            jtfm.init_params(cfg, seed=0), jnp.asarray(toks))
    ref["flash_error"] = str(err.value)
    ranks = {name: w.join_ranks(ctx, out, RANK_TIMEOUT)
             for name, (ctx, out) in started.items()}
    return ranks, ref


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("offsets", [(0, 0), (32, 0), (16, 48)])
@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal, offsets):
    q, k, v = sw.qkv(1)
    kw = dict(causal=causal, q_offset=offsets[0], k_offset=offsets[1])
    ref = jring.full_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tring.full_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


def test_full_attention_bf16_casts_p_to_v():
    """bf16 inputs: fp32 scores and softmax, p cast to bf16 before the
    second product, a bf16 result, as the JAX function's."""
    q, k, v = sw.qkv(2)
    ref = jring.full_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), causal=True)
    got = tring.full_attention(*(torch.from_numpy(a).bfloat16()
                                 for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_on_sp4_matches_jax(runs, kind, causal):
    ranks, ref = runs
    sp4 = [r["sp4"] for r in ranks["sp4"]]
    got = _assemble(sp4, (kind, causal), sw.SP4)
    np.testing.assert_allclose(got, ref[kind, causal], **ATTN_TOL)
    q, k, v = (jnp.asarray(a) for a in sw.qkv(0, **(
        {"H": sw.ULYSSES_H} if kind == "ulysses" else {})))
    full = np.asarray(jring.full_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got, full, **ATTN_TOL)
    counts = sp4[0][kind, causal]["counts"]
    # the ring: K and V passed on at each of 4 steps; Ulysses: q, k, v to
    # heads and the output back
    assert (counts["ppermute"], counts["all_to_all"]) == (
        (8, 0) if kind == "ring" else (0, 4))


def test_ring_attention_composes_with_dp_and_grads(runs):
    ranks, ref = runs
    dp_sp = [r["dp_sp"] for r in ranks["sp4"]]
    got = _assemble(dp_sp, "ring", sw.DP_SP, batch_axis="dp")
    np.testing.assert_allclose(got, ref["dp_sp_ring"], **ATTN_TOL)
    for i, name in enumerate("qkv"):
        total = sum(r["ring"]["grads"][i] for r in dp_sp)
        np.testing.assert_allclose(total, ref["dp_sp_grads"][i], **ATTN_TOL,
                                   err_msg=name)


def test_ring_with_the_wrong_k_offset_fails_parity(runs):
    """The planted ring masks each chunk with the rank's own offset: the
    past chunks of later ranks lose their keys."""
    ranks, ref = runs
    sp4 = [r["sp4"] for r in ranks["sp4"]]
    np.testing.assert_allclose(_assemble(sp4, ("ring", True), sw.SP4),
                               ref["ring", True], **ATTN_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_assemble(sp4, "fault", sw.SP4),
                                   ref["ring", True], **ATTN_TOL)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sw.SP_MODES)
def test_transformer_loss_and_grads_on_sp2(runs, mode):
    ranks, ref = runs
    runs_ = [dict(r["modes"][mode], coords=r["coords"])
             for r in ranks["sp2"]]
    loss, grads = ref["sp2"][mode]
    for r in runs_:
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
    hold(shares(runs_), grads, "sp2 " + mode)
    fwd = runs_[0]["forward"]
    n_layers = sw.CFG["n_layers"]
    want = {"ring": ("ppermute", 2 * 2 * n_layers),
            "ulysses": ("all_to_all", 4 * n_layers),
            "full": ("all_gather", 2 * n_layers)}[mode]
    assert fwd[want[0]] == want[1], fwd


@pytest.mark.parametrize("name,fixed", [("dp_sp", ()), ("mp_sp", ("mp",))])
def test_transformer_loss_and_grads_on_4_ranks(runs, name, fixed):
    ranks, ref = runs
    runs_ = [dict(r[name]["tfm"], coords=r[name]["coords"])
             for r in ranks["sp4"]]
    loss, grads = ref[name]
    for r in runs_:
        assert r["loss"] == pytest.approx(loss, rel=1e-5)
    hold(shares(runs_, fixed), grads, name)


def test_train_steps_on_mp_sp_match_jax(runs):
    ranks, ref = runs
    losses, params, momentum = ref["steps"]
    for r in ranks["sp4"]:
        steps = r["mp_sp"]["steps"]
        np.testing.assert_allclose(steps["losses"], losses, **TOL)
        hold(steps["params"], params, "params")
        hold(steps["momentum"], momentum, "momentum")
    # the replicated params stay bit for bit equal on all four ranks
    reps = [r["mp_sp"]["replicated"] for r in ranks["sp4"]]
    for k in reps[0]:
        assert all(np.array_equal(x[k], reps[0][k]) for x in reps[1:]), k


@pytest.mark.parametrize("key", [("sp2", m) for m in sw.SP_MODES]
                         + ["dp_sp", "mp_sp"], ids=str)
def test_block_collective_counts_match_jax(runs, key):
    ranks, ref = runs
    if isinstance(key, tuple):
        got = ranks["sp2"][0]["counts"][key[1]]
    else:
        got = ranks["sp4"][0][key]["counts"]
    assert got == ref["counts"][key]


def test_axis_groups_on_dp_sp(runs):
    """``axis_group`` over one axis and over both of ``{"dp": 2, "sp":
    2}``: sizes, row-major indices and members (the sum of their global
    ranks); the subgroups made by enumeration agree with the mesh's."""
    ranks, _ref = runs
    for rank, r in enumerate(ranks["sp4"]):
        dp, sp = divmod(rank, 2)
        g = r["groups"]
        assert g[("dp",)] == (2, dp, float(sp + sp + 2))
        assert g[("sp",)] == (2, sp, float(4 * dp + 1))
        assert g[("dp", "sp")] == (4, rank, 6.0)
        assert g["sub", ("dp",)] == g[("dp",)]
        assert g["sub", ("sp",)] == g[("sp",)]


def test_flash_on_sp_raises_as_jax(runs):
    ranks, ref = runs
    for r in ranks["sp2"]:
        assert r["flash_error"] == ref["flash_error"]
    assert "incompatible with a sequence-parallel" in ref["flash_error"]


def test_attention_modes_without_sp():
    """The ``attn`` switch without an sp axis: auto and flash run the flash
    function, full, ring and ulysses plain attention; an unknown mode
    raises."""
    from mxnet_tpu_torch.models import transformer as ttfm

    q, k, v = (torch.from_numpy(a) for a in sw.qkv(3))
    ref = tring.full_attention(q, k, v, causal=True)
    for mode in ttfm.ATTN_MODES:
        got = ttfm._attention(q, k, v, attn=mode)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **ATTN_TOL)
    with pytest.raises(ValueError, match="unknown attn mode"):
        ttfm._attention(q, k, v, attn="paged")
