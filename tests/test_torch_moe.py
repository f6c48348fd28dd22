"""The MoE transformer in the PyTorch port (``n_experts > 0``) against the
JAX package's, on the CPU at a small size: 2 layers, d_model 64, 4 heads,
d_ff 128, vocab 256, 4 experts, fp32.

- ``init_params``: one seed gives bit-identical weights (gate, ffn-up,
  ffn-down drawn in the JAX order).
- The loss and every gradient against the JAX one-device loss (jitted
  ``value_and_grad`` on a one-device dp mesh), and on 2 gloo ranks of a
  ``(dp 1, mp 2)`` mesh against JAX's ``shard_map`` loss on the same mesh
  shape and the port's one-device run. ``moe_gate_weight`` is replicated
  while the gated sum is of each rank's partial expert outputs, so its
  cotangent must be summed over the mp group: the planted run without
  that sum must fail the same check.
- ``block_collective_counts`` equals the JAX package's (2 sums a block).
- ``GenerateServer``'s greedy chains, plain and with the prefix cache and
  speculative decoding, equal the JAX ``GenerateServer``'s.

Tolerance rtol 1e-4 / atol 1e-5 (fp32, summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.serving import GenerateServer as JaxGenerateServer
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.serving import GenerateServer

import torch_dp_workers as w
import torch_mp_workers as mw

TOL = dict(rtol=1e-4, atol=1e-5)
RANK_TIMEOUT = 240
CFG = mw.MOE_CFG
MOE_KEYS = ("moe_gate_weight", "ffn_up_weight", "ffn_down_weight")


def _cfgs(**kw):
    c = dict(CFG, **kw)
    return jtfm.TransformerConfig(**c), ttfm.TransformerConfig(**c)


def _hold(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], np.asarray(v), **TOL,
                                   err_msg="%s: %s" % (what, k))


def _jax_loss_and_grads(mesh, toks):
    jc, _ = _cfgs()
    loss_fn, specs = jtfm.make_loss_fn(jc, mesh)
    pp = {k: jax.device_put(v, NamedSharding(mesh, specs.get(k, P())))
          for k, v in jtfm.init_params(jc, seed=0).items()}
    tt = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("dp")))
    val, grads = jax.jit(jax.value_and_grad(loss_fn))(pp, tt)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grads(toks):
    _, tc = _cfgs()
    loss_fn, _ = ttfm.make_loss_fn(tc, device="cpu")
    p = {k: v.requires_grad_() for k, v in ttfm.init_params(tc, 0).items()}
    loss = loss_fn(p, toks)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {k: g.numpy() for k, g in zip(p, grads)}


def _jmesh(shape, names=("dp", "mp")):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory):
    """The port's 2 mp ranks (started first) and, meanwhile, the JAX
    references: the mp=2 loss and gradients, 3 train steps on that mesh and
    the collective counts."""
    out = tmp_path_factory.mktemp("moe_mp")
    ctx = w.start_ranks("torch_mp_workers:moe_mp_worker", 2, out)
    jc, _ = _cfgs()
    mesh = _jmesh((1, 2))
    ref = {"grad": _jax_loss_and_grads(mesh, mw.moe_tokens()),
           "counts": jtfm.block_collective_counts(jc, mesh)}
    step, place = jtfm.make_train_step(jc, mesh, optimizer=dict(mw.OPT))
    carry = place(jtfm.init_params(jc, seed=0))
    losses = []
    for i in range(mw.STEPS):
        carry, loss = step(carry, jnp.asarray(mw.moe_tokens(10 + i)))
        losses.append(float(loss))
    ref["steps"] = losses, {k: np.asarray(v) for k, v in carry[0].items()}
    ref["one"] = _port_loss_and_grads(mw.moe_tokens())
    return w.join_ranks(ctx, out, RANK_TIMEOUT), ref


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------
def test_init_params_bit_identical_to_jax():
    jc, tc = _cfgs()
    jp, tp = jtfm.init_params(jc, seed=3), ttfm.init_params(tc, seed=3)
    assert list(tp) == list(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    assert tuple(tp["ffn_up_weight"].shape) == (2, 4, 64, 128)
    carried = ttfm.params_from_jax(jp, device="cpu")
    for k in MOE_KEYS:
        assert torch.equal(carried[k], tp[k]), k


def test_loss_and_every_gradient_match_jax_one_device():
    toks = mw.moe_tokens(1)
    jloss, jgrads = _jax_loss_and_grads(
        make_mesh({"dp": 1}, devices=jax.devices()[:1]), toks)
    loss, grads = _port_loss_and_grads(toks)
    np.testing.assert_allclose(loss, jloss, **TOL)
    _hold(grads, jgrads, "one device")
    assert all(np.abs(grads[k]).max() > 0 for k in MOE_KEYS)


def test_train_steps_match_jax_one_device():
    jc, tc = _cfgs()
    jstep, jplace = jtfm.make_train_step(
        jc, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
        optimizer=dict(mw.OPT))
    tstep, tplace = ttfm.make_train_step(tc, optimizer=dict(mw.OPT),
                                         device="cpu")
    jcarry = jplace(jtfm.init_params(jc, seed=0))
    tcarry = tplace(ttfm.init_params(tc, seed=0))
    for i in range(mw.STEPS):
        toks = mw.moe_tokens(20 + i)
        jcarry, jloss = jstep(jcarry, jnp.asarray(toks))
        tcarry, tloss = tstep(tcarry, toks)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _hold({k: v.detach().numpy() for k, v in tcarry[0].items()},
          jcarry[0], "params after steps")


def test_forward_matches_jax_and_prefill_decode_use_the_moe():
    jc, tc = _cfgs()
    jp = jtfm.init_params(jc, seed=0)
    tp = ttfm.params_from_jax(jp, device="cpu")
    toks = mw.moe_tokens(4)[:2, :16]
    ref = np.asarray(jtfm.make_forward_fn(jc)(jp, jnp.asarray(toks)))
    got = ttfm.make_forward_fn(tc, device="cpu")(tp, toks)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    page = 8
    cache = ttfm.init_kv_cache(tc, 4, page, device="cpu")
    cache, last = ttfm.make_prefill_fn(tc, page, device="cpu")(
        tp, cache, toks[:1], 16, np.array([1, 2]))
    np.testing.assert_allclose(last.numpy(), got[0, 15].numpy(), **TOL)
    dense = dict(tp, ffn_up_weight=tp["ffn_up_weight"][:, 0],
                 ffn_down_weight=tp["ffn_down_weight"][:, 0])
    del dense["moe_gate_weight"]
    other = ttfm.make_forward_fn(ttfm.TransformerConfig(
        **dict(CFG, n_experts=0)), device="cpu")(dense, toks)
    assert np.abs(other.numpy() - ref).max() > 1e-3


def test_ep_mesh_still_raises_by_name(mp_runs):
    ranks, _ref = mp_runs
    msg = ranks[0]["ep_refusal"]
    assert msg is not None and "'ep'" in msg and "item 8c" in msg


# ---------------------------------------------------------------------------
# mp = 2
# ---------------------------------------------------------------------------
def test_mp_shards_keep_the_expert_axis_whole(mp_runs):
    ranks, _ref = mp_runs
    shapes = ranks[0]["shard_shapes"]
    assert shapes["moe_gate_weight"] == (2, 64, 4)
    assert shapes["ffn_up_weight"] == (2, 4, 64, 64)
    assert shapes["ffn_down_weight"] == (2, 4, 64, 64)


def test_mp_counts_match_jax(mp_runs):
    ranks, ref = mp_runs
    assert ranks[0]["counts"] == ref["counts"]
    assert ranks[0]["counts"]["psum_per_block"] == 2


@pytest.mark.parametrize("against", ["jax_mp2", "port_one_device"])
def test_mp_loss_and_every_gradient(mp_runs, against):
    ranks, ref = mp_runs
    loss, grads = ref["grad"] if against == "jax_mp2" else ref["one"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, **TOL)
        _hold(r["grads"], grads, against)


def test_mp_gate_gradient_needs_its_sum_over_the_group(mp_runs):
    """Without the sum, each rank keeps its partial gate cotangent: the
    gate's gradient (and the gradients upstream of it) leave the tolerance,
    and the last layer's experts' own, which no gate feeds, stay in it."""
    ranks, ref = mp_runs
    grads = ref["grad"][1]
    fault = ranks[0]["fault_grads"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(fault["moe_gate_weight"],
                                   grads["moe_gate_weight"], **TOL)
    np.testing.assert_allclose(fault["ffn_up_weight"][-1],
                               grads["ffn_up_weight"][-1], **TOL)


def test_mp_train_steps_match_jax_and_keep_the_gate_replicated(mp_runs):
    ranks, ref = mp_runs
    losses, params = ref["steps"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, **TOL)
        _hold(r["params"], params, "params after steps")
    np.testing.assert_array_equal(ranks[0]["gate"], ranks[1]["gate"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _prompts(seed=5, n=4, prefix=16, tail=5):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, CFG["vocab"], prefix).tolist()
    return [np.asarray(head + rng.randint(1, CFG["vocab"], tail + i).tolist(),
                       np.int32) for i in range(n)]


def _chains(server, prompts):
    with server as srv:
        return [list(srv.generate(p, max_new_tokens=8)["tokens"])
                for p in prompts]


@pytest.mark.parametrize("extra", [{}, dict(prefix_cache=True, spec_k=2,
                                            draft=1)],
                         ids=["plain", "prefix_spec"])
def test_generate_server_chains_match_jax(extra):
    jc, tc = _cfgs()
    jp = jtfm.init_params(jc, seed=0)
    tp = ttfm.params_from_jax(jp, device="cpu")
    kw = dict(slots=2, page_size=8, max_steps=8, **extra)
    prompts = _prompts()
    ours = _chains(GenerateServer(tc, tp, device="cpu", **kw), prompts)
    theirs = _chains(JaxGenerateServer(jc, jp, **kw), prompts)
    assert ours == theirs
    assert all(len(c) == 8 for c in ours)
