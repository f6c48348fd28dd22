"""Transformer training in the PyTorch port (``make_loss_fn``,
``make_train_step``, the functional optimizers and the lr schedulers)
against the JAX package, on the CPU at a small size.

Inputs come from numpy seeds and go through both packages. The JAX loss
runs on a one-device ``dp`` mesh (as tests/test_transformer.py does), where
its attention is ``full_attention``; the port's is its flash-attention
autograd Function, whose CPU backward is the plain version of B6/B7.
Tolerances: loss and gradients in fp32 rtol 1e-4 / atol 1e-5 (ROADMAP's
parity tolerance: summation order only); optimizer updates rtol 1e-5 /
atol 1e-6 (the same fp32 arithmetic, elementwise, except adam's bias
correction lr * sqrt(1 - beta2**t) / (1 - beta1**t): a host scalar that
the port takes in fp64 and the JAX package in fp32, where 1 - 0.999**t
loses ~1e-5 of its value to cancellation at small t).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import lr_scheduler as jlr
from mxnet_tpu.models import transformer as jtfm
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.parallel import spmd as jspmd
from mxnet_tpu_torch import lr_scheduler as tlr
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as fa
from mxnet_tpu_torch.models import transformer as ttfm
from mxnet_tpu_torch.parallel import FunctionalOptimizer, functional_optimizer

SMALL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-5)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)


def _tokens(seed=0, shape=(4, 17)):
    return np.random.RandomState(seed).randint(0, 64, shape).astype(np.int32)


def _mesh1():
    return make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _cfgs(**kw):
    c = dict(SMALL, **kw)
    return jtfm.TransformerConfig(**c), ttfm.TransformerConfig(**c)


def _torch_loss_and_grads(tc, params, toks):
    loss_fn, specs = ttfm.make_loss_fn(tc, device="cpu")
    assert specs is None
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = loss_fn(p, toks)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss, dict(zip(p, grads))


def test_loss_and_every_gradient_match_jax():
    jc, tc = _cfgs()
    jp, tp = jtfm.init_params(jc, seed=0), ttfm.init_params(tc, seed=0)
    toks = _tokens()
    jloss_fn, _ = jtfm.make_loss_fn(jc, _mesh1())
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jp,
                                                         jnp.asarray(toks))
    loss, grads = _torch_loss_and_grads(tc, tp, toks)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), **TOL,
                                   err_msg=k)


def test_bf16_compute_loss_and_gradients_near_jax():
    """bf16 compute: the two packages round to bf16 at other places (the
    JAX CPU path casts the softmax to bf16 before p.v, the port's flash
    path keeps it fp32). Loss within 2e-2 (~0.5% of ln 64); each gradient
    within 25% of its largest entry: at this size the JAX package's own
    bf16 gradients sit up to 14.5% of the largest entry from its fp32
    ones (ffn_up_weight), and the port's as far."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp, tp = jtfm.init_params(jc, seed=1), ttfm.init_params(tc, seed=1)
    toks = _tokens(1)
    jloss_fn, _ = jtfm.make_loss_fn(jc, _mesh1())
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jp,
                                                         jnp.asarray(toks))
    loss, grads = _torch_loss_and_grads(tc, tp, toks)
    assert abs(loss.item() - float(jloss)) < 2e-2
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        ref = np.asarray(jgrads[k])
        assert np.abs(g.numpy() - ref).max() <= 0.25 * np.abs(ref).max(), k


def test_remat_is_bit_identical_and_recomputes_the_forward(monkeypatch):
    """``remat=True`` recomputes each layer in the backward
    (torch.utils.checkpoint): the same loss and gradients bit for bit, and
    twice the attention forwards (on the card: 2x B5 launches)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_reference, fa.flash_attention_bwd_reference

    def count_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_reference", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", count_bwd)
    _, tc = _cfgs()
    tp = ttfm.init_params(tc, seed=0)
    toks = _tokens(2)
    out = {}
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        tc.remat = remat
        out[remat] = _torch_loss_and_grads(tc, tp, toks)
        assert calls == {"fwd": (1 + remat) * tc.n_layers,
                         "bwd": tc.n_layers}, (remat, calls)
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][1].items():
        assert torch.equal(g, out[True][1][k]), k


OPTIMIZERS = {
    "sgd_momentum": dict(name="sgd", learning_rate=0.1, momentum=0.9),
    "adam_wd_clip": dict(name="adam", learning_rate=0.01, wd=0.01,
                         clip_gradient=0.05),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_three_train_steps_match_jax(opt):
    jc, tc = _cfgs()
    params = ttfm.init_params(tc, seed=3)
    toks = [_tokens(10 + i) for i in range(3)]
    jstep, jplace = jtfm.make_train_step(jc, _mesh1(),
                                         optimizer=dict(OPTIMIZERS[opt]))
    jcarry = jplace({k: jnp.asarray(v.numpy()) for k, v in params.items()})
    step, place = ttfm.make_train_step(tc, optimizer=dict(OPTIMIZERS[opt]),
                                       device="cpu")
    carry = place(params)
    for i, t in enumerate(toks):
        jcarry, jloss = jstep(jcarry, jnp.asarray(t))
        carry, loss = step(carry, t)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL,
                                   err_msg="step %d" % i)
    assert carry[2] == int(jcarry[2]) == 3
    for k, w in carry[0].items():
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(jcarry[0][k]), **TOL, err_msg=k)
        got, want = carry[1][k], jcarry[1][k]
        for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL,
                                       err_msg=k)


def test_train_step_learns_in_place_and_leaves_the_init_alone():
    _, tc = _cfgs()
    params = ttfm.init_params(tc, seed=0)
    init = {k: v.clone() for k, v in params.items()}
    step, place = ttfm.make_train_step(tc, device="cpu")   # sgd 0.1 / 0.9
    carry = place(params)
    placed = carry[0]["embed_weight"]
    toks = _tokens(4)
    losses = []
    for _ in range(6):
        carry, loss = step(carry, toks)
        assert not loss.requires_grad
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert carry[0]["embed_weight"] is placed and carry[2] == 6
    for k, v in params.items():
        assert torch.equal(v, init[k]), k


def _opt_params(rng):
    return {"fc_weight": rng.randn(6, 5).astype(np.float32),
            "fc_bias": rng.randn(5).astype(np.float32),
            "bn_gamma": rng.randn(5).astype(np.float32),
            "bn_beta": rng.randn(5).astype(np.float32)}


def _schedule(mod):
    return mod.FactorScheduler(step=2, factor=0.5, base_lr=0.05)


OPT_CASES = {
    "sgd": lambda lr: dict(name="sgd", learning_rate=0.1),
    "sgd_momentum_wd_mults": lambda lr: dict(
        name="sgd", learning_rate=0.1, momentum=0.9, wd=0.01,
        lr_mult={"fc_bias": 2.0}, wd_mult={"fc_weight": 0.5}),
    "sgd_wd_pattern": lambda lr: dict(name="sgd", learning_rate=0.1,
                                      momentum=0.5, wd=0.1),
    "adam_rescale_clip_schedule": lambda lr: dict(
        name="adam", learning_rate=0.01, wd=0.01, rescale_grad=0.5,
        clip_gradient=0.3, lr_scheduler=_schedule(lr)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_functional_optimizer_matches_jax_update_by_update(case):
    rng = np.random.RandomState(5)
    init = _opt_params(rng)
    jopt = jspmd.functional_optimizer(**OPT_CASES[case](jlr))
    topt = functional_optimizer(**OPT_CASES[case](tlr))
    assert isinstance(topt, FunctionalOptimizer)
    assert topt.hyper == jopt.hyper
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for n in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in init.items()}
        jp, js = jopt.apply(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                            js, jnp.int32(n))
        tp2, ts2 = topt.apply(tp, {k: torch.from_numpy(g)
                                   for k, g in grads.items()}, ts, n)
        assert tp2 is tp and ts2 is ts          # updated in place
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **OPT_TOL, err_msg="%s %d" % (k, n))
        leaves_j = jax.tree_util.tree_leaves(js)
        leaves_t = [x for k in sorted(ts) for x in
                    (ts[k] if isinstance(ts[k], tuple) else (ts[k],))]
        assert len(leaves_j) == len(leaves_t)
        for a, b in zip(leaves_t, leaves_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL)


def test_unknown_optimizer_and_bad_optimizer_type_raise():
    with pytest.raises(MXNetError, match="unknown optimizer"):
        functional_optimizer("rmsprop")
    _, tc = _cfgs()
    with pytest.raises(MXNetError, match="FunctionalOptimizer"):
        ttfm.make_train_step(tc, optimizer=object(), device="cpu")


SCHEDULERS = {
    "factor": lambda m: m.FactorScheduler(step=3, factor=0.5,
                                          stop_factor_lr=1e-3, base_lr=0.1),
    "multifactor": lambda m: m.MultiFactorScheduler(step=[2, 5, 9],
                                                    factor=0.1, base_lr=1.0),
    "poly": lambda m: m.PolyScheduler(max_update=12, base_lr=0.2, pwr=2),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULERS))
def test_lr_schedulers_match_jax(kind):
    js, ts = SCHEDULERS[kind](jlr), SCHEDULERS[kind](tlr)
    assert [ts(n) for n in range(20)] == [js(n) for n in range(20)]


@pytest.mark.parametrize("bad", [
    lambda m: m.FactorScheduler(step=0), lambda m: m.FactorScheduler(
        step=1, factor=2.0), lambda m: m.MultiFactorScheduler(step=[3, 2]),
    lambda m: m.PolyScheduler(max_update=0)])
def test_lr_schedulers_refuse_what_jax_refuses(bad):
    with pytest.raises(Exception) as jerr:
        bad(jlr)
    with pytest.raises(MXNetError) as terr:
        bad(tlr)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("make", [
    lambda c: ttfm.make_loss_fn(c), lambda c: ttfm.make_train_step(c)],
    ids=["loss", "train_step"])
def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        make(ttfm.TransformerConfig(**SMALL))


def test_training_refuses_params_on_another_device():
    _, tc = _cfgs()
    meta = {k: v.to("meta") for k, v in ttfm.init_params(tc).items()}
    loss_fn, _ = ttfm.make_loss_fn(tc, device="cpu")
    with pytest.raises(MXNetError, match="params is on meta"):
        loss_fn(meta, _tokens())
    step, _place = ttfm.make_train_step(tc, device="cpu")
    with pytest.raises(MXNetError, match="params is on meta"):
        step((meta, {}, 0), _tokens())


@pytest.mark.parametrize("make", [
    lambda c, m: ttfm.make_loss_fn(c, m, device="cpu"),
    lambda c, m: ttfm.make_train_step(c, m, device="cpu")],
    ids=["loss", "train_step"])
def test_mesh_sharding_raises_not_ported(make):
    _, tc = _cfgs()
    with pytest.raises(MXNetError, match="mesh sharding is not ported yet"):
        make(tc, _mesh1())


def test_moe_training_is_refused_by_name():
    _, tc = _cfgs(n_experts=2)
    with pytest.raises(MXNetError, match="MoE"):
        ttfm.make_loss_fn(tc, device="cpu")
