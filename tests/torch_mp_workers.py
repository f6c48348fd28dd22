"""Rank processes for the port's tensor-parallel tests (imported by the
spawned ranks, so it imports neither JAX nor ``mxnet_tpu``).

The ranks are started by ``torch_dp_workers.start_ranks`` with a function
name ``"torch_mp_workers:<name>"``; each joins a gloo group on the CPU and
returns its results, which the parent holds against the JAX package's
sharded functions and the port's one-device ones. Every input is made from
a numpy seed, so the parent makes the same ones.
"""
import os
import signal
import time

import numpy as np
import torch

# tests/test_model_parallel.py's tiny model; serving at its sharded-bind
# setup (max_len 32, 2 slots, pages of 4)
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=16,
           dtype="float32")
SERVE_CFG = dict(CFG, max_len=32)
SLOTS, PAGE = 2, 4
BATCH = (4, 9)
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9)
STEPS = 3
# the served workload: prompts under one 8-token prefix (two full pages)
# and others, 6 new tokens each
PREFIX = [7, 3, 12, 40, 5, 9, 33, 21]
NEW_TOKENS = 6


def tokens(seed=0, shape=BATCH):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab"], shape).astype(np.int32)


def prompts():
    rng = np.random.RandomState(3)
    out = []
    for i in range(6):
        tail = rng.randint(1, CFG["vocab"], rng.randint(1, 6)).tolist()
        head = PREFIX if i % 2 == 0 else rng.randint(
            1, CFG["vocab"], 8).tolist()
        out.append(np.asarray(head + tail, np.int32))
    return out


def _tfm():
    from mxnet_tpu_torch.models import transformer as tfm

    return tfm


def loss_and_grads(cfg, mesh, params, fault=False):
    """The loss and this rank's gradient, unsharded (its data rank's
    share), of ``make_loss_fn`` on ``mesh``. ``fault`` plants the
    conjugate error: the mp sums' backward sums too
    (``all_reduce_autograd``)."""
    tfm = _tfm()
    if fault:
        from mxnet_tpu_torch.parallel.mesh import all_reduce_autograd

        real = tfm.reduce_from_mp
        tfm.reduce_from_mp = lambda t, tp: t if tp is None else \
            all_reduce_autograd(t, tp[0])
    try:
        loss_fn, _specs = tfm.make_loss_fn(cfg, mesh, device="cpu")
        p = {k: v.requires_grad_() for k, v in
             tfm.shard_params(params, cfg, mesh).items()}
        loss = loss_fn(p, tokens())
        grads = torch.autograd.grad(loss, list(p.values()))
    finally:
        if fault:
            tfm.reduce_from_mp = real
    full = tfm.unshard(dict(zip(p, grads)), cfg, mesh)
    return loss.item(), {k: v.numpy() for k, v in full.items()}


def mp_train_worker(rank, world, mp):
    """Sharding, the loss and its gradient, the collective counts and
    ``STEPS`` train steps on ``train_mesh(mp=mp)``; on 2 ranks also the
    ``tp`` alias, a ``{"dp": 2}`` mesh, the planted fault and the loss on
    ``sp`` and ``ep`` meshes."""
    from mxnet_tpu_torch.parallel.mesh import (data_group, make_mesh,
                                               model_group, train_mesh)

    tfm = _tfm()
    cfg = tfm.TransformerConfig(**CFG)
    params = tfm.init_params(cfg, seed=0)
    mesh = train_mesh(mp=mp, device="cpu")
    out = {"axes": mesh.mesh_dim_names, "model": model_group(mesh)[1:],
           "data": data_group(mesh)[1:]}
    shards = tfm.shard_params(params, cfg, mesh)
    back = tfm.unshard(shards, cfg, mesh)
    out["roundtrip"] = all(torch.equal(back[k], params[k]) for k in params)
    out["shard_shapes"] = {k: tuple(v.shape) for k, v in shards.items()}
    out["specs"] = (tfm.param_specs(cfg, mesh), tfm.kv_cache_spec(mesh))
    out["loss"], out["grads"] = loss_and_grads(cfg, mesh, params)
    out["counts"] = {"mesh": tfm.block_collective_counts(cfg, mesh)}

    step, place = tfm.make_train_step(cfg, mesh, optimizer=dict(OPT),
                                      device="cpu")
    carry = place(params)
    out["losses"] = []
    for i in range(STEPS):
        carry, loss = step(carry, tokens(10 + i))
        out["losses"].append(float(loss))
    out["params"] = {k: v.detach().numpy() for k, v in tfm.unshard(
        {k: v.detach() for k, v in carry[0].items()}, cfg, mesh).items()}
    out["momentum"] = {k: v.numpy() for k, v in
                       tfm.unshard(carry[1], cfg, mesh).items()}
    sharded = {k for k, spec in tfm.param_specs(cfg, mesh).items()
               if "mp" in spec}
    out["replicated"] = {k: v.detach().numpy().copy()
                         for k, v in carry[0].items() if k not in sharded}
    if world == 2:
        out["counts"]["dp"] = tfm.block_collective_counts(
            cfg, make_mesh({"dp": 2}, device="cpu"))
        tp_mesh = make_mesh({"dp": 1, "tp": 2}, device="cpu")
        out["tp_specs"] = (tfm.param_specs(cfg, tp_mesh),
                           tfm.kv_cache_spec(tp_mesh))
        out["tp_loss"], out["tp_grads"] = loss_and_grads(cfg, tp_mesh,
                                                         params)
        out["fault_grads"] = loss_and_grads(cfg, mesh, params, fault=True)[1]
        out["moe_specs"] = tfm.param_specs(
            tfm.TransformerConfig(**dict(CFG, n_experts=2)), mesh)
        out["axis_losses"] = []
        for axes in ({"dp": 1, "sp": 2}, {"dp": 1, "ep": 2}):
            mesh2 = make_mesh(axes, device="cpu")
            loss_fn, _specs = tfm.make_loss_fn(cfg, mesh2, device="cpu")
            out["axis_losses"].append(loss_fn(
                tfm.shard_params(params, cfg, mesh2), tokens()).item())
    return out


def mp_knob_worker(rank, world):
    """``train_mesh()`` with no ``mp=``: the mesh ``MXNET_MP_SIZE`` (2,
    set here in the rank's own environment) gives."""
    from mxnet_tpu_torch.parallel.mesh import model_group, train_mesh

    os.environ["MXNET_MP_SIZE"] = "2"
    mesh = train_mesh(device="cpu")
    return {"axes": mesh.mesh_dim_names, "model": model_group(mesh)[1:]}


def predictor_script(pred):
    """One predictor's calls (the port's or the JAX package's: the same
    API): a prefill, a decode step, a 2-token extend and a tail prefill
    over a shared first page. Returns each call's logits (numpy)."""
    out = {}
    prompt = np.array([5, 9, 3, 7, 1, 11, 2, 8, 4], np.int32)
    pages = pred.pool.alloc(pred.pages_needed(len(prompt) + 3))
    out["prefill"] = pred.prefill(prompt, pages[:pred.pages_needed(
        len(prompt))])
    bt = np.zeros((pred.slots, pred.max_pages_per_slot), np.int32)
    bt[0, :len(pages)] = pages
    first = int(np.argmax(out["prefill"]))
    out["decode"] = pred.decode(np.array([first, 0], np.int32),
                                np.array([len(prompt), 0], np.int32), bt,
                                np.array([True, False]))
    out["extend"] = pred.extend(np.array([[3, 4], [0, 0]], np.int32),
                                np.array([[10, 11], [0, 0]], np.int32), bt,
                                np.array([[True, True], [False, False]]))
    tail = pred.pool.alloc(2)
    out["extend_tail"] = pred.extend_tail(np.array([6, 1, 9, 2, 7], np.int32),
                                          PAGE, [pages[0]] + tail)
    return out


def serve(server_cls, cfg, params, prefix_cache, **kw):
    """Tokens and prefix counters of ``prompts()`` through a
    GenerateServer: all submitted at once without the prefix cache (the
    slots batch them), one after another with it (so each shared prompt
    finds the pages of the ones before)."""
    from mxnet_tpu_torch import profiler

    profiler.generate_reset()
    srv = server_cls(cfg, params, slots=SLOTS, page_size=PAGE,
                     prefix_cache=prefix_cache, **kw)
    try:
        if prefix_cache:
            res = [srv.generate(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts()]
        else:
            futs = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                    for p in prompts()]
            res = [f.result(timeout=120) for f in futs]
        stats = srv.stats()
    finally:
        srv.close()
    return {"tokens": [r["tokens"] for r in res],
            "hits": stats["prefix_hits"],
            "saved": stats["prefill_tokens_saved"],
            "prefills": stats["prefills"]}


def mp_serve_worker(rank, world):
    """The sharded predictor and GenerateServer over it on
    ``train_mesh(mp=2)``: rank 0 leads, rank 1 follows three predictors
    (the script's, then a server's without and with the prefix cache)."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving import GenerateServer
    from mxnet_tpu_torch.serving.generate import (GenerateError,
                                                  GenerativePredictor)

    tfm = _tfm()
    cfg = tfm.TransformerConfig(**SERVE_CFG)
    params = tfm.init_params(cfg, seed=0)
    mesh = train_mesh(mp=2, device="cpu")

    def predictor():
        return GenerativePredictor(cfg, params, slots=SLOTS, page_size=PAGE,
                                   mesh=mesh)

    if rank != 0:
        pred = predictor()
        out = {"kv_shape": tuple(pred._kv.shape), "calls": []}
        out["calls"].append(pred.follow())
        for _ in range(2):
            out["calls"].append(predictor().follow())
        return out
    pred = predictor()
    out = {"kv_shape": tuple(pred._kv.shape)}
    out["script"] = predictor_script(pred)
    profiler.mp_reset()
    out["stats"] = pred.sharded_stats()
    out["mp_stats"] = profiler.mp_stats()
    out["errors"] = {}
    try:
        GenerateServer(predictor=pred, spec_k=2, draft_config=cfg,
                       draft_params=params)
    except GenerateError as e:
        out["errors"]["spec"] = str(e)
    try:
        GenerativePredictor(cfg, params, slots=SLOTS, page_size=PAGE,
                            mesh=mesh, device="cpu")
    except GenerateError as e:
        out["errors"]["device"] = str(e)
    pred.close()
    try:
        pred.prefill(np.array([1, 2], np.int32), pred.pool.alloc(1))
    except GenerateError as e:
        out["errors"]["closed"] = str(e)
    out["served"] = {on: serve(GenerateServer, cfg, params, on, mesh=mesh)
                     for on in (False, True)}
    return out


def dead_follower_worker(rank, world):
    """Rank 1 dies (SIGKILL) once the predictor is made; rank 0 serves a
    request and must get an error, not hang. Returns rank 0's error and
    the seconds it took."""
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving import GenerateServer
    from mxnet_tpu_torch.serving.generate import GenerativePredictor

    tfm = _tfm()
    cfg = tfm.TransformerConfig(**SERVE_CFG)
    pred = GenerativePredictor(cfg, tfm.init_params(cfg, seed=0),
                               slots=SLOTS, page_size=PAGE,
                               mesh=train_mesh(mp=2, device="cpu"))
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    srv = GenerateServer(predictor=pred)
    t0 = time.monotonic()
    try:
        srv.generate(prompts()[0], max_new_tokens=2)
        err = None
    except Exception as e:          # the test reads which error it was
        err = "%s: %s" % (type(e).__name__, e)
    seconds = time.monotonic() - t0
    srv.close()
    return {"error": err, "seconds": seconds}


# the MoE parity tests' model (tests/test_torch_moe.py)
MOE_CFG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
               max_len=64, n_experts=4, dtype="float32")
MOE_BATCH = (4, 17)


def moe_tokens(seed=0):
    return np.random.RandomState(seed).randint(
        0, MOE_CFG["vocab"], MOE_BATCH).astype(np.int32)


def _moe_without_gate_sum(ln, h, lp, cdt, tp=None, ep=None):
    """The MoE branch with the gate's cotangent left partial on each rank
    (no sum over the mp group): the fault the parity test must catch (on
    an mp mesh: ``ep`` is None)."""
    import torch.nn.functional as F

    gate = torch.softmax(torch.einsum("bsd,de->bse", ln.float(),
                                      lp["moe_gate_weight"].float()), dim=-1)
    up = F.relu(torch.einsum("bsd,edf->besf", h, lp["ffn_up_weight"].to(cdt)))
    down = torch.einsum("besf,efd->besd", up, lp["ffn_down_weight"].to(cdt))
    return torch.einsum("besd,bse->bsd", down, gate.to(cdt))


def moe_mp_worker(rank, world):
    """The MoE transformer on ``train_mesh(mp=2)``: its shards, the loss
    and every gradient (and again with the gate's sum over the group taken
    out), the collective counts, ``STEPS`` train steps and the replicated
    params after them, and the serving step's ``ep`` refusal."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.mesh import make_mesh, train_mesh

    tfm = _tfm()
    cfg = tfm.TransformerConfig(**MOE_CFG)
    params = tfm.init_params(cfg, seed=0)
    mesh = train_mesh(mp=2, device="cpu")
    out = {"shard_shapes": {k: tuple(v.shape) for k, v in
                            tfm.shard_params(params, cfg, mesh).items()}}
    loss_fn, _specs = tfm.make_loss_fn(cfg, mesh, device="cpu")

    def loss_and_grads():
        p = {k: v.requires_grad_() for k, v in
             tfm.shard_params(params, cfg, mesh).items()}
        loss = loss_fn(p, moe_tokens())
        grads = torch.autograd.grad(loss, list(p.values()))
        full = tfm.unshard(dict(zip(p, grads)), cfg, mesh)
        return loss.item(), {k: v.numpy() for k, v in full.items()}

    out["loss"], out["grads"] = loss_and_grads()
    real = tfm._moe
    tfm._moe = _moe_without_gate_sum
    try:
        out["fault_grads"] = loss_and_grads()[1]
    finally:
        tfm._moe = real
    out["counts"] = tfm.block_collective_counts(cfg, mesh)
    step, place = tfm.make_train_step(cfg, mesh, optimizer=dict(OPT),
                                      device="cpu")
    carry = place(params)
    out["losses"] = []
    for i in range(STEPS):
        carry, loss = step(carry, moe_tokens(10 + i))
        out["losses"].append(float(loss))
    out["params"] = {k: v.detach().numpy() for k, v in tfm.unshard(
        {k: v.detach() for k, v in carry[0].items()}, cfg, mesh).items()}
    out["gate"] = carry[0]["moe_gate_weight"].detach().numpy().copy()
    try:
        tfm.make_prefill_fn(cfg, 8, mesh=make_mesh({"dp": 1, "ep": 2},
                                                   device="cpu"))
        out["ep_refusal"] = None
    except MXNetError as e:
        out["ep_refusal"] = str(e)
    return out
