"""Rank processes for the port's tests of a symbol sharded over the mp axis
(``tests/test_torch_mp_symbol.py``; imported by the spawned ranks, so it
imports neither JAX nor ``mxnet_tpu``).

The ranks are started by ``torch_dp_workers.start_ranks`` with a function
name ``"torch_mp_symbol_workers:<name>"``; each joins a gloo group on the
CPU. Nets are built by :func:`net` from either package's ``mx`` (the
parent builds the JAX package's with the same function), and every input
comes in as numpy from the parent.
"""
import os
import time

import numpy as np
import torch

# the rules of the JAX package's tests/test_model_parallel.py
MLP_RULES = "fc1_weight:mp,*;fc2_weight:*,mp"
CONV_RULES = "conv1_weight:mp,*,*,*;fc1_weight:*,mp"
PRED_RULES = [("fc1_weight", (None, "mp")), ("fc2_weight", ("mp", None))]


def net(mx, kind):
    """``mlp``: the JAX test's Megatron pair (fc1 32 wide, relu, fc2 4);
    ``conv``: a conv whose weight is gathered at use, BatchNorm, pooling
    and a lone FC sharded on its input dim (gathered too); ``pred``: the
    sharded predictor test's tanh MLP."""
    d = mx.sym.Variable("data")
    if kind == "mlp":
        h = mx.sym.FullyConnected(d, num_hidden=32, name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    elif kind == "conv":
        h = mx.sym.Convolution(d, num_filter=8, kernel=(3, 3), pad=(1, 1),
                               name="conv1")
        h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                           name="pool1")
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc1")
    else:
        h = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
        h = mx.sym.Activation(h, act_type="tanh", name="tanh1")
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def data(kind, n, seed=0):
    """``(data, label)`` numpy batches of ``n`` rows for ``kind``."""
    rng = np.random.RandomState(seed)
    shape = (n, 2, 6, 6) if kind == "conv" else (n, 16) if kind == "mlp" \
        else (n, 8)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, 4, (n,)).astype(np.float32)
    return x, y


def params(mx, sym, kind, seed=0, scale=0.2):
    """Whole params and aux (numpy) of ``sym`` at ``kind``'s shapes."""
    x, _ = data(kind, 2)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=x.shape)
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if "var" in n else np.zeros(s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _rules(text):
    from mxnet_tpu_torch.parallel.spmd import parse_rules

    return parse_rules(text)


def trainstep_worker(rank, world, kind, rules, mp, batches, opt,
                     fault=False, zero=False):
    """``TrainStep(mesh=train_mesh(mp=mp), param_rules=rules)`` for one
    step a batch from the whole params; each rank's losses, whole params
    (gathered), aux, memory and mp stats, collective counts. ``fault``
    drops the row-parallel FC's sum over the mp group; ``zero`` shards the
    update of every replicated param over the data axis (ZeRO)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel import tensor_parallel as tpl
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.parallel.spmd import TrainStep

    if fault:
        # the planted fault: each rank keeps its partial product
        tpl.reduce_from_mp = lambda t, tp: t
    sym = net(mx, kind)
    mesh = train_mesh(mp=mp, device="cpu")
    ts = TrainStep(sym, dict(opt), mesh=mesh, param_rules=_rules(rules),
                   zero=zero, zero_min_size=0)
    args, aux = params(mx, sym, kind)
    profiler.mp_reset()
    tpl.reset_counts()
    carry = ts.place({k: torch.from_numpy(v.copy()) for k, v in args.items()},
                     ts.optimizer.init({k: torch.from_numpy(v.copy())
                                        for k, v in args.items()}),
                     {k: torch.from_numpy(v.copy()) for k, v in aux.items()})
    held = {k: tuple(v.shape) for k, v in carry[0].items()}
    mem = ts.memory_stats(carry)
    losses = []
    for x, y in batches:
        carry, loss = ts(carry, {"data": x, "softmax_label": y})
        losses.append(float(loss))
    whole = ts.whole_params(carry[0])
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy() for k, v in
                       whole.items()},
            "aux": {k: v.numpy().copy() for k, v in carry[2].items()},
            "held": held, "mem": mem, "mp_stats": profiler.mp_stats(),
            "counts": tpl.counts(), "bytes": tpl.wire_bytes(),
            "opt": {k: [t.numpy().copy() for t in (v if isinstance(
                v, (tuple, list)) else (v,))]
                for k, v in ts.logical_opt_state(carry[1],
                                                 carry[0]).items()}}


def module_data():
    """The JAX test's data: 128 rows of 16 features, 4 classes."""
    rng = np.random.RandomState(0)
    X = rng.randn(128, 16).astype(np.float32)
    y = X.dot(rng.randn(16, 4)).argmax(axis=1).astype(np.float32)
    return X, y, rng


def module_args(mx, rng):
    """The JAX test's initial params, drawn after its data from ``rng``."""
    sym = net(mx, "mlp")
    shapes, _, _ = sym.infer_shape(data=(2, 16))
    return {n: rng.normal(0, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def module_worker(rank, world, env, args0, epochs=2, batch=32):
    """``Module(kvstore='tpu')`` under ``env`` (the mp knobs) for
    ``epochs`` over :func:`module_data`: the whole params from
    ``get_params``, the ``mp_stats`` gauge and the fused path's use."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler

    os.environ.update(env)
    X, y, _ = module_data()
    profiler.mp_reset()
    with mx.cpu():
        it = mx.io.NDArrayIter(X, y, batch_size=batch, shuffle=False)
        mod = mx.mod.Module(net(mx, "mlp"), context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in args0.items()})
        mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        fused = mod._fused is not None
        for _ in range(epochs):
            it.reset()
            for b in it:
                mod.forward_backward(b)
                mod.update()
        arg, _aux = mod.get_params()
        held = {k: tuple(v.shape) for k, v in mod._fused._carry[0].items()}
        return {"params": {k: v.asnumpy() for k, v in arg.items()},
                "mp_stats": profiler.mp_stats(), "fused": fused,
                "held": held}


def module_batch_worker(rank, world, batch):
    """The error a Module under ``MXNET_MP_SIZE=2`` gives for a batch the
    dp size does not divide."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError

    os.environ.update({"MXNET_MP_SIZE": "2"})
    X, y, rng = module_data()
    with mx.cpu():
        it = mx.io.NDArrayIter(X[:batch * 2], y[:batch * 2],
                               batch_size=batch)
        mod = mx.mod.Module(net(mx, "mlp"), context=mx.cpu())
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v) for k, v in
                                    module_args(mx, rng).items()})
        try:
            mod.init_optimizer(kvstore="tpu", optimizer="sgd")
        except MXNetError as e:
            return str(e)
    return None


def predictor_worker(rank, world, args, x, rules):
    """The sharded predictor test's ``AOTPredictor(mesh=train_mesh(mp=2),
    param_rules=rules)`` on every rank: rank 0 predicts ``x`` and reads
    ``sharded_stats``, the others follow; each rank also reports the
    grammar and placement errors."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving import AOTPredictor
    from mxnet_tpu_torch.serving.predictor import ServingError

    sym = net(mx, "pred")
    mesh = train_mesh(mp=2, device="cpu")
    pred = AOTPredictor(sym, args, data_shapes={"data": (1, 8)},
                        mesh=mesh, param_rules=rules, ladder=(1, 4))
    out = {"shards": {k: tuple(v.shape) for k, v in pred._shards.items()}}
    if rank != 0:
        out["calls"] = pred.follow()
        return out
    profiler.mp_reset()
    out["outs"] = pred.predict({"data": x})
    out["stats"] = pred.sharded_stats()
    out["mp_stats"] = profiler.mp_stats()
    errors = {}
    try:
        AOTPredictor(sym, args, data_shapes={"data": (1, 8)}, mesh=mesh,
                     device="cpu")
    except ServingError as e:
        errors["device"] = str(e)
    try:
        pred.swap_params(args)
    except ServingError as e:
        errors["swap"] = str(e)
    out["errors"] = errors
    pred.close()
    try:
        pred.predict({"data": x})
    except ServingError as e:
        errors["closed"] = str(e)
    return out


# speculative decoding on a sharded tiny transformer: tests/
# test_model_parallel.py's tiny config, the prompts of torch_mp_workers
SPEC_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=32, dtype="float32")
SPEC_K, SPEC_DRAFT, SPEC_NEW = 3, 1, 6


def spec_prompts():
    rng = np.random.RandomState(3)
    return [rng.randint(1, SPEC_CFG["vocab"], rng.randint(3, 10)).astype(
        np.int32) for _ in range(5)]


def spec_serve(params, mesh=None, device=None):
    """Each prompt's tokens and the server's stats through
    ``GenerateServer(spec_k=SPEC_K, draft=SPEC_DRAFT)``."""
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.serving import GenerateServer

    cfg = tfm.TransformerConfig(**SPEC_CFG)
    kw = dict(mesh=mesh) if mesh is not None else dict(device=device)
    srv = GenerateServer(cfg, params, slots=2, page_size=4, spec_k=SPEC_K,
                         draft=SPEC_DRAFT, **kw)
    try:
        futs = [srv.submit(p, max_new_tokens=SPEC_NEW)
                for p in spec_prompts()]
        res = [f.result(timeout=120) for f in futs]
        stats = srv.stats()
    finally:
        srv.close()
    return [r["tokens"] for r in res], stats


def spec_worker(rank, world, params):
    """The spec server on ``train_mesh(mp=2)``: rank 0 serves, rank 1
    follows the target (and, through it, the self-draft)."""
    from mxnet_tpu_torch.models import transformer as tfm
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving.generate import GenerativePredictor

    mesh = train_mesh(mp=2, device="cpu")
    if rank != 0:
        cfg = tfm.TransformerConfig(**SPEC_CFG)
        pred = GenerativePredictor(cfg, params, slots=2, page_size=4,
                                   mesh=mesh)
        return {"calls": pred.follow()}
    tokens, stats = spec_serve(params, mesh=mesh)
    return {"tokens": tokens, "stats": stats}


def rules_worker(rank, world):
    """The JAX test's rule errors on ``train_mesh(mp=2)``: each case's
    error class and message (None when it did not raise)."""
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.parallel.spmd import param_shardings

    mesh = train_mesh(mp=2, device="cpu")
    cases = {"odd": ({"odd_weight": torch.zeros(7, 3)},
                     [("odd_weight", (None, "mp"))]),
             "no_axis": ({"w": torch.zeros(4, 4)}, [("w", ("nope", None))]),
             "fits": ({"w": torch.zeros(4, 6)}, [("w", (None, "mp"))])}
    out = {}
    for name, (ps, rules) in cases.items():
        try:
            got = param_shardings(ps, mesh, rules)
            out[name] = (None, {k: v.spec for k, v in got.items()})
        except Exception as e:
            out[name] = (type(e).__name__, str(e))
    return out


def group_replica_worker(rank, world, tracker_uri, args, rules):
    """One member of a sharded replica group of the ``pred`` net: rank 0
    serves model ``m`` behind a ReplicaServer registered with the
    tracker, rank 1 publishes its own ReplicaServer and follows. Rank 0
    returns when a router stops it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel.mesh import train_mesh
    from mxnet_tpu_torch.serving import AOTPredictor, ModelServer
    from mxnet_tpu_torch.serving.fleet import ReplicaServer

    sym = net(mx, "pred")
    mesh = train_mesh(mp=2, device="cpu")
    pred = AOTPredictor(sym, args, data_shapes={"data": (1, 8)}, mesh=mesh,
                        param_rules=rules, ladder=(1, 4))
    server = ModelServer(ladder=(1, 4), device="cpu")
    if rank == 0:
        server.add_model("m", predictor=pred)
    rep = ReplicaServer(server, tracker_uri=tracker_uri, group="g",
                        group_size=world, group_rank=rank,
                        publish_interval=0.2)
    if rank != 0:
        rep.serve_in_background()
        calls = pred.follow()
        rep.shutdown()
        return {"calls": calls}
    rep.serve_forever()
    rep.shutdown()
    pred.close()
    return {"addr": rep.addr}
