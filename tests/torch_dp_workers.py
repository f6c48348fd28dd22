"""Rank processes for the port's data-parallel tests (imported by the
spawned ranks, so it imports neither JAX nor ``mxnet_tpu``).

``start_ranks`` spawns ``world`` processes that join a gloo process group
on the CPU at a free localhost port and each run one of the functions
below; ``join_ranks`` waits for them within a time limit of its own and
returns each rank's result (``torch.save``d into a scratch directory). The
parent can run the JAX reference in between. Every input is made from a
numpy seed, so the parent makes the same ones.
"""
import os
import socket
import time

import numpy as np
import torch

TINY = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
            num_classes=5, image_shape=(3, 32, 32), bottle_neck=True)
BATCH = 8
SHAPES = {"data": (BATCH, 3, 32, 32), "softmax_label": (BATCH,)}
OPT = dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4)
STEPS = 3
ZERO_OPTS = {
    "sgd": dict(name="sgd", learning_rate=0.1),
    "sgd-mom-wd": dict(name="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4),
    "adam": dict(name="adam", learning_rate=1e-3, wd=1e-4),
}
ZERO_STEPS = 5
ZERO_SHAPES = {"data": (16, 33), "softmax_label": (16,)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn_name, world, port, out_dir, args):
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=world)
    try:
        result = globals()[fn_name](rank, world, *args)
        torch.save(result, os.path.join(out_dir, "rank%d.pt" % rank))
    finally:
        dist.destroy_process_group()


def start_ranks(fn_name, world, out_dir, *args):
    """Spawn ``world`` ranks running ``fn_name(rank, world, *args)``."""
    import torch.multiprocessing as mp

    return mp.start_processes(_entry, args=(fn_name, world, _free_port(),
                                            str(out_dir), args),
                              nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, out_dir, timeout):
    """Each rank's result, in rank order; fails (killing the ranks) when
    they have not all ended within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("ranks did not finish within %d s" % timeout)
    return [torch.load(os.path.join(out_dir, "rank%d.pt" % r),
                       weights_only=False)
            for r in range(len(ctx.processes))]


def cpu_mesh(axes=None):
    from mxnet_tpu_torch.parallel import make_mesh

    return make_mesh(axes, device="cpu")


# ---------------------------------------------------------------------------
# the fused unit (tests/test_torch_fused_spmd.py)
# ---------------------------------------------------------------------------
UNIT_CASES = ((1, False), (1, True), (2, True))


def unit_inputs(stride, shortcut, seed=0, n=8, h=8, ci=16, csq=8):
    """Global NHWC data, HWIO weights, gammas and betas (numpy)."""
    rng = np.random.RandomState(seed + 10 * stride + int(shortcut))
    f = np.float32
    x = {"data": rng.randn(n, h, h, ci).astype(f),
         "w1": (rng.randn(1, 1, ci, csq) * 0.2).astype(f),
         "w2": (rng.randn(3, 3, csq, csq) * 0.2).astype(f),
         "w3": (rng.randn(1, 1, csq, ci) * 0.2).astype(f),
         "wsc": (rng.randn(1, 1, ci, ci) * 0.2).astype(f) if shortcut
         else None}
    for i, c in enumerate((ci, csq, csq), 1):
        x["g%d" % i] = (1.0 + 0.1 * rng.randn(c)).astype(f)
        x["b%d" % i] = (0.1 * rng.randn(c)).astype(f)
    for i, c in enumerate((ci, csq, csq), 1):
        x["mm%d" % i] = (0.1 * rng.randn(c)).astype(f)
        x["mv%d" % i] = (np.abs(rng.randn(c)) + 0.5).astype(f)
    return x


UNIT_ARGS = ("data", "w1", "w2", "w3", "wsc", "g1", "b1", "g2", "b2", "g3",
             "b3")


def _unit_case(fb, mesh, rank, world, stride, shortcut):
    x = unit_inputs(stride, shortcut)
    b = x["data"].shape[0] // world
    t = {k: None if x[k] is None else torch.from_numpy(x[k]) for k in x}
    t["data"] = t["data"][rank * b:(rank + 1) * b].clone()
    leaves = [None if t[k] is None else t[k].requires_grad_()
              for k in UNIT_ARGS]
    y, stats = fb.bottleneck_train_spmd(*leaves, stride, 1e-5, mesh, ("dp",))
    loss = torch.sum(y ** 2) * 1e-3
    grads = torch.autograd.grad(loss, [v for v in leaves if v is not None])
    inf = fb.bottleneck_infer_spmd(
        *[None if t[k] is None else t[k].detach() for k in UNIT_ARGS],
        *[t[k] for k in ("mm1", "mv1", "mm2", "mv2", "mm3", "mv3")],
        stride=stride, eps=1e-5, mesh=mesh, axes=("dp",))
    return {"out": y.detach(), "stats": [s.detach() for s in stats],
            "grads": dict(zip([k for k in UNIT_ARGS if t[k] is not None],
                              grads)),
            "infer": inf}


def fused_unit_worker(rank, world):
    """Each case's rows of out, the statistics, the 11 gradients of
    ``sum(out ** 2) * 1e-3`` through ``bottleneck_train_spmd`` and the rows
    of ``bottleneck_infer_spmd``; again with the unit's weight-gradient
    all-reduce planted wrong, dropped and doubled: ``{fault: {case:
    results}}``."""
    from mxnet_tpu_torch.kernels import fused_block as fb

    mesh = cpu_mesh({"dp": world})
    orig = fb._reduce_weight_grads
    faults = {None: orig, "drop": lambda dws, group: dws,
              "double": lambda dws, group: orig(orig(dws, group), group)}
    out = {}
    for fault, reduce in faults.items():
        fb._reduce_weight_grads = reduce
        try:
            out[fault] = {case: _unit_case(fb, mesh, rank, world, *case)
                          for case in UNIT_CASES}
        finally:
            fb._reduce_weight_grads = orig
    return out


# ---------------------------------------------------------------------------
# TrainStep on a mesh (tests/test_torch_dp_train.py)
# ---------------------------------------------------------------------------
def train_batch(seed=4, nan=False):
    rng = np.random.RandomState(seed)
    b = {"data": rng.randn(*SHAPES["data"]).astype(np.float32),
         "softmax_label": rng.randint(0, 5, SHAPES["softmax_label"])
         .astype(np.float32)}
    if nan:
        b["data"][1, 0, 3, 5] = np.nan
    return b


def _snapshot(carry):
    params, opt, aux, step = carry
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "aux": {k: v.detach().clone() for k, v in aux.items()},
            "opt": {k: (tuple(x.clone() for x in v)
                        if isinstance(v, (tuple, list)) else v.clone())
                    for k, v in opt.items() if isinstance(v, (tuple, list,
                                                              torch.Tensor))},
            "step": int(step)}


def _train(mesh, fused, steps=STEPS, batches=None, **kw):
    from mxnet_tpu_torch import initializer as tinit
    from mxnet_tpu_torch.models import resnet as tresnet
    from mxnet_tpu_torch.parallel import TrainStep

    ts = TrainStep(tresnet.resnet(fused=fused, **TINY), OPT, mesh=mesh,
                   device="cpu" if mesh is None else None, **kw)
    carry = ts.place(*ts.init_params(SHAPES, initializer=tinit.Xavier()))
    res = {"losses": [], "snaps": [], "outs": [], "stats": []}
    for i in range(steps):
        batch = batches[i] if batches is not None else train_batch()
        carry, r = ts(carry, batch)
        loss = r[0] if isinstance(r, tuple) else r
        res["losses"].append(float(loss))
        res["snaps"].append(_snapshot(carry))
        if isinstance(r, tuple):
            res["outs"].append(r[1][0])
            if len(r) > 2:
                res["stats"].append(dict(r[2]))
    res["health"] = ts.health_stats(carry)
    return res


def dp_train_worker(rank, world, axes):
    """3 steps of the tiny ResNet, fused and unfused, with outputs and
    metric_stats; the sentinel (skip) over a NaN batch; the fused run with
    the step's sums planted wrong (none of the fused units' gradients
    excluded: they count twice; every gradient excluded: the others are
    dropped). ``axes``: the mesh's axis spec."""
    from mxnet_tpu_torch.parallel import spmd

    mesh = cpu_mesh(axes)
    data_axes = tuple(axes)
    out = {}
    for fused in (True, False):
        out[fused] = _train(mesh, fused, data_axes=data_axes,
                            return_outputs=True, metric_stats=True)
    if world == 4:
        return out
    out["sentinel"] = _train(
        mesh, False, batches=[train_batch(), train_batch(nan=True),
                              train_batch()], sentinel="skip")
    orig = spmd._fused_owned
    for fault, owned in (("double", lambda sym, names: set()),
                         ("drop", lambda sym, names: set(names))):
        spmd._fused_owned = owned
        try:
            out[fault] = _train(mesh, True)
        finally:
            spmd._fused_owned = orig
    return out


def zero_symbol(mx=None):
    """fc1_weight (13, 33) = 429 elements, uneven over 2 ranks and above
    the min size; fc1_bias (13,) below it. ``mx``: either package (the
    port by default)."""
    if mx is None:
        import mxnet_tpu_torch as mx

    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=13,
                                name="fc1")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def zero_batch():
    rng = np.random.RandomState(0)
    return {"data": rng.randn(16, 33).astype(np.float32),
            "softmax_label": rng.randint(0, 10, (16,)).astype(np.float32)}


def _zero_run(mesh, opt, zero):
    from mxnet_tpu_torch.parallel import TrainStep

    ts = TrainStep(zero_symbol(), opt, mesh=mesh, zero=zero,
                   zero_min_size=16, device="cpu" if mesh is None else None)
    carry = ts.place(*ts.init_params(ZERO_SHAPES, seed=3))
    losses = []
    for _ in range(ZERO_STEPS):
        carry, loss = ts(carry, zero_batch())
        losses.append(float(loss))
    return ts, carry, losses


def zero_worker(rank, world):
    """ZeRO against the replicated update for each optimizer: losses,
    params, each rank's optimizer-state rows and bytes, the plan, the
    logical state and its round trips through zero=False and zero=True."""
    mesh = cpu_mesh({"dp": world})
    out = {}
    for name, opt in ZERO_OPTS.items():
        ts_r, c_r, l_r = _zero_run(mesh, opt, False)
        ts_z, c_z, l_z = _zero_run(mesh, opt, True)
        logical = ts_z.logical_opt_state(c_z[1], c_z[0])
        # the logical state placed again: into zero=False, and into
        # zero=True (which splits it into this rank's rows again)
        back_r = ts_r.place(c_z[0], logical, c_z[2])[1]
        back_z = ts_z.place(c_z[0], logical, c_z[2])[1]
        out[name] = {
            "losses": (l_r, l_z),
            "params": ({k: v.clone() for k, v in c_r[0].items()},
                       {k: v.clone() for k, v in c_z[0].items()}),
            "opt_rep": _snapshot(c_r)["opt"],
            "opt_zero_rows": _snapshot(c_z)["opt"],
            "logical": _snapshot((c_z[0], logical, c_z[2], 0))["opt"],
            "back_rep": _snapshot((c_z[0], back_r, c_z[2], 0))["opt"],
            "relogical": _snapshot(
                (c_z[0], ts_z.logical_opt_state(back_z, c_z[0]), c_z[2],
                 0))["opt"],
            "plan": ts_z.zero_plan(c_z[0]),
            "memory": (ts_r.memory_stats(c_r), ts_z.memory_stats(c_z))}
    return out


# ---------------------------------------------------------------------------
# kvstore and Module (tests/test_torch_kvstore_module.py)
# ---------------------------------------------------------------------------
MLP_BATCH = 16
MLP_EPOCHS = 2


def mlp_symbol(mx):
    """FC -> BatchNorm -> ReLU -> FC -> SoftmaxOutput: a batch statistic on
    the Module path. fc1 has no bias: BatchNorm would make its gradient
    exactly zero, which each package gives as noise of its own summation
    order, and Adam would scale that noise up to a step."""
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, no_bias=True,
                                name="fc1")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def mlp_data(n=64, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = rng.randn(d, classes)
    return x, x.dot(w).argmax(axis=1).astype(np.float32)


def mlp_init(seed=1, d=16):
    """Initial params and aux by name (numpy)."""
    rng = np.random.RandomState(seed)
    f = np.float32
    args = {"fc1_weight": rng.normal(0, 0.3, (32, d)).astype(f),
            "bn1_gamma": (1 + 0.1 * rng.randn(32)).astype(f),
            "bn1_beta": (0.1 * rng.randn(32)).astype(f),
            "fc2_weight": rng.normal(0, 0.3, (4, 32)).astype(f),
            "fc2_bias": rng.normal(0, 0.1, (4,)).astype(f)}
    aux = {"bn1_moving_mean": np.zeros(32, f),
           "bn1_moving_var": np.ones(32, f)}
    return args, aux


FIT_CASES = {
    "fused": dict(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))),
    "fused-adam-zero": dict(optimizer="adam", optimizer_params=(
        ("learning_rate", 0.01), ("wd", 1e-4)), zero=True),
    "fallback": dict(optimizer="sgd", optimizer_params=(
        ("learning_rate", 0.1), ("momentum", 0.9)), lr_scheduler=True),
}


def fit_case(mx, case, record):
    """``Module.fit`` of one ``FIT_CASES`` entry on ``mx`` (either
    package), recording params, aux and the metric after every batch into
    ``record``; returns the module."""
    spec = dict(FIT_CASES[case])
    zero = spec.pop("zero", None)
    opt_params = dict(spec.pop("optimizer_params"))
    if spec.pop("lr_scheduler", False):
        opt_params["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(
            step=2, factor=0.5)
    x, y = mlp_data()
    it = mx.io.NDArrayIter(x, y, batch_size=MLP_BATCH, shuffle=False)
    kw = {} if zero is None else {"zero": zero}
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu(), **kw) \
        if mx.__name__ == "mxnet_tpu_torch" else \
        mx.mod.Module(mlp_symbol(mx), context=[mx.cpu(0), mx.cpu(1)], **kw)
    args, aux = mlp_init()
    metric = mx.metric.Accuracy()

    def on_batch(param):
        a, x_ = mod.get_params()
        record.append({"params": {k: v.asnumpy().copy() for k, v in a.items()},
                       "aux": {k: v.asnumpy().copy() for k, v in x_.items()},
                       "metric": param.eval_metric.get()[1]})

    mod.fit(it, eval_metric=metric, kvstore="tpu", num_epoch=MLP_EPOCHS,
            arg_params={k: mx.nd.array(v) for k, v in args.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()},
            batch_end_callback=on_batch, optimizer=spec.pop("optimizer"),
            optimizer_params=opt_params)
    return mod


def module_worker(rank, world, states_dir):
    """Each ``FIT_CASES`` entry through ``Module.fit(kvstore='tpu')``: the
    record of every batch, whether the fused group ran, the ``.states``
    bytes (rank 0 writes them into ``states_dir``), the TPU kvstore's
    rank, workers, init broadcast and push sum."""
    import mxnet_tpu_torch as mx

    out = {}
    with mx.cpu():
        for case in FIT_CASES:
            record = []
            mod = fit_case(mx, case, record)
            out[case] = {"record": record, "fused": mod._fused is not None,
                         "mesh": mod._kvstore.mesh is not None}
            if case != "fallback":
                path = os.path.join(states_dir, "%s.states" % case)
                mod.save_optimizer_states(path + ".%d" % rank)
                out[case]["states"] = path + ".%d" % rank
        kv = mx.kv.create("tpu")
        kv.init("w", mx.nd.array(np.full((3,), float(rank + 1), np.float32)))
        got = mx.nd.zeros((3,))
        kv.pull("w", out=got)
        kv.push("w", [mx.nd.ones((3,)) * (rank + 1),
                      mx.nd.ones((3,)) * 10])
        summed = mx.nd.zeros((3,))
        kv.pull("w", out=summed)
        kv.barrier()
        out["kv"] = {"rank": kv.rank, "num_workers": kv.num_workers,
                     "init": got.asnumpy(), "after_push": summed.asnumpy()}
    return out


# ---------------------------------------------------------------------------
# ops over the batch axis under a data-parallel scope
# (tests/test_torch_dp_batch_axis.py)
# ---------------------------------------------------------------------------
def batch_axis_input(seed=0):
    """The global batch: 8 rows of (3, 4)."""
    return np.random.RandomState(seed).randn(8, 3, 4).astype(np.float32)


def _loss_grad(name, **attrs):
    """The gradient a loss head sends its data, from a ones cotangent."""
    from mxnet_tpu_torch.ops import registry

    def run(x, label):
        x = x.detach().requires_grad_()
        op = registry.get(name)
        out = op.fn(x, label, **attrs) if "label" in op.input_names \
            else op.fn(x, **attrs)
        (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
        return g

    return run


def batch_axis_cases():
    """name -> fn(rows, label rows): the ops that touch the batch axis.
    Imported by the test too, which runs each on the whole batch."""
    from mxnet_tpu_torch.ops import registry

    def op(name, **attrs):
        fn = registry.get(name).fn

        def run(x, _label):
            out = fn(x, **attrs)
            return out[0] if isinstance(out, tuple) else out

        return run

    def gen_op(name, **attrs):
        fn = registry.get(name).fn

        def run(x, _label):
            g = torch.Generator()
            g.manual_seed(0)
            return fn(g, x, **attrs)[0]

        return run

    def layer_norm(axis):
        def run(x, _label):
            c = x.shape[axis]
            return registry.get("LayerNorm").fn(
                x, torch.ones(c), torch.zeros(c), axis=axis)[0]

        return run

    def concat(dim):
        return lambda x, _label: registry.get("Concat").fn(x, 2 * x,
                                                           dim=dim)

    def rnn(x, _label):
        params = torch.zeros(4 * 5 * 4 + 4 * 5 * 5 + 2 * 4 * 5)
        g = torch.Generator()
        return registry.get("RNN").fn(g, x, params, torch.zeros(1, 3, 5),
                                      state_size=5)[0]

    return {
        "softmax-axis0": op("softmax", axis=0),
        "softmax-axis1": op("softmax", axis=1),
        "log_softmax-axis0": op("log_softmax", axis=0),
        "log_softmax-axis-1": op("log_softmax", axis=-1),
        "argmax-axis0": op("argmax", axis=0),
        "argmax-all": op("argmax"),
        "argmax-axis2": op("argmax", axis=2),
        "argmin-axis0": op("argmin", axis=0),
        "argmin-axis1": op("argmin", axis=1),
        "LayerNorm-axis0": layer_norm(0),
        "LayerNorm-axis-1": layer_norm(-1),
        "Concat-dim0": concat(0),
        "Concat-dim1": concat(1),
        "Reshape-keep": op("Reshape", shape=(0, -1)),
        "Reshape-merge": op("Reshape", shape=(-3, 0)),
        "Reshape-split-rows": op("Reshape", shape=(-4, -1, 2, 0, 0)),
        "Reshape-split-batch": op("Reshape", shape=(-4, 2, -1, 0, 0)),
        "Reshape-batch-literal": op("Reshape", shape=(4, -1)),
        "Reshape-reverse-merge": op("Reshape", shape=(-1, 12),
                                    reverse=True),
        "Flatten": op("Flatten"),
        "transpose-keep": op("transpose", axes=(0, 2, 1)),
        "transpose-move": op("transpose", axes=(1, 0, 2)),
        "transpose-reverse": op("transpose"),
        "swapaxes-0-1": op("swapaxes", dim1=0, dim2=1),
        "swapaxes-1-2": op("swapaxes", dim1=1, dim2=2),
        "Dropout-axes0": gen_op("Dropout", p=0.5, axes=(0,),
                                mode="always"),
        "RNN": rnn,
        "make_loss-batch": _loss_grad("make_loss", normalization="batch",
                                      grad_scale=3.0),
        "make_loss-valid": _loss_grad("make_loss", normalization="valid",
                                      valid_thresh=0.5),
        "make_loss-null": _loss_grad("make_loss"),
        "softmax_cross_entropy": lambda x, label: registry.get(
            "softmax_cross_entropy").fn(x[:, 0], label),
        "SoftmaxOutput-batch": lambda x, label: _loss_grad(
            "SoftmaxOutput", normalization="batch")(x[:, 0], label),
        "LinearRegressionOutput": _loss_grad("LinearRegressionOutput"),
        "SVMOutput": lambda x, label: _loss_grad("SVMOutput")(x[:, 0],
                                                            label),
    }


def batch_axis_label():
    return np.random.RandomState(1).randint(0, 4, (8,)).astype(np.float32)


def batch_axis_worker(rank, world):
    """Each case on this rank's rows inside ``spmd_scope`` (its output, or
    the error it raised) and on the whole batch outside it."""
    from mxnet_tpu_torch.kernels.fused_block import spmd_scope
    from mxnet_tpu_torch.parallel.feed import rank_rows

    mesh = cpu_mesh()
    x = torch.from_numpy(batch_axis_input())
    label = torch.from_numpy(batch_axis_label())
    rows = rank_rows(x, world, rank, "data", "test")
    lrows = rank_rows(label, world, rank, "label", "test")
    out = {}
    for name, fn in batch_axis_cases().items():
        with spmd_scope(mesh, ("dp",)):
            try:
                got = ("ok", fn(rows, batch_axis_label_of(name, lrows))
                       .detach().clone())
            except Exception as e:  # the refusal under test
                got = ("raised", "%s: %s" % (type(e).__name__, e))
        out[name] = (got, fn(x, batch_axis_label_of(name, label))
                     .detach().clone())
    return out


def batch_axis_label_of(name, label):
    """A class per row for the heads that take one, else a label shaped
    as the data."""
    if name in ("softmax_cross_entropy", "SVMOutput", "SoftmaxOutput-batch"):
        return label
    return label[:, None, None].expand(-1, 3, 4).contiguous()
