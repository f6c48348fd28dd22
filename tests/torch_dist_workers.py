"""Worker processes of ``tests/test_torch_dist.py`` (they import neither
JAX nor ``mxnet_tpu``; the parent runs the JAX package on the same inputs).

Two ways in:

- ``python tests/torch_dist_workers.py SCENARIO OUT_DIR``, started by a
  launcher (``tools/launch.py -n 2 -s 0`` or ``python -m
  mxnet_tpu_torch.launch``): each worker joins the job from the launcher's
  environment and ``torch.save``s its results to
  ``OUT_DIR/SCENARIO-rank<r>.pt``;
- ``torch_dp_workers.start_ranks("torch_dist_workers:<fn>", ...)`` for the
  functions that take ``(rank, world)``.

Every input is made from a numpy seed by a function of this module, so the
parent makes the same ones.
"""
import os
import signal
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LOCAL_BATCH = 8
STEPS = 5
MLP_OPT = {"learning_rate": 0.05, "momentum": 0.9,
           "rescale_grad": 1.0 / LOCAL_BATCH}
RESNET = dict(units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
              num_classes=4, image_shape=(3, 16, 16), bottle_neck=True)
RESNET_STEPS = 3
RESNET_OPT = {"learning_rate": 0.05, "rescale_grad": 1.0 / LOCAL_BATCH}
SGD_STORE = dict(learning_rate=0.1, momentum=0.9, wd=0.01)
RSP_SHAPE = (6, 3)


# ---------------------------------------------------------------------------
# inputs (either package's ``mx`` where a symbol is built)
# ---------------------------------------------------------------------------
def mlp_symbol(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def mlp_data():
    """The global batch of the MLP: rank r's rows are ``r * 8 .. r * 8 +
    8``."""
    rng = np.random.RandomState(3)
    x = rng.randn(2 * LOCAL_BATCH, 12).astype(np.float32)
    y = (np.abs(x).sum(axis=1) * 3 % 3).astype(np.float32)
    return x, y


def resnet_data():
    rng = np.random.RandomState(5)
    return (rng.randn(2 * LOCAL_BATCH, 3, 16, 16).astype(np.float32),
            rng.randint(0, 4, (2 * LOCAL_BATCH,)).astype(np.float32))


def init_values(symbol, data_shape, seed=0):
    """Seeded numpy weights for every parameter of ``symbol`` (gaussian
    over the fan-in; BatchNorm gamma 1, beta 0, moving mean 0, var 1)."""
    args, _, auxs = symbol.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    arg_params = {}
    for name, shape in zip(symbol.list_arguments(), args):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("gamma"):
            v = np.ones(shape)
        elif name.endswith("beta") or name.endswith("bias"):
            v = np.zeros(shape)
        else:
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            v = rng.randn(*shape) / np.sqrt(fan_in)
        arg_params[name] = v.astype(np.float32)
    aux_params = {name: (np.ones(shape) if name.endswith("var")
                         else np.zeros(shape)).astype(np.float32)
                  for name, shape in zip(symbol.list_auxiliary_states(),
                                         auxs)}
    return arg_params, aux_params


def dense_grad(rank, step=0):
    return np.full((4, 4), float(rank + 1 + step), np.float32)


def compressed_grad(rank):
    return np.full((4, 4), 0.3 * (rank + 1), np.float32)


def batched_grads(rank):
    return {"k%d" % i: np.full((3, 5), float((rank + 1) * (i + 1)),
                               np.float32) for i in range(6)}


def rsp_grads(rank):
    """``{key: (values, row ids)}`` of rank ``rank``'s row-sparse pushes."""
    many = (np.arange(4) + rank) % RSP_SHAPE[0]
    return {
        "rsp": (np.full((2, 3), float(rank + 1), np.float32),
                np.array([rank, rank + 1], np.int64)),
        "rsp2": (np.full((1, 3), 10.0 * (rank + 1), np.float32),
                 np.array([5 - rank], np.int64)),
        "rsp_dense": (np.full((4, 3), float(rank + 1), np.float32),
                      many.astype(np.int64)),
    }


def store_w0():
    return np.linspace(-1, 1, 12).reshape(4, 3).astype(np.float32)


def store_grad(rank, step):
    return np.full((4, 3), float(rank + 1 + step), np.float32) \
        + np.arange(12, dtype=np.float32).reshape(4, 3) * 0.01


def host_inputs(rank):
    return {"i64": np.arange(5, dtype=np.int64) * (2 ** 40) + rank,
            "f64": np.linspace(0, 1, 7) + 1e-9 * rank,
            "bf16": (torch.linspace(-3, 3, 9) + rank * 0.001).to(
                torch.bfloat16)}


# ---------------------------------------------------------------------------
# the serverless plane, one launcher run
# ---------------------------------------------------------------------------
def _host_collectives(dist):
    r = dist.rank()
    ins = host_inputs(r)
    return {
        "sum": dist.allreduce(np.array([r + 1.0, 2.0 * r], np.float32)),
        "max": dist.allreduce(np.array([r, -r], np.int64), op="max"),
        "gather": dist.allgather(np.array([r, r * 10], np.int64)),
        "b_i64": dist.broadcast0(ins["i64"]),
        "b_f64": dist.broadcast0(ins["f64"]),
        "b_bf16": dist.broadcast0(ins["bf16"]),
        "barrier": dist.barrier() is None,
        "dead": dist.get_num_dead_node(timeout=60),
    }


def _kvstore_scenarios(mx, nd):
    """tests/dist_check.py's scenarios on ``dist_sync`` stores."""
    kv = mx.kv.create("dist_sync")
    r = kv.rank
    out = {"rank": r, "num_workers": kv.num_workers, "type": type(kv).__name__}
    kv.init("w", nd.zeros((4, 4)))
    kv.push("w", nd.array(dense_grad(r)))
    got = nd.zeros((4, 4))
    kv.pull("w", out=got)
    out["dense"] = got.asnumpy()
    kv.barrier()
    grads = batched_grads(r)
    for k, g in grads.items():
        kv.init(k, nd.zeros(g.shape))
        kv.push(k, nd.array(g))
    out["pending"] = len(kv._pending)
    out["batched"] = {}
    for k in grads:
        o = nd.zeros((3, 5))
        kv.pull(k, out=o)
        out["batched"][k] = o.asnumpy()
    out["pending_after"] = len(kv._pending)
    # a buffer reused before the flushing pull: the push kept a snapshot
    g = nd.array(dense_grad(r))
    kv.push("w", g)
    g[:] = 0.0
    kv.pull("w", out=got)
    out["snapshot"] = got.asnumpy()

    kvc = mx.kv.create("dist_sync")
    kvc.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kvc.init("c", nd.zeros((4, 4)))
    seen = []
    kvc._set_updater(lambda k, gr, w: seen.append(gr.asnumpy().copy()))
    for _ in range(2):
        kvc.push("c", nd.array(compressed_grad(r)))
        kvc.pull("c", out=nd.zeros((4, 4)))
    out["compressed"] = seen

    from mxnet_tpu_torch.ndarray import sparse as nd_sparse

    kvr = mx.kv.create("dist_sync")
    out["rsp"] = {}
    for k, (vals, ids) in rsp_grads(r).items():
        kvr.init(k, nd.zeros(RSP_SHAPE))
        kvr.push(k, nd_sparse.row_sparse_array((vals, ids),
                                               shape=RSP_SHAPE))
    out["rsp_tag"] = kvr._pending["rsp"][0]
    for k in rsp_grads(r):
        o = nd.zeros(RSP_SHAPE)
        kvr.pull(k, out=o)
        out["rsp"][k] = o.asnumpy()
    rsp_out = nd_sparse.zeros("row_sparse", RSP_SHAPE)
    kvr.row_sparse_pull("rsp", out=rsp_out,
                        row_ids=nd.array(np.array([1.0, 3.0])))
    out["rsp_pull"] = rsp_out.tostype("default").asnumpy()

    kvu = mx.kv.create("dist_sync")
    kvu.init("w", nd.ones(RSP_SHAPE))
    touched = []

    def lazy(key, gr, w):
        touched.append(gr.indices.asnumpy().tolist())
        with torch.no_grad():
            w.tensor.index_add_(0, gr.indices.tensor.long(),
                                -0.1 * gr.data.tensor)

    kvu._set_updater(lazy)
    kvu.push("w", nd_sparse.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([r], np.int64)),
        shape=RSP_SHAPE))
    o = nd.zeros(RSP_SHAPE)
    kvu.pull("w", out=o)
    out["lazy"] = (o.asnumpy(), touched)

    kvo = mx.kv.create("dist_sync")
    n = kvo.num_workers
    kvo.set_optimizer(mx.optimizer.SGD(rescale_grad=1.0 / n, **SGD_STORE))
    kvo.init("srv_w", nd.array(store_w0()))
    for step in range(3):
        kvo.push("srv_w", nd.array(store_grad(r, step)))
        wo = nd.zeros((4, 3))
        kvo.pull("srv_w", out=wo)
    out["store_opt"] = wo.asnumpy()
    out["dead"] = kvo.num_dead_node()
    return out


def _fused_mlp(mx, nd):
    """Module(kvstore='dist_sync') on the MLP, fed by
    DeviceQueueIter(group=) with this worker's rows."""
    from mxnet_tpu_torch.parallel.feed import DeviceQueueIter

    x, y = mlp_data()
    sym = mlp_symbol(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (LOCAL_BATCH, 12))],
             label_shapes=[("softmax_label", (LOCAL_BATCH,))])
    args, _aux = init_values(sym, (LOCAL_BATCH, 12), seed=1)
    from mxnet_tpu_torch import dist

    # rank 1 starts from other weights: rank 0's win at the group's place
    shift = 0.5 * dist.rank()
    mod.init_params(arg_params={k: nd.array(v + shift)
                                for k, v in args.items()})
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params=dict(MLP_OPT))
    r = mod._kvstore.rank
    lo = r * LOCAL_BATCH
    feed = DeviceQueueIter(
        mx.io.NDArrayIter(x[lo:lo + LOCAL_BATCH], y[lo:lo + LOCAL_BATCH],
                          batch_size=LOCAL_BATCH), group=mod._fused)
    for step in range(STEPS):
        if step:
            feed.reset()
        mod.forward_backward(feed.next())
        mod.update()
    outs = mod.get_outputs()[0].asnumpy()
    feed.close()
    arg, _ = mod.get_params()
    import hashlib

    states = hashlib.sha256(mod._fused.get_states()).hexdigest()
    return {"states": states,
            "engaged": (mod._fused is not None, mod._fused.distributed,
                        tuple(mod._fused.mesh.mesh_dim_names),
                        tuple(mod._fused.mesh.mesh.shape)),
            "outputs": outs,
            "params": {k: v.asnumpy() for k, v in arg.items()}}


def _fused_resnet(mx, nd):
    from mxnet_tpu_torch.models import resnet

    xs, ys = resnet_data()
    sym = resnet.resnet(fused=True, **RESNET)
    shape = (LOCAL_BATCH, 3, 16, 16)
    args, auxs = init_values(sym, shape, seed=2)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (LOCAL_BATCH,))])
    mod.init_params(arg_params={k: nd.array(v) for k, v in args.items()},
                    aux_params={k: nd.array(v) for k, v in auxs.items()})
    mod.init_optimizer(kvstore="dist_sync", optimizer="sgd",
                       optimizer_params=dict(RESNET_OPT))
    r = mod._kvstore.rank
    lo = r * LOCAL_BATCH
    batch = mx.io.DataBatch(data=[nd.array(xs[lo:lo + LOCAL_BATCH])],
                            label=[nd.array(ys[lo:lo + LOCAL_BATCH])])
    for _ in range(RESNET_STEPS):
        mod.forward_backward(batch)
        mod.update()
    arg, aux = mod.get_params()
    return {"engaged": mod._fused is not None,
            "params": {k: v.asnumpy() for k, v in arg.items()},
            "aux": {k: v.asnumpy() for k, v in aux.items()}}


class _Rows:
    """An iterator of batches of the given row counts (the second one
    differs: the mid-stream change)."""

    def __init__(self, counts):
        from mxnet_tpu_torch.io import DataBatch, DataDesc

        self._batch, self._counts, self._i = DataBatch, counts, 0
        self.batch_size = counts[0]
        self.provide_data = [DataDesc("data", (counts[0], 12))]
        self.provide_label = [DataDesc("softmax_label", (counts[0],))]

    def next(self):
        if self._i >= len(self._counts):
            raise StopIteration
        n, self._i = self._counts[self._i], self._i + 1
        x, y = mlp_data()
        import mxnet_tpu_torch as mx

        # the feed's own thread: its default context is not the caller's
        return self._batch([mx.nd.array(x[:n], ctx=mx.cpu())],
                           [mx.nd.array(y[:n], ctx=mx.cpu())])

    def reset(self):
        self._i = 0


def _feed(mx, dist):
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.feed import DeviceQueueIter

    mesh = dist.global_mesh(device="cpu")
    r = dist.rank()
    x, y = mlp_data()
    lo = r * LOCAL_BATCH
    with DeviceQueueIter(
            mx.io.NDArrayIter(x[lo:lo + LOCAL_BATCH], y[lo:lo + LOCAL_BATCH],
                              batch_size=4),
            mesh=mesh, data_axes=tuple(mesh.mesh_dim_names),
            distributed=True) as dq:
        placed = [dq.next().data[0].asnumpy() for _ in range(2)]
    err = None
    with DeviceQueueIter(_Rows([4, 3]), mesh=mesh,
                         data_axes=tuple(mesh.mesh_dim_names),
                         distributed=True) as dq:
        dq.next()
        try:
            dq.next()
        except MXNetError as e:
            err = str(e)
    return {"placed": placed, "error": err}


def _rescale(mx, nd):
    """C23: rescale_grad under the dist types, batch 8, 2 workers."""
    import warnings

    out = {}
    for kv in ("dist_sync", "dist_async"):
        mod = mx.mod.Module(mlp_symbol(mx), context=mx.cpu())
        mod.bind(data_shapes=[("data", (LOCAL_BATCH, 12))],
                 label_shapes=[("softmax_label", (LOCAL_BATCH,))])
        mod.init_params(arg_params={k: nd.array(v) for k, v in init_values(
            mlp_symbol(mx), (LOCAL_BATCH, 12), seed=1)[0].items()})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.init_optimizer(kvstore=kv, optimizer="sgd")
        out[kv] = (mod._optimizer.rescale_grad,
                   [str(c.message) for c in caught])
    return out


def plane(out_dir):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import dist, nd

    torch.set_num_threads(2)
    assert dist.init_from_env()
    res = {"backend": dist.backend(), "env": dist.env_spec()}
    with mx.cpu():
        res["host"] = _host_collectives(dist)
        res["kv"] = _kvstore_scenarios(mx, nd)
        res["mlp"] = _fused_mlp(mx, nd)
        res["resnet"] = _fused_resnet(mx, nd)
        res["feed"] = _feed(mx, dist)
        res["rescale"] = _rescale(mx, nd)
    return dist.rank(), res


def kill(out_dir):
    """Rank 1 dies by SIGKILL after joining; rank 0 counts it dead."""
    from mxnet_tpu_torch import dist

    dist.init_from_env()
    dist.barrier()
    if dist.rank() == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.monotonic()
    before = dist.get_num_dead_node(timeout=2)
    seen = before
    while seen < 1 and time.monotonic() - t0 < 20:
        time.sleep(0.2)
        seen = dist.get_num_dead_node(timeout=2)
    res = {"before": before, "dead": seen,
           "seconds": time.monotonic() - t0,
           "live": dist.live_workers(timeout=2),
           "exit_barrier": dist.exit_barrier(timeout_ms=500)}
    torch.save(res, os.path.join(out_dir, "kill-rank0.pt"))
    sys.stdout.flush()
    os._exit(0)     # the process group's peer is gone: no teardown


FIT_BATCH = 50


def fit_data(rank, n=400):
    """A worker's own synthetic classification rows (64 features, 10
    classes, the class's feature raised)."""
    rng = np.random.RandomState(10 + rank)
    y = rng.randint(0, 10, n)
    x = rng.randn(n, 64).astype(np.float32)
    x[np.arange(n), y] += 3.0
    return x, y.astype(np.float32)


def sched(out_dir):
    """The scheduler topology: ``dist_sync`` refused, then ``dist_async``
    from the tracker's rendezvous: the servers' SGD on one key, then
    ``Module.fit`` on the same store."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.base import MXNetError

    with mx.cpu():
        try:
            mx.kv.create("dist_sync")
            refused = None
        except MXNetError as e:
            refused = str(e)
        kv = mx.kv.create("dist_async")
        r = kv.rank
        x, y = fit_data(r)
        net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=32,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc2")
        net = mx.sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        it = mx.io.NDArrayIter(x, y, batch_size=FIT_BATCH)
        mod.bind(it.provide_data, it.provide_label)
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier())
        ce0 = dict(mod.score(it, "ce"))["cross-entropy"]
        it.reset()
        mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
        it.reset()
        ce1 = dict(mod.score(it, "ce"))["cross-entropy"]
        # one more key under the fit's server-side SGD (lr 0.1, rescale
        # 1 / (batch * workers)): both workers' pushes applied
        kv.init("w", nd.array(store_w0()))
        kv.barrier()
        kv.push("w", nd.array(store_grad(r, 0)))
        kv.barrier()
        got = nd.zeros((4, 3))
        kv.pull("w", out=got)
        res = {"refused": refused, "type": type(kv).__name__, "rank": r,
               "servers": kv.num_servers, "w": got.asnumpy(),
               "zero_keys": sorted(kv._zinfo), "fit": (ce0, ce1)}
        kv.barrier()
        kv.close()
    return r, res


def barrier(addr):
    """Connects to a server and blocks in its barrier (killed there)."""
    from mxnet_tpu_torch.kvstore_server import ServerKVStore

    kv = ServerKVStore(addr)
    print("IN_BARRIER", flush=True)
    kv.barrier()
    print("RELEASED", flush=True)


RECSYS = dict(users=2000, items=1200, dim=16, batch=256, epochs=2,
              samples=4000, lr=0.08)


def _recsys_interactions(n, users, items, rank_k):
    """(user, item, rating) triples of a hidden low-rank model, zipfian
    over users and items; the same on every worker (fixed seeds)."""
    rng = np.random.RandomState(9)
    gt_u = np.random.RandomState(7).randn(users, rank_k) * 0.8
    gt_v = np.random.RandomState(8).randn(items, rank_k) * 0.8
    u = np.minimum(rng.zipf(1.3, n) - 1, users - 1)
    i = np.minimum(rng.zipf(1.3, n) - 1, items - 1)
    r = (gt_u[u] * gt_v[i]).sum(axis=1) + rng.randn(n) * 0.05
    return u.astype(np.int64), i.astype(np.int64), r.astype(np.float32)


def recsys(out_dir):
    """The matrix-factorization recommender of
    ``examples/recommender/train.py`` on the port: two embedding tables
    row-sharded over the servers, interactions read from record shards
    leased through the tracker; each worker's loss over the whole set
    before and after."""
    import struct

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.data import manifest_path, write_record_shards
    from mxnet_tpu_torch.data.service import (ShardedRecordStream,
                                              iter_manifest_records)
    from mxnet_tpu_torch.embedding import SparseEmbedding

    cfg = RECSYS
    rec = struct.Struct("<qqf")
    data_dir = os.path.join(out_dir, "data")
    mpath = manifest_path(data_dir, "interactions")
    if not os.path.isfile(mpath):
        u, i, r = _recsys_interactions(cfg["samples"], cfg["users"],
                                       cfg["items"], cfg["dim"])
        mpath = write_record_shards(data_dir, "interactions", [
            rec.pack(int(a), int(b), float(c)) for a, b, c in zip(u, i, r)])
    with mx.cpu():
        kv = mx.kv.create("dist_async")
        kv.set_optimizer("sgd", learning_rate=cfg["lr"], momentum=0.9,
                         rescale_grad=1.0)
        emb_u = SparseEmbedding(cfg["dim"], cfg["users"], kvstore=kv,
                                key="mf_user")
        emb_i = SparseEmbedding(cfg["dim"], cfg["items"], kvstore=kv,
                                key="mf_item")
        emb_u.initialize_table(scale=0.1, seed=11)
        emb_i.initialize_table(scale=0.1, seed=12)
        full = [rec.unpack(raw) for _s, _i, raw in
                iter_manifest_records(mpath)]
        users, items, ratings = (np.asarray(c) for c in zip(*full))

        def mse():
            se = 0.0
            for o in range(0, len(users), cfg["batch"]):
                sl = slice(o, o + cfg["batch"])
                pred = (emb_u(nd.array(users[sl])) * emb_i(
                    nd.array(items[sl]))).sum(axis=1).asnumpy()
                se += float(((pred - ratings[sl]) ** 2).sum())
            return se / len(users)

        def step(bu, bi, br):
            with autograd.record():
                pred = (emb_u(nd.array(np.asarray(bu, np.int64)))
                        * emb_i(nd.array(np.asarray(bi, np.int64)))) \
                    .sum(axis=1)
                diff = pred - nd.array(np.asarray(br, np.float32))
                loss = (diff * diff).mean()
            loss.backward()
            emb_u.step(priority=1)
            emb_i.step(priority=0)

        loss0 = mse()
        stream = ShardedRecordStream(mpath,
                                     decode=lambda raw, seed: rec.unpack(raw))
        try:
            while stream.epoch < cfg["epochs"]:
                batch = []
                for _s, _i, row in stream.epoch_records():
                    batch.append(row)
                    if len(batch) == cfg["batch"]:
                        step(*zip(*batch))
                        batch = []
                if batch:
                    step(*zip(*batch))
        finally:
            stream.close()
        loss1 = mse()
        print("worker %d loss %.4f -> %.4f" % (kv.rank, loss0, loss1),
              flush=True)
        kv.barrier()
    return kv.rank, {"loss": (loss0, loss1)}


SCENARIOS = {"plane": plane, "kill": kill, "sched": sched,
             "barrier": barrier, "recsys": recsys}


# ---------------------------------------------------------------------------
# ZeRO's 2-bit wire on gloo ranks (torch_dp_workers.start_ranks)
# ---------------------------------------------------------------------------
def zero_wire_worker(rank, world):
    """``zero_wire`` raw and 2bit on a ``{"dp": world}`` CPU mesh: losses,
    the residual rows and the plan."""
    import torch_dp_workers as w
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    mesh = make_mesh({"dp": world}, device="cpu")
    out = {}
    for wire in ("raw", "2bit"):
        ts = TrainStep(w.zero_symbol(), dict(ZERO_WIRE_OPT), mesh=mesh,
                       zero=True, zero_min_size=16, zero_wire=wire)
        carry = ts.place(*ts.init_params(w.ZERO_SHAPES, seed=3))
        losses = []
        for _ in range(ZERO_WIRE_STEPS):
            carry, loss = ts(carry, w.zero_batch())
            losses.append(float(loss))
        res = carry[1].get(TrainStep._ZERO_RES)
        out[wire] = {
            "losses": losses, "plan": ts.zero_plan(carry[0]),
            "residual": None if res is None else
            {k: v.clone() for k, v in res.items()},
            "logical": sorted(ts.logical_opt_state(carry[1], carry[0])),
            "params": {k: v.clone() for k, v in carry[0].items()}}
        if wire == "2bit":
            # the wire turned off drops the residual; placed again from
            # the logical state (a restore) it starts at zeros
            raw = TrainStep(w.zero_symbol(), dict(ZERO_WIRE_OPT), mesh=mesh,
                            zero=True, zero_min_size=16, zero_wire="raw")
            out["dropped"] = TrainStep._ZERO_RES in \
                raw.place(carry[0], carry[1], carry[2])[1]
            logical = ts.logical_opt_state(carry[1], carry[0])
            back = ts.place(carry[0], logical, carry[2])[1]
            out["restored"] = {k: float(v.abs().sum())
                               for k, v in back[TrainStep._ZERO_RES].items()}
    return out


ZERO_WIRE_OPT = dict(name="sgd", learning_rate=0.05, momentum=0.9)
ZERO_WIRE_STEPS = 8


def main():
    scenario, out_dir = sys.argv[1], sys.argv[2]
    result = SCENARIOS[scenario](out_dir)
    if result is not None:
        rank, res = result
        torch.save(res, os.path.join(out_dir, "%s-rank%d.pt"
                                     % (scenario, rank)))
    print("TORCH_DIST_OK %s" % scenario, flush=True)


if __name__ == "__main__":
    main()
