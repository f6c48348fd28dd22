"""One ``Module.fit`` batch of a model-zoo network in either package, on
the CPU (shared by ``tests/test_torch_model_zoo*.py``).

The port runs first and records the masks its Dropout nodes draw; the JAX
package's run replays them in the same node order (its Dropout replaced by
a test double that multiplies by the recorded mask), so the two fits
differ only in arithmetic.
"""
import contextlib
import itertools

import numpy as np
import pytest

CLASSES = 10
OPT = dict(learning_rate=0.01, momentum=0.9, wd=1e-4)
# network -> (image shape, builder arguments, batch). The networks without
# BatchNorm run at the smallest input their pools and strided convolutions
# admit, batch 2. Those with BatchNorm (train-mode batch statistics) run
# at batch 4 and an input whose last stage keeps 3x3 or 4x4 positions:
# at 1x1 a BatchNorm normalizes 2 values, whose output does not depend on
# its input, so its input gradient is rounding noise.
NETS = {
    "lenet": ((1, 28, 28), {}, 2),
    "mlp": ((1, 28, 28), {}, 2),
    "alexnet": ((3, 63, 63), {}, 2),
    "vgg": ((3, 32, 32), {"num_layers": 16}, 2),
    "googlenet": ((3, 64, 64), {}, 2),
    "mobilenet": ((3, 96, 96), {}, 4),
    "resnext": ((3, 96, 96), {"num_layers": 50}, 4),
    "inception-bn": ((3, 128, 128), {}, 4),
    "inception-v3": ((3, 160, 160), {}, 4),
}


def batch(shape, n, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _nudged(a, rng):
    """``a`` with each element moved by one rounding (2**-23 relative)."""
    return (a * (1 + rng.choice([-1.0, 1.0], a.shape) * 2.0 ** -23)) \
        .astype(np.float32)


def fit_one_batch(pkg, network, nudge=None):
    """``(outputs, gradients, params after the update)`` of one fit batch
    from Xavier weights after ``random.seed(0)``; ``nudge`` seeds a move
    of every image and parameter element by one rounding."""
    shape, kw, n = NETS[network]
    with pkg.name.NameManager():
        sym = pkg.models.get_symbol(network, num_classes=CLASSES, **kw)
    x, y = batch(shape, n)
    init = pkg.init.Xavier()
    if nudge is not None:
        rng = np.random.RandomState(nudge)
        x = _nudged(x, rng)
        xavier = init

        def init(desc, arr):
            xavier(desc, arr)
            arr[:] = _nudged(arr.asnumpy(), rng)
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    it = pkg.io.NDArrayIter(x, y, batch_size=n)
    step = mod.forward_backward
    rec = {}

    def forward_backward(data_batch):
        step(data_batch)
        rec["grads"] = {n: g[0].asnumpy().copy() for n, g in
                        zip(mod._param_names, mod._exec_group.grad_arrays)}
        rec["outs"] = mod.get_outputs()[0].asnumpy().copy()

    mod.forward_backward = forward_backward
    pkg.random.seed(0)
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            initializer=init)
    args, _aux = mod.get_params()
    return rec["outs"], rec["grads"], {k: v.asnumpy() for k, v in
                                       args.items()}


@contextlib.contextmanager
def recording_masks():
    """The port's Dropout, recording each training mask it draws."""
    from mxnet_tpu_torch.ops import registry

    op = registry.get("Dropout")
    masks, orig = [], op.fn

    def fn(gen, data, **attrs):
        out = orig(gen, data, **attrs)
        if attrs.get("__is_train__"):
            masks.append(out[1].detach().numpy().copy())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(op, "fn", fn)
        yield masks


@contextlib.contextmanager
def replaying_masks(masks):
    """The JAX Dropout replaced by one multiplying by ``masks`` in turn."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry

    op = registry.get("Dropout")
    turn = itertools.count()

    def fn(key, data, p=0.5, mode="training", axes=(), __is_train__=False):
        if not (__is_train__ or mode == "always") or p <= 0.0:
            return data, jnp.ones_like(data)
        mask = jnp.asarray(masks[next(turn) % len(masks)])
        return data * mask, mask

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(op, "fn", fn)
        yield


def fit_both(network):
    """The port's and the JAX package's one-batch fits of ``network``."""
    import mxnet_tpu as jmx
    import mxnet_tpu.models  # noqa: F401
    import mxnet_tpu_torch as tmx
    import mxnet_tpu_torch.models  # noqa: F401

    with recording_masks() as masks:
        with tmx.cpu():
            port = fit_one_batch(tmx, network)
    with replaying_masks(masks):
        ref = fit_one_batch(jmx, network)
    return port, ref, len(masks)
