"""More than one device in one process on the card, against the port's own
CPU path (tests/test_torch_multi_context.py holds the port against the JAX
package on CPU contexts).

Marked ``cuda``: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs on the card's machine
without the JAX-setting conftest:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_multi_context_cuda.py

- ``ctx_group`` placement: a tiny fused ResNet's body on the card and its
  head (fc1, softmax) on the host, against the unplaced bind on the card:
  outputs and every gradient within 1e-4 of each tensor's largest (floored
  at 1% of the largest of any), the head's nodes recorded on ``cpu(0)``,
  the outputs on the card;
- a two-context ``Module`` over ``[gpu(0), gpu(0)]`` (one card twice)
  against ``[cpu(0), cpu(1)]``: merged outputs and each executor's
  gradients within 1e-4 (TF32 off).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from torch_dp_workers import SHAPES, TINY, train_batch

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _placed_resnet():
    from mxnet_tpu_torch.models import resnet

    with mx.AttrScope(ctx_group="body"):
        feat = resnet.resnet(fused=True, **TINY) \
            .get_internals()["pool1_output"]
    with mx.AttrScope(ctx_group="head"):
        fc1 = mx.sym.FullyConnected(mx.sym.Flatten(feat),
                                    num_hidden=TINY["num_classes"],
                                    name="fc1")
        return mx.sym.SoftmaxOutput(fc1, name="softmax")


def _held(got, ref, what):
    floor = 1e-2 * max(float(np.abs(v).max()) for v in ref.values())
    for k, g in ref.items():
        err = float(np.abs(got[k] - g).max()) / max(float(np.abs(g).max()),
                                                     floor)
        assert err <= TOL, (what, k, err)


@pytest.mark.cuda
def test_ctx_group_head_on_the_host():
    _card()
    from mxnet_tpu_torch.models import resnet

    sym = _placed_resnet()
    args, auxs = resnet.init_params(sym, SHAPES["data"], seed=0)
    batch = train_batch()
    outs = []
    for g2c in (None, {"body": mx.gpu(0), "head": mx.cpu(0)}):
        ex = sym.simple_bind(mx.gpu(0), group2ctx=g2c, **SHAPES)
        for d, src in ((ex.arg_dict, args), (ex.aux_dict, auxs)):
            for k, v in src.items():
                d[k][:] = v
        ex.forward_backward(**batch)
        outs.append((ex.outputs[0].asnumpy(),
                     {k: v.asnumpy() for k, v in ex.grad_dict.items()
                      if k not in batch}, ex))
    (ref, rg, _), (got, gg, ex) = outs
    assert float(np.abs(got - ref).max()) <= TOL
    _held(gg, rg, "placed")
    assert ex.node_devices["fc1"] == mx.cpu(0)
    assert ex.node_devices["softmax"] == mx.cpu(0)
    assert ex.node_devices["pool1"] == mx.gpu(0)
    assert ex.outputs[0].context == mx.gpu(0)


@pytest.mark.cuda
def test_two_context_module_on_one_card_matches_cpu_contexts():
    _card()
    from mxnet_tpu_torch.models import resnet

    sym = resnet.resnet(fused=True, **TINY)
    n = SHAPES["data"][0]
    args, auxs = resnet.init_params(sym, SHAPES["data"], seed=0)
    batch = train_batch()
    got = {}
    for where, ctxs in (("card", [mx.gpu(0), mx.gpu(0)]),
                        ("cpu", [mx.cpu(0), mx.cpu(1)])):
        mod = mx.mod.Module(sym, context=ctxs)
        mod.bind([("data", SHAPES["data"])], [("softmax_label", (n,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in args.items()},
                        aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in auxs.items()})
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(batch["data"], ctx=mx.cpu())],
            [mx.nd.array(batch["softmax_label"], ctx=mx.cpu())]))
        got[where] = (mod.get_outputs()[0].asnumpy(),
                      [{k: e.grad_dict[k].asnumpy() for k in args}
                       for e in mod._exec_group.execs])
    assert float(np.abs(got["card"][0] - got["cpu"][0]).max()) <= TOL
    for card, cpu in zip(got["card"][1], got["cpu"][1]):
        _held(card, cpu, "executor")
