"""The port's image-classification builders against the JAX package's, on
the CPU: Symbol JSON, ``get_symbol``'s dispatch, and one ``Module.fit``
batch of each network without BatchNorm.

- Symbol JSON equal for lenet, mlp, alexnet, vgg 11/13/16/19 with and
  without BatchNorm, inception v1 (googlenet), bn and v3, mobilenet at two
  widths, resnext 50/101/152 and resnet 50 (each built in a fresh name
  scope, so the automatic names agree).
- One ``Module.fit`` batch (sgd, lr 0.01, momentum 0.9, wd 1e-4, Xavier
  weights after ``random.seed(0)``, 10 classes, batch 2) of lenet and mlp
  at MNIST shape and alexnet (63x63), vgg-16 (32x32) and googlenet
  (64x64), the smallest inputs those builders admit: the outputs, every
  gradient and every updated parameter against the JAX Module's. The JAX
  run replays the port's Dropout masks (``tests/torch_zoo_fit.py``). fp32:
  rtol 1e-4, and an atol of 1e-5 of the largest |value| (outputs) or of
  each tensor's largest |value| floored at 1% of the largest of any
  (gradients, parameters). The networks with BatchNorm are in
  ``tests/test_torch_model_zoo_bn.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.models as jmodels
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.models as tmodels
import torch_zoo_fit as zoo

BUILDS = [("lenet", {}), ("mlp", {}), ("alexnet", {}),
          *[("vgg", dict(num_layers=n, batch_norm=bn))
            for n in (11, 13, 16, 19) for bn in (False, True)],
          ("googlenet", {}), ("inception-bn", {}), ("inception-v3", {}),
          ("inception-bn", dict(version="v1")),
          ("mobilenet", {}), ("mobilenet", dict(multiplier=0.25)),
          ("resnext", {}), ("resnext", dict(num_layers=101)),
          ("resnext", dict(num_layers=152, num_group=64)),
          ("resnet", dict(num_layers=50, image_shape=(3, 224, 224)))]


def _ids(builds):
    return ["%s-%s" % (n, "-".join("%s=%s" % kv for kv in kw.items()))
            for n, kw in builds]


@pytest.mark.parametrize("network,kw", BUILDS, ids=_ids(BUILDS))
def test_symbol_json_matches_jax(network, kw):
    with jmx.name.NameManager():
        want = jmodels.get_symbol(network, num_classes=1000, **kw)
    with mx.name.NameManager():
        got = tmodels.get_symbol(network, num_classes=1000, **kw)
    assert got.tojson() == want.tojson()
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states()


def test_get_symbol_dispatch():
    assert sorted(tmodels._BUILDERS) == sorted(jmodels._BUILDERS)
    assert tmodels._VERSION_KW == jmodels._VERSION_KW
    with pytest.raises(ValueError, match="unknown network"):
        tmodels.get_symbol("densenet")
    with pytest.raises(mx.MXNetError, match="ssd.*not ported.*7d"):
        tmodels.get_symbol("ssd")


def _close(got, want, floor, what):
    np.testing.assert_allclose(
        got, want, rtol=1e-4,
        atol=1e-5 * max(float(np.abs(want).max()), floor), err_msg=what)


FITS = {"lenet": 0, "mlp": 0, "alexnet": 2, "vgg": 2, "googlenet": 1}


@pytest.mark.parametrize("network", sorted(FITS))
def test_one_fit_batch_matches_jax(network):
    (outs, grads, params), (jouts, jgrads, jparams), n_masks = \
        zoo.fit_both(network)
    assert n_masks == FITS[network]
    _close(outs, jouts, 0.0, "outputs")
    assert sorted(grads) == sorted(jgrads)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in jgrads.values())
    for k, g in jgrads.items():
        _close(grads[k], g, floor, "gradient " + k)
    floor = 1e-2 * max(float(np.abs(p).max()) for p in jparams.values())
    for k, p in jparams.items():
        _close(params[k], p, floor, "parameter " + k)
