"""The port's Gluon vision model zoo (``mxnet_tpu_torch.gluon.model_zoo``)
against the JAX package's, on the CPU.

- all 30 names of ``get_model`` build the JAX package's parameter names
  and (deferred) shapes, each pair inside a fresh ``NameManager``;
- one network of each family (resnet v1, resnet v2, vgg with BatchNorm,
  alexnet, squeezenet, mobilenet, densenet, inception v3 at 299 and batch
  1) at a small input: the JAX network's weights carried by a ``.params``
  file, the predict-mode forward of the port's eager and hybridized
  network against the JAX one;
- the offline model store: the scenario of
  ``tests/test_vision.py::test_model_store_cache_layout`` and
  ``pretrained=True`` from a local file.

Tolerance fp32: rtol 1e-4, atol 1e-5.
"""
import hashlib
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_the_30_names():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 30
    with pytest.raises(MXNetError, match="not supported"):
        tvision.get_model("resnet7_v9")


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_get_model_builds_the_jax_names_and_shapes(name):
    kw = dict(classes=10)
    with jmx.name.NameManager():
        jnet = jvision.get_model(name, **kw)
    with tmx.name.NameManager():
        tnet = tvision.get_model(name, **kw)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for k in jp.keys():
        assert tp[k].shape == jp[k].shape, k
        assert tp[k].grad_req == jp[k].grad_req, k


FAMILIES = {
    "resnet18_v1": (2, 32), "resnet18_v2": (2, 32), "vgg11_bn": (2, 32),
    "alexnet": (2, 64), "squeezenet1.1": (2, 64), "mobilenet0.25": (2, 32),
    "densenet121": (2, 32), "inceptionv3": (1, 299),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_forward_matches_jax(name, tmp_path):
    batch, side = FAMILIES[name]
    x = np.random.RandomState(0).uniform(
        -1, 1, (batch, 3, side, side)).astype(np.float32)
    jnet = jvision.get_model(name, classes=10)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    path = str(tmp_path / "w.params")
    jnet.save_params(path)
    tnet = tvision.get_model(name, classes=10)
    tnet.initialize()
    tnet.load_params(path)
    eager = tnet(tmx.nd.array(x)).asnumpy()
    assert eager.shape == (batch, 10)
    scale = np.abs(want).max()
    np.testing.assert_allclose(eager, want, rtol=1e-4, atol=1e-5 * max(
        1.0, scale))
    tnet.hybridize()
    hybrid = tnet(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(hybrid, eager, **TOL)


def test_model_store_cache_layout(tmp_path, monkeypatch):
    """A cached file with the published SHA-1 is found; an offline
    ``MXNET_GLUON_REPO`` directory fills an empty cache; no file raises
    (nothing is fetched); ``purge`` empties the cache."""
    payload = b"not-really-params"
    sha = hashlib.sha1(payload).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "inceptionv3", sha)
    name = "inceptionv3-%s.params" % sha[:8]
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / name).write_bytes(payload)
    got = model_store.get_model_file("inceptionv3", root=str(cache))
    assert got == str(cache / name)
    repo = tmp_path / "repo"
    repo.mkdir()
    (repo / name).write_bytes(payload)
    monkeypatch.setenv("MXNET_GLUON_REPO", str(repo))
    got = model_store.get_model_file("inceptionv3",
                                     root=str(tmp_path / "cache2"))
    assert os.path.exists(got)
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://" + str(repo))
    assert os.path.exists(model_store.get_model_file(
        "inceptionv3", root=str(tmp_path / "cache4")))
    monkeypatch.delenv("MXNET_GLUON_REPO")
    with pytest.raises(MXNetError, match="nothing is fetched"):
        model_store.get_model_file("inceptionv3",
                                   root=str(tmp_path / "cache3"))
    (cache / name).write_bytes(b"tampered")
    with pytest.raises(MXNetError):
        model_store.get_model_file("inceptionv3", root=str(cache))
    model_store.purge(str(cache))
    assert not list(cache.glob("*.params"))
    with pytest.raises(ValueError, match="not available"):
        model_store.get_model_file("mobilenet1.0", root=str(cache))


def test_pretrained_loads_a_local_file_only(tmp_path, monkeypatch):
    """``pretrained=True`` loads the store's file (here one saved by the JAX
    package, its SHA-1 registered for the test) and gives the JAX
    network's outputs."""
    jnet = jvision.get_model("resnet18_v1", classes=10)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(3).uniform(-1, 1, (1, 3, 32, 32)).astype(
        np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    tmp = tmp_path / "tmp.params"
    jnet.save_params(str(tmp))
    sha = hashlib.sha1(tmp.read_bytes()).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1", sha)
    root = tmp_path / "models"
    root.mkdir()
    os.replace(tmp, root / ("resnet18_v1-%s.params" % sha[:8]))
    net = tvision.resnet18_v1(classes=10, pretrained=True, root=str(root))
    np.testing.assert_allclose(net(tmx.nd.array(x)).asnumpy(), want,
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(MXNetError, match="nothing is fetched"):
        tvision.vgg11(pretrained=True, root=str(tmp_path / "empty"))
