"""The pretrained-weights store (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``), offline.

``get_model_file(name, root)`` returns ``root/{name}-{sha1[:8]}.params``
when that file is there and its SHA-1 is the published one. Otherwise it
copies the file (or unpacks its ``.zip``) from ``MXNET_GLUON_REPO`` when
that names a local directory (or a ``file://`` tree), and raises
``MXNetError`` when there is no such file. Nothing is fetched over a
network. ``load_pretrained`` is the model zoo's ``pretrained=True``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import zipfile

from ...base import MXNetError

__all__ = ["get_model_file", "purge", "short_hash", "check_sha1",
           "load_pretrained"]

# name -> SHA-1 of the released .params files (the published checksums)
_model_sha1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("d2b128fa89477c2e20061607a53a8d9f66ce239d", "resnet101_v1"),
    ("6562166cd597a6328a32a0ce47bb651df80b3bbb", "resnet152_v1"),
    ("38d6d423c22828718ec3397924b8e116a03e6ac0", "resnet18_v1"),
    ("4dc2c2390a7c7990e0ca1e53aeebb1d1a08592d1", "resnet34_v1"),
    ("2a903ab21260c85673a78fe65037819a843a1f43", "resnet50_v1"),
    ("8aacf80ff4014c1efa2362a963ac5ec82cf92d5b", "resnet18_v2"),
    ("0ed3cd06da41932c03dea1de7bc2506ef3fb97b3", "resnet34_v2"),
    ("eb7a368774aa34a12ed155126b641ae7556dad9d", "resnet50_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("649467530119c0f78c4859999e264e7bf14471a9", "vgg16"),
    ("6b9dbe6194e5bfed30fd7a7c9a71f7e5a276cb14", "vgg16_bn"),
    ("f713436691eee9a20d70a145ce0d53ed24bf7399", "vgg19"),
    ("9730961c9cea43fd7eeefb00d792e386c45847d6", "vgg19_bn"),
]}

DEFAULT_ROOT = "~/.mxnet/models/"


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError("Pretrained model for %s is not available." % name)
    return _model_sha1[name][:8]


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1 << 20)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def _from_local_repo(repo, file_name, root, file_path, name):
    src_params = os.path.join(repo, file_name + ".params")
    src_zip = os.path.join(repo, file_name + ".zip")
    if os.path.exists(src_params):
        shutil.copyfile(src_params, file_path)
    elif os.path.exists(src_zip):
        zip_path = os.path.join(root, file_name + ".zip")
        shutil.copyfile(src_zip, zip_path)
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(root)
        os.remove(zip_path)
    else:
        raise MXNetError("pretrained %r not found in local repo %s"
                         % (name, repo))


def get_model_file(name, root=DEFAULT_ROOT):
    """The path of ``name``'s pretrained ``.params`` file in the cache
    ``root`` (the reference's layout, so a cache filled by another
    installation is used as it is), copied there from ``MXNET_GLUON_REPO``
    when that is a local directory."""
    file_name = "%s-%s" % (name, short_hash(name))
    root = os.path.expanduser(root)
    file_path = os.path.join(root, file_name + ".params")
    sha1_hash = _model_sha1[name]
    if os.path.exists(file_path) and check_sha1(file_path, sha1_hash):
        return file_path
    repo = os.environ.get("MXNET_GLUON_REPO", "")
    if repo.startswith("file://"):
        repo = repo[len("file://"):]
    if not repo or not os.path.isdir(repo):
        raise MXNetError(
            "pretrained %r: no file %s.params with the published SHA-1 under "
            "%s, and MXNET_GLUON_REPO names no local directory to copy it "
            "from (nothing is fetched over a network)"
            % (name, file_name, root))
    os.makedirs(root, exist_ok=True)
    _from_local_repo(repo, file_name, root, file_path, name)
    if check_sha1(file_path, sha1_hash):
        return file_path
    raise MXNetError("pretrained %r: %s has another SHA-1 than the published "
                     "one" % (name, file_path))


def purge(root=DEFAULT_ROOT):
    """Remove every cached ``.params`` file under ``root``."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))


def load_pretrained(net, name, pretrained, ctx=None, root=None):
    """``net``, with ``name``'s pretrained weights loaded when
    ``pretrained`` (from :func:`get_model_file`)."""
    if pretrained:
        path = get_model_file(name, root=root or DEFAULT_ROOT)
        net.initialize(ctx=ctx)
        net.load_params(path, ctx=ctx)
    return net
