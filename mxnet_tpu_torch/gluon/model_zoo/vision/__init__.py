"""The vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ``get_model`` by the 30 names of the
JAX package, with its parameter names and shapes. ``pretrained=True``
loads ``model_store``'s local file and fetches nothing."""
from __future__ import annotations

from ....base import MXNetError
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201)
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (MobileNet, mobilenet0_25, mobilenet0_5,  # noqa: F401
                        mobilenet0_75, mobilenet1_0)
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet  # noqa: F401
from .squeezenet import (SqueezeNet, get_squeezenet,  # noqa: F401
                         squeezenet1_0, squeezenet1_1)
from .vgg import (VGG, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,  # noqa: F401
                  vgg16_bn, vgg19, vgg19_bn)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,  # noqa: F405
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,  # noqa: F405
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,  # noqa: F405
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,  # noqa: F405
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,  # noqa: F405
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """The network ``name`` (one of the 30), built with ``kwargs``."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            "Model %s is not supported. Available options are:\n\t%s"
            % (name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
