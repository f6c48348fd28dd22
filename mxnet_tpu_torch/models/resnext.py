"""ResNeXt (counterpart of ``mxnet_tpu/models/resnext.py``, after
``example/image-classification/symbols/resnext.py``): bottleneck units
whose 3x3 convolution is grouped (``num_group``, the cardinality), 50, 101
or 152 layers. The same graph, node names and Symbol JSON."""
from .. import symbol as sym
from ..base import MXNetError


def _unit(data, num_filter, stride, dim_match, name, num_group=32,
          bottle_mult=0.5, bn_mom=0.9):
    mid = int(num_filter * bottle_mult)
    c1 = sym.Convolution(data=data, num_filter=mid, kernel=(1, 1),
                         no_bias=True, name=name + "_conv1")
    b1 = sym.BatchNorm(data=c1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn1")
    a1 = sym.Activation(data=b1, act_type="relu", name=name + "_relu1")
    c2 = sym.Convolution(data=a1, num_filter=mid, kernel=(3, 3),
                         stride=stride, pad=(1, 1), num_group=num_group,
                         no_bias=True, name=name + "_conv2")
    b2 = sym.BatchNorm(data=c2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn2")
    a2 = sym.Activation(data=b2, act_type="relu", name=name + "_relu2")
    c3 = sym.Convolution(data=a2, num_filter=num_filter, kernel=(1, 1),
                         no_bias=True, name=name + "_conv3")
    b3 = sym.BatchNorm(data=c3, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                       name=name + "_bn3")
    if dim_match:
        sc = data
    else:
        sc = sym.Convolution(data=data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        sc = sym.BatchNorm(data=sc, fix_gamma=False, eps=2e-5,
                           momentum=bn_mom, name=name + "_sc_bn")
    return sym.Activation(data=b3 + sc, act_type="relu", name=name + "_out")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape=(3, 224, 224), **kwargs):
    if num_layers == 50:
        units = [3, 4, 6, 3]
    elif num_layers == 101:
        units = [3, 4, 23, 3]
    elif num_layers == 152:
        units = [3, 8, 36, 3]
    else:
        raise MXNetError("resnext: unsupported depth %d" % num_layers)
    filters = [256, 512, 1024, 2048]

    data = sym.var("data")
    x = sym.Convolution(data=data, num_filter=64, kernel=(7, 7),
                        stride=(2, 2), pad=(3, 3), no_bias=True, name="conv0")
    x = sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5, name="bn0")
    x = sym.Activation(data=x, act_type="relu", name="relu0")
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max")
    for stage, (n, f) in enumerate(zip(units, filters), 1):
        for i in range(1, n + 1):
            stride = (1, 1) if stage == 1 or i > 1 else (2, 2)
            x = _unit(x, f, stride, dim_match=(i > 1),
                      name="stage%d_unit%d" % (stage, i),
                      num_group=num_group)
    x = sym.Pooling(data=x, global_pool=True, kernel=(7, 7), pool_type="avg")
    fc = sym.FullyConnected(data=sym.Flatten(data=x),
                            num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
