"""VGG-11/13/16/19, with or without BatchNorm (counterpart of
``mxnet_tpu/models/vgg.py``, after
``example/image-classification/symbols/vgg.py``): the same graph, node
names and Symbol JSON."""
from .. import symbol as sym
from ..base import MXNetError

_CFGS = {
    11: ((1, 64), (1, 128), (2, 256), (2, 512), (2, 512)),
    13: ((2, 64), (2, 128), (2, 256), (2, 512), (2, 512)),
    16: ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    19: ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)),
}


def get_feature(data, num_layers=16, batch_norm=False):
    if num_layers not in _CFGS:
        raise MXNetError("vgg: num_layers must be one of %s" % list(_CFGS))
    for i, (reps, filters) in enumerate(_CFGS[num_layers], 1):
        for j in range(1, reps + 1):
            data = sym.Convolution(data=data, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters,
                                   name="conv%d_%d" % (i, j))
            if batch_norm:
                data = sym.BatchNorm(data=data, fix_gamma=False,
                                     name="bn%d_%d" % (i, j))
            data = sym.Activation(data=data, act_type="relu",
                                  name="relu%d_%d" % (i, j))
        data = sym.Pooling(data=data, kernel=(2, 2), stride=(2, 2),
                           pool_type="max", name="pool%d" % i)
    return data


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype="float32", **kwargs):
    data = sym.var("data")
    feat = get_feature(data, num_layers, batch_norm)
    flat = sym.Flatten(data=feat)
    fc6 = sym.FullyConnected(data=flat, num_hidden=4096, name="fc6")
    r6 = sym.Activation(data=fc6, act_type="relu")
    d6 = sym.Dropout(data=r6, p=0.5)
    fc7 = sym.FullyConnected(data=d6, num_hidden=4096, name="fc7")
    r7 = sym.Activation(data=fc7, act_type="relu")
    d7 = sym.Dropout(data=r7, p=0.5)
    fc8 = sym.FullyConnected(data=d7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=fc8, name="softmax")
