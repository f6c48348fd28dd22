"""MobileNet v1 (counterpart of ``mxnet_tpu/models/mobilenet.py``, after
``example/image-classification/symbols/mobilenet.py``): depthwise
convolutions as ``num_group`` = channels, width ``multiplier``. The same
graph, node names and Symbol JSON."""
from .. import symbol as sym


def _conv_bn(data, num_filter, kernel, stride, pad, name, num_group=1):
    c = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, num_group=num_group,
                        no_bias=True, name=name)
    b = sym.BatchNorm(data=c, fix_gamma=False, name=name + "_bn")
    return sym.Activation(data=b, act_type="relu", name=name + "_relu")


def _dw_sep(data, in_ch, out_ch, stride, name):
    dw = _conv_bn(data, in_ch, (3, 3), stride, (1, 1), name + "_dw",
                  num_group=in_ch)
    return _conv_bn(dw, out_ch, (1, 1), (1, 1), (0, 0), name + "_pw")


def get_symbol(num_classes=1000, multiplier=1.0, **kwargs):
    def ch(n):
        return max(8, int(n * multiplier))

    data = sym.var("data")
    x = _conv_bn(data, ch(32), (3, 3), (2, 2), (1, 1), "conv1")
    cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
           (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
          [(512, 1024, 2), (1024, 1024, 1)]
    for i, (cin, cout, s) in enumerate(cfg, 2):
        x = _dw_sep(x, ch(cin), ch(cout), (s, s), "conv%d" % i)
    x = sym.Pooling(data=x, global_pool=True, kernel=(7, 7), pool_type="avg")
    fc = sym.FullyConnected(data=sym.Flatten(data=x),
                            num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")
