"""The Inception family (counterpart of ``mxnet_tpu/models/inception.py``,
after ``example/image-classification/symbols/{googlenet,inception-bn,
inception-v3}.py``): GoogLeNet (``version="v1"``), Inception-BN (``"bn"``)
and Inception-v3 (``"v3"``). The same graphs, node names and Symbol
JSON."""
from .. import symbol as sym


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None,
          with_bn=True, suffix=""):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, no_bias=with_bn,
                           name="%s%s_conv" % (name, suffix))
    if with_bn:
        conv = sym.BatchNorm(data=conv, fix_gamma=False, eps=1e-3,
                             name="%s%s_bn" % (name, suffix))
    return sym.Activation(data=conv, act_type="relu",
                          name="%s%s_relu" % (name, suffix))


# ---------------------------------------------------------------------------
# GoogLeNet (v1, no BN)
# ---------------------------------------------------------------------------
def _v1_block(data, name, f1, f3r, f3, f5r, f5, proj):
    p1 = _conv(data, f1, (1, 1), name=name + "_1x1", with_bn=False)
    p3 = _conv(data, f3r, (1, 1), name=name + "_3x3r", with_bn=False)
    p3 = _conv(p3, f3, (3, 3), pad=(1, 1), name=name + "_3x3", with_bn=False)
    p5 = _conv(data, f5r, (1, 1), name=name + "_5x5r", with_bn=False)
    p5 = _conv(p5, f5, (5, 5), pad=(2, 2), name=name + "_5x5", with_bn=False)
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max", name=name + "_pool")
    pp = _conv(pp, proj, (1, 1), name=name + "_proj", with_bn=False)
    return sym.Concat(p1, p3, p5, pp, dim=1, name=name + "_concat")


def get_googlenet(num_classes=1000, **kwargs):
    data = sym.var("data")
    x = _conv(data, 64, (7, 7), (2, 2), (3, 3), name="conv1", with_bn=False)
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 64, (1, 1), name="conv2r", with_bn=False)
    x = _conv(x, 192, (3, 3), pad=(1, 1), name="conv2", with_bn=False)
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _v1_block(x, "in3a", 64, 96, 128, 16, 32, 32)
    x = _v1_block(x, "in3b", 128, 128, 192, 32, 96, 64)
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _v1_block(x, "in4a", 192, 96, 208, 16, 48, 64)
    x = _v1_block(x, "in4b", 160, 112, 224, 24, 64, 64)
    x = _v1_block(x, "in4c", 128, 128, 256, 24, 64, 64)
    x = _v1_block(x, "in4d", 112, 144, 288, 32, 64, 64)
    x = _v1_block(x, "in4e", 256, 160, 320, 32, 128, 128)
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _v1_block(x, "in5a", 256, 160, 320, 32, 128, 128)
    x = _v1_block(x, "in5b", 384, 192, 384, 48, 128, 128)
    x = sym.Pooling(data=x, global_pool=True, kernel=(7, 7), pool_type="avg")
    x = sym.Dropout(data=sym.Flatten(data=x), p=0.4)
    fc = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


# ---------------------------------------------------------------------------
# Inception-BN (v2)
# ---------------------------------------------------------------------------
def _bn_block(data, name, f1, f3r, f3, d3r, d3, proj, pool="avg",
              stride=(1, 1)):
    parts = []
    if f1 > 0:
        parts.append(_conv(data, f1, (1, 1), name=name + "_1x1"))
    p3 = _conv(data, f3r, (1, 1), name=name + "_3x3r")
    parts.append(_conv(p3, f3, (3, 3), stride=stride, pad=(1, 1),
                       name=name + "_3x3"))
    pd = _conv(data, d3r, (1, 1), name=name + "_d3x3r")
    pd = _conv(pd, d3, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    parts.append(_conv(pd, d3, (3, 3), stride=stride, pad=(1, 1),
                       name=name + "_d3x3b"))
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=stride, pad=(1, 1),
                     pool_type=pool, name=name + "_pool")
    if proj > 0:
        pp = _conv(pp, proj, (1, 1), name=name + "_proj")
    parts.append(pp)
    return sym.Concat(*parts, dim=1, name=name + "_concat")


def get_inception_bn(num_classes=1000, **kwargs):
    data = sym.var("data")
    x = _conv(data, 64, (7, 7), (2, 2), (3, 3), name="conv1")
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 64, (1, 1), name="conv2r")
    x = _conv(x, 192, (3, 3), pad=(1, 1), name="conv2")
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _bn_block(x, "in3a", 64, 64, 64, 64, 96, 32)
    x = _bn_block(x, "in3b", 64, 64, 96, 64, 96, 64)
    x = _bn_block(x, "in3c", 0, 128, 160, 64, 96, 0, pool="max",
                  stride=(2, 2))
    x = _bn_block(x, "in4a", 224, 64, 96, 96, 128, 128)
    x = _bn_block(x, "in4b", 192, 96, 128, 96, 128, 128)
    x = _bn_block(x, "in4c", 160, 128, 160, 128, 160, 128)
    x = _bn_block(x, "in4d", 96, 128, 192, 160, 192, 128)
    x = _bn_block(x, "in4e", 0, 128, 192, 192, 256, 0, pool="max",
                  stride=(2, 2))
    x = _bn_block(x, "in5a", 352, 192, 320, 160, 224, 128)
    x = _bn_block(x, "in5b", 352, 192, 320, 192, 224, 128, pool="max")
    x = sym.Pooling(data=x, global_pool=True, kernel=(7, 7), pool_type="avg")
    fc = sym.FullyConnected(data=sym.Flatten(data=x),
                            num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


# ---------------------------------------------------------------------------
# Inception-v3
# ---------------------------------------------------------------------------
def _v3_a(data, name, proj):
    p1 = _conv(data, 64, (1, 1), name=name + "_1x1")
    p5 = _conv(data, 48, (1, 1), name=name + "_5x5r")
    p5 = _conv(p5, 64, (5, 5), pad=(2, 2), name=name + "_5x5")
    p3 = _conv(data, 64, (1, 1), name=name + "_3x3r")
    p3 = _conv(p3, 96, (3, 3), pad=(1, 1), name=name + "_3x3a")
    p3 = _conv(p3, 96, (3, 3), pad=(1, 1), name=name + "_3x3b")
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    pp = _conv(pp, proj, (1, 1), name=name + "_proj")
    return sym.Concat(p1, p5, p3, pp, dim=1, name=name + "_concat")


def _v3_b(data, name):  # grid reduction 35 -> 17
    p3 = _conv(data, 384, (3, 3), (2, 2), name=name + "_3x3")
    pd = _conv(data, 64, (1, 1), name=name + "_d3x3r")
    pd = _conv(pd, 96, (3, 3), pad=(1, 1), name=name + "_d3x3a")
    pd = _conv(pd, 96, (3, 3), (2, 2), name=name + "_d3x3b")
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                     pool_type="max", name=name + "_pool")
    return sym.Concat(p3, pd, pp, dim=1, name=name + "_concat")


def _v3_c(data, name, f7):  # factorized 7x7
    p1 = _conv(data, 192, (1, 1), name=name + "_1x1")
    p7 = _conv(data, f7, (1, 1), name=name + "_7x7r")
    p7 = _conv(p7, f7, (1, 7), pad=(0, 3), name=name + "_1x7")
    p7 = _conv(p7, 192, (7, 1), pad=(3, 0), name=name + "_7x1")
    pd = _conv(data, f7, (1, 1), name=name + "_d7r")
    pd = _conv(pd, f7, (7, 1), pad=(3, 0), name=name + "_d7x1a")
    pd = _conv(pd, f7, (1, 7), pad=(0, 3), name=name + "_d1x7a")
    pd = _conv(pd, f7, (7, 1), pad=(3, 0), name=name + "_d7x1b")
    pd = _conv(pd, 192, (1, 7), pad=(0, 3), name=name + "_d1x7b")
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    pp = _conv(pp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(p1, p7, pd, pp, dim=1, name=name + "_concat")


def _v3_d(data, name):  # grid reduction 17 -> 8
    p3 = _conv(data, 192, (1, 1), name=name + "_3x3r")
    p3 = _conv(p3, 320, (3, 3), (2, 2), name=name + "_3x3")
    p7 = _conv(data, 192, (1, 1), name=name + "_7x7r")
    p7 = _conv(p7, 192, (1, 7), pad=(0, 3), name=name + "_1x7")
    p7 = _conv(p7, 192, (7, 1), pad=(3, 0), name=name + "_7x1")
    p7 = _conv(p7, 192, (3, 3), (2, 2), name=name + "_3x3b")
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                     pool_type="max", name=name + "_pool")
    return sym.Concat(p3, p7, pp, dim=1, name=name + "_concat")


def _v3_e(data, name):  # expanded filter bank
    p1 = _conv(data, 320, (1, 1), name=name + "_1x1")
    p3 = _conv(data, 384, (1, 1), name=name + "_3x3r")
    p3a = _conv(p3, 384, (1, 3), pad=(0, 1), name=name + "_1x3")
    p3b = _conv(p3, 384, (3, 1), pad=(1, 0), name=name + "_3x1")
    pd = _conv(data, 448, (1, 1), name=name + "_d3r")
    pd = _conv(pd, 384, (3, 3), pad=(1, 1), name=name + "_d3")
    pda = _conv(pd, 384, (1, 3), pad=(0, 1), name=name + "_d1x3")
    pdb = _conv(pd, 384, (3, 1), pad=(1, 0), name=name + "_d3x1")
    pp = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    pp = _conv(pp, 192, (1, 1), name=name + "_proj")
    return sym.Concat(p1, p3a, p3b, pda, pdb, pp, dim=1,
                      name=name + "_concat")


def get_inception_v3(num_classes=1000, **kwargs):
    data = sym.var("data")
    x = _conv(data, 32, (3, 3), (2, 2), name="conv1")
    x = _conv(x, 32, (3, 3), name="conv2")
    x = _conv(x, 64, (3, 3), pad=(1, 1), name="conv3")
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv(x, 80, (1, 1), name="conv4")
    x = _conv(x, 192, (3, 3), name="conv5")
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _v3_a(x, "in_a1", 32)
    x = _v3_a(x, "in_a2", 64)
    x = _v3_a(x, "in_a3", 64)
    x = _v3_b(x, "in_b")
    x = _v3_c(x, "in_c1", 128)
    x = _v3_c(x, "in_c2", 160)
    x = _v3_c(x, "in_c3", 160)
    x = _v3_c(x, "in_c4", 192)
    x = _v3_d(x, "in_d")
    x = _v3_e(x, "in_e1")
    x = _v3_e(x, "in_e2")
    x = sym.Pooling(data=x, global_pool=True, kernel=(8, 8), pool_type="avg")
    x = sym.Dropout(data=sym.Flatten(data=x), p=0.5)
    fc = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc, name="softmax")


def get_symbol(num_classes=1000, version="v3", **kwargs):
    if version in ("v1", "googlenet"):
        return get_googlenet(num_classes, **kwargs)
    if version in ("bn", "v2"):
        return get_inception_bn(num_classes, **kwargs)
    return get_inception_v3(num_classes, **kwargs)
