"""AlexNet (counterpart of ``mxnet_tpu/models/alexnet.py``, after
``example/image-classification/symbols/alexnet.py``): five convolutions
with LRN after the first two, three fully connected layers with dropout
after the first two, and no grouped convolutions. The same graph, node
names and Symbol JSON."""
from .. import symbol as sym


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    data = sym.var("data")
    c1 = sym.Convolution(data=data, kernel=(11, 11), stride=(4, 4),
                         pad=(2, 2), num_filter=96, name="conv1")
    r1 = sym.Activation(data=c1, act_type="relu")
    l1 = sym.LRN(data=r1, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    p1 = sym.Pooling(data=l1, kernel=(3, 3), stride=(2, 2), pool_type="max")

    c2 = sym.Convolution(data=p1, kernel=(5, 5), pad=(2, 2), num_filter=256,
                         name="conv2")
    r2 = sym.Activation(data=c2, act_type="relu")
    l2 = sym.LRN(data=r2, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    p2 = sym.Pooling(data=l2, kernel=(3, 3), stride=(2, 2), pool_type="max")

    c3 = sym.Convolution(data=p2, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv3")
    r3 = sym.Activation(data=c3, act_type="relu")
    c4 = sym.Convolution(data=r3, kernel=(3, 3), pad=(1, 1), num_filter=384,
                         name="conv4")
    r4 = sym.Activation(data=c4, act_type="relu")
    c5 = sym.Convolution(data=r4, kernel=(3, 3), pad=(1, 1), num_filter=256,
                         name="conv5")
    r5 = sym.Activation(data=c5, act_type="relu")
    p5 = sym.Pooling(data=r5, kernel=(3, 3), stride=(2, 2), pool_type="max")

    f6 = sym.FullyConnected(data=sym.Flatten(data=p5), num_hidden=4096,
                            name="fc6")
    r6 = sym.Activation(data=f6, act_type="relu")
    d6 = sym.Dropout(data=r6, p=0.5)
    f7 = sym.FullyConnected(data=d6, num_hidden=4096, name="fc7")
    r7 = sym.Activation(data=f7, act_type="relu")
    d7 = sym.Dropout(data=r7, p=0.5)
    f8 = sym.FullyConnected(data=d7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=f8, name="softmax")
