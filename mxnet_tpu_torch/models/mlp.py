"""A three-layer MLP (counterpart of ``mxnet_tpu/models/mlp.py``, after
``example/image-classification/symbols/mlp.py``): the same graph, node
names and Symbol JSON."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.var("data")
    data = sym.Flatten(data=data)
    fc1 = sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    act1 = sym.Activation(data=fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(data=act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(data=fc2, name="relu2", act_type="relu")
    fc3 = sym.FullyConnected(data=act2, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc3, name="softmax")
