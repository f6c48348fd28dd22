"""Small utilities (counterpart of ``mxnet_tpu/util.py``): the numpy-mode
flags (off: the port has MXNet's classic NDArray semantics), ``makedirs``
and ``get_gpu_count`` (the CUDA devices torch sees)."""


def is_np_array():
    return False


def is_np_shape():
    return False


def makedirs(d):
    import os

    os.makedirs(d, exist_ok=True)


def get_gpu_count():
    from .context import num_gpus

    return num_gpus()
