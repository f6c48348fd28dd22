"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It sits beside the JAX package, keeps its file names, parameter names and
layouts, and imports neither JAX nor ``mxnet_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

Ported so far, three paths and four hand-written CUDA kernels
(``kernels``):

- generative serving: ``models.transformer`` prefill and paged decode
  behind ``serving.GenerateServer``, on the flash-attention forward (B5);
- transformer training: ``make_loss_fn`` and ``make_train_step`` with the
  functional optimizers, on the flash-attention backward (B6 dq, B7 dk/dv);
- fused image serving: ``models.resnet`` through the IR ``fusion`` pass
  (``symbol``, ``ir``) into ``serving.AOTPredictor`` behind
  ``serving.ModelServer``, on the fused BN-apply convolution (B1).

ROADMAP.md lists what remains.
"""
from .base import MXNetError
from .context import resolve_device

__all__ = ["MXNetError", "resolve_device"]
