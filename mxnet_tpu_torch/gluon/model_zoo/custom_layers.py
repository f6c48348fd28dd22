"""The model zoo's helper blocks (counterpart of
``mxnet_tpu/gluon/model_zoo/custom_layers.py``): HybridConcurrent and
Identity."""
from __future__ import annotations

from ...ndarray.ndarray import invoke
from ..nn.basic_layers import HybridBlock


class HybridConcurrent(HybridBlock):
    """Run child blocks on the same input and concat their outputs."""

    def __init__(self, concat_dim=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.concat_dim = concat_dim
        self._layers = []

    def add(self, block):
        self._layers.append(block)
        self.register_child(block)

    def forward(self, x):
        outs = [block(x) for block in self._layers]
        if len(outs) == 1:
            return outs[0]
        return invoke("Concat", outs, {"dim": self.concat_dim})


class Identity(HybridBlock):
    """Pass-through (useful as a no-op branch of HybridConcurrent)."""

    def forward(self, x):
        return x
