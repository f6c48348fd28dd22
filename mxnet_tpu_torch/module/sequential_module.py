"""SequentialModule — sub-modules chained into one training pipeline
(counterpart of ``mxnet_tpu/module/sequential_module.py``).

``add(module, take_labels=..., auto_wiring=...)``: each sub-module's
outputs become the next one's data (``auto_wiring`` renames them to its
data names), the pipeline's labels go to the modules that take them, and
gradients flow back through ``get_input_grads`` (every module after the
first binds with ``inputs_need_grad``).
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from ..io import DataDesc
from .base_module import BaseModule


def _norm(shapes):
    """[(name, shape)] from DataDesc or tuple entries."""
    out = []
    for d in shapes:
        if isinstance(d, DataDesc):
            out.append((d.name, tuple(d.shape)))
        else:
            out.append((d[0], tuple(d[1])))
    return out


class SequentialModule(BaseModule):
    """A container chaining several modules end to end."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append a module. ``take_labels=True`` routes the pipeline's
        labels to this module; ``auto_wiring=True`` renames this module's
        data to the previous module's outputs."""
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, (
                "unknown meta %r (known: %s)" % (key, self._meta_keys))
        self._metas.append(kwargs)
        # binding state resets whenever the chain changes
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self  # chaining: seq.add(a).add(b)

    # -- properties ----------------------------------------------------------
    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- params --------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        initializer = initializer or Uniform(0.01)
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init, allow_extra=True)

        # no duplicate parameter names across sub-modules
        seen = {}
        for i, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for name in list(arg) + list(aux):
                assert name not in seen, (
                    "duplicate parameter %r in modules %d and %d"
                    % (name, seen[name], i))
                seen[name] = i
        self.params_initialized = True

    # -- bind ----------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None, (
            "shared_module is not supported for SequentialModule")
        assert len(self._modules) > 0, "add modules before bind"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            my_label_shapes = label_shapes if take_labels else None
            if take_labels:
                anybody_ever_needs_label = True
            my_inputs_need_grad = inputs_need_grad if i == 0 else True
            if meta.get(self.META_AUTO_WIRING, False) and i > 0:
                # rename the previous outputs to this module's data names
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [
                    (name, shape)
                    for name, (_, shape) in zip(data_names,
                                                _norm(my_data_shapes))
                ]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            # next module consumes this one's outputs
            my_data_shapes = _norm(module.output_shapes)
        if not anybody_ever_needs_label:
            self._label_shapes = None

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch

        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(data=module.get_outputs(),
                              label=data_batch.label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for module in self._modules:
            module.install_monitor(mon)
