"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``;
ref: python/mxnet/lr_scheduler.py — FactorScheduler, MultiFactorScheduler,
PolyScheduler).

The port's own copy: the same classes, arguments, checks and schedules.
Each scheduler is called with the update count and returns the learning
rate for it; ``FactorScheduler`` and ``MultiFactorScheduler`` keep state
between calls, so call them with non-decreasing counts.
"""
from __future__ import annotations

import logging

from .base import MXNetError


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise MXNetError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise MXNetError("Factor must be no more than 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: lr reached stop factor, freeze at %0.5e", num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e", num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1, base_lr=0.01):
        super().__init__(base_lr)
        if not isinstance(step, list) or len(step) < 1:
            raise MXNetError("step must be a non-empty list")
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise MXNetError("step must be an increasing list")
            if _step < 1:
                raise MXNetError("step must be >= 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e", num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if max_update < 1:
            raise MXNetError("maximum number of updates must be >= 1")
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / float(self.max_update), self.power
            )
        return self.base_lr
