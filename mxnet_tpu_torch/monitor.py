"""Monitor: statistics of the executors' outputs and arguments during
training (counterpart of ``mxnet_tpu/monitor.py``).

``install(exe)`` sets the executor's monitor callback. Between ``tic`` and
``toc`` of every ``interval``-th batch the callback queues the stat of
each output a forward gives (the port's executor calls it after
``forward_backward``'s forward too); ``toc`` adds each argument's and
returns ``(step, name, text)`` rows, ``toc_print`` logs them. The default
stat is ``norm(x) / sqrt(x.size)``.

Monitor is a host-side inspector: a monitored batch waits for the card at
``tic`` and ``toc`` and copies each stat to the host. ``Module`` warns when
one is installed on a module whose kvstore engaged the fused group, whose
one-program step calls no per-executor callback.
"""
from __future__ import annotations

import logging
import re
from math import sqrt

from .ndarray.ndarray import NDArray


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return x.norm() / sqrt(x.size)

            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(arr)))

        self.stat_helper = stat_helper

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        if self.step % self.interval == 0:
            for exe in self.exes:
                for array in exe.arg_arrays:
                    array.wait_to_read()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        if not self.activated:
            return []
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            assert isinstance(v_list, list)
            s = ""
            for v in v_list:
                assert isinstance(v, NDArray)
                if v.shape == (1,) or v.shape == ():
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: {:7d} {:30s} {:s}".format(n, k, v))
