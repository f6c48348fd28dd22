"""Optimizers and the updater (counterpart of ``mxnet_tpu/optimizer.py``).

``Optimizer`` keeps the JAX package's surface: a registry (``create``),
``rescale_grad``, ``clip_gradient``, ``lr_scheduler``, per-parameter
``lr_mult``/``wd_mult`` by name through ``idx2name`` (or ``param_dict``),
and update counts per index. ``SGD``, ``Adam``, ``RMSProp``, ``Ftrl`` and
``Signum`` run the update ops of ``ops/optimizer_ops.py``; ``NAG``,
``AdaGrad``, ``AdaDelta``, ``Adamax``, ``Nadam``, ``SGLD`` and ``DCASGD``
run NDArray arithmetic, as there. ``SGD`` and ``Adam`` with
``lazy_update=True`` (the default) take the lazy row-sparse update of
``ndarray/sparse.py`` for a ``RowSparseNDArray`` gradient: only its rows
move. Every update writes into the weight's own tensor (and the states'),
so an executor bound to that weight trains it. ``SGLD`` draws its noise
from the weight's device generator (``random.generator``), as the port's
random ops do.

``Updater`` owns the per-index states; ``get_states`` pickles the
``{index: numpy state}`` map as the JAX package does, and ``set_states``
reads such bytes with a restricted unpickler that admits numpy arrays and
plain containers only.
"""
from __future__ import annotations

import pickle

import numpy

from .base import MXNetError
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray, invoke

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _zeros_like(weight):
    return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)


class Optimizer:
    """The base optimizer: learning rate, weight decay and their
    per-parameter multipliers, update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self.multi_precision = multi_precision
        self._index_update_count = {}
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    @staticmethod
    def register(klass):
        return register(klass)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def _low_precision(self, weight):
        return self.multi_precision and weight.dtype == numpy.float16

    def create_state_multi_precision(self, index, weight):
        if self._low_precision(weight):
            w32 = weight.astype(numpy.float32)
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._low_precision(weight):
            inner, w32 = state
            self.update(index, w32, grad.astype(numpy.float32), inner)
            w32.copyto(weight)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; use lr_scheduler to "
                             "change lr")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight decay only on weights and gammas (multiplier 0 for every
        other name in ``idx2name``), then ``args_wd_mult``."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            return getattr(self.param_dict[name], attr)
        return table.get(name, 1.0)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _prepared_grad(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        return g


@register
class SGD(Optimizer):
    """SGD with optional momentum and multi-precision (fp16 weights with an
    fp32 master copy)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        from .ndarray.sparse import RowSparseNDArray, sgd_update_rsp

        self._update_count(index)
        kw = self._common_kwargs(index)
        if isinstance(grad, RowSparseNDArray) and self.lazy_update:
            sgd_update_rsp(weight, grad, kw["lr"], wd=kw["wd"],
                           rescale_grad=kw["rescale_grad"],
                           clip_gradient=kw.get("clip_gradient"),
                           state=state, momentum=self.momentum)
        elif state is not None:
            invoke("sgd_mom_update", [weight, grad, state],
                   dict(kw, momentum=self.momentum), out=weight)
        else:
            invoke("sgd_update", [weight, grad], kw, out=weight)

    def update_multi_precision(self, index, weight, grad, state):
        if not self._low_precision(weight):
            return self.update(index, weight, grad, state)
        self._update_count(index)
        kw = self._common_kwargs(index)
        inner, w32 = state
        if inner is not None:
            invoke("mp_sgd_mom_update", [weight, grad, inner, w32],
                   dict(kw, momentum=self.momentum), out=weight)
        else:
            invoke("mp_sgd_update", [weight, grad, w32], kw, out=weight)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            invoke("signum_update", [weight, grad, state],
                   dict(kw, momentum=self.momentum, wd_lh=self.wd_lh),
                   out=weight)
        else:
            invoke("signsgd_update", [weight, grad], kw, out=weight)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prepared_grad(grad) + wd * weight
        if state is not None:
            state *= self.momentum
            state += g
            g = g + self.momentum * state
        weight -= lr * g


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    Gaussian noise of variance ``lr``, drawn from the weight's device
    generator."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prepared_grad(grad)
        noise = invoke("_random_normal", [], {
            "loc": 0.0, "scale": float(numpy.sqrt(lr)),
            "shape": weight.shape}, ctx=weight.context)
        weight -= lr / 2 * (g + wd * weight)
        weight += noise


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: the gradient is corrected by
    ``lamda * g * g * (weight - previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prepared_grad(grad)
        mom, prev = state
        step = -lr * (g + wd * weight + self.lamda * g * g * (weight - prev))
        if mom is not None:
            mom *= self.momentum
            mom += step
        else:
            mom = step
        prev[:] = weight
        weight += mom


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        from .ndarray.sparse import RowSparseNDArray, adam_update_rsp

        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._common_kwargs(index)
        mean, var = state
        if isinstance(grad, RowSparseNDArray) and self.lazy_update:
            adam_update_rsp(weight, grad, mean, var, kw["lr"],
                            beta1=self.beta1, beta2=self.beta2,
                            epsilon=self.epsilon, wd=kw["wd"],
                            rescale_grad=kw["rescale_grad"],
                            clip_gradient=kw.get("clip_gradient"), t=t)
            return
        kw["lr"] *= numpy.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        invoke("adam_update", [weight, grad, mean, var],
               dict(kw, beta1=self.beta1, beta2=self.beta2,
                    epsilon=self.epsilon), out=weight)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._prepared_grad(grad) + wd * weight
        state += g * g
        weight -= lr * g / (state.sqrt() + self.float_stable_eps)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(self._common_kwargs(index), gamma1=self.gamma1,
                  epsilon=self.epsilon)
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            invoke("rmspropalex_update", [weight, grad, *state],
                   dict(kw, gamma2=self.gamma2), out=weight)
        else:
            invoke("rmsprop_update", [weight, grad, state], kw, out=weight)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._prepared_grad(grad)
        acc_g, acc_delta = state
        acc_g *= self.rho
        acc_g += (1 - self.rho) * g * g
        delta = ((acc_delta + self.epsilon).sqrt()
                 / (acc_g + self.epsilon).sqrt()) * g
        acc_delta *= self.rho
        acc_delta += (1 - self.rho) * delta * delta
        weight -= delta + wd * weight


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))     # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        invoke("ftrl_update", [weight, grad, z, n],
               dict(self._common_kwargs(index), lamda1=self.lamda1,
                    beta=self.beta), out=weight)


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t *= self.beta1
        m_t += (1.0 - self.beta1) * g
        u_t[:] = invoke("broadcast_maximum", [self.beta2 * u_t, g.abs()], {})
        weight -= lr * m_t / u_t


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t *= self.beta1
        m_t += (1.0 - self.beta1) * g
        v_t *= self.beta2
        v_t += (1.0 - self.beta2) * g * g
        g_prime = g / (1.0 - self.m_schedule)
        m_t_prime = m_t / (1.0 - m_schedule_next)
        v_t_prime = v_t / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_t_prime
        weight -= lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``weight += grad * rescale_grad``,
    and the state holds the new weight."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


_OPT_REGISTRY["ccsgd"] = SGD
ccSGD = SGD


def create(name, **kwargs):
    """An optimizer by registered name (an instance passes through)."""
    if isinstance(name, Optimizer):
        return name
    klass = _OPT_REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError("unknown optimizer %r" % name)
    return klass(**kwargs)


# -- optimizer-state files ----------------------------------------------------
def loads_states(data):
    """The ``{index: state}`` map of a ``.states`` file's bytes, read with
    the restricted unpickler (numpy arrays and plain containers only); a
    ``(map, optimizer)`` pair (the reference's dump) gives its map."""
    from .checkpoint import loads_plain, unwrap_states_map

    obj = unwrap_states_map(loads_plain(data, "optimizer states"))
    if not isinstance(obj, dict):
        raise MXNetError("optimizer states: expected a dict, got %s"
                         % type(obj).__name__)
    return obj


class Updater:
    """Applies an optimizer by parameter index, creating each index's state
    at its first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = _on_context(self.states[index],
                                             weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Install states from ``get_states`` bytes (of either package)."""
        self.set_states_from_map(loads_states(states))

    def set_states_from_map(self, states_map):
        """Install a plain ``{index: numpy state}`` map; each state moves to
        its weight's context at its next update."""
        def to_nd(x):
            if isinstance(x, numpy.ndarray):
                return nd.array(x, ctx=_cpu(), dtype=x.dtype)
            if isinstance(x, (list, tuple)):
                return type(x)(to_nd(i) for i in x)
            return x

        self.states = {k: to_nd(v) for k, v in states_map.items()}
        self.states_synced = {k: False for k in self.states}

    def get_states_map(self):
        def to_np(x):
            if isinstance(x, NDArray):
                return x.asnumpy()
            if isinstance(x, (list, tuple)):
                return type(x)(to_np(i) for i in x)
            return x

        return {k: to_np(v) for k, v in self.states.items()}

    def get_states(self, dump_optimizer=False):
        return pickle.dumps(self.get_states_map())


def _cpu():
    from .context import cpu

    return cpu()


def _on_context(state, ctx):
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (list, tuple)):
        return type(state)(_on_context(s, ctx) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)


__all__ = ["Optimizer", "SGD", "NAG", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Adamax", "Nadam", "Signum", "Ftrl",
           "create",
           "register", "Updater", "get_updater"]
