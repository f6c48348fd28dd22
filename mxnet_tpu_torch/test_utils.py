"""Test utilities (``mx.test_utils``; counterpart of
``mxnet_tpu/test_utils.py``): finite-difference gradient checks, symbolic
forward/backward checks, cross-context consistency, random arrays and
array comparisons. The comparisons take NDArrays, numpy arrays and torch
tensors alike."""
from __future__ import annotations

import numpy as np
import torch

from . import context as ctx_mod
from .base import MXNetError
from .ndarray import ndarray as nd


def _np(a):
    """A numpy copy of an NDArray or a torch tensor (bfloat16 as float32),
    or ``np.asarray`` of anything else."""
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(a)


def default_context():
    return ctx_mod.current_context()


def default_dtype():
    return np.float32


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (
        np.random.randint(1, dim0 + 1),
        np.random.randint(1, dim1 + 1),
        np.random.randint(1, dim2 + 1),
    )


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None):
    if stype == "default":
        return nd.array(np.random.uniform(-1, 1, shape), ctx=ctx, dtype=dtype or np.float32)
    from .ndarray import sparse as sp

    density = 0.5 if density is None else density
    arr = np.random.uniform(-1, 1, shape).astype(dtype or np.float32)
    mask = np.random.uniform(0, 1, (shape[0],) + (1,) * (len(shape) - 1)) < density
    arr = arr * mask
    if stype == "row_sparse":
        return sp.cast_storage(nd.array(arr, ctx=ctx), "row_sparse")
    if stype == "csr":
        mask2 = np.random.uniform(0, 1, shape) < density
        return sp.cast_storage(nd.array(arr * mask2, ctx=ctx), "csr")
    raise MXNetError("unknown stype %r" % stype)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b")):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg="%s vs %s" % names)


def almost_equal(a, b, rtol=1e-5, atol=1e-20):
    a, b = _np(a), _np(b)
    return np.allclose(a, b, rtol=rtol, atol=atol)


def same(a, b):
    a, b = _np(a), _np(b)
    return np.array_equal(a, b)


def _parse_location(sym, location, ctx, dtype=np.float32):
    if isinstance(location, dict):
        wrong = set(location.keys()) - set(sym.list_arguments())
        if wrong:
            raise ValueError("unknown argument names %s" % wrong)
        return {
            k: (v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx, dtype=dtype))
            for k, v in location.items()
        }
    return {
        k: (v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx, dtype=dtype))
        for k, v in zip(sym.list_arguments(), location)
    }


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           aux_states=None, ctx=None, dtype=np.float32):
    """Run the bound forward and compare with the expected arrays."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    aux = None
    if aux_states is not None:
        aux = {
            k: (v if isinstance(v, nd.NDArray) else nd.array(v, ctx=ctx, dtype=dtype))
            for k, v in aux_states.items()
        }
    else:
        aux_names = sym.list_auxiliary_states()
        if aux_names:
            shapes = {k: v.shape for k, v in location.items()}
            _, _, aux_shapes = sym.infer_shape(**shapes)
            aux = {n: nd.zeros(s, ctx=ctx) for n, s in zip(aux_names, aux_shapes)}
    executor = sym.bind(ctx=ctx, args=location, aux_states=aux)
    outputs = executor.forward(is_train=False)
    for output, expect in zip(outputs, expected):
        assert_almost_equal(output, expect, rtol=rtol, atol=atol)
    return outputs


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-5, grad_req="write", ctx=None, aux_states=None,
                            dtype=np.float32):
    """Run the backward and compare the argument gradients."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    args_grad = {k: nd.zeros(v.shape, ctx=ctx, dtype=dtype) for k, v in location.items()}
    aux = None
    aux_names = sym.list_auxiliary_states()
    if aux_names:
        if aux_states is not None:
            aux = {k: nd.array(v, ctx=ctx, dtype=dtype) for k, v in aux_states.items()}
        else:
            shapes = {k: v.shape for k, v in location.items()}
            _, _, aux_shapes = sym.infer_shape(**shapes)
            aux = {n: nd.zeros(s, ctx=ctx) for n, s in zip(aux_names, aux_shapes)}
    executor = sym.bind(ctx=ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux)
    executor.forward(is_train=True)
    og = out_grads
    if og is not None:
        og = [
            g if isinstance(g, nd.NDArray) else nd.array(g, ctx=ctx, dtype=dtype)
            for g in (og if isinstance(og, (list, tuple)) else [og])
        ]
    executor.backward(og)
    if isinstance(expected, dict):
        for name, expect in expected.items():
            if executor.grad_dict.get(name) is not None:
                assert_almost_equal(executor.grad_dict[name], expect, rtol=rtol, atol=atol)
    else:
        for name, expect in zip(sym.list_arguments(), expected):
            if expect is not None and executor.grad_dict.get(name) is not None:
                assert_almost_equal(executor.grad_dict[name], expect, rtol=rtol, atol=atol)
    return executor.grad_arrays


def numeric_grad(executor, location, aux_states=None, eps=1e-4, use_forward_train=True):
    """Central finite differences on the bound executor."""
    approx_grads = {k: np.zeros(v.shape, dtype=np.float32) for k, v in location.items()}
    for k, v in location.items():
        old_value = np.array(v.asnumpy())  # writable copy
        flat = old_value.reshape(-1)
        grad_flat = approx_grads[k].reshape(-1)
        for i in range(flat.size):
            orig = flat[i].copy()
            flat[i] = orig + eps / 2
            executor.arg_dict[k][:] = nd.array(old_value.reshape(v.shape))
            f_pos = sum(o.asnumpy().sum() for o in executor.forward(is_train=use_forward_train))
            flat[i] = orig - eps / 2
            executor.arg_dict[k][:] = nd.array(old_value.reshape(v.shape))
            f_neg = sum(o.asnumpy().sum() for o in executor.forward(is_train=use_forward_train))
            grad_flat[i] = (f_pos - f_neg) / eps
            flat[i] = orig
        executor.arg_dict[k][:] = nd.array(old_value.reshape(v.shape))
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None, dtype=np.float32):
    """Finite-difference gradient check."""
    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx, dtype)
    if grad_nodes is None:
        grad_nodes = [k for k in location]
    args_grad = {k: nd.zeros(v.shape, ctx=ctx, dtype=dtype) for k, v in location.items()}
    aux = None
    aux_names = sym.list_auxiliary_states()
    if aux_names:
        shapes = {k: v.shape for k, v in location.items()}
        _, _, aux_shapes = sym.infer_shape(**shapes)
        aux = {n: nd.zeros(s, ctx=ctx) for n, s in zip(aux_names, aux_shapes)}
        if aux_states:
            for k, v in aux_states.items():
                aux[k] = nd.array(v, ctx=ctx)
    executor = sym.bind(ctx=ctx, args=location, args_grad=args_grad, aux_states=aux)
    executor.forward(is_train=use_forward_train)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}

    fd_grads = numeric_grad(
        executor, {k: v for k, v in location.items() if k in grad_nodes},
        eps=numeric_eps, use_forward_train=use_forward_train,
    )
    for name in grad_nodes:
        np.testing.assert_allclose(
            fd_grads[name], symbolic_grads[name], rtol=rtol, atol=atol if atol is not None else 1e-4,
            err_msg="numeric vs symbolic gradient mismatch for %s" % name,
        )


def check_consistency(sym, ctx_list, scale=1.0, grad_req="write", rtol=1e-4, atol=1e-4):
    """Run the same graph on several contexts (the CPU and the card) and
    compare outputs and gradients."""
    if len(ctx_list) < 2:
        return
    results = []
    arg_np = None
    for ctx_spec in ctx_list:
        ctx = ctx_spec["ctx"]
        shapes = {k: v for k, v in ctx_spec.items() if k != "ctx" and not k.endswith("dtype")}
        arg_names = sym.list_arguments()
        arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        if arg_np is None:
            arg_np = [np.random.normal(0, scale, size=s).astype(np.float32) for s in arg_shapes]
        args = {n: nd.array(a, ctx=ctx) for n, a in zip(arg_names, arg_np)}
        grads = {n: nd.zeros(s, ctx=ctx) for n, s in zip(arg_names, arg_shapes)}
        aux = {n: nd.zeros(s, ctx=ctx) for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
        exe = sym.bind(ctx=ctx, args=args, args_grad=grads, grad_req=grad_req, aux_states=aux)
        outs = exe.forward(is_train=True)
        exe.backward()
        results.append((
            [o.asnumpy() for o in outs],
            {n: g.asnumpy() for n, g in exe.grad_dict.items() if g is not None},
        ))
    ref_outs, ref_grads = results[0]
    for outs, grads in results[1:]:
        for a, b in zip(ref_outs, outs):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
        for n in ref_grads:
            np.testing.assert_allclose(ref_grads[n], grads[n], rtol=rtol, atol=atol)


def check_speed(sym=None, location=None, ctx=None, N=20, grad_req="write", typ="whole", **kwargs):
    """Time forward(+backward) executions."""
    import time

    ctx = ctx or default_context()
    location = _parse_location(sym, location, ctx)
    args_grad = {k: nd.zeros(v.shape, ctx=ctx) for k, v in location.items()}
    exe = sym.bind(ctx=ctx, args=location, args_grad=args_grad, grad_req=grad_req)
    # warmup
    exe.forward(is_train=True)
    if typ == "whole":
        exe.backward()
    nd.waitall()
    tic = time.time()
    for _ in range(N):
        if typ == "whole":
            exe.forward_backward()
        else:
            exe.forward(is_train=False)
    for o in exe.outputs:
        o.wait_to_read()
    nd.waitall()
    return (time.time() - tic) / N


def list_gpus():
    from .context import num_gpus

    return list(range(num_gpus()))


def download(url, fname=None, dirname=None, overwrite=False):
    raise MXNetError("download: no network egress in this environment")


def clean_dist_env(repo_root=None):
    """A copy of ``os.environ`` with every distributed-topology and
    elastic-recovery knob stripped: the launch environment of subprocess
    tests (one definition, so no caller inherits a stale knob)."""
    import os

    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("DMLC_", "MXNET_TPU_", "MXNET_PS_", "MXNET_MAX_",
                         "MXNET_CHECKPOINT_", "MXNET_FAULT_",
                         "MXNET_EMBED_", "MXNET_DATA_",
                         "MXNET_FLEET_AUTOSCALE_", "MXNET_QOS_")):
            del env[k]
    if repo_root:
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH",
                                                             "")
    return env
