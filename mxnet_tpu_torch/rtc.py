"""Run-time compiled CUDA (``mx.rtc``; counterpart of ``mxnet_tpu/rtc.py``,
to MXNet's contract: ``python/mxnet/rtc.py`` with ``src/common/rtc.cc``).

``CudaModule(source, options=(), exports=())`` compiles CUDA C++ source
with NVRTC (``libnvrtc`` of the CUDA toolkit, through :mod:`ctypes`) for
the card's architecture (``sm_90a`` on Hopper) into a cubin, cached under
``mxnet_tpu_torch/_build/rtc`` by a hash of the source, the options, the
exports and the architecture. ``get_kernel(name, signature)`` loads it
through the driver API (``cuModuleLoadData``, ``cuModuleGetFunction``) in
the device's primary context, the one torch uses, and checks the kernel's
C signature (``"const float *x, float *y, int n"``: pointers take
NDArrays, the rest scalars). ``CudaKernel.launch(args, ctx, grid_dims,
block_dims, shared_mem=0)`` launches it on torch's current stream with
``cuLaunchKernel``; the kernel writes its arrays in place and ``launch``
returns None. ``launches`` counts the launches.

A kernel is found by its ``extern "C"`` name, or, for a C++ kernel, by
the name expression ``exports`` lists (``"axpy<float>"``: NVRTC's lowered
name). A name the source does not define raises ``"rtc: source defines no
kernel ..."``.

The card only: a machine where torch sees no CUDA device, a CPU context
and an NDArray on the CPU each raise by name. Nothing runs the source
another way. The JAX package's ``CudaModule`` takes Python source and
returns its outputs (XLA has no user CUDA); this one takes CUDA source and
writes in place, as MXNet's does.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import threading
import time

import numpy as np

from .base import MXNetError

__all__ = ["CudaModule", "CudaKernel"]

# the C types a signature may name (MXNet's rtc.py table)
_DTYPE_CPP_TO_NP = {
    "float": np.float32, "double": np.float64, "__half": np.float16,
    "uint8_t": np.uint8, "int": np.int32, "int32_t": np.int32,
    "int8_t": np.int8, "char": np.int8, "int64_t": np.int64}
_ARG_RE = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


def _parse_signature(signature):
    """``[(is_const, numpy dtype, is_pointer, name)]`` of a C parameter
    list; a malformed parameter or an unknown type raises."""
    if not signature.strip():
        return []
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG_RE.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(
                'rtc: invalid kernel parameter "%s": must be "(const) type '
                '(*) (name)"' % arg.strip())
        if m.group(2) not in _DTYPE_CPP_TO_NP:
            raise MXNetError(
                "rtc: unsupported kernel argument type %r (supported: %s)"
                % (m.group(2), ", ".join(_DTYPE_CPP_TO_NP)))
        out.append((bool(m.group(1)), _DTYPE_CPP_TO_NP[m.group(2)],
                    bool(m.group(3)), m.group(4)))
    return out


_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_GLOBAL_RE = re.compile(
    r"__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_EXTERN_C_BLOCK_RE = re.compile(r'extern\s+"C"\s*\{')


def _kernels(source):
    """``{name: is extern "C"}`` of the ``__global__`` functions of
    ``source``: inside an ``extern "C" { }`` block, or declared
    ``extern "C" __global__``."""
    text = _COMMENT_RE.sub(" ", source)
    blocks = []
    for m in _EXTERN_C_BLOCK_RE.finditer(text):
        depth, i = 1, m.end()
        while i < len(text) and depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        blocks.append((m.end(), i))
    out = {}
    for m in _GLOBAL_RE.finditer(text):
        c_linkage = text[:m.start()].rstrip().endswith('"C"') or any(
            a <= m.start() < b for a, b in blocks)
        out[m.group(1)] = out.get(m.group(1), False) or c_linkage
    return out


def _kernel_symbol(source, exports, name):
    """The symbol to look ``name`` up by: a name expression of ``exports``
    as itself (its lowered name comes from NVRTC), an ``extern "C"``
    kernel as its name. Anything else raises by name."""
    kernels = _kernels(source)
    if name in exports:
        if name.split("<")[0].strip() not in kernels:
            raise MXNetError("rtc: source defines no kernel %r" % name)
        return name
    if name not in kernels:
        raise MXNetError("rtc: source defines no kernel %r" % name)
    if not kernels[name]:
        raise MXNetError(
            'rtc: kernel %r has a C++ name: declare it extern "C" or name '
            "its expression in exports=" % name)
    return name


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise MXNetError(
            "rtc: CudaModule compiles CUDA source for a CUDA device and "
            "torch sees none (torch.cuda.is_available() is False); the "
            "source is not run any other way")


# ---------------------------------------------------------------------------
# NVRTC and the driver API, through ctypes
# ---------------------------------------------------------------------------
_LIB_LOCK = threading.Lock()
_LIBS = {}


def _cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"


def _nvrtc():
    """``libnvrtc``: the toolkit's (``$CUDA_HOME``, else /usr/local/cuda),
    else the one torch's wheels carry. Its builtins library is loaded
    first from the same directory, so NVRTC finds it by name."""
    with _LIB_LOCK:
        if "nvrtc" in _LIBS:
            return _LIBS["nvrtc"]
        dirs = [os.path.join(_cuda_home(), "lib64")]
        try:
            import nvidia.cuda_nvrtc as _wheel

            dirs.append(os.path.join(list(_wheel.__path__)[0], "lib"))
        except ImportError:
            pass
        tried = []
        for d in dirs:
            for path in sorted(glob.glob(os.path.join(d, "libnvrtc.so*")),
                               key=len):
                tried.append(path)
                try:
                    for b in sorted(glob.glob(os.path.join(
                            d, "libnvrtc-builtins.so.*")), key=len)[-1:]:
                        ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                    lib = ctypes.CDLL(path)
                except OSError:
                    continue
                _declare_nvrtc(lib)
                _LIBS["nvrtc"] = lib
                return lib
        raise MXNetError("rtc: libnvrtc not found (tried %s); set CUDA_HOME "
                         "to the CUDA toolkit" % (tried or dirs))


def _declare_nvrtc(lib):
    P, S = ctypes.c_void_p, ctypes.c_char_p
    sigs = {
        "nvrtcCreateProgram": [ctypes.POINTER(P), S, S, ctypes.c_int,
                               ctypes.POINTER(S), ctypes.POINTER(S)],
        "nvrtcAddNameExpression": [P, S],
        "nvrtcCompileProgram": [P, ctypes.c_int, ctypes.POINTER(S)],
        "nvrtcGetProgramLogSize": [P, ctypes.POINTER(ctypes.c_size_t)],
        "nvrtcGetProgramLog": [P, ctypes.c_char_p],
        "nvrtcGetCUBINSize": [P, ctypes.POINTER(ctypes.c_size_t)],
        "nvrtcGetCUBIN": [P, ctypes.c_char_p],
        "nvrtcGetLoweredName": [P, S, ctypes.POINTER(S)],
        "nvrtcDestroyProgram": [ctypes.POINTER(P)],
    }
    for fn, args in sigs.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
    lib.nvrtcGetErrorString.restype = ctypes.c_char_p


def _nvrtc_check(lib, res, what):
    if res != 0:
        raise MXNetError("rtc: %s failed: %s" % (
            what, lib.nvrtcGetErrorString(res).decode()))


def _driver():
    """``libcuda`` (the driver torch runs on), initialised."""
    with _LIB_LOCK:
        if "cuda" in _LIBS:
            return _LIBS["cuda"]
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("rtc: the CUDA driver (libcuda.so.1) does not "
                             "load: %s" % e) from None
        P, U = ctypes.c_void_p, ctypes.c_uint
        sigs = {
            "cuInit": [U],
            "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
            "cuDevicePrimaryCtxRetain": [ctypes.POINTER(P), ctypes.c_int],
            "cuCtxSetCurrent": [P],
            "cuModuleLoadData": [ctypes.POINTER(P), P],
            "cuModuleGetFunction": [ctypes.POINTER(P), P, ctypes.c_char_p],
            "cuFuncSetAttribute": [P, ctypes.c_int, ctypes.c_int],
            "cuLaunchKernel": [P, U, U, U, U, U, U, U, P,
                               ctypes.POINTER(P), ctypes.POINTER(P)],
            "cuGetErrorString": [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_char_p)],
        }
        for fn, args in sigs.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _cu_check(lib, lib.cuInit(0), "cuInit")
        _LIBS["cuda"] = lib
        return lib


_CUDA_ERROR_NOT_FOUND = 500


def _cu_check(lib, res, what):
    if res != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError("rtc: %s failed: CUresult %d (%s)" % (
            what, res, (msg.value or b"?").decode()))


_CTXS = {}


def _make_current(lib, device_index):
    """Make device ``device_index``'s primary context (torch's) current on
    this thread (autograd may run a backward on a thread of its own)."""
    ctx = _CTXS.get(device_index)
    if ctx is None:
        import torch

        torch.cuda.init()
        dev = ctypes.c_int()
        _cu_check(lib, lib.cuDeviceGet(ctypes.byref(dev), device_index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _CTXS[device_index] = ctx
    _cu_check(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------
def _cache_dir():
    from .kernels._build import BUILD_DIR

    return BUILD_DIR / "rtc"


def _arch():
    import torch

    major, minor = torch.cuda.get_device_capability()
    return "sm_%d%d%s" % (major, minor, "a" if major >= 9 else "")


def _compile(source, options, exports):
    """``(cubin bytes, {export: lowered name}, cached)``: the image from
    the cache when it holds one for this source, options, exports and
    architecture, else compiled with NVRTC and cached."""
    opts = list(options)
    if not any(o.startswith(("--gpu-architecture", "-arch")) for o in opts):
        opts.append("--gpu-architecture=%s" % _arch())
    include = os.path.join(_cuda_home(), "include")
    if os.path.isdir(include):
        opts.append("--include-path=%s" % include)
    key = hashlib.sha256(json.dumps(
        [source, opts, list(exports)]).encode()).hexdigest()[:24]
    cubin = _cache_dir() / ("%s.cubin" % key)
    names = _cache_dir() / ("%s.json" % key)
    if cubin.exists() and names.exists():
        return cubin.read_bytes(), json.loads(names.read_text()), True
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for e in exports:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(prog, e.encode()),
                         "nvrtcAddNameExpression(%r)" % e)
        argv = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), argv)
        if res != 0:
            size = ctypes.c_size_t()
            lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
            log = ctypes.create_string_buffer(size.value + 1)
            lib.nvrtcGetProgramLog(prog, log)
            raise MXNetError("rtc: cannot compile kernel source (%s):\n%s"
                             % (lib.nvrtcGetErrorString(res).decode(),
                                log.value.decode(errors="replace")))
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        buf = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, buf), "nvrtcGetCUBIN")
        image = buf.raw
        lowered = {}
        for e in exports:
            p = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(
                prog, e.encode(), ctypes.byref(p)),
                "nvrtcGetLoweredName(%r)" % e)
            lowered[e] = p.value.decode()
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))
    _cache_dir().mkdir(parents=True, exist_ok=True)
    for path, data in ((cubin, image), (names, json.dumps(lowered).encode())):
        tmp = path.with_suffix(path.suffix + ".tmp%d" % os.getpid())
        tmp.write_bytes(data)
        os.replace(tmp, path)
    return image, lowered, False


# ---------------------------------------------------------------------------
# the user surface
# ---------------------------------------------------------------------------
class CudaModule:
    """CUDA C++ source compiled at run time for the card.

    ``options`` go to NVRTC (``--gpu-architecture`` defaults to the card's,
    ``sm_90a`` on Hopper); ``exports`` name C++ kernels by their name
    expressions. ``compile_seconds`` is the construction's compile (or
    cache read) time and ``cached`` says whether the image came from the
    cache::

        mod = mx.rtc.CudaModule(r'''
        extern "C" __global__ void axpy(const float *x, float *y, float a,
                                        int n) {
            int i = blockIdx.x * blockDim.x + threadIdx.x;
            if (i < n) y[i] += a * x[i];
        }''')
        k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
        k.launch([x, y, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
                 (256, 1, 1))
    """

    def __init__(self, source, options=(), exports=()):
        _require_cuda()
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._source = source
        self._exports = tuple(exports)
        t0 = time.perf_counter()
        self._image, self._lowered, self.cached = _compile(
            source, tuple(options), self._exports)
        self.compile_seconds = time.perf_counter() - t0
        self._modules = {}    # device index -> CUmodule

    def _module(self, device_index):
        lib = _driver()
        _make_current(lib, device_index)
        mod = self._modules.get(device_index)
        if mod is None:
            mod = ctypes.c_void_p()
            _cu_check(lib, lib.cuModuleLoadData(ctypes.byref(mod),
                                                self._image),
                      "cuModuleLoadData")
            self._modules[device_index] = mod
        return mod

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name, or a name expression
        of ``exports``) with its C parameter list ``signature``."""
        import torch

        symbol = _kernel_symbol(self._source, self._exports, name)
        args = _parse_signature(signature)
        lib = _driver()
        mod = self._module(torch.cuda.current_device())
        fn = ctypes.c_void_p()
        res = lib.cuModuleGetFunction(
            ctypes.byref(fn), mod,
            self._lowered.get(symbol, symbol).encode())
        if res == _CUDA_ERROR_NOT_FOUND:
            raise MXNetError("rtc: source defines no kernel %r" % name)
        _cu_check(lib, res, "cuModuleGetFunction(%r)" % name)
        return CudaKernel(self, name, args)


class CudaKernel:
    """A kernel of a :class:`CudaModule`; ``launch`` runs it."""

    def __init__(self, module, name, args):
        self._module = module
        self._name = name
        self._args = args
        self._functions = {}    # device index -> CUfunction
        self.launches = 0

    @property
    def name(self):
        return self._name

    def _function(self, device_index):
        fn = self._functions.get(device_index)
        if fn is None:
            lib = _driver()
            mod = self._module._module(device_index)
            fn = ctypes.c_void_p()
            symbol = self._module._lowered.get(self._name, self._name)
            _cu_check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), mod,
                                                   symbol.encode()),
                      "cuModuleGetFunction(%r)" % self._name)
            self._functions[device_index] = fn
        return fn

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``args`` (NDArrays on ``ctx`` for the pointer
        parameters, numbers for the rest) over ``grid_dims`` x
        ``block_dims`` (3 ints each) with ``shared_mem`` bytes of dynamic
        shared memory, on torch's current stream; returns None."""
        import torch

        from .context import Context
        from .ndarray.ndarray import NDArray

        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError("rtc: kernel %r launches on a gpu context, got "
                             "%s" % (self._name, ctx))
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("rtc: grid_dims and block_dims are 3 ints each")
        if len(args) != len(self._args):
            raise MXNetError("rtc: kernel %r takes %d arguments, got %d"
                             % (self._name, len(self._args), len(args)))
        device = torch.device("cuda", ctx.device_id)
        holders, ptrs = [], []
        for i, (arg, (_const, dtype, is_ptr, pname)) in enumerate(
                zip(args, self._args)):
            what = "argument %d (%s) of kernel %r" % (i, pname or "?",
                                                      self._name)
            if is_ptr:
                if not isinstance(arg, NDArray):
                    raise MXNetError("rtc: %s is a pointer: give an NDArray, "
                                     "got %s" % (what, type(arg).__name__))
                t = arg.tensor
                if t.device != device:
                    raise MXNetError("rtc: %s is on %s; the launch is on %s"
                                     % (what, arg.context, ctx))
                if np.dtype(arg.dtype) != np.dtype(dtype):
                    raise MXNetError("rtc: %s is %s; the signature says %s"
                                     % (what, np.dtype(arg.dtype).name,
                                        np.dtype(dtype).name))
                if not t.is_contiguous():
                    raise MXNetError("rtc: %s is not contiguous" % what)
                h = ctypes.c_void_p(t.data_ptr())
                ptrs.append(ctypes.addressof(h))
            else:
                if isinstance(arg, NDArray) or not isinstance(
                        arg, (int, float, np.number, bool)):
                    raise MXNetError("rtc: %s is a %s scalar, got %s"
                                     % (what, np.dtype(dtype).name,
                                        type(arg).__name__))
                h = np.array(arg, dtype=dtype)
                ptrs.append(h.ctypes.data)
            holders.append(h)
        lib = _driver()
        fn = self._function(ctx.device_id)
        _make_current(lib, ctx.device_id)
        if shared_mem > 48 * 1024:
            # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
            _cu_check(lib, lib.cuFuncSetAttribute(fn, 8, int(shared_mem)),
                      "cuFuncSetAttribute")
        params = (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)
        stream = torch.cuda.current_stream(device).cuda_stream
        _cu_check(lib, lib.cuLaunchKernel(
            fn, *[int(g) for g in grid_dims], *[int(b) for b in block_dims],
            int(shared_mem), ctypes.c_void_p(stream), params, None),
            "cuLaunchKernel(%r)" % self._name)
        self.launches += 1
        del holders
