/*
 * CPython-embedding plumbing for the port's C predict library
 * (c_predict.cc; the port's copy of src/embed_common.h): interpreter
 * bootstrap, GIL guard, and python-exception capture into a
 * thread-local error slot (the MXGetLastError contract). Header-only so
 * the .so stays a single translation unit; the statics are per-TU by
 * design (each library owns its error slot, the process-wide
 * interpreter state is Python's).
 */
#ifndef MXTPU_EMBED_COMMON_H_
#define MXTPU_EMBED_COMMON_H_

/* "#" length args in Py_BuildValue are Py_ssize_t (required since 3.10) */
#ifndef PY_SSIZE_T_CLEAN
#define PY_SSIZE_T_CLEAN
#endif
#include <Python.h>

#ifdef __linux__
#include <dlfcn.h>
#include <stdio.h>
#endif

#include <string>

namespace mxtpu_embed {

inline thread_local std::string g_last_error;

inline void set_error(const std::string &msg) { g_last_error = msg; }

/* Capture the pending Python exception into the error slot. */
inline void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      set_error(c != nullptr ? c : "unknown python error");
      Py_DECREF(s);
    }
  } else {
    set_error("unknown python error");
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

/* PyUnicode_AsUTF8 returns nullptr for non-str / surrogate-laden
 * objects, and std::string(nullptr) is UB — every AsUTF8 on a value
 * that crosses the C boundary must pass through this check (the error
 * lands in the MXGetLastError / MXPredGetLastError slot). */
inline const char *safe_utf8(PyObject *o) {
  const char *s =
      (o != nullptr && PyUnicode_Check(o)) ? PyUnicode_AsUTF8(o) : nullptr;
  if (s == nullptr) {
    if (PyErr_Occurred() != nullptr) {
      capture_py_error();
    } else {
      set_error("expected str from backend");
    }
  }
  return s;
}

/* Interpreter bring-up. Must run before any PyGILState_Ensure: the init
 * leaves the GIL held on the calling thread, so it is released right
 * away and every entry point balances it via the Gil guard below.
 *
 * When this library is itself dlopen'd (perl/R/java FFI consumers
 * rather than a C program linked against it), libpython is loaded in
 * LOCAL scope — python C extensions (numpy's _multiarray_umath, ...)
 * rely on interpreter symbols being global and fail to import
 * otherwise. Re-open libpython with RTLD_GLOBAL | RTLD_NOLOAD to
 * promote the already-mapped image before Py_Initialize. */
inline void ensure_python() {
  if (!Py_IsInitialized()) {
#ifdef __linux__
    char soname[64];
    snprintf(soname, sizeof(soname), "libpython%d.%d.so.1.0",
             PY_MAJOR_VERSION, PY_MINOR_VERSION);
    void *h = dlopen(soname, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD);
    if (h == nullptr) {
      /* not yet mapped (static-linked python?): best-effort load */
      dlopen(soname, RTLD_NOW | RTLD_GLOBAL);
    }
#endif
    Py_InitializeEx(0);
    (void)PyEval_SaveThread();
  }
}

class Gil {
 public:
  Gil() {
    ensure_python();
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }
  Gil(const Gil &) = delete;
  Gil &operator=(const Gil &) = delete;

 private:
  PyGILState_STATE state_;
};

/* Import the backing python module once, prepending MXNET_TPU_HOME to
 * sys.path so a pure-C process can point at the package root. */
inline PyObject *import_backend(const char *module_name) {
  ensure_python();
  Gil gil;
  const char *home = std::getenv("MXNET_TPU_HOME");
  if (home != nullptr) {
    PyObject *sys_path = PySys_GetObject("path");
    if (sys_path != nullptr) {
      PyObject *p = PyUnicode_FromString(home);
      PyList_Insert(sys_path, 0, p);
      Py_DECREF(p);
    }
  }
  PyObject *mod = PyImport_ImportModule(module_name);
  if (mod == nullptr) capture_py_error();
  return mod;
}

}  // namespace mxtpu_embed

#endif  /* MXTPU_EMBED_COMMON_H_ */
