/*
 * C predict ABI (src/c_predict_api.h) over the PyTorch port.
 *
 * The port's copy of src/c_predict.cc: one C shared library that
 * (a) embeds CPython on first use, (b) imports mxnet_tpu_torch.c_predict,
 * (c) forwards every ABI call into it. The JSON parse, the shape
 * inference and the forward are the port's AOTPredictor, the code the
 * serving tier runs, on the card for dev_type 2. The public header is
 * src/c_predict_api.h, so one C program links against either package's
 * library. Built by mxnet_tpu_torch/_native.py (build_predict).
 *
 * Thread-safety: every entry takes the GIL (PyGILState_Ensure).
 */
#include "embed_common.h"  /* defines PY_SSIZE_T_CLEAN before Python.h */

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "c_predict_api.h"

namespace {

using mxtpu_embed::Gil;
using mxtpu_embed::capture_py_error;
using mxtpu_embed::g_last_error;
using mxtpu_embed::set_error;

/* Initialize the interpreter (no-op when hosted inside Python already,
 * e.g. a ctypes consumer) and import mxnet_tpu_torch.c_predict. */
PyObject *predict_module() {
  static PyObject *mod = nullptr;
  if (mod == nullptr) {
    mod = mxtpu_embed::import_backend("mxnet_tpu_torch.c_predict");
  }
  return mod;
}

struct Predictor {
  PyObject *obj;                       /* CPredictor instance */
  std::vector<mx_uint> shape_buf;      /* storage behind GetOutputShape */
};

struct NDList {
  PyObject *obj;                            /* NDList instance */
  std::vector<std::string> keys;
  std::vector<std::vector<mx_uint>> shapes; /* storage behind Get */
};

int create_impl(const char *symbol_json_str, const void *param_bytes,
                int param_size, int dev_type, int dev_id,
                mx_uint num_input_nodes, const char **input_keys,
                const mx_uint *input_shape_indptr,
                const mx_uint *input_shape_data, mx_uint num_output_nodes,
                const char **output_keys, PredictorHandle *out) {
  PyObject *mod = predict_module();
  if (mod == nullptr) return -1;
  Gil gil;
  PyObject *shapes = PyDict_New();
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject *tup = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j) {
      PyTuple_SET_ITEM(tup, j - lo,
                       PyLong_FromUnsignedLong(input_shape_data[j]));
    }
    PyObject *key = PyUnicode_FromString(input_keys[i]);
    PyDict_SetItem(shapes, key, tup);
    Py_DECREF(key);
    Py_DECREF(tup);
  }
  PyObject *outputs = Py_None;
  Py_INCREF(Py_None);
  if (num_output_nodes > 0) {
    Py_DECREF(outputs);
    outputs = PyList_New(num_output_nodes);
    for (mx_uint i = 0; i < num_output_nodes; ++i) {
      PyList_SET_ITEM(outputs, i, PyUnicode_FromString(output_keys[i]));
    }
  }
  PyObject *params = PyBytes_FromStringAndSize(
      static_cast<const char *>(param_bytes), param_size);
  PyObject *pred = PyObject_CallMethod(
      mod, "create_predictor", "sOiiOO", symbol_json_str, params, dev_type,
      dev_id, shapes, outputs);
  Py_DECREF(params);
  Py_DECREF(shapes);
  Py_DECREF(outputs);
  if (pred == nullptr) {
    capture_py_error();
    return -1;
  }
  auto *p = new Predictor();
  p->obj = pred;
  *out = p;
  return 0;
}

}  // namespace

extern "C" {

const char *MXGetLastError() { return g_last_error.c_str(); }

int MXPredCreate(const char *symbol_json_str, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char **input_keys,
                 const mx_uint *input_shape_indptr,
                 const mx_uint *input_shape_data, PredictorHandle *out) {
  return create_impl(symbol_json_str, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, 0, nullptr, out);
}

int MXPredCreatePartialOut(const char *symbol_json_str,
                           const void *param_bytes, int param_size,
                           int dev_type, int dev_id, mx_uint num_input_nodes,
                           const char **input_keys,
                           const mx_uint *input_shape_indptr,
                           const mx_uint *input_shape_data,
                           mx_uint num_output_nodes, const char **output_keys,
                           PredictorHandle *out) {
  return create_impl(symbol_json_str, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, num_output_nodes, output_keys, out);
}

int MXPredSetInput(PredictorHandle handle, const char *key,
                   const mx_float *data, mx_uint size) {
  auto *p = static_cast<Predictor *>(handle);
  Gil gil;
  PyObject *r = PyObject_CallMethod(
      p->obj, "set_input", "sKI", key,
      (unsigned long long)(uintptr_t)data, size);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXPredForward(PredictorHandle handle) {
  auto *p = static_cast<Predictor *>(handle);
  Gil gil;
  PyObject *r = PyObject_CallMethod(p->obj, "forward", nullptr);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXPredPartialForward(PredictorHandle handle, int step, int *step_left) {
  if (step == 0) {
    int rc = MXPredForward(handle);
    if (rc != 0) return rc;
  }
  if (step_left != nullptr) *step_left = 0;
  return 0;
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint **shape_data, mx_uint *shape_ndim) {
  auto *p = static_cast<Predictor *>(handle);
  Gil gil;
  PyObject *r = PyObject_CallMethod(p->obj, "output_shape", "I", index);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(r);
  p->shape_buf.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    p->shape_buf[i] =
        static_cast<mx_uint>(PyLong_AsUnsignedLong(PyTuple_GET_ITEM(r, i)));
  }
  Py_DECREF(r);
  *shape_data = p->shape_buf.data();
  *shape_ndim = static_cast<mx_uint>(n);
  return 0;
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, mx_float *data,
                    mx_uint size) {
  auto *p = static_cast<Predictor *>(handle);
  Gil gil;
  PyObject *r = PyObject_CallMethod(
      p->obj, "get_output", "IKI", index,
      (unsigned long long)(uintptr_t)data, size);
  if (r == nullptr) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXPredFree(PredictorHandle handle) {
  auto *p = static_cast<Predictor *>(handle);
  if (p != nullptr) {
    Gil gil;
    Py_XDECREF(p->obj);
    delete p;
  }
  return 0;
}

int MXNDListCreate(const char *nd_file_bytes, int nd_file_size,
                   NDListHandle *out, mx_uint *out_length) {
  PyObject *mod = predict_module();
  if (mod == nullptr) return -1;
  Gil gil;
  PyObject *payload =
      PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject *lst = PyObject_CallMethod(mod, "create_ndlist", "O", payload);
  Py_DECREF(payload);
  if (lst == nullptr) {
    capture_py_error();
    return -1;
  }
  auto *l = new NDList();
  l->obj = lst;
  Py_ssize_t n = PyObject_Length(lst);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *k = PyObject_CallMethod(lst, "key", "n", i);
    const char *kk = mxtpu_embed::safe_utf8(k);
    if (kk == nullptr) {
      Py_XDECREF(k);
      Py_DECREF(l->obj);
      delete l;
      return -1;
    }
    l->keys.emplace_back(kk);
    Py_DECREF(k);
    PyObject *s = PyObject_CallMethod(lst, "shape", "n", i);
    if (s == nullptr) {
      capture_py_error();
      Py_DECREF(l->obj);
      delete l;
      return -1;
    }
    std::vector<mx_uint> shape;
    for (Py_ssize_t j = 0; j < PyTuple_Size(s); ++j) {
      shape.push_back(static_cast<mx_uint>(
          PyLong_AsUnsignedLong(PyTuple_GET_ITEM(s, j))));
    }
    Py_DECREF(s);
    l->shapes.push_back(std::move(shape));
  }
  *out = l;
  *out_length = static_cast<mx_uint>(n);
  return 0;
}

int MXNDListGet(NDListHandle handle, mx_uint index, const char **out_key,
                const mx_float **out_data, const mx_uint **out_shape,
                mx_uint *out_ndim) {
  auto *l = static_cast<NDList *>(handle);
  if (index >= l->keys.size()) {
    set_error("NDList index out of range");
    return -1;
  }
  Gil gil;
  PyObject *ptr = PyObject_CallMethod(l->obj, "data_ptr", "I", index);
  if (ptr == nullptr) {
    capture_py_error();
    return -1;
  }
  *out_data = reinterpret_cast<const mx_float *>(
      (uintptr_t)PyLong_AsUnsignedLongLong(ptr));
  Py_DECREF(ptr);
  *out_key = l->keys[index].c_str();
  *out_shape = l->shapes[index].data();
  *out_ndim = static_cast<mx_uint>(l->shapes[index].size());
  return 0;
}

int MXNDListFree(NDListHandle handle) {
  auto *l = static_cast<NDList *>(handle);
  if (l != nullptr) {
    Gil gil;
    Py_XDECREF(l->obj);
    delete l;
  }
  return 0;
}

}  // extern "C"
