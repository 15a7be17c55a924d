// CPython extension: the microsecond-free single-query serving path.
//
// The ctypes route (native/__init__.py BoundsHandle) costs ~1.5-2.5 us of
// foreign-function marshalling per call on top of the ~100 ns binary
// search. This extension replaces it with a direct C method call
// (METH_FASTCALL): pinned text/SA pointers live in the object, the query
// arrives as a bytes object, and the result is a freshly built 2-tuple.
//
// It also exposes a pure-C self-benchmark (`bench`) so the framework can
// report the C-only floor alongside the Python-visible number — the
// apples-to-apples row against the reference's in-process #[bench]
// results (README.md:86-94), which pay no language-boundary cost at all.
//
// Built by native/__init__.py on first use (same scheme as libsaistpu.so).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <ctime>

#include "bounds_core.h"
#include "sais_core.h"

namespace {

struct BoundsObject {
  PyObject_HEAD
  Py_buffer text;  // contiguous uint8 view, held for the object's lifetime
  Py_buffer sa;    // contiguous uint32 view
  PyObject* sa_obj;  // the sa ndarray itself: base object for result views
  const uint8_t* text_p;
  const uint32_t* sa_p;
  uint32_t n;
  int views_held;
};

int Bounds_init(PyObject* self_obj, PyObject* args, PyObject* kwds) {
  static const char* kwlist[] = {"text", "sa", nullptr};
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  PyObject* text_obj;
  PyObject* sa_obj;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "OO",
                                   const_cast<char**>(kwlist), &text_obj,
                                   &sa_obj)) {
    return -1;
  }
  if (PyObject_GetBuffer(text_obj, &self->text, PyBUF_C_CONTIGUOUS) != 0) {
    return -1;
  }
  if (PyObject_GetBuffer(sa_obj, &self->sa, PyBUF_C_CONTIGUOUS) != 0) {
    PyBuffer_Release(&self->text);
    return -1;
  }
  self->views_held = 1;
  if (self->sa.len != self->text.len * 4) {
    PyErr_SetString(PyExc_ValueError,
                    "sa must hold one uint32 per text byte");
    return -1;
  }
  Py_INCREF(sa_obj);
  self->sa_obj = sa_obj;
  self->text_p = static_cast<const uint8_t*>(self->text.buf);
  self->sa_p = static_cast<const uint32_t*>(self->sa.buf);
  self->n = static_cast<uint32_t>(self->text.len);
  return 0;
}

void Bounds_dealloc(PyObject* self_obj) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  if (self->views_held) {
    PyBuffer_Release(&self->text);
    PyBuffer_Release(&self->sa);
    Py_XDECREF(self->sa_obj);
  }
  Py_TYPE(self_obj)->tp_free(self_obj);
}

// Extract (ptr, len) from a bytes query; sets TypeError otherwise.
inline bool query_bytes(PyObject* query, const uint8_t** q, uint32_t* qlen) {
  if (!PyBytes_Check(query)) {
    PyErr_SetString(PyExc_TypeError, "query must be bytes");
    return false;
  }
  *q = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(query));
  *qlen = static_cast<uint32_t>(PyBytes_GET_SIZE(query));
  return true;
}

// Like query_bytes but also accepts str (indexed as UTF-8 — the
// SuffixTable contract, src/table.rs:66) and any bytes-like object.
// Doing the coercion here instead of in Python is what lets SuffixTable
// bind these methods directly onto instances (single attribute lookup +
// one C call per operation). *owner receives a new reference when a
// temporary had to be materialized; release it AFTER consuming *q.
inline bool query_view(PyObject* query, const uint8_t** q, uint32_t* qlen,
                       PyObject** owner) {
  *owner = nullptr;
  if (PyBytes_Check(query)) {
    *q = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(query));
    *qlen = static_cast<uint32_t>(PyBytes_GET_SIZE(query));
    return true;
  }
  if (PyUnicode_Check(query)) {
    Py_ssize_t l;
    const char* s = PyUnicode_AsUTF8AndSize(query, &l);
    if (!s) return false;
    *q = reinterpret_cast<const uint8_t*>(s);
    *qlen = static_cast<uint32_t>(l);
    return true;  // the UTF-8 cache lives as long as the str itself
  }
  // Anything else takes the exact `bytes(query)` coercion (buffer
  // protocol, sequences of ints, even the int zero-fill): the Python
  // wrappers coerce with bytes() on the un-bound first call, and the
  // bound extension methods must accept the same inputs on every call
  // after (ADVICE r4: call-N behavior must match call-1).
  PyObject* b = PyBytes_FromObject(query);
  if (!b) return false;
  *owner = b;
  *q = reinterpret_cast<const uint8_t*>(PyBytes_AS_STRING(b));
  *qlen = static_cast<uint32_t>(PyBytes_GET_SIZE(b));
  return true;
}

// bounds(query: bytes) -> (start, count)
PyObject* Bounds_bounds(PyObject* self_obj, PyObject* query) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const uint8_t* q;
  uint32_t qlen;
  PyObject* owner;
  if (!query_view(query, &q, &qlen, &owner)) return nullptr;
  uint32_t start, count;
  stpu::bounds_core(self->text_p, self->n, self->sa_p, q, qlen, &start,
                    &count);
  Py_XDECREF(owner);
  return Py_BuildValue("II", (unsigned int)start, (unsigned int)count);
}

// positions(query: bytes) -> uint32 ndarray view of sa[start:start+count]
// — zero-copy, exactly the reference's unordered-slice semantics
// (src/table.rs:252-258). The view's base is the pinned sa array.
PyObject* Bounds_positions(PyObject* self_obj, PyObject* query) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const uint8_t* q;
  uint32_t qlen;
  PyObject* owner;
  if (!query_view(query, &q, &qlen, &owner)) return nullptr;
  uint32_t start, count;
  stpu::bounds_core(self->text_p, self->n, self->sa_p, q, qlen, &start,
                    &count);
  Py_XDECREF(owner);
  npy_intp dims[1] = {static_cast<npy_intp>(count)};
  PyObject* view = PyArray_New(
      &PyArray_Type, 1, dims, NPY_UINT32, nullptr,
      const_cast<uint32_t*>(self->sa_p + start), 0, NPY_ARRAY_CARRAY_RO,
      nullptr);
  if (!view) return nullptr;
  Py_INCREF(self->sa_obj);
  if (PyArray_SetBaseObject(reinterpret_cast<PyArrayObject*>(view),
                            self->sa_obj) < 0) {
    Py_DECREF(view);
    return nullptr;
  }
  return view;
}

// contains(query: bytes) -> bool — early-exit search (reference shape:
// any_position().is_some(), src/table.rs:197-199).
PyObject* Bounds_contains(PyObject* self_obj, PyObject* query) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const uint8_t* q;
  uint32_t qlen;
  PyObject* owner;
  if (!query_view(query, &q, &qlen, &owner)) return nullptr;
  const bool hit =
      stpu::contains_core(self->text_p, self->n, self->sa_p, q, qlen);
  Py_XDECREF(owner);
  if (hit) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

// count(query: bytes) -> int
PyObject* Bounds_count(PyObject* self_obj, PyObject* query) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const uint8_t* q;
  uint32_t qlen;
  PyObject* owner;
  if (!query_view(query, &q, &qlen, &owner)) return nullptr;
  uint32_t start, count;
  stpu::bounds_core(self->text_p, self->n, self->sa_p, q, qlen, &start,
                    &count);
  Py_XDECREF(owner);
  return PyLong_FromUnsignedLong(count);
}

// any_position(query: bytes) -> int | None  (reference src/table.rs:279-293:
// *some* matching byte offset; this route returns table[start], matching
// the batch path so the two routes stay bit-identical).
PyObject* Bounds_any_position(PyObject* self_obj, PyObject* query) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const uint8_t* q;
  uint32_t qlen;
  PyObject* owner;
  if (!query_view(query, &q, &qlen, &owner)) return nullptr;
  uint32_t start, count;
  stpu::bounds_core(self->text_p, self->n, self->sa_p, q, qlen, &start,
                    &count);
  Py_XDECREF(owner);
  if (count == 0) Py_RETURN_NONE;
  return PyLong_FromUnsignedLong(self->sa_p[start]);
}

// bench(query: bytes, iters: int) -> ns per call, pure C loop.
// The C-only floor: no interpreter, no marshalling — comparable to the
// reference's in-process nightly #[bench] loop.
PyObject* Bounds_bench(PyObject* self_obj, PyObject* args) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const char* qc;
  Py_ssize_t qlen;
  long iters;
  if (!PyArg_ParseTuple(args, "y#l", &qc, &qlen, &iters)) return nullptr;
  if (iters <= 0) {
    PyErr_SetString(PyExc_ValueError, "iters must be positive");
    return nullptr;
  }
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qc);
  uint32_t start = 0, count = 0;
  uint64_t sink = 0;
  struct timespec t0, t1;
  Py_BEGIN_ALLOW_THREADS
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (long i = 0; i < iters; i++) {
    stpu::bounds_core(self->text_p, self->n, self->sa_p, q,
                      static_cast<uint32_t>(qlen), &start, &count);
    sink += start + count;  // keep the loop body observable
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  Py_END_ALLOW_THREADS
  double ns = (t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec);
  // Fold the sink into an unobservable-but-live value so the compiler
  // cannot delete the loop.
  if (sink == UINT64_MAX) ns += 1e-9;
  return PyFloat_FromDouble(ns / iters);
}

// bench_contains(query: bytes, iters: int) -> ns per early-exit
// contains_core call, pure C loop.
PyObject* Bounds_bench_contains(PyObject* self_obj, PyObject* args) {
  BoundsObject* self = reinterpret_cast<BoundsObject*>(self_obj);
  const char* qc;
  Py_ssize_t qlen;
  long iters;
  if (!PyArg_ParseTuple(args, "y#l", &qc, &qlen, &iters)) return nullptr;
  if (iters <= 0) {
    PyErr_SetString(PyExc_ValueError, "iters must be positive");
    return nullptr;
  }
  const uint8_t* q = reinterpret_cast<const uint8_t*>(qc);
  uint64_t sink = 0;
  struct timespec t0, t1;
  Py_BEGIN_ALLOW_THREADS
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (long i = 0; i < iters; i++) {
    sink += stpu::contains_core(self->text_p, self->n, self->sa_p, q,
                                static_cast<uint32_t>(qlen));
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  Py_END_ALLOW_THREADS
  double ns = (t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec);
  if (sink == UINT64_MAX) ns += 1e-9;
  return PyFloat_FromDouble(ns / iters);
}

PyMethodDef Bounds_methods[] = {
    {"bounds", Bounds_bounds, METH_O,
     "bounds(query: bytes) -> (start, count) rank bounds"},
    {"positions", Bounds_positions, METH_O,
     "positions(query: bytes) -> uint32 view of sa[start:start+count]"},
    {"contains", Bounds_contains, METH_O,
     "contains(query: bytes) -> bool"},
    {"count", Bounds_count, METH_O, "count(query: bytes) -> int"},
    {"any_position", Bounds_any_position, METH_O,
     "any_position(query: bytes) -> int | None"},
    {"bench", Bounds_bench, METH_VARARGS,
     "bench(query: bytes, iters: int) -> pure-C ns per bounds call"},
    {"bench_contains", Bounds_bench_contains, METH_VARARGS,
     "bench_contains(query: bytes, iters: int) -> pure-C ns per contains"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject BoundsType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// sais(text: bytes) -> uint32 ndarray suffix array. The small-build
// serving path: the ctypes route pays ~8 us of marshalling on an 11-byte
// build (vs the reference's 1,038 ns sais_small, README.md:116); this is
// one C call + one ndarray allocation.
PyObject* module_sais(PyObject*, PyObject* text_obj) {
  const uint8_t* t;
  uint32_t n;
  if (!query_bytes(text_obj, &t, &n)) return nullptr;
  npy_intp dims[1] = {static_cast<npy_intp>(n)};
  PyObject* out = PyArray_SimpleNew(1, dims, NPY_UINT32);
  if (!out) return nullptr;
  stpu::sais_u8(
      t, n,
      static_cast<uint32_t*>(
          PyArray_DATA(reinterpret_cast<PyArrayObject*>(out))));
  return out;
}

// sais_bench(text: bytes, iters: int) -> pure-C ns per full SA-IS build,
// the C-only floor against the reference's sais_small/sais_dna benches.
PyObject* module_sais_bench(PyObject*, PyObject* args) {
  const char* tc;
  Py_ssize_t tlen;
  long iters;
  if (!PyArg_ParseTuple(args, "y#l", &tc, &tlen, &iters)) return nullptr;
  if (iters <= 0) {
    PyErr_SetString(PyExc_ValueError, "iters must be positive");
    return nullptr;
  }
  const uint8_t* t = reinterpret_cast<const uint8_t*>(tc);
  uint32_t n = static_cast<uint32_t>(tlen);
  std::vector<uint32_t> out(n ? n : 1);
  uint64_t sink = 0;
  struct timespec t0, t1;
  Py_BEGIN_ALLOW_THREADS
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (long i = 0; i < iters; i++) {
    stpu::sais_u8(t, n, out.data());
    sink += out[0];
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  Py_END_ALLOW_THREADS
  double ns = (t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec);
  if (sink == UINT64_MAX) ns += 1e-9;
  return PyFloat_FromDouble(ns / iters);
}

// naive(text: bytes) -> uint32 suffix array via the reference-shaped
// O(n^2 log n) oracle (sort of suffix offsets, full slice compares) —
// a second, independent native oracle.
PyObject* module_naive(PyObject*, PyObject* text_obj) {
  const uint8_t* t;
  uint32_t n;
  if (!query_bytes(text_obj, &t, &n)) return nullptr;
  npy_intp dims[1] = {static_cast<npy_intp>(n)};
  PyObject* out = PyArray_SimpleNew(1, dims, NPY_UINT32);
  if (!out) return nullptr;
  stpu::naive_u8(
      t, n,
      static_cast<uint32_t*>(
          PyArray_DATA(reinterpret_cast<PyArrayObject*>(out))));
  return out;
}

// naive_bench(text: bytes, iters: int) -> pure-C ns per naive build.
PyObject* module_naive_bench(PyObject*, PyObject* args) {
  const char* tc;
  Py_ssize_t tlen;
  long iters;
  if (!PyArg_ParseTuple(args, "y#l", &tc, &tlen, &iters)) return nullptr;
  if (iters <= 0) {
    PyErr_SetString(PyExc_ValueError, "iters must be positive");
    return nullptr;
  }
  const uint8_t* t = reinterpret_cast<const uint8_t*>(tc);
  uint32_t n = static_cast<uint32_t>(tlen);
  std::vector<uint32_t> out(n ? n : 1);
  uint64_t sink = 0;
  struct timespec t0, t1;
  Py_BEGIN_ALLOW_THREADS
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (long i = 0; i < iters; i++) {
    stpu::naive_u8(t, n, out.data());
    sink += out[0];
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  Py_END_ALLOW_THREADS
  double ns = (t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec);
  if (sink == UINT64_MAX) ns += 1e-9;
  return PyFloat_FromDouble(ns / iters);
}

PyMethodDef module_methods[] = {
    {"sais", module_sais, METH_O,
     "sais(text: bytes) -> uint32 suffix array (native SA-IS, one call)"},
    {"sais_bench", module_sais_bench, METH_VARARGS,
     "sais_bench(text: bytes, iters: int) -> pure-C ns per build"},
    {"naive", module_naive, METH_O,
     "naive(text: bytes) -> uint32 suffix array (O(n^2 log n) oracle)"},
    {"naive_bench", module_naive_bench, METH_VARARGS,
     "naive_bench(text: bytes, iters: int) -> pure-C ns per naive build"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef fastpath_module = {
    PyModuleDef_HEAD_INIT, "_fastpath",
    "Single-query suffix-array bounds: direct C method, no ctypes.",
    -1, module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastpath(void) {
  import_array();  // numpy C API (result views)
  BoundsType.tp_name = "_fastpath.Bounds";
  BoundsType.tp_basicsize = sizeof(BoundsObject);
  BoundsType.tp_flags = Py_TPFLAGS_DEFAULT;
  BoundsType.tp_doc = "Pinned (text, sa) pair answering single queries";
  BoundsType.tp_new = PyType_GenericNew;
  BoundsType.tp_init = Bounds_init;
  BoundsType.tp_dealloc = Bounds_dealloc;
  BoundsType.tp_methods = Bounds_methods;
  if (PyType_Ready(&BoundsType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&fastpath_module);
  if (!m) return nullptr;
  Py_INCREF(&BoundsType);
  if (PyModule_AddObject(m, "Bounds",
                         reinterpret_cast<PyObject*>(&BoundsType)) < 0) {
    Py_DECREF(&BoundsType);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
