// searchlite C embedding library.
//
// Implements the 5-function C ABI of the reference's FFI crate
// (`searchlite-ffi/src/lib.rs:20-195`) by embedding CPython and
// delegating to `searchlite.embed` — so a C/C++/Go/anything host
// gets the full engine behind a plain shared library, no Python
// code on the host side.
//
// Interpreter ownership: if the process has no Python runtime yet we
// initialize one (and keep it for the process lifetime); if the host
// already embeds Python we use theirs. Every entry point brackets its
// work in PyGILState_Ensure/Release, so calls are thread-safe and
// work from threads Python has never seen.

#include <Python.h>

#include <mutex>

#include "searchlite.h"

namespace {

std::once_flag g_init_once;
PyObject* g_embed = nullptr;  // searchlite.embed module (owned ref)

void ensure_python() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // Py_InitializeEx leaves this thread holding the GIL; release it
      // so PyGILState_Ensure below works uniformly from any thread.
      PyEval_SaveThread();
    }
  });
}

// Returns a BORROWED reference to the embed module (cached), or
// nullptr with the Python error cleared. Caller must hold the GIL.
PyObject* embed_module() {
  if (g_embed == nullptr) {
    g_embed = PyImport_ImportModule("searchlite.embed");
    if (g_embed == nullptr) PyErr_Clear();
  }
  return g_embed;
}

// Call embed.<fn>(*args); returns a NEW reference or nullptr with the
// error cleared. Caller must hold the GIL and has given us ownership
// of `args` (may be nullptr on allocation failure).
PyObject* call_embed(const char* fn, PyObject* args) {
  PyObject* mod = embed_module();
  if (mod == nullptr || args == nullptr) {
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* callable = PyObject_GetAttrString(mod, fn);
  if (callable == nullptr) {
    PyErr_Clear();
    Py_DECREF(args);
    return nullptr;
  }
  PyObject* result = PyObject_CallObject(callable, args);
  Py_DECREF(callable);
  Py_DECREF(args);
  if (result == nullptr) PyErr_Clear();
  return result;
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

}  // namespace

extern "C" {

searchlite_handle searchlite_index_open(const char* path,
                                        int create_if_missing) {
  if (path == nullptr) return 0;
  ensure_python();
  GilGuard gil;
  PyObject* result = call_embed(
      "searchlite_index_open",
      Py_BuildValue("(si)", path, create_if_missing != 0 ? 1 : 0));
  if (result == nullptr) return 0;
  long long handle = PyLong_AsLongLong(result);
  Py_DECREF(result);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return 0;
  }
  return handle;
}

void searchlite_index_close(searchlite_handle handle) {
  ensure_python();
  GilGuard gil;
  PyObject* result = call_embed("searchlite_index_close",
                                Py_BuildValue("(L)", handle));
  Py_XDECREF(result);
}

int searchlite_add_json(searchlite_handle handle, const char* doc_json) {
  if (doc_json == nullptr) return -1;
  ensure_python();
  GilGuard gil;
  PyObject* result = call_embed("searchlite_add_json",
                                Py_BuildValue("(Ls)", handle, doc_json));
  if (result == nullptr) return -1;
  long code = PyLong_AsLong(result);
  Py_DECREF(result);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return -1;
  }
  return static_cast<int>(code);
}

int searchlite_commit(searchlite_handle handle) {
  ensure_python();
  GilGuard gil;
  PyObject* result =
      call_embed("searchlite_commit", Py_BuildValue("(L)", handle));
  if (result == nullptr) return -1;
  long code = PyLong_AsLong(result);
  Py_DECREF(result);
  if (PyErr_Occurred()) {
    PyErr_Clear();
    return -1;
  }
  return static_cast<int>(code);
}

long long searchlite_search(searchlite_handle handle, const char* query,
                            int limit, const char* cursor,
                            const char* aggs_json, char* out,
                            long long out_cap) {
  if (query == nullptr || out == nullptr || out_cap <= 0) return -1;
  ensure_python();
  GilGuard gil;
  PyObject* py_cursor =
      cursor ? PyUnicode_FromString(cursor) : Py_NewRef(Py_None);
  PyObject* py_aggs =
      aggs_json ? PyUnicode_FromString(aggs_json) : Py_NewRef(Py_None);
  PyObject* result = call_embed(
      "searchlite_search",
      Py_BuildValue("(LsiNN)", handle, query, limit, py_cursor, py_aggs));
  if (result == nullptr) return -1;
  if (result == Py_None) {
    Py_DECREF(result);
    return -1;
  }
  Py_ssize_t size = 0;
  const char* utf8 = PyUnicode_AsUTF8AndSize(result, &size);
  if (utf8 == nullptr) {
    PyErr_Clear();
    Py_DECREF(result);
    return -1;
  }
  long long copy = size < out_cap - 1 ? size : out_cap - 1;
  memcpy(out, utf8, static_cast<size_t>(copy));
  out[copy] = '\0';
  Py_DECREF(result);
  return static_cast<long long>(size);
}

}  // extern "C"
