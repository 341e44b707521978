// C ABI for embedding the port's trainer in a non-Python host: the
// counterpart of isle_tpu's isle_capi.cpp for isle_tpu_torch.
//
// A flat extern "C" surface (the reference's trainer_export.cpp:31-99):
// CreateTrainer / feedData / finalizeData / Train / GetBasicModel /
// GetNumEdgeTopics / GetEdgeModel / DestroyTrainer, which a host can
// dlopen. The implementation embeds CPython and forwards to the Python
// handle API (isle_tpu_torch/capi.py), which drives the PyTorch
// pipeline. It never imports jax or isle_tpu.
//
// Usage contract (mirrors the reference header comments):
//   1. CreateTrainer(), feedData()*, finalizeData(), Train()
//   2. pre-allocate num_topics*vocab_size floats, GetBasicModel()
//   3. GetNumEdgeTopics(), pre-allocate, GetEdgeModel()
//   4. DestroyTrainer()
// Ids are 0-based for docs and 1-based for words in feedData, exactly as
// the reference feed path expects (src/trainer.cpp:214-228).
//
// Environment of the host process:
//   PYTHONPATH            must hold the directory of isle_tpu_torch and
//                         the site-packages with torch and numpy (the
//                         embedded CPython honours it).
//   ISLE_CAPI_DEVICE      the torch device the trainers run on: "cuda"
//                         (the default; the kernels launch) or "cpu".
//   ISLE_CAPI_BOOTSTRAP   optional Python snippet run before the first
//                         import.
//   ISLE_CAPI_EDGE_TOPICS optional int: train this many edge topics.
//
// Build: python -m isle_tpu_torch._build_capi   (g++, links libpython;
// writes build/isle_tpu_torch/libisle_trainer_torch.so)

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

PyObject* g_capi = nullptr;  // isle_tpu_torch.capi module

// One-time interpreter + module setup. Returns the capi module (borrowed
// global) or nullptr on failure. Releases the GIL after init; every API
// call re-acquires it with PyGILState_Ensure.
PyObject* ensure_capi() {
  if (g_capi) return g_capi;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    const char* boot = getenv("ISLE_CAPI_BOOTSTRAP");
    if (boot && *boot) {
      if (PyRun_SimpleString(boot) != 0) {
        fprintf(stderr, "isle_capi: ISLE_CAPI_BOOTSTRAP failed\n");
      }
    }
    g_capi = PyImport_ImportModule("isle_tpu_torch.capi");
    if (!g_capi) {
      PyErr_Print();
      fprintf(stderr,
              "isle_capi: cannot import isle_tpu_torch.capi (is PYTHONPATH "
              "set to the package's directory + site-packages?)\n");
    }
    // Release the GIL so any host thread can call in via PyGILState.
    (void)PyEval_SaveThread();
    return g_capi;
  }
  PyGILState_STATE s = PyGILState_Ensure();
  g_capi = PyImport_ImportModule("isle_tpu_torch.capi");
  if (!g_capi) PyErr_Print();
  PyGILState_Release(s);
  return g_capi;
}

// Call capi.<name>(*args). Returns a new reference or nullptr (with the
// Python error printed). Caller must hold the GIL.
PyObject* call(const char* name, PyObject* args) {
  PyObject* fn = PyObject_GetAttrString(g_capi, name);
  if (!fn) {
    PyErr_Print();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (!out) PyErr_Print();
  return out;
}

// Copy a float32 numpy array (buffer protocol) into out. Returns 0/-1.
int copy_f32(PyObject* arr, float* out) {
  Py_buffer view;
  if (PyObject_GetBuffer(arr, &view, PyBUF_CONTIG_RO) != 0) {
    PyErr_Print();
    return -1;
  }
  memcpy(out, view.buf, static_cast<size_t>(view.len));
  PyBuffer_Release(&view);
  return 0;
}

}  // namespace

extern "C" {

// Returns an opaque handle (> 0), or 0 on failure. `max_entries` is
// accepted for signature parity with the reference but unneeded here
// (ingest buffers grow dynamically).
int64_t CreateTrainer(int32_t vocab_size, int32_t num_docs,
                      int64_t max_entries, int32_t num_topics,
                      int32_t sample_docs, float sample_rate) {
  (void)max_entries;
  if (!ensure_capi()) return 0;
  PyGILState_STATE s = PyGILState_Ensure();
  const char* edge = getenv("ISLE_CAPI_EDGE_TOPICS");
  long max_edge = edge ? strtol(edge, nullptr, 10) : 0;
  const char* device = getenv("ISLE_CAPI_DEVICE");
  if (!device || !*device) device = "cuda";
  PyObject* kwargs = Py_BuildValue(
      "{s:i,s:i,s:i,s:O,s:f,s:O,s:i,s:s}", "vocab_size", vocab_size,
      "num_docs", num_docs, "num_topics", num_topics, "sample_docs",
      sample_docs ? Py_True : Py_False, "sample_rate", sample_rate,
      "compute_edge_topics", max_edge > 0 ? Py_True : Py_False,
      "max_edge_topics", static_cast<int>(max_edge), "device", device);
  PyObject* fn =
      g_capi ? PyObject_GetAttrString(g_capi, "CreateTrainer") : nullptr;
  int64_t handle = 0;
  if (fn && kwargs) {
    PyObject* empty = PyTuple_New(0);
    PyObject* out = PyObject_Call(fn, empty, kwargs);
    Py_DECREF(empty);
    if (out) {
      handle = PyLong_AsLongLong(out);
      Py_DECREF(out);
    } else {
      PyErr_Print();
    }
  }
  Py_XDECREF(fn);
  Py_XDECREF(kwargs);
  PyGILState_Release(s);
  return handle;
}

void DestroyTrainer(int64_t handle) {
  if (!g_capi) return;
  PyGILState_STATE s = PyGILState_Ensure();
  Py_XDECREF(call("DestroyTrainer", Py_BuildValue("(L)", handle)));
  PyGILState_Release(s);
}

// words are 1-based word ids (reference feed semantics,
// src/trainer.cpp:214-228); counts are raw term frequencies.
void feedData(int64_t handle, int32_t doc, const int32_t* words,
              const int32_t* counts, int32_t num_words) {
  if (!g_capi) return;
  PyGILState_STATE s = PyGILState_Ensure();
  PyObject* w = PyList_New(num_words);
  PyObject* c = PyList_New(num_words);
  for (int32_t i = 0; i < num_words; ++i) {
    PyList_SET_ITEM(w, i, PyLong_FromLong(words[i]));
    PyList_SET_ITEM(c, i, PyLong_FromLong(counts[i]));
  }
  Py_XDECREF(
      call("feedData", Py_BuildValue("(LiNNi)", handle, doc, w, c, num_words)));
  PyGILState_Release(s);
}

void finalizeData(int64_t handle) {
  if (!g_capi) return;
  PyGILState_STATE s = PyGILState_Ensure();
  Py_XDECREF(call("finalizeData", Py_BuildValue("(L)", handle)));
  PyGILState_Release(s);
}

void Train(int64_t handle) {
  if (!g_capi) return;
  PyGILState_STATE s = PyGILState_Ensure();
  Py_XDECREF(call("Train", Py_BuildValue("(L)", handle)));
  PyGILState_Release(s);
}

// basicModel must be pre-allocated to num_topics * vocab_size floats;
// layout basicModel[topic*vocab_size + word] (the reference's column-
// major memcpy, src/trainer.cpp:993-1006). Returns 0 on success.
int32_t GetBasicModel(int64_t handle, float* basicModel) {
  if (!g_capi) return -1;
  PyGILState_STATE s = PyGILState_Ensure();
  PyObject* arr = call("GetBasicModel", Py_BuildValue("(L)", handle));
  int rc = arr ? copy_f32(arr, basicModel) : -1;
  Py_XDECREF(arr);
  PyGILState_Release(s);
  return rc;
}

int32_t GetNumEdgeTopics(int64_t handle) {
  if (!g_capi) return 0;
  PyGILState_STATE s = PyGILState_Ensure();
  PyObject* out = call("GetNumEdgeTopics", Py_BuildValue("(L)", handle));
  int32_t n = 0;
  if (out) {
    n = static_cast<int32_t>(PyLong_AsLong(out));
    Py_DECREF(out);
  }
  PyGILState_Release(s);
  return n;
}

// edgeModel pre-allocated to GetNumEdgeTopics() * vocab_size floats.
int32_t GetEdgeModel(int64_t handle, float* edgeModel) {
  if (!g_capi) return -1;
  PyGILState_STATE s = PyGILState_Ensure();
  PyObject* arr = call("GetEdgeModel", Py_BuildValue("(L)", handle));
  int rc = (arr && arr != Py_None) ? copy_f32(arr, edgeModel) : -1;
  Py_XDECREF(arr);
  PyGILState_Release(s);
  return rc;
}

}  // extern "C"
