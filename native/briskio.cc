// briskio — native IO runtime for ethzasl_brisk_jax.
//
// The reference's runtime is C++ (pgm IO: brisk/src/brisk-opencv.cc:67+;
// golden-set serialization: brisk/src/test/serialization.{h,cc}); this is
// the JAX framework's native counterpart: a CPython extension providing
//   * read_pgm(path) -> (height, width, bytes)        [8-bit binary P5/P2]
//   * write_pgm(path, height, width, bytes)
//   * read_batch(paths, n_threads) -> list[(h, w, bytes)]
//     — multithreaded sequence loader feeding the device pipeline
//   * read_set(path) -> list of entries (the reference .set layout)
// Python-side wrappers (core/image_io.py, core/golden.py) prefer this
// module and fall back to the pure-Python implementations.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> data;
  bool ok = false;
  std::string err;
};

// Minimal netpbm tokenizer (comments + whitespace).
bool NextToken(const std::vector<uint8_t>& buf, size_t* pos,
               std::string* tok) {
  size_t p = *pos;
  while (p < buf.size()) {
    if (buf[p] == '#') {
      while (p < buf.size() && buf[p] != '\n') ++p;
    } else if (isspace(buf[p])) {
      ++p;
    } else {
      break;
    }
  }
  size_t start = p;
  while (p < buf.size() && !isspace(buf[p])) ++p;
  *tok = std::string(buf.begin() + start, buf.begin() + p);
  *pos = p;
  return !tok->empty();
}

Image LoadPgm(const std::string& path) {
  Image img;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    img.err = "cannot open " + path;
    return img;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    img.err = "short read " + path;
    return img;
  }
  fclose(f);

  size_t pos = 0;
  std::string tok;
  if (!NextToken(buf, &pos, &tok) || (tok != "P5" && tok != "P2")) {
    img.err = "not a PGM: " + path;
    return img;
  }
  bool binary = tok == "P5";
  std::string sw, sh, sm;
  if (!NextToken(buf, &pos, &sw) || !NextToken(buf, &pos, &sh) ||
      !NextToken(buf, &pos, &sm)) {
    img.err = "bad header: " + path;
    return img;
  }
  img.w = atoi(sw.c_str());
  img.h = atoi(sh.c_str());
  int maxval = atoi(sm.c_str());
  if (img.w <= 0 || img.h <= 0 || maxval <= 0 || maxval > 255) {
    img.err = "unsupported PGM (8-bit only): " + path;
    return img;
  }
  size_t n = static_cast<size_t>(img.w) * img.h;
  img.data.resize(n);
  if (binary) {
    pos += 1;  // single whitespace after maxval
    if (pos + n > buf.size()) {
      img.err = "truncated raster: " + path;
      return img;
    }
    memcpy(img.data.data(), buf.data() + pos, n);
  } else {
    for (size_t i = 0; i < n; ++i) {
      if (!NextToken(buf, &pos, &tok)) {
        img.err = "truncated ascii raster: " + path;
        return img;
      }
      img.data[i] = static_cast<uint8_t>(atoi(tok.c_str()));
    }
  }
  img.ok = true;
  return img;
}

PyObject* ImageToTuple(const Image& img) {
  if (!img.ok) {
    PyErr_SetString(PyExc_IOError, img.err.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.data.data()), img.data.size());
  if (!bytes) return nullptr;
  return Py_BuildValue("(iiN)", img.h, img.w, bytes);
}

PyObject* ReadPgm(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  Image img;
  Py_BEGIN_ALLOW_THREADS
  img = LoadPgm(path);
  Py_END_ALLOW_THREADS
  return ImageToTuple(img);
}

PyObject* WritePgm(PyObject*, PyObject* args) {
  const char* path;
  int h, w;
  Py_buffer data;
  if (!PyArg_ParseTuple(args, "siiy*", &path, &h, &w, &data))
    return nullptr;
  if (static_cast<Py_ssize_t>(h) * w != data.len) {
    PyBuffer_Release(&data);
    PyErr_SetString(PyExc_ValueError, "h*w != len(data)");
    return nullptr;
  }
  bool ok = false;
  Py_BEGIN_ALLOW_THREADS {
    FILE* f = fopen(path, "wb");
    if (f) {
      fprintf(f, "P5\n%d %d\n255\n", w, h);
      ok = fwrite(data.buf, 1, data.len, f) ==
           static_cast<size_t>(data.len);
      fclose(f);
    }
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&data);
  if (!ok) {
    PyErr_SetString(PyExc_IOError, "write failed");
    return nullptr;
  }
  Py_RETURN_NONE;
}

// Multithreaded batch loader: the native data-loading stage of the frame
// pipeline (host side of the host->device pipe).
PyObject* ReadBatch(PyObject*, PyObject* args) {
  PyObject* list;
  int n_threads = 8;
  if (!PyArg_ParseTuple(args, "O|i", &list, &n_threads)) return nullptr;
  if (!PySequence_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "expected a sequence of paths");
    return nullptr;
  }
  Py_ssize_t n = PySequence_Size(list);
  std::vector<std::string> paths(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_GetItem(list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) {
      Py_XDECREF(item);
      return nullptr;
    }
    paths[i] = s;
    Py_DECREF(item);
  }
  std::vector<Image> images(n);
  Py_BEGIN_ALLOW_THREADS {
    int workers = std::max(1, std::min<int>(n_threads, n));
    std::vector<std::thread> threads;
    std::atomic<Py_ssize_t>* counter = new std::atomic<Py_ssize_t>(0);
    for (int t = 0; t < workers; ++t) {
      threads.emplace_back([&images, &paths, counter, n]() {
        while (true) {
          Py_ssize_t i = counter->fetch_add(1);
          if (i >= n) break;
          images[i] = LoadPgm(paths[i]);
        }
      });
    }
    for (auto& th : threads) th.join();
    delete counter;
  }
  Py_END_ALLOW_THREADS
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* t = ImageToTuple(images[i]);
    if (!t) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, t);
  }
  return out;
}

PyMethodDef Methods[] = {
    {"read_pgm", ReadPgm, METH_VARARGS,
     "read_pgm(path) -> (h, w, bytes)"},
    {"write_pgm", WritePgm, METH_VARARGS,
     "write_pgm(path, h, w, bytes)"},
    {"read_batch", ReadBatch, METH_VARARGS,
     "read_batch(paths, n_threads=8) -> list[(h, w, bytes)]"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef Module = {
    PyModuleDef_HEAD_INIT, "briskio",
    "Native IO runtime for ethzasl_brisk_jax", -1, Methods,
};

}  // namespace

PyMODINIT_FUNC PyInit_briskio(void) { return PyModule_Create(&Module); }
