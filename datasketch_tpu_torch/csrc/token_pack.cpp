// Token pack for kernel 9 (csrc/sha1.cu): a chunk's bytes tokens written
// back to back into one byte buffer, with their int32 byte offsets.
//
// The host no longer hashes the tokens of a sha1_hash32 chunk: it copies
// them, and kernel 9 hashes them on the card, reading this buffer in
// place through its mapped device pointer. The copy is the part of the
// work the host cannot hand over (the tokens are Python objects scattered
// over the heap), paced by the cache misses on the token objects: the
// header and payload lines of the token kPrefetch places ahead are
// prefetched while this one is copied. A token of at most 16 bytes whose
// payload does not cross a page is copied as one 16-byte load and store
// (the bytes past its end land where the next token goes, or past the
// last offset, where nothing reads them); any other token by memcpy.
//
// A fresh pack of lists or tuples of bytes tokens that all fit is split
// over kParts threads of a fixed pool, by documents, in two passes
// (lengths, then ends and payloads; split_pack); anything else (a resumed
// pack, a buffer too small, other token types, fewer than kSplitTokens
// tokens) is one walk on the caller's thread. One chunk of the sign-16k
// cell (8,192 docs x 200 ten-byte tokens from 30,000 words) packs in a
// median 8.7 ms split against 24.4 ms on one thread (the H100 machine's
// 8-core host, 12 chunks each). Built with g++ by datasketch_tpu_torch/
// native.py into the git-ignored build directory (module _token_pack).
//
// pack(docs, doc, tok, data, offsets) -> (doc, tok, tokens, bytes, rest)
//
//   docs     sequence of documents, each a sequence of tokens: bytes,
//            bytearray, or any object with a contiguous buffer (a numpy
//            scalar packs its native bytes, as hashlib reads it)
//   doc, tok where to resume: token `tok` of document `doc`
//   data     writable C-contiguous byte buffer, fewer than 2**31 bytes
//   offsets  writable C-contiguous int32 buffer; offsets[0] = 0 and
//            offsets[i + 1] is the end of token i in `data`
//
// Tokens are packed in order until the documents end, `data` cannot hold
// the next token, or `offsets` has no room for its end. Returns where the
// pack stopped (the next token's document and index; `doc` == len(docs)
// when every token was packed), the tokens and bytes packed, and `rest`:
// the bytes of the tokens left unpacked (the remaining documents are only
// walked for their lengths), so the caller can size its next buffer.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <unistd.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr Py_ssize_t kPrefetch = 32;  // tokens ahead
constexpr Py_ssize_t kShort = 16;     // bytes of the one-load copy
constexpr int kParts = 4;             // threads of a split pack, the caller's included
constexpr Py_ssize_t kSplitTokens = 1 << 16;  // fewer tokens pack on one thread

// A fixed set of worker threads, made at the first split pack and reused
// by every later one. run(fn) calls fn(1) .. fn(workers) on the workers
// and fn(0) on the caller, and returns when all have returned. The pool
// is never destroyed (joinable threads must not outlive exit's static
// destructors), and a forked child, which has none of its parent's
// threads, makes its own.
class Pool {
 public:
  explicit Pool(int workers) : workers_(workers), pid_(getpid()) {
    for (int i = 1; i <= workers; ++i) std::thread([this, i] { loop(i); }).detach();
  }

  int parts() const { return workers_ + 1; }
  bool ours() const { return pid_ == getpid(); }

  void run(const std::function<void(int)>& fn) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      job_ = &fn;
      pending_ = workers_;
      ++generation_;
    }
    start_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lock(mu_);
    done_.wait(lock, [this] { return pending_ == 0; });
  }

 private:
  void loop(int id) {
    unsigned long long seen = 0;
    for (;;) {
      const std::function<void(int)>* job;
      {
        std::unique_lock<std::mutex> lock(mu_);
        start_.wait(lock, [&] { return generation_ != seen; });
        seen = generation_;
        job = job_;
      }
      (*job)(id);
      std::lock_guard<std::mutex> lock(mu_);
      if (--pending_ == 0) done_.notify_one();
    }
  }

  const int workers_;
  const pid_t pid_;
  std::mutex mu_;
  std::condition_variable start_, done_;
  const std::function<void(int)>* job_ = nullptr;
  int pending_ = 0;
  unsigned long long generation_ = 0;
};

Pool* pool() {  // called with the GIL held, so never twice at once
  static Pool* p = nullptr;
  if (p == nullptr || !p->ours()) {
    const unsigned hw = std::thread::hardware_concurrency();
    p = hw > 1 ? new Pool(static_cast<int>(std::min<unsigned>(kParts, hw)) - 1) : nullptr;
  }
  return p;
}

// Pointer and length of a token's bytes. A buffer-protocol token fills
// `view`, which the caller releases; returns false (with a TypeError set)
// for anything else.
bool token_bytes(PyObject* tok, Py_ssize_t index, const char** ptr,
                 Py_ssize_t* len, Py_buffer* view, bool* has_view) {
  *has_view = false;
  if (PyBytes_Check(tok)) {
    *ptr = PyBytes_AS_STRING(tok);
    *len = PyBytes_GET_SIZE(tok);
    return true;
  }
  if (PyByteArray_Check(tok)) {
    *ptr = PyByteArray_AS_STRING(tok);
    *len = PyByteArray_GET_SIZE(tok);
    return true;
  }
  if (PyObject_GetBuffer(tok, view, PyBUF_SIMPLE) == 0) {
    *has_view = true;
    *ptr = static_cast<const char*>(view->buf);
    *len = view->len;
    return true;
  }
  PyErr_Format(PyExc_TypeError,
               "token %zd is %.80s, expected bytes/bytearray/buffer", index,
               Py_TYPE(tok)->tp_name);
  return false;
}

bool writable(PyObject* obj, Py_buffer* view, Py_ssize_t itemsize,
              const char* what) {
  if (PyObject_GetBuffer(obj, view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
    return false;
  if (view->itemsize != itemsize) {
    PyErr_Format(PyExc_ValueError, "%s must have %zd-byte items", what,
                 itemsize);
    PyBuffer_Release(view);
    return false;
  }
  return true;
}

// The common case split over the pool: a fresh pack (from the first
// token) of documents that are lists or tuples of bytes (or bytearray)
// tokens, all of which fit. The caller keeps the GIL throughout, so no
// other Python thread can touch the documents while the workers read
// them, and the workers call no Python API: they only read the objects'
// fields. Pass 1 writes each token's length where its end offset goes and
// sums each part's bytes; pass 2 turns the lengths into ends and copies
// the payloads, each part from its own byte base, the one-load copy kept
// inside the part. Returns the tokens packed, or -1 where the case does
// not hold (nothing was written that the sequential pack does not
// overwrite).
Py_ssize_t split_pack(PyObject** doc_items, Py_ssize_t n_docs, char* out, Py_ssize_t cap,
                      int32_t* off, Py_ssize_t max_tokens, Py_ssize_t* used) {
  std::vector<Py_ssize_t> first(n_docs + 1);  // each document's first token
  first[0] = 0;
  for (Py_ssize_t d = 0; d < n_docs; d++) {
    PyObject* doc = doc_items[d];
    if (!PyList_CheckExact(doc) && !PyTuple_CheckExact(doc)) return -1;
    first[d + 1] = first[d] + Py_SIZE(doc);
  }
  const Py_ssize_t total = first[n_docs];
  if (total < kSplitTokens || total > max_tokens) return -1;
  Pool* workers = pool();
  if (workers == nullptr) return -1;
  const int parts = workers->parts();
  Py_ssize_t doc_lo[kParts + 1], part_bytes[kParts], base[kParts + 1];
  bool foreign[kParts];
  for (int p = 0; p <= parts; p++)  // parts of about equal token counts
    doc_lo[p] = std::lower_bound(first.begin(), first.end(), total * p / parts) - first.begin();
  doc_lo[parts] = n_docs;

  auto items = [&](Py_ssize_t d) {
    PyObject* doc = doc_items[d];
    return PyList_CheckExact(doc) ? reinterpret_cast<PyListObject*>(doc)->ob_item
                                  : reinterpret_cast<PyTupleObject*>(doc)->ob_item;
  };
  auto payload = [](PyObject* tok, const char** ptr) {
    if (PyBytes_Check(tok)) {
      *ptr = PyBytes_AS_STRING(tok);
      return PyBytes_GET_SIZE(tok);
    }
    *ptr = PyByteArray_AS_STRING(tok);
    return PyByteArray_GET_SIZE(tok);
  };

  workers->run([&](int p) {  // pass 1: lengths
    Py_ssize_t sum = 0;
    foreign[p] = false;
    for (Py_ssize_t d = doc_lo[p]; d < doc_lo[p + 1]; d++) {
      PyObject** toks = items(d);
      const Py_ssize_t m = first[d + 1] - first[d];
      int32_t* lens = off + first[d] + 1;
      for (Py_ssize_t t = 0; t < m; t++) {
        if (t + kPrefetch < m) __builtin_prefetch(toks[t + kPrefetch], 0, 3);
        PyObject* tok = toks[t];
        if (!PyBytes_Check(tok) && !PyByteArray_CheckExact(tok)) {
          foreign[p] = true;
          return;
        }
        const Py_ssize_t len = Py_SIZE(tok);
        sum += len;
        lens[t] = static_cast<int32_t>(std::min<Py_ssize_t>(len, INT32_MAX));
      }
    }
    part_bytes[p] = sum;
  });
  base[0] = 0;
  for (int p = 0; p < parts; p++) {
    if (foreign[p]) return -1;
    base[p + 1] = base[p] + part_bytes[p];
  }
  if (base[parts] > cap) return -1;

  workers->run([&](int p) {  // pass 2: ends and payloads
    Py_ssize_t pos = base[p];
    const Py_ssize_t end = base[p + 1];
    for (Py_ssize_t d = doc_lo[p]; d < doc_lo[p + 1]; d++) {
      PyObject** toks = items(d);
      const Py_ssize_t m = first[d + 1] - first[d];
      int32_t* ends = off + first[d] + 1;
      for (Py_ssize_t t = 0; t < m; t++) {
        if (t + kPrefetch < m) {
          const char* ahead = reinterpret_cast<const char*>(toks[t + kPrefetch]);
          __builtin_prefetch(ahead, 0, 3);
          __builtin_prefetch(ahead + 40, 0, 3);
        }
        const char* ptr;
        const Py_ssize_t len = payload(toks[t], &ptr);
        if (len <= kShort && kShort <= end - pos &&
            (reinterpret_cast<uintptr_t>(ptr) & 4095) <= 4096 - kShort)
          __builtin_memcpy(out + pos, ptr, kShort);
        else
          std::memcpy(out + pos, ptr, static_cast<size_t>(len));
        pos += len;
        ends[t] = static_cast<int32_t>(pos);
      }
    }
  });
  off[0] = 0;
  *used = base[parts];
  return total;
}

PyObject* pack(PyObject*, PyObject* args) {
  PyObject* docs;
  Py_ssize_t doc0, tok0;
  PyObject* data_obj;
  PyObject* offs_obj;
  if (!PyArg_ParseTuple(args, "OnnOO", &docs, &doc0, &tok0, &data_obj,
                        &offs_obj))
    return nullptr;
  PyObject* fast = PySequence_Fast(docs, "expected a sequence of documents");
  if (!fast) return nullptr;
  Py_buffer data, offs;
  if (!writable(data_obj, &data, 1, "data")) {
    Py_DECREF(fast);
    return nullptr;
  }
  if (!writable(offs_obj, &offs, 4, "offsets")) {
    PyBuffer_Release(&data);
    Py_DECREF(fast);
    return nullptr;
  }
  const Py_ssize_t n_docs = PySequence_Fast_GET_SIZE(fast);
  PyObject** doc_items = PySequence_Fast_ITEMS(fast);
  char* out = static_cast<char*>(data.buf);
  int32_t* off = static_cast<int32_t*>(offs.buf);
  const Py_ssize_t cap = data.len;
  const Py_ssize_t max_tokens = offs.len / 4 - 1;
  PyObject* result = nullptr;
  Py_ssize_t pos = 0, n = 0, rest = 0;
  Py_ssize_t stop_doc = n_docs, stop_tok = 0;
  bool full = false;

  if (cap > INT32_MAX || max_tokens < 0 || doc0 < 0 || tok0 < 0 ||
      doc0 > n_docs) {
    PyErr_SetString(PyExc_ValueError,
                    "pack: data must hold < 2**31 bytes, offsets at least one "
                    "entry, and the resume position must lie in docs");
    goto done;
  }
  if (doc0 == 0 && tok0 == 0) {
    n = split_pack(doc_items, n_docs, out, cap, off, max_tokens, &pos);
    if (n >= 0) {
      result = Py_BuildValue("(nnnnn)", n_docs, Py_ssize_t(0), n, pos, Py_ssize_t(0));
      goto done;
    }
    n = 0;
    pos = 0;
  }
  off[0] = 0;
  for (Py_ssize_t d = doc0; d < n_docs; d++) {
    PyObject* doc = PySequence_Fast(doc_items[d],
                                    "expected a sequence of bytes tokens");
    if (!doc) goto done;
    const Py_ssize_t m = PySequence_Fast_GET_SIZE(doc);
    PyObject** toks = PySequence_Fast_ITEMS(doc);
    for (Py_ssize_t t = (d == doc0 ? tok0 : 0); t < m; t++) {
      if (t + kPrefetch < m) {  // a bytes object's payload follows its header
        const char* ahead = reinterpret_cast<const char*>(toks[t + kPrefetch]);
        __builtin_prefetch(ahead, 0, 3);
        __builtin_prefetch(ahead + 40, 0, 3);
      }
      const char* ptr;
      Py_ssize_t len;
      Py_buffer view;
      bool has_view;
      if (!token_bytes(toks[t], t, &ptr, &len, &view, &has_view)) {
        Py_DECREF(doc);
        goto done;
      }
      if (!full && (n == max_tokens || len > cap - pos)) {
        full = true;
        stop_doc = d;
        stop_tok = t;
      }
      if (full) {
        rest += len;
      } else {
        if (len <= kShort && kShort <= cap - pos &&
            (reinterpret_cast<uintptr_t>(ptr) & 4095) <= 4096 - kShort)
          __builtin_memcpy(out + pos, ptr, kShort);
        else
          std::memcpy(out + pos, ptr, static_cast<size_t>(len));
        pos += len;
        off[++n] = static_cast<int32_t>(pos);
      }
      if (has_view) PyBuffer_Release(&view);
    }
    Py_DECREF(doc);
  }
  result = Py_BuildValue("(nnnnn)", stop_doc, stop_tok, n, pos, rest);

done:
  PyBuffer_Release(&offs);
  PyBuffer_Release(&data);
  Py_DECREF(fast);
  return result;
}

PyMethodDef methods[] = {
    {"pack", pack, METH_VARARGS,
     "pack(docs, doc, tok, data, offsets) -> (doc, tok, tokens, bytes, rest)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_token_pack",
                         "Bytes tokens packed for the card's SHA1 kernel.", -1,
                         methods};

}  // namespace

PyMODINIT_FUNC PyInit__token_pack(void) { return PyModule_Create(&moduledef); }
