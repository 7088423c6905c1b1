// C ABI frontend for the zerokit_tpu_torch RLN engine (see native/rln.h).
//
// Counterpart of native/rln_ffi.cpp, the JAX package's shim: the same C
// surface over the same rln.h, routed to zerokit_tpu_torch.ffi_glue. Native
// equivalent of the reference's safer-ffi layer
// (rln/src/ffi/ffi_rln.rs, ffi_rln_v3.rs, ffi_tree.rs). The reference links
// the whole Rust prover into the cdylib; here the prover is the PyTorch +
// CUDA pipeline, so this library embeds the CPython runtime and routes each
// call to zerokit_tpu_torch.ffi_glue over primitive ints/bytes. The shim owns only GIL
// discipline, buffer copies, and error capture; all wire formats and engine
// logic live behind the glue module so the C surface stays byte-exact with
// the Python API.
//
// Works both as a standalone embedding (a C host program) and when loaded
// into an existing Python process (the pytest FFI tests drive it through
// ctypes): Py_IsInitialized() decides whether we own the interpreter.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "rln.h"

namespace {

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

// Acquires the GIL for the scope, initializing the interpreter on first use.
class GilScope {
 public:
  GilScope() {
    static std::once_flag once;
    std::call_once(once, []() {
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        // Release the GIL acquired by initialization so that plain
        // PyGILState_Ensure works from any thread afterwards.
        PyEval_SaveThread();
      }
    });
    state_ = PyGILState_Ensure();
  }
  ~GilScope() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

std::string fetch_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  if (type) {
    PyObject *n = PyObject_GetAttrString(type, "__name__");
    if (n) {
      const char *c = PyUnicode_AsUTF8(n);
      if (c) msg = std::string(c) + ": " + msg;
      Py_DECREF(n);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return msg;
}

// The directory that holds zerokit_tpu_torch/, given at build time
// (runtime/build.py build_ffi passes -DZK_REPO_ROOT): the library lives
// under build/zerokit_tpu_torch/, so its own path does not say where the
// package is.
#ifndef ZK_REPO_ROOT
#error "build with -DZK_REPO_ROOT=\"<directory holding zerokit_tpu_torch>\""
#endif

// When this library is hosted standalone (a plain C program, no Python
// environment), the zerokit_tpu_torch package may not be on sys.path: add
// the build-time root as a fallback.
void add_package_dir_to_path() {
  PyObject *sys_path = PySys_GetObject("path");  // borrowed
  if (!sys_path) return;
  PyObject *dir = PyUnicode_FromString(ZK_REPO_ROOT);
  if (dir) {
    PyList_Append(sys_path, dir);
    Py_DECREF(dir);
  }
}

PyObject *import_glue() {
  PyObject *mod = PyImport_ImportModule("zerokit_tpu_torch.ffi_glue");
  if (!mod) {
    PyErr_Clear();
    add_package_dir_to_path();
    mod = PyImport_ImportModule("zerokit_tpu_torch.ffi_glue");
  }
  return mod;
}

// Calls zerokit_tpu_torch.ffi_glue.<fn>(*args). Steals `args` (a tuple). Returns
// a new reference or nullptr with g_last_error set.
PyObject *call_glue(const char *fn, PyObject *args) {
  if (!args) {
    set_error("failed to build arguments for " + std::string(fn));
    return nullptr;
  }
  PyObject *mod = import_glue();
  if (!mod) {
    set_error(fetch_py_error());
    Py_DECREF(args);
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (!f) {
    set_error(fetch_py_error());
    Py_DECREF(args);
    return nullptr;
  }
  PyObject *res = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (!res) set_error(fetch_py_error());
  return res;
}

int result_to_buffer(PyObject *res, rln_buffer *out) {
  char *data = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &data, &len) != 0) {
    set_error(fetch_py_error());
    return -1;
  }
  out->ptr = static_cast<uint8_t *>(std::malloc(len > 0 ? len : 1));
  out->len = static_cast<size_t>(len);
  if (len > 0) std::memcpy(out->ptr, data, len);
  return 0;
}

// Shared tail: unwrap an optional bytes result into `out` (if given).
int finish_call(PyObject *res, rln_buffer *out) {
  if (!res) return -1;
  int rc = 0;
  if (out) rc = result_to_buffer(res, out);
  Py_DECREF(res);
  return rc;
}

PyObject *bytes_or_none(const uint8_t *ptr, size_t len) {
  if (!ptr) Py_RETURN_NONE;
  return PyBytes_FromStringAndSize(reinterpret_cast<const char *>(ptr),
                                   static_cast<Py_ssize_t>(len));
}

}  // namespace

extern "C" {

void rln_buffer_free(rln_buffer *buf) {
  if (buf && buf->ptr) {
    std::free(buf->ptr);
    buf->ptr = nullptr;
    buf->len = 0;
  }
}

const char *rln_last_error(void) { return g_last_error.c_str(); }

int rln_init(void) {
  GilScope gil;
  PyObject *mod = import_glue();
  if (!mod) {
    set_error(fetch_py_error());
    return -1;
  }
  Py_DECREF(mod);
  return 0;
}

uint64_t rln_new(int stateful, const char *mode, const char *tree_backend,
                 const uint8_t *zkey, size_t zkey_len, const uint8_t *graph,
                 size_t graph_len, const char *tree_config_json) {
  GilScope gil;
  PyObject *zk = bytes_or_none(zkey, zkey_len);
  PyObject *gr = bytes_or_none(graph, graph_len);
  PyObject *cfg = tree_config_json ? PyUnicode_FromString(tree_config_json)
                                   : (Py_INCREF(Py_None), Py_None);
  PyObject *args = Py_BuildValue("(issNNN)", stateful, mode ? mode : "single",
                                 tree_backend ? tree_backend : "optimal", zk,
                                 gr, cfg);
  PyObject *res = call_glue("new", args);
  if (!res) return 0;
  uint64_t h = PyLong_AsUnsignedLongLong(res);
  Py_DECREF(res);
  if (PyErr_Occurred()) {
    set_error(fetch_py_error());
    return 0;
  }
  return h;
}

void rln_free(uint64_t handle) {
  GilScope gil;
  PyObject *res = call_glue("free", Py_BuildValue("(K)", handle));
  Py_XDECREF(res);
}

/* ---- tree ops ---- */

int rln_set_leaf(uint64_t handle, uint64_t index, const uint8_t fr_le[32]) {
  GilScope gil;
  return finish_call(
      call_glue("set_leaf", Py_BuildValue("(KKy#)", handle, index,
                                          (const char *)fr_le, (Py_ssize_t)32)),
      nullptr);
}

int rln_get_leaf(uint64_t handle, uint64_t index, rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("get_leaf", Py_BuildValue("(KK)", handle, index)),
                     out);
}

int rln_set_leaves_from(uint64_t handle, uint64_t index, const uint8_t *leaves,
                        size_t leaves_len) {
  GilScope gil;
  return finish_call(
      call_glue("set_leaves_from",
                Py_BuildValue("(KKy#)", handle, index, (const char *)leaves,
                              (Py_ssize_t)leaves_len)),
      nullptr);
}

int rln_init_tree_with_leaves(uint64_t handle, const uint8_t *leaves,
                              size_t leaves_len) {
  GilScope gil;
  return finish_call(
      call_glue("init_tree_with_leaves",
                Py_BuildValue("(Ky#)", handle, (const char *)leaves,
                              (Py_ssize_t)leaves_len)),
      nullptr);
}

int rln_atomic_operation(uint64_t handle, uint64_t index,
                         const uint8_t *leaves, size_t leaves_len,
                         const uint64_t *indices, size_t n_indices) {
  GilScope gil;
  PyObject *idx_list = PyList_New(static_cast<Py_ssize_t>(n_indices));
  for (size_t i = 0; i < n_indices; i++) {
    PyList_SET_ITEM(idx_list, static_cast<Py_ssize_t>(i),
                    PyLong_FromUnsignedLongLong(indices[i]));
  }
  return finish_call(
      call_glue("atomic_operation",
                Py_BuildValue("(KKy#N)", handle, index, (const char *)leaves,
                              (Py_ssize_t)leaves_len, idx_list)),
      nullptr);
}

int rln_set_next_leaf(uint64_t handle, const uint8_t fr_le[32]) {
  GilScope gil;
  return finish_call(
      call_glue("set_next_leaf", Py_BuildValue("(Ky#)", handle,
                                               (const char *)fr_le,
                                               (Py_ssize_t)32)),
      nullptr);
}

int rln_delete_leaf(uint64_t handle, uint64_t index) {
  GilScope gil;
  return finish_call(
      call_glue("delete_leaf", Py_BuildValue("(KK)", handle, index)), nullptr);
}

int rln_get_root(uint64_t handle, rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("get_root", Py_BuildValue("(K)", handle)), out);
}

int rln_get_subtree_root(uint64_t handle, uint64_t level, uint64_t index,
                         rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("get_subtree_root", Py_BuildValue("(KKK)", handle, level, index)),
      out);
}

int rln_get_merkle_proof(uint64_t handle, uint64_t index, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("get_merkle_proof", Py_BuildValue("(KK)", handle, index)), out);
}

int rln_get_empty_leaves_indices(uint64_t handle, rln_buffer *out) {
  GilScope gil;
  PyObject *res =
      call_glue("get_empty_leaves_indices", Py_BuildValue("(K)", handle));
  if (!res) return -1;
  Py_ssize_t n = PyList_Size(res);
  out->len = static_cast<size_t>(n) * 8;
  out->ptr = static_cast<uint8_t *>(std::malloc(out->len > 0 ? out->len : 1));
  for (Py_ssize_t i = 0; i < n; i++) {
    uint64_t v = PyLong_AsUnsignedLongLong(PyList_GET_ITEM(res, i));
    std::memcpy(out->ptr + i * 8, &v, 8);  // little-endian hosts
  }
  Py_DECREF(res);
  return 0;
}

int64_t rln_leaves_set(uint64_t handle) {
  GilScope gil;
  PyObject *res = call_glue("leaves_set", Py_BuildValue("(K)", handle));
  if (!res) return -1;
  int64_t v = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return v;
}

int rln_tree_depth(uint64_t handle) {
  GilScope gil;
  PyObject *res = call_glue("tree_depth", Py_BuildValue("(K)", handle));
  if (!res) return -1;
  int v = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return v;
}

int rln_set_metadata(uint64_t handle, const uint8_t *data, size_t len) {
  GilScope gil;
  return finish_call(
      call_glue("set_metadata", Py_BuildValue("(Ky#)", handle,
                                              (const char *)data,
                                              (Py_ssize_t)len)),
      nullptr);
}

int rln_get_metadata(uint64_t handle, rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("get_metadata", Py_BuildValue("(K)", handle)),
                     out);
}

int rln_flush(uint64_t handle) {
  GilScope gil;
  return finish_call(call_glue("flush", Py_BuildValue("(K)", handle)), nullptr);
}

/* ---- proof ops ---- */

int rln_generate_proof(uint64_t handle, const uint8_t *witness,
                       size_t witness_len, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("generate_proof",
                Py_BuildValue("(Ky#i)", handle, (const char *)witness,
                              (Py_ssize_t)witness_len, be)),
      out);
}

int rln_prove_with_witness(uint64_t handle, const uint8_t *calculated,
                           size_t calculated_len, const uint8_t *witness,
                           size_t witness_len, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("prove_with_witness",
                Py_BuildValue("(Ky#y#i)", handle, (const char *)calculated,
                              (Py_ssize_t)calculated_len,
                              (const char *)witness, (Py_ssize_t)witness_len,
                              be)),
      out);
}

static int bool_result(PyObject *res, int *ok) {
  if (!res) return -1;
  *ok = PyObject_IsTrue(res);
  Py_DECREF(res);
  return 0;
}

int rln_verify(uint64_t handle, const uint8_t *proof, size_t proof_len,
               int *ok) {
  GilScope gil;
  return bool_result(
      call_glue("verify", Py_BuildValue("(Ky#)", handle, (const char *)proof,
                                        (Py_ssize_t)proof_len)),
      ok);
}

int rln_verify_rln_proof(uint64_t handle, const uint8_t *proof,
                         size_t proof_len, const uint8_t x_le[32], int *ok) {
  GilScope gil;
  return bool_result(
      call_glue("verify_rln_proof",
                Py_BuildValue("(Ky#y#)", handle, (const char *)proof,
                              (Py_ssize_t)proof_len, (const char *)x_le,
                              (Py_ssize_t)32)),
      ok);
}

int rln_verify_with_roots(uint64_t handle, const uint8_t *proof,
                          size_t proof_len, const uint8_t x_le[32],
                          const uint8_t *roots, size_t roots_len, int *ok) {
  GilScope gil;
  return bool_result(
      call_glue("verify_with_roots",
                Py_BuildValue("(Ky#y#y#)", handle, (const char *)proof,
                              (Py_ssize_t)proof_len, (const char *)x_le,
                              (Py_ssize_t)32,
                              (const char *)(roots ? roots : (const uint8_t *)""),
                              (Py_ssize_t)roots_len)),
      ok);
}

int rln_generate_partial_proof(uint64_t handle, const uint8_t *partial_witness,
                               size_t len, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("generate_partial_proof",
                Py_BuildValue("(Ky#i)", handle, (const char *)partial_witness,
                              (Py_ssize_t)len, be)),
      out);
}

int rln_finish_proof(uint64_t handle, const uint8_t *partial_proof,
                     size_t partial_len, const uint8_t *witness,
                     size_t witness_len, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("finish_proof",
                Py_BuildValue("(Ky#y#i)", handle, (const char *)partial_proof,
                              (Py_ssize_t)partial_len, (const char *)witness,
                              (Py_ssize_t)witness_len, be)),
      out);
}

int rln_recover_id_secret(const uint8_t *proof1, size_t len1,
                          const uint8_t *proof2, size_t len2,
                          rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("recover_id_secret",
                Py_BuildValue("(y#y#)", (const char *)proof1, (Py_ssize_t)len1,
                              (const char *)proof2, (Py_ssize_t)len2)),
      out);
}

/* ---- primitives ---- */

int rln_keygen(rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("ffi_keygen", Py_BuildValue("()")), out);
}

int rln_seeded_keygen(const uint8_t *seed, size_t seed_len, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_keygen", Py_BuildValue("(y#)", (const char *)seed,
                                            (Py_ssize_t)seed_len)),
      out);
}

int rln_extended_keygen(rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("ffi_extended_keygen", Py_BuildValue("()")), out);
}

int rln_extended_seeded_keygen(const uint8_t *seed, size_t seed_len,
                               rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_extended_keygen",
                Py_BuildValue("(y#)", (const char *)seed, (Py_ssize_t)seed_len)),
      out);
}

int rln_hash_to_field(const uint8_t *signal, size_t len, int be,
                      rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_hash", Py_BuildValue("(y#i)", (const char *)signal,
                                          (Py_ssize_t)len, be)),
      out);
}

int rln_poseidon_hash(const uint8_t *inputs, size_t inputs_len,
                      rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_poseidon_hash",
                Py_BuildValue("(y#)", (const char *)inputs,
                              (Py_ssize_t)inputs_len)),
      out);
}


/* ---- standalone codecs, vec builders, extended ops (round 3) ---- */

static int recode3(const char *fn, const uint8_t *data, size_t len, int in_be,
                   int out_be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue(fn, Py_BuildValue("(y#ii)", (const char *)data,
                                  (Py_ssize_t)len, in_be, out_be)),
      out);
}

int rln_recode_witness(const uint8_t *data, size_t len, int in_be, int out_be,
                       rln_buffer *out) {
  return recode3("recode_witness", data, len, in_be, out_be, out);
}

int rln_recode_partial_witness(const uint8_t *data, size_t len, int in_be,
                               int out_be, rln_buffer *out) {
  return recode3("recode_partial_witness", data, len, in_be, out_be, out);
}

int rln_recode_proof_values(const uint8_t *data, size_t len, int in_be,
                            int out_be, rln_buffer *out) {
  return recode3("recode_proof_values", data, len, in_be, out_be, out);
}

int rln_witness_to_v3(const uint8_t *data, size_t len, int in_be, int out_be,
                      rln_buffer *out) {
  return recode3("witness_to_v3", data, len, in_be, out_be, out);
}

int rln_v3_to_witness(const uint8_t *data, size_t len, int in_be, int out_be,
                      rln_buffer *out) {
  return recode3("v3_to_witness", data, len, in_be, out_be, out);
}

static int bytes_be_call(const char *fn, const uint8_t *data, size_t len,
                         int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue(fn, Py_BuildValue("(y#i)", (const char *)data,
                                  (Py_ssize_t)len, be)),
      out);
}

int rln_proof_values_from_witness(const uint8_t *witness, size_t len, int be,
                                  rln_buffer *out) {
  return bytes_be_call("ffi_proof_values_from_witness", witness, len, be, out);
}

int rln_extract_proof_values(const uint8_t *proof, size_t len, int be,
                             rln_buffer *out) {
  return bytes_be_call("extract_proof_values", proof, len, be, out);
}

int rln_proof_values_root(const uint8_t *values, size_t len, int be,
                          rln_buffer *out) {
  return bytes_be_call("proof_values_root", values, len, be, out);
}

int rln_proof_values_x(const uint8_t *values, size_t len, int be,
                       rln_buffer *out) {
  return bytes_be_call("proof_values_x", values, len, be, out);
}

int rln_proof_values_external_nullifier(const uint8_t *values, size_t len,
                                        int be, rln_buffer *out) {
  return bytes_be_call("proof_values_external_nullifier", values, len, be, out);
}

int rln_proof_values_nullifiers(const uint8_t *values, size_t len, int be,
                                rln_buffer *out) {
  return bytes_be_call("proof_values_nullifiers", values, len, be, out);
}

int rln_vec_fr_build(const uint8_t *frs, size_t len, int be, rln_buffer *out) {
  return bytes_be_call("vec_fr_build", frs, len, be, out);
}

int rln_vec_fr_len(const uint8_t *vec, size_t len, int be, size_t *count) {
  GilScope gil;
  PyObject *res = call_glue(
      "vec_fr_len",
      Py_BuildValue("(y#i)", (const char *)vec, (Py_ssize_t)len, be));
  if (!res) return -1;
  *count = (size_t)PyLong_AsUnsignedLongLong(res);
  Py_DECREF(res);
  return 0;
}

int rln_vec_fr_get(const uint8_t *vec, size_t len, int be, size_t index,
                   rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("vec_fr_get",
                Py_BuildValue("(y#iK)", (const char *)vec, (Py_ssize_t)len, be,
                              (unsigned long long)index)),
      out);
}

int rln_vec_u8_build(const uint8_t *data, size_t len, int be, rln_buffer *out) {
  return bytes_be_call("vec_u8_build", data, len, be, out);
}

int rln_vec_u8_read(const uint8_t *vec, size_t len, int be, rln_buffer *out) {
  return bytes_be_call("vec_u8_read", vec, len, be, out);
}

int rln_keygen_be(rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("ffi_keygen_be", Py_BuildValue("()")), out);
}

int rln_seeded_keygen_be(const uint8_t *seed, size_t seed_len,
                         rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_keygen_be", Py_BuildValue("(y#)", (const char *)seed,
                                               (Py_ssize_t)seed_len)),
      out);
}

int rln_extended_keygen_be(rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("ffi_extended_keygen_be", Py_BuildValue("()")),
                     out);
}

int rln_extended_seeded_keygen_be(const uint8_t *seed, size_t seed_len,
                                  rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_extended_keygen_be",
                Py_BuildValue("(y#)", (const char *)seed, (Py_ssize_t)seed_len)),
      out);
}

int rln_poseidon_hash_pair(const uint8_t a[32], const uint8_t b[32], int be,
                           rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_poseidon_hash_pair",
                Py_BuildValue("(y#y#i)", (const char *)a, (Py_ssize_t)32,
                              (const char *)b, (Py_ssize_t)32, be)),
      out);
}

int rln_id_commitment(const uint8_t secret[32], int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("ffi_id_commitment",
                Py_BuildValue("(y#i)", (const char *)secret, (Py_ssize_t)32, be)),
      out);
}

uint64_t rln_new_with_config_file(int stateful, const char *mode,
                                  const char *tree_backend, const uint8_t *zkey,
                                  size_t zkey_len, const uint8_t *graph,
                                  size_t graph_len, const char *config_path) {
  GilScope gil;
  PyObject *zk = bytes_or_none(zkey, zkey_len);
  PyObject *gr = bytes_or_none(graph, graph_len);
  PyObject *args = Py_BuildValue(
      "(issNNs)", stateful, mode ? mode : "single",
      tree_backend ? tree_backend : "optimal", zk, gr, config_path);
  PyObject *res = call_glue("new_with_config_file", args);
  if (!res) return 0;
  uint64_t h = PyLong_AsUnsignedLongLong(res);
  Py_DECREF(res);
  if (PyErr_Occurred()) {
    set_error(fetch_py_error());
    return 0;
  }
  return h;
}

int rln_get_leaves(uint64_t handle, rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("get_leaves", Py_BuildValue("(K)", handle)), out);
}

int rln_generate_proof_with_rs(uint64_t handle, const uint8_t *witness,
                               size_t witness_len, int be, const uint8_t r[32],
                               const uint8_t s[32], rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("generate_proof_with_rs",
                Py_BuildValue("(Ky#iy#y#)", handle, (const char *)witness,
                              (Py_ssize_t)witness_len, be, (const char *)r,
                              (Py_ssize_t)32, (const char *)s, (Py_ssize_t)32)),
      out);
}

int rln_generate_proofs(uint64_t handle, size_t count, const uint8_t *witnesses,
                        size_t witnesses_len, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("generate_proofs_batch",
                Py_BuildValue("(KKy#i)", handle, (unsigned long long)count,
                              (const char *)witnesses,
                              (Py_ssize_t)witnesses_len, be)),
      out);
}

/* ---- component-wise witness construction + per-field accessors ---------- */

int rln_witness_build_single(const uint8_t secret[32], uint64_t limit,
                             uint64_t message_id, const uint8_t *path_elements,
                             size_t path_elements_len,
                             const uint8_t *path_index, size_t path_index_len,
                             const uint8_t x[32],
                             const uint8_t external_nullifier[32], int be,
                             rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("witness_build_single",
                Py_BuildValue("(y#KKy#y#y#y#i)", (const char *)secret,
                              (Py_ssize_t)32, (unsigned long long)limit,
                              (unsigned long long)message_id,
                              (const char *)path_elements,
                              (Py_ssize_t)path_elements_len,
                              (const char *)path_index,
                              (Py_ssize_t)path_index_len, (const char *)x,
                              (Py_ssize_t)32, (const char *)external_nullifier,
                              (Py_ssize_t)32, be)),
      out);
}

int rln_witness_build_multi(const uint8_t secret[32], uint64_t limit,
                            const uint8_t *message_ids, size_t message_ids_len,
                            const uint8_t *selectors, size_t selectors_len,
                            const uint8_t *path_elements,
                            size_t path_elements_len, const uint8_t *path_index,
                            size_t path_index_len, const uint8_t x[32],
                            const uint8_t external_nullifier[32], int be,
                            rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("witness_build_multi",
                Py_BuildValue(
                    "(y#Ky#y#y#y#y#y#i)", (const char *)secret, (Py_ssize_t)32,
                    (unsigned long long)limit, (const char *)message_ids,
                    (Py_ssize_t)message_ids_len, (const char *)selectors,
                    (Py_ssize_t)selectors_len, (const char *)path_elements,
                    (Py_ssize_t)path_elements_len, (const char *)path_index,
                    (Py_ssize_t)path_index_len, (const char *)x, (Py_ssize_t)32,
                    (const char *)external_nullifier, (Py_ssize_t)32, be)),
      out);
}

int rln_witness_identity_secret(const uint8_t *witness, size_t len, int be,
                                rln_buffer *out) {
  return bytes_be_call("witness_identity_secret", witness, len, be, out);
}

int rln_witness_user_message_limit(const uint8_t *witness, size_t len, int be,
                                   rln_buffer *out) {
  return bytes_be_call("witness_user_message_limit", witness, len, be, out);
}

int rln_witness_message_ids(const uint8_t *witness, size_t len, int be,
                            rln_buffer *out) {
  return bytes_be_call("witness_message_ids", witness, len, be, out);
}

int rln_witness_x(const uint8_t *witness, size_t len, int be,
                  rln_buffer *out) {
  return bytes_be_call("witness_x", witness, len, be, out);
}

int rln_witness_external_nullifier(const uint8_t *witness, size_t len, int be,
                                   rln_buffer *out) {
  return bytes_be_call("witness_external_nullifier", witness, len, be, out);
}

int rln_witness_path_elements(const uint8_t *witness, size_t len, int be,
                              rln_buffer *out) {
  return bytes_be_call("witness_path_elements", witness, len, be, out);
}

int rln_witness_path_index(const uint8_t *witness, size_t len, int be,
                           rln_buffer *out) {
  return bytes_be_call("witness_path_index", witness, len, be, out);
}

int rln_proof_values_ys(const uint8_t *values, size_t len, int be,
                        rln_buffer *out) {
  return bytes_be_call("proof_values_ys", values, len, be, out);
}

int rln_proof_values_selectors(const uint8_t *values, size_t len, int be,
                               rln_buffer *out) {
  return bytes_be_call("proof_values_selectors", values, len, be, out);
}

/* ---- Fr field helpers (reference ffi_utils.rs CFr arithmetic) ----------- */

static int fr_binop_call(const char *op, const uint8_t a[32],
                         const uint8_t b[32], int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("fr_binop",
                Py_BuildValue("(sy#y#i)", op, (const char *)a, (Py_ssize_t)32,
                              (const char *)b, (Py_ssize_t)32, be)),
      out);
}

static int fr_unop_call(const char *op, const uint8_t a[32], int be,
                        rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("fr_unop", Py_BuildValue("(sy#i)", op, (const char *)a,
                                         (Py_ssize_t)32, be)),
      out);
}

int rln_fr_add(const uint8_t a[32], const uint8_t b[32], int be,
               rln_buffer *out) {
  return fr_binop_call("add", a, b, be, out);
}

int rln_fr_sub(const uint8_t a[32], const uint8_t b[32], int be,
               rln_buffer *out) {
  return fr_binop_call("sub", a, b, be, out);
}

int rln_fr_mul(const uint8_t a[32], const uint8_t b[32], int be,
               rln_buffer *out) {
  return fr_binop_call("mul", a, b, be, out);
}

int rln_fr_div(const uint8_t a[32], const uint8_t b[32], int be,
               rln_buffer *out) {
  return fr_binop_call("div", a, b, be, out);
}

int rln_fr_neg(const uint8_t a[32], int be, rln_buffer *out) {
  return fr_unop_call("neg", a, be, out);
}

int rln_fr_inv(const uint8_t a[32], int be, rln_buffer *out) {
  return fr_unop_call("inv", a, be, out);
}

int rln_fr_from_uint64(uint64_t v, int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(
      call_glue("fr_from_uint64",
                Py_BuildValue("(Ki)", (unsigned long long)v, be)),
      out);
}

int rln_fr_random(int be, rln_buffer *out) {
  GilScope gil;
  return finish_call(call_glue("fr_random", Py_BuildValue("(i)", be)), out);
}

}  // extern "C"
