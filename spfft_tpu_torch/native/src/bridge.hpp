/*
 * Embedded-runtime bridge for the spfft_tpu_torch native API.
 *
 * The native library owns the process-side runtime: handle lifetimes, host
 * buffers and error translation live in C++, while the PyTorch compute core
 * (spfft_tpu_torch, its CUDA kernels on the card) is driven through an
 * embedded CPython interpreter running the spfft_tpu_torch.capi marshalling
 * module. This plays the role the reference's direct FFTW/cuFFT calls play
 * (reference: src/fft/fftw_interface.hpp, src/gpu_util/) — the boundary to
 * the vendor compute runtime, here CUDA through PyTorch.
 *
 * Threading: the interpreter is initialized once on first use; every entry
 * point acquires the GIL through bridge::Gil. When the library is loaded into
 * an existing Python process (e.g. via ctypes for testing) the running
 * interpreter is reused.
 */
#ifndef SPFFT_TPU_TORCH_BRIDGE_HPP
#define SPFFT_TPU_TORCH_BRIDGE_HPP

#include <Python.h>

#include <cstddef>

namespace spfft {
namespace bridge {

/* Initialize the interpreter (idempotent) and acquire the GIL for the
 * lifetime of this object. */
class Gil {
public:
  Gil();
  ~Gil();
  Gil(const Gil&) = delete;
  Gil& operator=(const Gil&) = delete;

private:
  PyGILState_STATE state_;
};

/* Owning PyObject reference. Copy/destroy acquire the GIL themselves, so a
 * Ref may live in objects destroyed from arbitrary (non-Python) threads —
 * e.g. a Transform deleted through the C API with no Gil in scope. */
class Ref {
public:
  Ref() = default;
  explicit Ref(PyObject* obj) : obj_(obj) {} /* steals */
  Ref(const Ref& other) : obj_(other.obj_) {
    if (obj_ != nullptr) {
      PyGILState_STATE s = PyGILState_Ensure();
      Py_INCREF(obj_);
      PyGILState_Release(s);
    }
  }
  Ref(Ref&& other) noexcept : obj_(other.obj_) { other.obj_ = nullptr; }
  Ref& operator=(Ref other) noexcept {
    PyObject* tmp = obj_;
    obj_ = other.obj_;
    other.obj_ = tmp;
    return *this;
  }
  ~Ref() {
    if (obj_ != nullptr && Py_IsInitialized()) {
      PyGILState_STATE s = PyGILState_Ensure();
      Py_DECREF(obj_);
      PyGILState_Release(s);
    }
  }

  PyObject* get() const { return obj_; }
  PyObject* release() {
    PyObject* o = obj_;
    obj_ = nullptr;
    return o;
  }
  explicit operator bool() const { return obj_ != nullptr; }

private:
  PyObject* obj_ = nullptr;
};

/* The spfft_tpu_torch.capi module (borrowed reference; GIL must be held). */
PyObject* capi();

/* Translate the pending Python exception into the matching C++ exception
 * from spfft/exceptions.hpp and throw it. */
[[noreturn]] void throw_pending_error();

/* Checked result: throws if `obj` is null (a Python error is pending). */
PyObject* checked(PyObject* obj);

/* Read-only / writable memoryviews over caller memory (no copy). */
Ref view_ro(const void* data, std::size_t bytes);
Ref view_rw(void* data, std::size_t bytes);

/* Call capi.<fn> returning an owned result; throws on Python error. */
Ref call(const char* fn, PyObject* args_tuple /* stolen */);

/* int/long helpers. */
long long as_longlong(PyObject* obj);

} // namespace bridge
} // namespace spfft

#endif // SPFFT_TPU_TORCH_BRIDGE_HPP
