#include "bridge.hpp"

#include <spfft/exceptions.hpp>

#include <mutex>
#include <string>

namespace spfft {
namespace bridge {

namespace {

void initialize_interpreter_once() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (Py_IsInitialized()) {
      return; /* loaded into a live Python process — reuse its interpreter */
    }
    Py_InitializeEx(0);
    /* Drop the GIL acquired by initialization so any thread can take it
     * through PyGILState_Ensure later. */
    PyEval_SaveThread();
  });
}

} // namespace

Gil::Gil() {
  initialize_interpreter_once();
  state_ = PyGILState_Ensure();
}

Gil::~Gil() { PyGILState_Release(state_); }

PyObject* capi() {
  /* Per-process module cache. Import errors surface as HostExecutionError —
   * the runtime environment is unusable. */
  static PyObject* module = nullptr;
  if (module == nullptr) {
    module = PyImport_ImportModule("spfft_tpu_torch.capi");
    if (module == nullptr) {
      PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
      PyErr_Fetch(&type, &value, &trace);
      std::string msg = "spfft_tpu_torch: cannot import runtime bridge";
      if (value != nullptr) {
        PyObject* s = PyObject_Str(value);
        if (s != nullptr) {
          const char* text = PyUnicode_AsUTF8(s);
          if (text != nullptr) {
            msg += ": ";
            msg += text;
          }
          Py_DECREF(s);
        }
      }
      Py_XDECREF(type);
      Py_XDECREF(value);
      Py_XDECREF(trace);
      throw HostExecutionError(msg);
    }
  }
  return module;
}

void throw_pending_error() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  Ref type_ref(type), value_ref(value), trace_ref(trace);

  std::string msg = "spfft_tpu_torch: unknown error";
  long code = SPFFT_UNKNOWN_ERROR;
  if (value_ref) {
    PyObject* s = PyObject_Str(value_ref.get());
    if (s != nullptr) {
      const char* text = PyUnicode_AsUTF8(s);
      if (text != nullptr) msg = text;
      Py_DECREF(s);
    }
    /* Let the Python side classify its own exception. */
    PyObject* code_obj =
        PyObject_CallMethod(capi(), "error_code", "O", value_ref.get());
    if (code_obj != nullptr) {
      code = PyLong_AsLong(code_obj);
      Py_DECREF(code_obj);
    } else {
      PyErr_Clear();
    }
  }

  switch (code) {
  case SPFFT_OVERFLOW_ERROR: throw OverflowError(msg);
  case SPFFT_ALLOCATION_ERROR: throw HostAllocationError(msg);
  case SPFFT_INVALID_PARAMETER_ERROR: throw InvalidParameterError(msg);
  case SPFFT_DUPLICATE_INDICES_ERROR: throw DuplicateIndicesError(msg);
  case SPFFT_INVALID_INDICES_ERROR: throw InvalidIndicesError(msg);
  case SPFFT_MPI_SUPPORT_ERROR: throw MPISupportError(msg);
  case SPFFT_MPI_ERROR: throw MPIError(msg);
  case SPFFT_MPI_PARAMETER_MISMATCH_ERROR: throw MPIParameterMismatchError(msg);
  case SPFFT_HOST_EXECUTION_ERROR: throw HostExecutionError(msg);
  case SPFFT_FFTW_ERROR: throw FFTWError(msg);
  case SPFFT_GPU_ERROR: throw GPUError(msg);
  case SPFFT_GPU_PRECEDING_ERROR: throw GPUPrecedingError(msg);
  case SPFFT_GPU_SUPPORT_ERROR: throw GPUSupportError(msg);
  case SPFFT_GPU_ALLOCATION_ERROR: throw GPUAllocationError(msg);
  case SPFFT_GPU_LAUNCH_ERROR: throw GPULaunchError(msg);
  case SPFFT_GPU_NO_DEVICE_ERROR: throw GPUNoDeviceError(msg);
  case SPFFT_GPU_INVALID_VALUE_ERROR: throw GPUInvalidValueError(msg);
  case SPFFT_GPU_INVALID_DEVICE_PTR_ERROR: throw GPUInvalidDevicePointerError(msg);
  case SPFFT_GPU_COPY_ERROR: throw GPUCopyError(msg);
  case SPFFT_GPU_FFT_ERROR: throw GPUFFTError(msg);
  default: throw GenericError(msg);
  }
}

PyObject* checked(PyObject* obj) {
  if (obj == nullptr) {
    throw_pending_error();
  }
  return obj;
}

Ref view_ro(const void* data, std::size_t bytes) {
  return Ref(checked(PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)),
      static_cast<Py_ssize_t>(bytes), PyBUF_READ)));
}

Ref view_rw(void* data, std::size_t bytes) {
  return Ref(checked(PyMemoryView_FromMemory(
      static_cast<char*>(data), static_cast<Py_ssize_t>(bytes), PyBUF_WRITE)));
}

Ref call(const char* fn, PyObject* args_tuple) {
  Ref args(checked(args_tuple));
  PyObject* callable = checked(PyObject_GetAttrString(capi(), fn));
  Ref callable_ref(callable);
  return Ref(checked(PyObject_CallObject(callable, args.get())));
}

long long as_longlong(PyObject* obj) {
  long long v = PyLong_AsLongLong(obj);
  if (v == -1 && PyErr_Occurred()) {
    throw_pending_error();
  }
  return v;
}

} // namespace bridge
} // namespace spfft
