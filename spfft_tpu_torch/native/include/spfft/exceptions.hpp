/*
 * spfft_tpu native API — C++ exception hierarchy.
 *
 * One exception class per SpfftError value (reference:
 * include/spfft/exceptions.hpp:40-306 has the same shape). The C API catches
 * GenericError and returns error_code(); unknown exceptions become
 * SPFFT_UNKNOWN_ERROR.
 */
#ifndef SPFFT_TPU_EXCEPTIONS_HPP
#define SPFFT_TPU_EXCEPTIONS_HPP

#include <spfft/errors.h>

#include <stdexcept>
#include <string>

namespace spfft {

class GenericError : public std::exception {
public:
  explicit GenericError(std::string msg = "spfft_tpu: error") : msg_(std::move(msg)) {}

  const char* what() const noexcept override { return msg_.c_str(); }

  virtual SpfftError error_code() const noexcept { return SPFFT_UNKNOWN_ERROR; }

private:
  std::string msg_;
};

#define SPFFT_TPU_DEFINE_ERROR(NAME, CODE, DEFAULT_MSG)                                  \
  class NAME : public GenericError {                                                     \
  public:                                                                                \
    explicit NAME(std::string msg = DEFAULT_MSG) : GenericError(std::move(msg)) {}       \
    SpfftError error_code() const noexcept override { return CODE; }                     \
  };

SPFFT_TPU_DEFINE_ERROR(InvalidHandleError, SPFFT_INVALID_HANDLE_ERROR,
                       "spfft_tpu: invalid handle")
SPFFT_TPU_DEFINE_ERROR(OverflowError, SPFFT_OVERFLOW_ERROR, "spfft_tpu: overflow")
SPFFT_TPU_DEFINE_ERROR(HostAllocationError, SPFFT_ALLOCATION_ERROR,
                       "spfft_tpu: allocation failed")
SPFFT_TPU_DEFINE_ERROR(InvalidParameterError, SPFFT_INVALID_PARAMETER_ERROR,
                       "spfft_tpu: invalid parameter")
SPFFT_TPU_DEFINE_ERROR(DuplicateIndicesError, SPFFT_DUPLICATE_INDICES_ERROR,
                       "spfft_tpu: duplicate indices")
SPFFT_TPU_DEFINE_ERROR(InvalidIndicesError, SPFFT_INVALID_INDICES_ERROR,
                       "spfft_tpu: invalid indices")
SPFFT_TPU_DEFINE_ERROR(MPISupportError, SPFFT_MPI_SUPPORT_ERROR,
                       "spfft_tpu: distributed support unavailable")
SPFFT_TPU_DEFINE_ERROR(MPIError, SPFFT_MPI_ERROR, "spfft_tpu: collective backend error")
SPFFT_TPU_DEFINE_ERROR(MPIParameterMismatchError, SPFFT_MPI_PARAMETER_MISMATCH_ERROR,
                       "spfft_tpu: cross-shard parameter mismatch")
SPFFT_TPU_DEFINE_ERROR(HostExecutionError, SPFFT_HOST_EXECUTION_ERROR,
                       "spfft_tpu: host execution failed")
SPFFT_TPU_DEFINE_ERROR(FFTWError, SPFFT_FFTW_ERROR, "spfft_tpu: host FFT backend error")
SPFFT_TPU_DEFINE_ERROR(GPUError, SPFFT_GPU_ERROR, "spfft_tpu: accelerator error")
SPFFT_TPU_DEFINE_ERROR(GPUPrecedingError, SPFFT_GPU_PRECEDING_ERROR,
                       "spfft_tpu: preceding accelerator error")
SPFFT_TPU_DEFINE_ERROR(GPUSupportError, SPFFT_GPU_SUPPORT_ERROR,
                       "spfft_tpu: accelerator support unavailable")
SPFFT_TPU_DEFINE_ERROR(GPUAllocationError, SPFFT_GPU_ALLOCATION_ERROR,
                       "spfft_tpu: accelerator allocation failed")
SPFFT_TPU_DEFINE_ERROR(GPULaunchError, SPFFT_GPU_LAUNCH_ERROR,
                       "spfft_tpu: accelerator launch failed")
SPFFT_TPU_DEFINE_ERROR(GPUNoDeviceError, SPFFT_GPU_NO_DEVICE_ERROR,
                       "spfft_tpu: no accelerator device")
SPFFT_TPU_DEFINE_ERROR(GPUInvalidValueError, SPFFT_GPU_INVALID_VALUE_ERROR,
                       "spfft_tpu: invalid accelerator value")
SPFFT_TPU_DEFINE_ERROR(GPUInvalidDevicePointerError, SPFFT_GPU_INVALID_DEVICE_PTR_ERROR,
                       "spfft_tpu: invalid device pointer")
SPFFT_TPU_DEFINE_ERROR(GPUCopyError, SPFFT_GPU_COPY_ERROR, "spfft_tpu: device copy failed")
SPFFT_TPU_DEFINE_ERROR(GPUFFTError, SPFFT_GPU_FFT_ERROR,
                       "spfft_tpu: accelerator FFT error")
SPFFT_TPU_DEFINE_ERROR(VerificationError, SPFFT_VERIFICATION_ERROR,
                       "spfft_tpu: self-verification failed, recovery exhausted")
SPFFT_TPU_DEFINE_ERROR(ServiceOverloadError, SPFFT_SERVICE_OVERLOAD_ERROR,
                       "spfft_tpu: service overloaded, admission refused")
SPFFT_TPU_DEFINE_ERROR(DeadlineExceededError, SPFFT_DEADLINE_EXCEEDED_ERROR,
                       "spfft_tpu: request deadline exceeded")
SPFFT_TPU_DEFINE_ERROR(HostLostError, SPFFT_HOST_LOST_ERROR,
                       "spfft_tpu: worker host lost (heartbeat/transport)")

#undef SPFFT_TPU_DEFINE_ERROR

} // namespace spfft

#endif // SPFFT_TPU_EXCEPTIONS_HPP
