/*
 * spfft_tpu native API — C error codes.
 *
 * Value-compatible with the reference SpfftError enum (reference:
 * include/spfft/errors.h:33-124). Every C API function returns one of these;
 * the C++ API throws the matching exception from spfft/exceptions.hpp.
 */
#ifndef SPFFT_TPU_ERRORS_H
#define SPFFT_TPU_ERRORS_H

enum SpfftError {
  SPFFT_SUCCESS = 0,
  SPFFT_UNKNOWN_ERROR = 1,
  SPFFT_INVALID_HANDLE_ERROR = 2,
  SPFFT_OVERFLOW_ERROR = 3,
  SPFFT_ALLOCATION_ERROR = 4,
  SPFFT_INVALID_PARAMETER_ERROR = 5,
  SPFFT_DUPLICATE_INDICES_ERROR = 6,
  SPFFT_INVALID_INDICES_ERROR = 7,
  SPFFT_MPI_SUPPORT_ERROR = 8, /* distributed support not compiled/available */
  SPFFT_MPI_ERROR = 9,         /* collective backend failure */
  SPFFT_MPI_PARAMETER_MISMATCH_ERROR = 10,
  SPFFT_HOST_EXECUTION_ERROR = 11,
  SPFFT_FFTW_ERROR = 12,
  SPFFT_GPU_ERROR = 13, /* accelerator (CUDA) runtime failure */
  SPFFT_GPU_PRECEDING_ERROR = 14,
  SPFFT_GPU_SUPPORT_ERROR = 15,
  SPFFT_GPU_ALLOCATION_ERROR = 16,
  SPFFT_GPU_LAUNCH_ERROR = 17,
  SPFFT_GPU_NO_DEVICE_ERROR = 18,
  SPFFT_GPU_INVALID_VALUE_ERROR = 19,
  SPFFT_GPU_INVALID_DEVICE_PTR_ERROR = 20,
  SPFFT_GPU_COPY_ERROR = 21,
  SPFFT_GPU_FFT_ERROR = 22,
  /* This build's extension beyond the reference enum: algorithm-based
   * self-verification (ABFT) failed and recovery was exhausted. */
  SPFFT_VERIFICATION_ERROR = 23,
  /* Serving-layer extensions (the serving layer): admission refused under
   * overload (bounded queue full, tenant quota, load shedding) ... */
  SPFFT_SERVICE_OVERLOAD_ERROR = 24,
  /* ... and a request deadline expired at admission or pre-dispatch. */
  SPFFT_DEADLINE_EXCEEDED_ERROR = 25,
  /* Multi-host extension: a worker host died or became unreachable
   * (missed heartbeats / dead RPC transport) with work in flight. */
  SPFFT_HOST_LOST_ERROR = 26
};

#ifndef __cplusplus
typedef enum SpfftError SpfftError;
#endif

#endif /* SPFFT_TPU_ERRORS_H */
