"""Error codes and exception hierarchy.

The reference's dual error surface: a C error enum (reference:
include/spfft/errors.h:33-126) and an exception hierarchy whose exceptions
each carry their enum value (reference: include/spfft/exceptions.hpp:40-306).
The codes are the same as the JAX package's, extensions included.
"""
from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Reference: include/spfft/errors.h:33-126 (SpfftError), same ordering."""

    SUCCESS = 0
    UNKNOWN = 1
    INVALID_HANDLE = 2
    OVERFLOW = 3
    ALLOCATION = 4
    INVALID_PARAMETER = 5
    DUPLICATE_INDICES = 6
    INVALID_INDICES = 7
    MPI_SUPPORT = 8
    MPI = 9
    MPI_PARAMETER_MISMATCH = 10
    HOST_EXECUTION = 11
    FFTW = 12
    GPU = 13
    GPU_PRECEDING = 14
    GPU_SUPPORT = 15
    GPU_ALLOCATION = 16
    GPU_LAUNCH = 17
    GPU_NO_DEVICE = 18
    GPU_INVALID_VALUE = 19
    GPU_INVALID_DEVICE_PTR = 20
    GPU_COPY = 21
    GPU_FFT = 22
    # Extensions beyond the reference enum, numbered as in the JAX package.
    VERIFICATION = 23
    SERVICE_OVERLOAD = 24
    DEADLINE_EXCEEDED = 25
    HOST_LOST = 26


class GenericError(Exception):
    """Base exception. Reference: include/spfft/exceptions.hpp:40-61.

    Constructing any typed error notifies the flight recorder
    (:mod:`spfft_tpu_torch.obs.trace`), as in the JAX package: with tracing
    armed the error lands as an ``error`` event stamped with the active run
    ID, and with ``SPFFT_TPU_TRACE_DUMP`` set the recorder is flushed to disk,
    so the events leading up to a typed failure survive it."""

    error_code: ErrorCode = ErrorCode.UNKNOWN

    def __init__(self, message: str | None = None):
        super().__init__(message or self.__class__.__doc__ or self.__class__.__name__)
        from .obs import trace

        if trace.enabled():
            trace.event("error", type=type(self).__name__, error_code=int(self.error_code),
                        message=str(self)[:200])
            trace.dump(reason=type(self).__name__)


class OverflowError_(GenericError):
    """Integer overflow in index or size computation."""

    error_code = ErrorCode.OVERFLOW


class AllocationError(GenericError):
    """Failed buffer allocation."""

    error_code = ErrorCode.ALLOCATION


class InvalidParameterError(GenericError):
    """Invalid parameter passed to a transform or grid."""

    error_code = ErrorCode.INVALID_PARAMETER


class DuplicateIndicesError(GenericError):
    """Duplicate frequency indices (possibly a z-stick split across shards)."""

    error_code = ErrorCode.DUPLICATE_INDICES


class InvalidIndicesError(GenericError):
    """Frequency index triplet out of bounds for the transform dimensions."""

    error_code = ErrorCode.INVALID_INDICES


class MPISupportError(GenericError):
    """Distributed execution requested without a multi-device backend."""

    error_code = ErrorCode.MPI_SUPPORT


class MPIError(GenericError):
    """Failure in the distributed communication backend."""

    error_code = ErrorCode.MPI


class MPIParameterMismatchError(GenericError):
    """Constructor parameters disagree across shards."""

    error_code = ErrorCode.MPI_PARAMETER_MISMATCH


class HostExecutionError(GenericError):
    """Execution failure on the host backend."""

    error_code = ErrorCode.HOST_EXECUTION


class FFTWError(GenericError):
    """Failure in the underlying FFT implementation."""

    error_code = ErrorCode.FFTW


class GPUError(GenericError):
    """Generic accelerator error."""

    error_code = ErrorCode.GPU


class GPUPrecedingError(GenericError):
    """An earlier accelerator operation already failed."""

    error_code = ErrorCode.GPU_PRECEDING


class GPUSupportError(GenericError):
    """Accelerator execution requested but no accelerator backend available."""

    error_code = ErrorCode.GPU_SUPPORT


class GPUAllocationError(GenericError):
    """Failed allocation in accelerator memory."""

    error_code = ErrorCode.GPU_ALLOCATION


class GPULaunchError(GenericError):
    """Failed to launch an accelerator kernel."""

    error_code = ErrorCode.GPU_LAUNCH


class GPUNoDeviceError(GenericError):
    """No accelerator device detected."""

    error_code = ErrorCode.GPU_NO_DEVICE


class GPUInvalidValueError(GenericError):
    """Invalid value passed to the accelerator runtime."""

    error_code = ErrorCode.GPU_INVALID_VALUE


class GPUInvalidDevicePointerError(GenericError):
    """Invalid device buffer reference."""

    error_code = ErrorCode.GPU_INVALID_DEVICE_PTR


class GPUCopyError(GenericError):
    """Failed host<->device transfer."""

    error_code = ErrorCode.GPU_COPY


class GPUFFTError(GenericError):
    """Failure in the accelerator FFT path."""

    error_code = ErrorCode.GPU_FFT


class VerificationError(GenericError):
    """Self-verification failed and recovery was exhausted."""

    error_code = ErrorCode.VERIFICATION


class ServiceOverloadError(GenericError):
    """The serving layer refused admission under overload."""

    error_code = ErrorCode.SERVICE_OVERLOAD


class DeadlineExceededError(GenericError):
    """A request's deadline expired before its result was produced."""

    error_code = ErrorCode.DEADLINE_EXCEEDED


class HostLostError(MPIError):
    """A worker host died or became unreachable mid-operation."""

    error_code = ErrorCode.HOST_LOST
