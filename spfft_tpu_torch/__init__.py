"""spfft_tpu_torch: the sparse 3-D FFT of spfft_tpu, in PyTorch, on an NVIDIA H100.

The port of the JAX package's local transform on its accelerator engine: every
DFT stage is a matrix product (kernel K1, ``csrc/complex_matmul.cu``) and the
stick <-> plane moves are row gathers (kernel K2, ``csrc/row_gather.cu``),
both CUDA C++ for ``sm_90a``, built with ``nvcc`` on first use. On CPU tensors
(``ProcessingUnit.HOST``) each kernel's plain PyTorch version runs instead.

    import spfft_tpu_torch as sp
    trip = sp.create_spherical_cutoff_triplets(64, 64, 64, 0.659)
    t = sp.Transform(sp.ProcessingUnit.GPU, sp.TransformType.C2C, 64, 64, 64,
                     indices=trip, dtype=np.float32)
    space = t.backward(values)                      # (Z, Y, X) on the card
    back = t.forward(scaling=sp.ScalingType.FULL)   # packed values
"""
from .errors import (  # noqa: F401
    AllocationError,
    DeadlineExceededError,
    DuplicateIndicesError,
    ErrorCode,
    FFTWError,
    GenericError,
    GPUAllocationError,
    GPUCopyError,
    GPUError,
    GPUFFTError,
    GPUInvalidDevicePointerError,
    GPUInvalidValueError,
    GPULaunchError,
    GPUNoDeviceError,
    GPUPrecedingError,
    GPUSupportError,
    HostExecutionError,
    HostLostError,
    InvalidIndicesError,
    InvalidParameterError,
    MPIError,
    MPIParameterMismatchError,
    MPISupportError,
    OverflowError_,
    ServiceOverloadError,
    VerificationError,
)
from .grid import Grid, device_for_processing_unit  # noqa: F401
from .indices import (  # noqa: F401
    check_stick_duplicates,
    convert_index_triplets,
    create_spherical_cutoff_triplets,
)
from .parameters import LocalParameters, from_jax_params, make_local_parameters  # noqa: F401
from .transform import Transform  # noqa: F401
from .types import (  # noqa: F401
    ExecType,
    IndexFormat,
    ProcessingUnit,
    ScalingType,
    TransformType,
)
