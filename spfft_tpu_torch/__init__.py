"""spfft_tpu_torch: the sparse 3-D FFT of spfft_tpu, in PyTorch, on an NVIDIA H100.

The port of the JAX package's local transform and its distributed
transforms (:class:`DistributedTransform` over the shards of
:func:`make_fft_mesh`, z-slabs, or of :func:`make_fft_mesh2`, 2-D pencils:
stacked on one device, or across processes with ``torch.distributed``). On its accelerator engine
(``engine="mxu"``, the default on the card) every DFT stage is a matrix
product (kernel K1, ``csrc/complex_matmul.cu``) and the stick <-> plane moves
are row gathers (kernel K2, ``csrc/row_gather.cu``), both CUDA C++ for
``sm_90a``, built with ``nvcc`` on first use. On CPU tensors
(``ProcessingUnit.HOST``) each kernel's plain PyTorch version runs instead.
``engine="xla"`` (the default on the CPU) is the ``torch.fft`` engine. Each
direction runs as one program (:mod:`spfft_tpu_torch.ir`; on the card one
CUDA-graph replay), or node by node with ``fuse=False``. Plan cards (``t.report()``), the timing tree
(:mod:`spfft_tpu_torch.timing`), run metrics and the flight recorder
(:mod:`spfft_tpu_torch.obs`) and the completion fence
(:mod:`spfft_tpu_torch.sync`) are the JAX package's observability layers;
guard mode, fault injection and the degradation ladder
(:mod:`spfft_tpu_torch.faults`) and self-verification
(:mod:`spfft_tpu_torch.verify`, ``verify=``) its robustness layers;
``policy="tuned"`` measures the plan's choices and keeps them in wisdom
(:mod:`spfft_tpu_torch.tuning`), and :mod:`spfft_tpu_torch.sched` runs task
graphs of transforms; :mod:`spfft_tpu_torch.serve` serves them to many
tenants (a bounded queue, coalesced batches, an RPC cluster front) and
:mod:`spfft_tpu_torch.hostmesh` boots worker hosts;
``python -m spfft_tpu_torch.programs.benchmark`` is the reference benchmark.

    import spfft_tpu_torch as sp
    trip = sp.create_spherical_cutoff_triplets(64, 64, 64, 0.659)
    t = sp.Transform(sp.ProcessingUnit.GPU, sp.TransformType.C2C, 64, 64, 64,
                     indices=trip, dtype=np.float32)
    space = t.backward(values)                      # (Z, Y, X) on the card
    back = t.forward(scaling=sp.ScalingType.FULL)   # packed values
"""
# Runtime lockdep arms FIRST, before any submodule import creates its
# threading primitives: the wrapper factories must be installed when the
# module-level locks (obs registry and trace, faults plane, tuning wisdom,
# verify breaker, the IR's capture lock, ...) are constructed. knobs pulls
# only errors (stdlib), and analysis.lockdep is stdlib-only: nothing here
# imports torch.
from . import knobs as _knobs

if _knobs.get_bool("SPFFT_TPU_LOCKDEP"):
    from .analysis import lockdep as _lockdep

    _lockdep.install(report_path=_knobs.get_str("SPFFT_TPU_LOCKDEP_REPORT"))

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
from . import faults, obs, sched, sync, timing, tuning, verify  # noqa: F401
from .distributed import DistributedTransform  # noqa: F401
from .grid import Grid, device_for_processing_unit  # noqa: F401
from .multi_transform import (  # noqa: F401
    dispatch_backward,
    dispatch_forward,
    finalize_backward,
    finalize_forward,
    multi_transform_backward,
    multi_transform_forward,
)
from .indices import (  # noqa: F401
    check_stick_duplicates,
    convert_index_triplets,
    create_spherical_cutoff_triplets,
    spherical_radius_for_fraction,
)
from .parallel.mesh import (  # noqa: F401
    ShardMesh,
    init_distributed,
    is_pencil2_mesh,
    make_fft_mesh,
    make_fft_mesh2,
    shutdown_distributed,
)
from .parameters import (  # noqa: F401
    DistributedParameters,
    LocalParameters,
    distribute_triplets,
    from_jax_distributed_params,
    from_jax_params,
    make_distributed_parameters,
    make_local_parameters,
)
from .transform import Transform, TransformFloat  # noqa: F401
from . import hostmesh, serve  # noqa: F401  (after the plans they serve)
from .types import (  # noqa: F401
    ExchangeType,
    ExecType,
    IndexFormat,
    ProcessingUnit,
    ScalingType,
    TransformType,
    SPFFT_EXCH_BUFFERED,
    SPFFT_EXCH_BUFFERED_BF16,
    SPFFT_EXCH_BUFFERED_FLOAT,
    SPFFT_EXCH_COMPACT_BUFFERED,
    SPFFT_EXCH_COMPACT_BUFFERED_BF16,
    SPFFT_EXCH_COMPACT_BUFFERED_FLOAT,
    SPFFT_EXCH_DEFAULT,
    SPFFT_EXCH_UNBUFFERED,
    SPFFT_EXEC_ASYNCHRONOUS,
    SPFFT_EXEC_SYNCHRONOUS,
    SPFFT_FULL_SCALING,
    SPFFT_INDEX_TRIPLETS,
    SPFFT_NO_SCALING,
    SPFFT_PU_GPU,
    SPFFT_PU_HOST,
    SPFFT_TRANS_C2C,
    SPFFT_TRANS_R2C,
)

__version__ = "0.3.0"  # the JAX package's version, which this port follows
# The reference API surface it mirrors (reference: CMakeLists.txt:2).
__reference_api_version__ = "1.0.2"
