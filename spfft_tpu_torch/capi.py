"""Marshalling bridge for the port's native C/C++/Fortran API layer.

The native library (``spfft_tpu_torch/native/``, built into
``libspfft_tpu_torch.so`` by :func:`spfft_tpu_torch._build.build_native`)
embeds a CPython interpreter and drives the PyTorch core through the
functions in this module, the twin of the JAX package's ``capi`` module with
the same names, getter tables and buffer contracts. Everything crossing the
boundary is either a plain scalar or a writable/readonly buffer created by
the C++ side with ``PyMemoryView_FromMemory``: no numpy C API, no pybind11.

Layout contracts (all row-major, matching the public Python API):
- frequency values: ``num_local_elements`` complex numbers, interleaved
  (re, im) pairs of the transform's real dtype.
- space domain: ``(dim_z, dim_y, dim_x)`` slab; complex-interleaved for C2C,
  real for R2C (reference semantics: docs/source/details.rst:21-27).
- index triplets: ``3 * num_local_elements`` int32.
- distributed plans: per-shard counts and shard-major concatenated values.

Every pointer is host memory: an ``SPFFT_PU_GPU`` plan runs on the current
CUDA device and its inputs and results cross the host boundary here, each
with one ``copy_`` between the caller's memory (a ``torch.frombuffer`` view)
and the plan's device. A HOST distributed grid stacks its shards on the CPU,
a GPU one on the card; nothing falls back to the CPU where the card is
missing (:class:`~spfft_tpu_torch.errors.GPUNoDeviceError`, the C caller's
``SPFFT_GPU_NO_DEVICE_ERROR``). The precision of a plan is its dtype: no
process-wide setting changes.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from . import errors
from .grid import Grid
from .multi_transform import multi_transform_backward, multi_transform_forward
from .transform import Transform
from .types import ExchangeType, ExecType, ProcessingUnit, ScalingType, TransformType

__all__ = [
    "error_code",
    "grid_create",
    "grid_create_distributed",
    "grid_create_distributed2",
    "grid_get",
    "transform_create",
    "transform_create_from_grid",
    "transform_clone",
    "transform_get",
    "transform_set_execution_mode",
    "transform_backward",
    "transform_forward",
    "multi_backward",
    "multi_forward",
    "dist_transform_create",
    "dist_transform_get",
    "dist_transform_get_shard",
    "dist_backward",
    "dist_forward",
]

_SP_UNKNOWN = int(errors.ErrorCode.UNKNOWN)


def error_code(exc: BaseException) -> int:
    """Translate a Python exception into an ``SpfftError`` C enum value.

    Mirrors the reference's catch-GenericError-return-error_code pattern
    (reference: src/spfft/transform.cpp:184-195); the card's out-of-memory
    error is ``SPFFT_GPU_ALLOCATION_ERROR``."""
    if isinstance(exc, errors.GenericError):
        return int(exc.error_code)
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return int(errors.ErrorCode.INVALID_PARAMETER)
    if isinstance(exc, MemoryError):
        return int(errors.ErrorCode.ALLOCATION)
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return int(errors.ErrorCode.GPU_ALLOCATION)
    return _SP_UNKNOWN


def _view(buf, dtype: torch.dtype, count: int) -> torch.Tensor:
    """``count`` elements of caller memory as a CPU tensor, no copy. The C
    side hands inputs over as read-only memoryviews, on which
    ``torch.frombuffer`` warns that the tensor is writable: the library
    only reads them, so the warning is not passed on to the caller."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=dtype, count=count)


def _real_dtype(t) -> torch.dtype:
    return torch.float64 if np.dtype(t.dtype) == np.float64 else torch.float32


def _indices(buf) -> np.ndarray:
    """Caller int32 triplets, copied (the plan keeps them)."""
    return _view(buf, torch.int32, len(memoryview(buf)) // 4).clone().numpy()


def _is_r2c(t) -> bool:
    return int(t.transform_type) == int(TransformType.R2C)


def _values(t, buf, count: int) -> torch.Tensor:
    """``count`` interleaved complex values of caller memory, as a complex view."""
    return torch.view_as_complex(_view(buf, _real_dtype(t), 2 * count).view(count, 2))


def _space(t, buf, shape) -> torch.Tensor:
    """A caller space buffer as a ``shape`` tensor: real for R2C, complex
    for C2C."""
    n = int(np.prod(shape))
    if _is_r2c(t):
        return _view(buf, _real_dtype(t), n).view(shape)
    return _values(t, buf, n).view(shape)


# ---- creation ---------------------------------------------------------------


def grid_create(
    max_dim_x: int,
    max_dim_y: int,
    max_dim_z: int,
    max_num_local_z_columns: int,
    processing_unit: int,
    max_num_threads: int,
) -> Grid:
    return Grid(
        max_dim_x,
        max_dim_y,
        max_dim_z,
        max_num_local_z_columns,
        ProcessingUnit(processing_unit),
        max_num_threads,
    )


def transform_create(
    processing_unit: int,
    transform_type: int,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    num_local_elements: int,
    indices,
    double_precision: bool,
) -> Transform:
    return Transform(
        ProcessingUnit(processing_unit),
        TransformType(transform_type),
        dim_x,
        dim_y,
        dim_z,
        num_local_elements,
        _indices(indices),
        dtype=np.float64 if double_precision else np.float32,
    )


def transform_create_from_grid(
    grid: Grid,
    processing_unit: int,
    transform_type: int,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    local_z_length: int,
    num_local_elements: int,
    indices,
    double_precision: bool,
) -> Transform:
    return grid.create_transform(
        ProcessingUnit(processing_unit),
        TransformType(transform_type),
        dim_x,
        dim_y,
        dim_z,
        num_local_elements,
        _indices(indices),
        local_z_length=local_z_length if local_z_length > 0 else None,
        dtype=np.float64 if double_precision else np.float32,
    )


def transform_clone(t: Transform) -> Transform:
    return t.clone()


# ---- distributed (single-controller) ----------------------------------------
# The reference's MPI Grid ctor takes a communicator and each rank supplies its
# local part (reference: include/spfft/grid.hpp:89-91). Here ONE process drives
# every shard of a mesh stacked on one device, so the C caller passes per-shard
# counts and shard-major concatenated data.


def _make_dist_grid(
    mesh_factory,
    max_dim_x: int,
    max_dim_y: int,
    max_dim_z: int,
    max_num_local_z_columns: int,
    max_local_z_length: int,
    processing_unit: int,
    exchange_type: int,
    max_num_threads: int,
) -> Grid:
    """Shared distributed-grid construction; ``mesh_factory(device)`` builds
    the mesh (1-D or 2-D pencil): HOST on the CPU, GPU on the current CUDA
    device (None: :class:`GPUNoDeviceError` where there is none)."""
    pu = ProcessingUnit(processing_unit)
    return Grid(
        max_dim_x,
        max_dim_y,
        max_dim_z,
        max_num_local_z_columns,
        pu,
        max_num_threads,
        max_local_z_length=max_local_z_length if max_local_z_length > 0 else None,
        mesh=mesh_factory("cpu" if pu == ProcessingUnit.HOST else None),
        exchange_type=ExchangeType(exchange_type),
    )


def grid_create_distributed(
    max_dim_x: int,
    max_dim_y: int,
    max_dim_z: int,
    max_num_local_z_columns: int,
    max_local_z_length: int,
    num_shards: int,
    processing_unit: int,
    exchange_type: int,
    max_num_threads: int,
) -> Grid:
    from .parallel.mesh import make_fft_mesh

    return _make_dist_grid(
        lambda device: make_fft_mesh(num_shards, device=device),
        max_dim_x,
        max_dim_y,
        max_dim_z,
        max_num_local_z_columns,
        max_local_z_length,
        processing_unit,
        exchange_type,
        max_num_threads,
    )


def grid_create_distributed2(
    max_dim_x: int,
    max_dim_y: int,
    max_dim_z: int,
    max_num_local_z_columns: int,
    max_local_z_length: int,
    p1: int,
    p2: int,
    processing_unit: int,
    exchange_type: int,
    max_num_threads: int,
) -> Grid:
    """2-D pencil mesh grid (parallel/pencil2.py): transforms created from it
    use the z-slabs x y-slabs decomposition; same dist_* execution surface."""
    from .parallel.mesh import make_fft_mesh2

    return _make_dist_grid(
        lambda device: make_fft_mesh2(p1, p2, device=device),
        max_dim_x,
        max_dim_y,
        max_dim_z,
        max_num_local_z_columns,
        max_local_z_length,
        processing_unit,
        exchange_type,
        max_num_threads,
    )


def dist_transform_create(
    grid: Grid,
    processing_unit: int,
    transform_type: int,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    num_shards: int,
    shard_num_elements,
    indices,
    double_precision: bool,
):
    counts = _view(shard_num_elements, torch.int32, num_shards).tolist()
    flat = _indices(indices).reshape(-1, 3)
    if flat.shape[0] != sum(counts):
        raise errors.InvalidParameterError(
            "indices length does not match the sum of shard_num_elements"
        )
    per_shard, off = [], 0
    for n in counts:
        per_shard.append(flat[off : off + n])
        off += n
    return grid.create_transform(
        ProcessingUnit(processing_unit),
        TransformType(transform_type),
        dim_x,
        dim_y,
        dim_z,
        indices=per_shard,
        dtype=np.float64 if double_precision else np.float32,
    )


# ---- accessors --------------------------------------------------------------

_TRANSFORM_GETTERS = {
    "dim_x": lambda t: t.dim_x,
    "dim_y": lambda t: t.dim_y,
    "dim_z": lambda t: t.dim_z,
    "local_z_length": lambda t: t.local_z_length,
    "local_z_offset": lambda t: t.local_z_offset,
    "local_slice_size": lambda t: t.local_slice_size,
    "num_local_elements": lambda t: t.num_local_elements,
    "num_global_elements": lambda t: t.num_global_elements,
    "global_size": lambda t: t.global_size,
    "transform_type": lambda t: int(t.transform_type),
    "processing_unit": lambda t: int(t.processing_unit),
    "device_id": lambda t: t.device_id,
    "num_threads": lambda t: t.num_threads,
    "execution_mode": lambda t: int(t.execution_mode()),
}

_GRID_GETTERS = {
    "max_dim_x": lambda g: g.max_dim_x,
    "max_dim_y": lambda g: g.max_dim_y,
    "max_dim_z": lambda g: g.max_dim_z,
    "max_num_local_z_columns": lambda g: g.max_num_local_z_columns,
    "max_local_z_length": lambda g: g.max_local_z_length,
    "processing_unit": lambda g: int(g.processing_unit),
    "max_num_threads": lambda g: g.max_num_threads,
    "device_id": lambda g: 0,
    "num_shards": lambda g: g.num_shards,
    "has_mesh": lambda g: int(g.mesh is not None),
    # p1 of a 2-D pencil mesh, 0 for local/1-D grids (drives copy fidelity)
    "mesh_p1": lambda g: (
        int(g.mesh.shape[0]) if g.mesh is not None and g.mesh.shape is not None else 0
    ),
    "exchange_type": lambda g: int(g.exchange_type),
}


def transform_get(t: Transform, name: str) -> int:
    return int(_TRANSFORM_GETTERS[name](t))


def grid_get(g: Grid, name: str) -> int:
    return int(_GRID_GETTERS[name](g))


def transform_set_execution_mode(t: Transform, mode: int) -> None:
    t.set_execution_mode(ExecType(mode))


# ---- execution --------------------------------------------------------------


def _write_space(t, out: torch.Tensor, buf, shape) -> None:
    """One copy of a ``shape`` space result into a caller buffer (R2C:
    real, C2C: complex-interleaved), from whatever device it lies on."""
    _space(t, buf, shape).copy_(out.reshape(shape))


def _write_values(t, vals: torch.Tensor, buf, count: int) -> None:
    """One copy of ``count`` packed values into a caller buffer."""
    _values(t, buf, count).copy_(vals.reshape(-1))


def _local_shape(t) -> tuple:
    return (t.local_z_length, t.dim_y, t.dim_x)


def transform_backward(t: Transform, values_buf, space_out_buf) -> None:
    """Freq -> space; writes the (Z, Y, X) slab into ``space_out_buf``."""
    out = t.backward(_values(t, values_buf, t.num_local_elements))
    _write_space(t, out, space_out_buf, _local_shape(t))


def transform_forward(t: Transform, space_buf, values_out_buf, scaling: int) -> None:
    """Space -> freq; ``space_buf`` of None reads the retained space buffer
    (the reference's pointer-free forward overload)."""
    space = None if space_buf is None else _space(t, space_buf, _local_shape(t))
    vals = t.forward(space, ScalingType(scaling))
    _write_values(t, vals, values_out_buf, t.num_local_elements)


# ---- multi-transform --------------------------------------------------------


def multi_backward(transforms, values_bufs, space_out_bufs) -> None:
    """Pipelined batched backward (reference: include/spfft/multi_transform.hpp:48)."""
    values = [_values(t, b, t.num_local_elements) for t, b in zip(transforms, values_bufs)]
    outs = multi_transform_backward(list(transforms), values)
    for t, out, buf in zip(transforms, outs, space_out_bufs):
        _write_space(t, out, buf, _local_shape(t))


def multi_forward(transforms, space_bufs, values_out_bufs, scalings) -> None:
    spaces = [None if b is None else _space(t, b, _local_shape(t))
              for t, b in zip(transforms, space_bufs)]
    results = multi_transform_forward(
        list(transforms), spaces, [ScalingType(s) for s in scalings]
    )
    for t, vals, buf in zip(transforms, results, values_out_bufs):
        _write_values(t, vals, buf, t.num_local_elements)


# ---- distributed execution --------------------------------------------------

_DIST_GETTERS = {
    "dim_x": lambda t: t.dim_x,
    "dim_y": lambda t: t.dim_y,
    "dim_z": lambda t: t.dim_z,
    "num_shards": lambda t: t.num_shards,
    "num_global_elements": lambda t: t.num_global_elements,
    "global_size": lambda t: t.global_size,
    "transform_type": lambda t: int(t.transform_type),
    "processing_unit": lambda t: int(t.processing_unit),
    "exchange_type": lambda t: int(t.exchange_type),
    "exchange_wire_bytes": lambda t: t.exchange_wire_bytes(),
    "exchange_rounds": lambda t: t.exchange_rounds(),
    "execution_mode": lambda t: int(t.execution_mode()),
}

_DIST_SHARD_GETTERS = {
    "local_z_length": lambda t, r: t.local_z_length(r),
    "local_z_offset": lambda t, r: t.local_z_offset(r),
    "local_y_length": lambda t, r: t.local_y_length(r),
    "local_y_offset": lambda t, r: t.local_y_offset(r),
    "local_slice_size": lambda t, r: t.local_slice_size(r),
    "num_local_elements": lambda t, r: t.num_local_elements(r),
}


def dist_transform_get(t, name: str) -> int:
    return int(_DIST_GETTERS[name](t))


def dist_transform_get_shard(t, name: str, shard: int) -> int:
    return int(_DIST_SHARD_GETTERS[name](t, shard))


def _global_shape(t) -> tuple:
    return (t.dim_z, t.dim_y, t.dim_x)


def dist_backward(t, values_buf, space_out_buf) -> None:
    """Shard-major concatenated freq values -> global (Z, Y, X) space array."""
    vals = _values(t, values_buf, t.num_global_elements)
    counts = [t.num_local_elements(r) for r in range(t.num_shards)]
    out = t.backward(list(torch.split(vals, counts)))
    _write_space(t, out, space_out_buf, _global_shape(t))


def dist_forward(t, space_buf, values_out_buf, scaling: int) -> None:
    """Global (Z, Y, X) space array (or None for the retained buffer) ->
    shard-major concatenated freq values."""
    space = None if space_buf is None else _space(t, space_buf, _global_shape(t))
    res = t.forward(space, ScalingType(scaling))
    dst = _values(t, values_out_buf, t.num_global_elements)
    # one copy from the plan's device of the values, concatenated there
    dst.copy_(torch.cat([v.reshape(-1) for v in res]))
