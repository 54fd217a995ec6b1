"""The ``Transform`` public API object.

A shape-specialised sparse 3-D FFT plan with the reference's surface
(reference: include/spfft/transform.hpp:56-318) and the JAX package's
signature. ``backward(values)`` maps packed complex values (triplet order) to
the space domain, ``(dim_z, dim_y, dim_x)``, complex for C2C and real for R2C;
``forward(space, scaling)`` maps back. Results are tensors on the plan's
``torch.device``: the CUDA card for ``ProcessingUnit.GPU``, the CPU for HOST.
"""
from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidParameterError
from .execution import from_pair
from .execution_mxu import MxuLocalExecution
from .grid import Grid, device_for_processing_unit
from .ops.fft import resolve_precision
from .parameters import LocalParameters, make_local_parameters
from .types import ExecType, IndexFormat, ProcessingUnit, ScalingType, TransformType


class Transform:
    """A sparse 3-D FFT plan on one device.

    ``engine`` is ``"auto"`` or ``"mxu"`` (the matrix-product engine, the only
    one ported; ``"xla"`` raises). Its y stage runs one of three plans, chosen
    as the JAX engine chooses (``SPFFT_TPU_SPARSE_Y``,
    ``SPFFT_TPU_SPARSE_Y_BLOCKS``, ``SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC``): dense,
    per-slot sparse (C2C) or blocked sparse (C2C and R2C).

    ``precision`` (any case) is the JAX package's matrix-product precision.
    In float32 on the card: ``"highest"`` FP32-accurate 3xTF32, ``"high"``
    bf16x3 (about 1e-5 relative on a 256^3 transform), ``"default"`` one
    bf16 pass (about 4e-3).
    Float64 plans accept the name and ignore it, as do CPU plans, whose plain
    products are exact float32 or float64.
    """

    def __init__(
        self,
        processing_unit,
        transform_type,
        dim_x,
        dim_y,
        dim_z,
        num_local_elements=None,
        indices=None,
        *,
        local_z_length=None,
        index_format: IndexFormat = IndexFormat.TRIPLETS,
        grid: Grid | None = None,
        dtype=None,
        engine: str = "auto",
        precision: str = "highest",
        device=None,
    ):
        if IndexFormat(index_format) != IndexFormat.TRIPLETS:
            raise InvalidParameterError("only SPFFT_INDEX_TRIPLETS is supported")
        if indices is None:
            raise InvalidParameterError("index triplets are required")
        indices = np.asarray(indices)
        if num_local_elements is not None:
            flat = indices.reshape(-1)
            if flat.size < 3 * num_local_elements:
                raise InvalidParameterError("fewer indices than num_local_elements")
            indices = flat[: 3 * int(num_local_elements)]
        # A local plan spans the full z-extent; 0 means unspecified.
        if local_z_length is not None:
            local_z_length = int(local_z_length)
            if local_z_length < 0:
                raise InvalidParameterError("local_z_length must be non-negative")
            if local_z_length not in (0, int(dim_z)):
                raise InvalidParameterError(
                    f"a local transform spans the full z-extent: local_z_length "
                    f"must be dim_z ({int(dim_z)}), got {local_z_length}"
                )
        params = make_local_parameters(
            TransformType(transform_type), dim_x, dim_y, dim_z, indices
        )
        self._setup(processing_unit, params, grid, dtype, engine, precision, device)

    @classmethod
    def from_parameters(
        cls, processing_unit, params: LocalParameters, *, grid: Grid | None = None,
        dtype=None, engine: str = "auto", precision: str = "highest", device=None,
    ) -> "Transform":
        """A plan from already built parameters, e.g. carried over from the
        JAX package by :func:`~spfft_tpu_torch.parameters.from_jax_params`."""
        self = cls.__new__(cls)
        self._setup(processing_unit, params, grid, dtype, engine, precision, device)
        return self

    def _setup(self, processing_unit, params, grid, dtype, engine, precision, device):
        self._processing_unit = ProcessingUnit(processing_unit)
        self._params = params
        self._grid = grid
        if grid is not None:
            # capacity validation, parity with src/spfft/transform_internal.cpp:45-137
            if (
                params.dim_x > grid.max_dim_x
                or params.dim_y > grid.max_dim_y
                or params.dim_z > grid.max_dim_z
            ):
                raise InvalidParameterError("transform dimensions exceed grid maxima")
            if params.num_sticks > grid.max_num_local_z_columns:
                raise InvalidParameterError("more z-columns than grid maximum")
            if not (self._processing_unit & grid.processing_unit):
                raise InvalidParameterError("transform processing unit not covered by grid")
            if device is None and (grid.device.type == "cpu") == (
                self._processing_unit == ProcessingUnit.HOST
            ):
                device = grid.device
        self._real_dtype = np.dtype(np.float64 if dtype is None else dtype)
        if self._real_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise InvalidParameterError("dtype must be float32 or float64")
        self._precision = resolve_precision(precision)
        if engine == "xla":
            raise InvalidParameterError("engine 'xla' is not yet ported")
        if engine not in ("auto", "mxu"):
            raise InvalidParameterError(f"unknown engine {engine!r}")
        self._engine = engine
        self._device = device_for_processing_unit(self._processing_unit, device)
        self._exec = MxuLocalExecution(params, self._real_dtype, self._device, self._precision)
        self._exec_mode = ExecType.SYNCHRONOUS
        self._space_data = None  # native (Y, X, Z): (re, im) for C2C, re for R2C

    # ---- transforms -----------------------------------------------------------

    def backward(self, values, output_location: ProcessingUnit | None = None):
        """Frequency -> space. Returns the ``(dim_z, dim_y, dim_x)`` space-domain
        tensor on the plan's device (complex for C2C, real for R2C).

        Reference: include/spfft/transform.hpp:286-298. The result is also
        retained for :meth:`space_domain_data` and input-less :meth:`forward`.
        """
        if output_location is not None:
            _validate_data_location(output_location)
        n = self._params.num_values
        size = values.numel() if torch.is_tensor(values) else np.asarray(values).size
        if size != n:
            raise InvalidParameterError(f"expected {n} frequency values, got {size}")
        re, im = self._exec.values_pair(values)
        self._space_data = self._exec.backward_pair(re, im)
        self._wait()
        return self._public_space(self._space_data)

    def forward(
        self,
        space=None,
        scaling: ScalingType = ScalingType.NONE,
        input_location: ProcessingUnit | None = None,
    ):
        """Space -> frequency. Returns the packed ``(num_local_elements,)``
        complex values on the plan's device.

        Reference: include/spfft/transform.hpp:259-283. ``space=None`` reads the
        retained space-domain data of the last :meth:`backward`.
        """
        if input_location is not None:
            _validate_data_location(input_location)
        if space is None:
            if self._space_data is None:
                raise InvalidParameterError(
                    "no space domain data: run backward first or pass an array"
                )
        else:
            self._retain_space(space)
        if self._is_r2c:
            re, im = self._space_data, None
        else:
            re, im = self._space_data
        out = from_pair(self._exec.forward_pair(re, im, ScalingType(scaling)))
        self._wait()
        return out

    def _retain_space(self, space) -> None:
        """A ``(Z, Y, X)`` array or tensor -> the retained native ``(Y, X, Z)`` data."""
        p = self._params
        if torch.is_tensor(space):
            t = space.to(self._device)
        else:  # a copy: the caller's array may be read-only
            t = torch.tensor(np.asarray(space), device=self._device)
        if t.numel() != p.total_size:
            raise InvalidParameterError(
                f"expected {p.total_size} space-domain elements, got {t.numel()}"
            )
        t = t.reshape(p.dim_z, p.dim_y, p.dim_x).permute(1, 2, 0)
        dt = self._exec.torch_dtype
        if self._is_r2c:
            self._space_data = (t.real if t.is_complex() else t).to(dt).contiguous()
        elif t.is_complex():
            self._space_data = (t.real.to(dt).contiguous(), t.imag.to(dt).contiguous())
        else:
            re = t.to(dt).contiguous()
            self._space_data = (re, torch.zeros_like(re))

    def _public_space(self, data):
        """Native ``(Y, X, Z)`` data -> the public ``(Z, Y, X)`` view."""
        arr = data if self._is_r2c else from_pair(data)
        return arr.permute(2, 0, 1)

    def _wait(self) -> None:
        if self._exec_mode == ExecType.SYNCHRONOUS and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def space_domain_data(self, processing_unit: ProcessingUnit | None = None):
        """The most recent space-domain result (reference: transform.hpp:245):
        a numpy ``(Z, Y, X)`` array for HOST (the default), the tensor on the
        plan's device for GPU."""
        if self._space_data is None:
            raise InvalidParameterError("no space domain data available yet")
        data = self._public_space(self._space_data)
        if processing_unit is not None and _validate_data_location(
            processing_unit
        ) == ProcessingUnit.GPU:
            return data
        return data.cpu().numpy()

    def clone(self) -> "Transform":
        """An independent transform with the same layout, engine and precision
        (reference: transform.hpp:133)."""
        return Transform.from_parameters(
            self._processing_unit, self._params, grid=self._grid,
            dtype=self._real_dtype, engine=self._engine, precision=self._precision,
            device=self._device,
        )

    # ---- accessors, parity with include/spfft/transform.hpp:147-245 -----------

    @property
    def _is_r2c(self) -> bool:
        return self._params.transform_type == TransformType.R2C

    @property
    def transform_type(self) -> TransformType:
        return self._params.transform_type

    @property
    def dim_x(self) -> int:
        return self._params.dim_x

    @property
    def dim_y(self) -> int:
        return self._params.dim_y

    @property
    def dim_z(self) -> int:
        return self._params.dim_z

    @property
    def local_z_length(self) -> int:
        return self._params.dim_z

    @property
    def local_z_offset(self) -> int:
        return 0

    @property
    def local_slice_size(self) -> int:
        return self.dim_x * self.dim_y * self.local_z_length

    @property
    def num_local_elements(self) -> int:
        return self._params.num_values

    @property
    def num_global_elements(self) -> int:
        return self._params.num_values

    @property
    def global_size(self) -> int:
        return self._params.total_size

    @property
    def processing_unit(self) -> ProcessingUnit:
        return self._processing_unit

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def device_id(self) -> int:
        return self._device.index or 0

    @property
    def dtype(self) -> np.dtype:
        return self._real_dtype

    @property
    def num_x_active(self) -> int:
        """Active x rows of the unique-x compaction (padded to ``SPFFT_TPU_XPAD``, 8)."""
        return self._exec.num_x_active

    @property
    def engine(self) -> str:
        return self._engine

    @property
    def precision(self) -> str:
        """The matrix-product precision: ``"highest"``, ``"high"`` or ``"default"``."""
        return self._precision

    def describe(self) -> dict:
        """The engine's plan decisions: precision, active x rows, the y plan."""
        return self._exec.describe()

    @property
    def grid(self) -> Grid | None:
        return self._grid

    @property
    def params(self) -> LocalParameters:
        return self._params

    def execution_mode(self) -> ExecType:
        return self._exec_mode

    def set_execution_mode(self, mode: ExecType) -> None:
        """Reference: include/spfft/transform.hpp:225. ASYNCHRONOUS returns once
        the kernels are enqueued; :meth:`synchronize` waits."""
        self._exec_mode = ExecType(mode)

    def synchronize(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)


def _validate_data_location(pu) -> ProcessingUnit:
    """A data location is exactly HOST or GPU."""
    try:
        pu = ProcessingUnit(pu)
    except ValueError as e:
        raise InvalidParameterError(f"invalid processing unit: {pu!r}") from e
    if pu not in (ProcessingUnit.HOST, ProcessingUnit.GPU):
        raise InvalidParameterError(f"invalid data location: {pu!r}")
    return pu

