"""The ``Grid`` public API object.

A Grid declares maximum transform extents and stick counts up front and hands
out transforms that must fit inside it (reference: include/spfft/grid.hpp:49-205).
Buffers belong to PyTorch's allocator, so what remains is capacity validation
and the binding of a processing unit to a ``torch.device``; a grid built with
a ``mesh`` (the reference's MPI Grid, grid.hpp:89-91) hands out
:class:`~spfft_tpu_torch.distributed.DistributedTransform` plans.
"""
from __future__ import annotations

import torch

from .errors import GPUNoDeviceError, InvalidParameterError, OverflowError_
from .types import ExchangeType, ProcessingUnit


def device_for_processing_unit(processing_unit, device=None) -> torch.device:
    """The ``torch.device`` a plan of ``processing_unit`` runs on.

    An explicit ``device`` wins. HOST is the CPU; GPU is the current CUDA
    device. Asking for the card where there is none raises
    :class:`GPUNoDeviceError`; nothing falls back to the CPU.
    """
    pu = ProcessingUnit(processing_unit)
    if device is not None:
        device = torch.device(device)
    elif pu == ProcessingUnit.HOST:
        device = torch.device("cpu")
    else:
        device = torch.device("cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise GPUNoDeviceError("ProcessingUnit.GPU asked for, but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class Grid:
    """Capacity envelope and device binding for transforms.

    Reference ctors: include/spfft/grid.hpp:65-66 (local), :89-91 (distributed:
    ``max_local_z_length``, the ``mesh`` and its ``exchange_type``).
    """

    def __init__(
        self,
        max_dim_x: int,
        max_dim_y: int,
        max_dim_z: int,
        max_num_local_z_columns: int,
        processing_unit: ProcessingUnit = ProcessingUnit.HOST,
        max_num_threads: int = -1,
        *,
        max_local_z_length: int | None = None,
        mesh=None,
        exchange_type: ExchangeType = ExchangeType.DEFAULT,
        device=None,
    ):
        if min(max_dim_x, max_dim_y, max_dim_z) < 1:
            raise InvalidParameterError("grid dimensions must be positive")
        if max_num_local_z_columns < 0:
            raise InvalidParameterError("max_num_local_z_columns must be non-negative")
        if max_dim_x * max_dim_y * max_dim_z >= 2**62:
            raise OverflowError_("grid too large")
        self._max_dim_x = int(max_dim_x)
        self._max_dim_y = int(max_dim_y)
        self._max_dim_z = int(max_dim_z)
        self._max_num_local_z_columns = int(max_num_local_z_columns)
        self._max_local_z_length = int(
            max_dim_z if max_local_z_length is None else max_local_z_length)
        self._processing_unit = ProcessingUnit(processing_unit)
        self._max_num_threads = max_num_threads
        self._mesh = mesh
        self._exchange_type = ExchangeType(exchange_type)
        if mesh is not None:
            if device is not None:
                raise InvalidParameterError("a mesh grid's device is its mesh's")
            device = mesh.device
        self._device = device_for_processing_unit(self._processing_unit, device)

    @property
    def max_dim_x(self) -> int:
        return self._max_dim_x

    @property
    def max_dim_y(self) -> int:
        return self._max_dim_y

    @property
    def max_dim_z(self) -> int:
        return self._max_dim_z

    @property
    def max_num_local_z_columns(self) -> int:
        return self._max_num_local_z_columns

    @property
    def max_local_z_length(self) -> int:
        return self._max_local_z_length

    @property
    def mesh(self):
        return self._mesh

    @property
    def exchange_type(self) -> ExchangeType:
        return self._exchange_type

    @property
    def num_shards(self) -> int:
        """Shards of the grid's mesh (1 for a local grid)."""
        return 1 if self._mesh is None else self._mesh.num_shards

    @property
    def processing_unit(self) -> ProcessingUnit:
        return self._processing_unit

    @property
    def max_num_threads(self) -> int:
        return self._max_num_threads

    @property
    def device(self) -> torch.device:
        return self._device

    def report(self) -> dict:
        """Grid card: the capacity envelope and bindings that transforms made
        from this grid inherit, the JAX package's ``Grid.report()`` (the
        grid-level slice of :meth:`Transform.report`'s plan card)."""
        card = {
            "kind": "grid",
            "max_dims": [self._max_dim_x, self._max_dim_y, self._max_dim_z],
            "max_num_local_z_columns": self._max_num_local_z_columns,
            "max_local_z_length": self._max_local_z_length,
            "processing_unit": self._processing_unit.name,
            "num_shards": self.num_shards,
            "exchange_type": self._exchange_type.name,
        }
        if self._mesh is None:
            card["device"] = str(self._device)
        else:
            card["mesh"] = {"fft": int(self._mesh.num_shards)}
        return card

    def create_transform(
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
        dtype=None,
        engine: str = "auto",
        precision: str = "highest",
        device=None,
        policy: str | None = None,
        guard: bool | None = None,
        verify=None,
        overlap: int | None = None,
        fuse=None,
    ):
        """A transform bound to this grid (reference: include/spfft/grid.hpp:138-141),
        with :class:`~spfft_tpu_torch.transform.Transform`'s options; a mesh
        grid hands out a :class:`~spfft_tpu_torch.distributed.DistributedTransform`
        (``indices`` per shard or global, ``local_z_length`` per shard)."""
        if self._mesh is not None:
            if device is not None:
                raise InvalidParameterError(
                    "device= applies to local transforms; distributed plans live on the mesh")
            from .distributed import DistributedTransform

            return DistributedTransform(
                processing_unit, transform_type, dim_x, dim_y, dim_z, indices,
                mesh=self._mesh, local_z_lengths=local_z_length,
                exchange_type=self._exchange_type, grid=self, dtype=dtype, engine=engine,
                precision=precision, policy=policy, guard=guard, verify=verify,
                overlap=overlap, fuse=fuse,
            )
        if overlap is not None:
            raise InvalidParameterError(
                "overlap= applies to distributed plans only (local transforms have no "
                "exchange to chunk)")
        from .transform import Transform

        return Transform(
            processing_unit, transform_type, dim_x, dim_y, dim_z,
            num_local_elements, indices, local_z_length=local_z_length, grid=self,
            dtype=dtype, engine=engine, precision=precision, device=device, policy=policy,
            guard=guard, verify=verify, fuse=fuse,
        )
