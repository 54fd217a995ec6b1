"""Transform metadata ("the plan").

The analogue of the reference's local ``Parameters`` (reference:
src/parameters/parameters.cpp:143-180): index triplets become the z-stick
layout, and every static shape is fixed here, once, on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from . import indices as _indices
from .errors import InvalidParameterError
from .types import TransformType


@dataclasses.dataclass(frozen=True)
class LocalParameters:
    """Metadata for a single-device transform."""

    transform_type: TransformType
    dim_x: int
    dim_y: int
    dim_z: int
    num_values: int
    # Flat slot of each packed caller value inside the stick table (stick*dim_z + z).
    value_indices: np.ndarray
    # Sorted unique xy keys (x*dim_y + y); position == stick id.
    stick_xy_indices: np.ndarray

    @property
    def dim_x_freq(self) -> int:
        """Frequency-domain x extent (hermitian-reduced for R2C)."""
        if self.transform_type == TransformType.R2C:
            return self.dim_x // 2 + 1
        return self.dim_x

    @property
    def num_sticks(self) -> int:
        return int(self.stick_xy_indices.size)

    @property
    def stick_x(self) -> np.ndarray:
        return self.stick_xy_indices // self.dim_y

    @property
    def stick_y(self) -> np.ndarray:
        return self.stick_xy_indices % self.dim_y

    @property
    def total_size(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z


def make_local_parameters(
    transform_type: TransformType,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    indices: np.ndarray | Sequence[int],
) -> LocalParameters:
    """Build local transform metadata from index triplets
    (reference: src/parameters/parameters.cpp:143-180)."""
    if dim_x <= 0 or dim_y <= 0 or dim_z <= 0:
        raise InvalidParameterError("transform dimensions must be positive")
    hermitian = transform_type == TransformType.R2C
    value_indices, stick_xy = _indices.convert_index_triplets(
        hermitian, dim_x, dim_y, dim_z, indices
    )
    return LocalParameters(
        transform_type=TransformType(transform_type),
        dim_x=int(dim_x),
        dim_y=int(dim_y),
        dim_z=int(dim_z),
        num_values=int(value_indices.size),
        value_indices=value_indices,
        stick_xy_indices=stick_xy,
    )


def from_jax_params(fields: Mapping) -> LocalParameters:
    """The port's plan from the JAX package's ``LocalParameters``, given as a
    mapping of its plain fields (``transform_type``, ``dim_x/y/z``,
    ``num_values``, ``value_indices``, ``stick_xy_indices``)."""
    value_indices = np.asarray(fields["value_indices"], dtype=np.int32)
    stick_xy = np.asarray(fields["stick_xy_indices"], dtype=np.int32)
    if value_indices.size != int(fields["num_values"]):
        raise InvalidParameterError("num_values does not match value_indices")
    return LocalParameters(
        transform_type=TransformType(int(fields["transform_type"])),
        dim_x=int(fields["dim_x"]),
        dim_y=int(fields["dim_y"]),
        dim_z=int(fields["dim_z"]),
        num_values=int(fields["num_values"]),
        value_indices=value_indices,
        stick_xy_indices=stick_xy,
    )
