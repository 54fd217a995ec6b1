"""Sparse frequency index handling.

Converts caller-supplied frequency index triplets into the z-stick layout
(reference: src/compression/indices.hpp:49-186), as vectorised numpy:

* a value's storage slot is ``stick_id * dim_z + z_storage`` (z-sticks contiguous in z)
* stick ids are assigned in ascending order of the xy key ``x_storage * dim_y + y_storage``
* negative ("centred") indices wrap modulo the dimension
* bounds are validated against either the non-negative or the centred interval,
  with the hermitian (R2C) restriction ``0 <= x <= dim_x // 2``

This is plan construction on the host; it runs once per Transform.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .errors import (
    DuplicateIndicesError,
    InvalidIndicesError,
    InvalidParameterError,
    OverflowError_,
)


def to_storage_index(dim: int, index: np.ndarray) -> np.ndarray:
    """Map centred indices into storage [0, dim) (reference: indices.hpp:49-55)."""
    return np.where(index < 0, index + dim, index)


def _validate_bounds(idx: np.ndarray, lo: int, hi: int) -> None:
    if idx.size and (int(idx.min()) < lo or int(idx.max()) > hi):
        raise InvalidIndicesError(
            f"frequency index out of bounds: allowed [{lo}, {hi}], "
            f"got [{int(idx.min())}, {int(idx.max())}]"
        )


def convert_index_triplets(
    hermitian_symmetry: bool,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    indices: np.ndarray | Sequence[int],
) -> tuple[np.ndarray, np.ndarray]:
    """Convert interleaved (x, y, z) triplets to (value_indices, stick_xy_indices).

    Returns int32 ``value_indices`` (flat slot ``stick_id * dim_z + z`` of each
    caller value) and int32 ``stick_xy_indices`` (sorted unique xy keys
    ``x * dim_y + y``; position == stick id). Centred indexing is detected
    from any negative index; hermitian symmetry restricts x to [0, dim_x//2]
    (reference: src/compression/indices.hpp:120-186).
    """
    triplets = np.asarray(indices, dtype=np.int64)
    if triplets.ndim == 1:
        if triplets.size % 3 != 0:
            raise InvalidParameterError("index triplet array length must be a multiple of 3")
        triplets = triplets.reshape(-1, 3)
    if triplets.ndim != 2 or triplets.shape[1] != 3:
        raise InvalidParameterError("indices must be (N, 3) or interleaved flat triplets")

    num_values = triplets.shape[0]
    if num_values > dim_x * dim_y * dim_z:
        raise InvalidParameterError("more values than grid points")

    x, y, z = triplets[:, 0], triplets[:, 1], triplets[:, 2]
    centered = bool(num_values) and bool((triplets < 0).any())

    # Allowed intervals; reference: src/compression/indices.hpp:137-148.
    max_x = (dim_x // 2 + 1 if (hermitian_symmetry or centered) else dim_x) - 1
    max_y = (dim_y // 2 + 1 if centered else dim_y) - 1
    max_z = (dim_z // 2 + 1 if centered else dim_z) - 1
    min_x = 0 if hermitian_symmetry else max_x - dim_x + 1
    min_y = max_y - dim_y + 1
    min_z = max_z - dim_z + 1
    _validate_bounds(x, min_x, max_x)
    _validate_bounds(y, min_y, max_y)
    _validate_bounds(z, min_z, max_z)

    xs = to_storage_index(dim_x, x)
    ys = to_storage_index(dim_y, y)
    zs = to_storage_index(dim_z, z)

    stick_xy_indices, stick_of_value = np.unique(xs * dim_y + ys, return_inverse=True)
    value_indices = stick_of_value.astype(np.int64) * dim_z + zs

    # Index tables are int32; reject plans whose stick table exceeds that range.
    if stick_xy_indices.size * dim_z >= 2**31 or dim_x * dim_y >= 2**31:
        raise OverflowError_("transform too large for 32-bit index arrays")
    if num_values and np.unique(value_indices).size != num_values:
        raise DuplicateIndicesError("duplicate frequency index triplets")

    return value_indices.astype(np.int32), stick_xy_indices.astype(np.int32)


def check_stick_duplicates(indices_per_shard: Sequence[np.ndarray]) -> None:
    """Raise if any z-stick (xy key) appears on more than one shard.

    Reference semantics: src/compression/indices.hpp:105-117.
    """
    if not len(indices_per_shard):
        return
    all_sticks = np.concatenate([np.asarray(s) for s in indices_per_shard])
    if all_sticks.size and np.unique(all_sticks).size != all_sticks.size:
        raise DuplicateIndicesError("a z-stick is owned by more than one shard")


def spherical_radius_for_fraction(fraction: float) -> float:
    """The radius fraction whose ball holds ``fraction`` of the cube's grid
    points (the normalised ball volume pi f^3 / 6 equals ``fraction``). Past
    pi / 6 the cube clips the ball, so the points it holds fall short of the
    request."""
    return float((6.0 * fraction / np.pi) ** (1.0 / 3.0))


def create_spherical_cutoff_triplets(
    dim_x: int, dim_y: int, dim_z: int, radius_fraction: float,
    hermitian_symmetry: bool = False,
) -> np.ndarray:
    """Centred index triplets inside a sphere of radius ``radius_fraction * dim/2``:
    the plane-wave DFT workload (sparsity model of the reference's
    tests/programs/benchmark.cpp:177-205)."""
    hx, hy, hz = dim_x // 2, dim_y // 2, dim_z // 2
    xs = np.arange(0 if hermitian_symmetry else -((dim_x - 1) // 2), hx + 1)
    ys = np.arange(-((dim_y - 1) // 2), hy + 1)
    zs = np.arange(-((dim_z - 1) // 2), hz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    r2 = (gx / max(hx, 1)) ** 2 + (gy / max(hy, 1)) ** 2 + (gz / max(hz, 1)) ** 2
    mask = r2 <= radius_fraction**2
    return np.stack([gx[mask], gy[mask], gz[mask]], axis=1).astype(np.int32)
