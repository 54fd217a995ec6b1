"""Transform metadata ("the plan").

The analogue of the reference's ``Parameters`` (reference:
src/parameters/parameters.cpp:43-180): index triplets become the z-stick
layout, and every static shape is fixed here, once, on the host. A
distributed plan adds the per-shard stick sets, the z-slab split and the
padded-uniform exchange geometry (the JAX package's ``spfft_tpu/parameters.py``,
copied).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from . import indices as _indices
from .errors import InvalidParameterError, MPIParameterMismatchError
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


@dataclasses.dataclass(frozen=True)
class DistributedParameters:
    """Metadata for a transform over P shards (reference:
    src/parameters/parameters.cpp:43-140). Per-shard arrays are stacked on
    axis 0 and padded: values to ``V_max`` (with the out-of-range sentinel
    ``S_max * dim_z``), sticks to ``S_max`` (x = ``dim_x_freq``, y = 0)."""

    transform_type: TransformType
    dim_x: int
    dim_y: int
    dim_z: int
    num_shards: int
    num_values_per_shard: np.ndarray  # (P,)
    num_sticks_per_shard: np.ndarray  # (P,)
    value_indices: np.ndarray  # (P, V_max) int32, stick * dim_z + z
    local_z_lengths: np.ndarray  # (P,)
    z_offsets: np.ndarray  # (P,)
    stick_x_all: np.ndarray  # (P, S_max) int32
    stick_y_all: np.ndarray  # (P, S_max) int32
    stick_xy_per_shard: tuple  # each shard's unpadded sorted xy keys
    zero_stick_shard: int  # owner of the (0, 0) stick, -1 if none
    zero_stick_row: int

    @property
    def dim_x_freq(self) -> int:
        if self.transform_type == TransformType.R2C:
            return self.dim_x // 2 + 1
        return self.dim_x

    @property
    def max_num_sticks(self) -> int:
        return int(self.stick_x_all.shape[1])

    @property
    def max_num_values(self) -> int:
        return int(self.value_indices.shape[1])

    @property
    def max_local_z_length(self) -> int:
        return int(self.local_z_lengths.max()) if self.num_shards else 0

    @property
    def total_size(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    def pack_z_map(self) -> np.ndarray:
        """``(P * L_max,)``: the global z of each packed exchange-plane slot,
        ``dim_z`` (out of range) on padding slots."""
        L = self.max_local_z_length
        out = np.full(self.num_shards * L, self.dim_z, dtype=np.int32)
        for r in range(self.num_shards):
            l, o = int(self.local_z_lengths[r]), int(self.z_offsets[r])
            out[r * L : r * L + l] = np.arange(o, o + l)
        return out

    def unpack_z_map(self) -> np.ndarray:
        """``(dim_z,)``: the packed exchange-plane slot of each global z."""
        L = self.max_local_z_length
        out = np.zeros(self.dim_z, dtype=np.int32)
        for r in range(self.num_shards):
            l, o = int(self.local_z_lengths[r]), int(self.z_offsets[r])
            out[o : o + l] = r * L + np.arange(l)
        return out


def make_distributed_parameters(
    transform_type: TransformType,
    dim_x: int,
    dim_y: int,
    dim_z: int,
    indices_per_shard: Sequence[np.ndarray],
    local_z_lengths: Sequence[int] | None = None,
) -> DistributedParameters:
    """Distributed metadata from per-shard index triplets, each shard owning
    whole z-sticks; ``local_z_lengths`` splits dim_z into slabs (default: the
    balanced split). Checks what the reference checks collectively: no stick
    on two shards (src/compression/indices.hpp:105-117) and a slab split that
    partitions dim_z (src/parameters/parameters.cpp:93-109)."""
    if dim_x <= 0 or dim_y <= 0 or dim_z <= 0:
        raise InvalidParameterError("transform dimensions must be positive")
    num_shards = len(indices_per_shard)
    if num_shards < 1:
        raise InvalidParameterError("need at least one shard")
    hermitian = TransformType(transform_type) == TransformType.R2C
    per_shard = [
        _indices.convert_index_triplets(hermitian, dim_x, dim_y, dim_z, trip)
        for trip in indices_per_shard
    ]
    stick_xy_per_shard = tuple(sticks for _, sticks in per_shard)
    _indices.check_stick_duplicates(stick_xy_per_shard)
    if local_z_lengths is None:
        base, rem = divmod(dim_z, num_shards)
        local_z_lengths = np.asarray(
            [base + (1 if r < rem else 0) for r in range(num_shards)], dtype=np.int64)
    else:
        local_z_lengths = np.asarray(local_z_lengths, dtype=np.int64).reshape(-1)
        if local_z_lengths.size != num_shards:
            raise MPIParameterMismatchError("one local_z_length per shard required")
        if local_z_lengths.sum() != dim_z or (local_z_lengths < 0).any():
            raise MPIParameterMismatchError("local_z_lengths must partition dim_z")
    z_offsets = np.concatenate([[0], np.cumsum(local_z_lengths)[:-1]])
    num_values = np.asarray([vi.size for vi, _ in per_shard], dtype=np.int64)
    num_sticks = np.asarray([s.size for _, s in per_shard], dtype=np.int64)
    s_max = max(1, int(num_sticks.max()))
    v_max = max(1, int(num_values.max()))
    dim_x_freq = dim_x // 2 + 1 if hermitian else dim_x
    value_indices = np.full((num_shards, v_max), s_max * dim_z, dtype=np.int32)
    stick_x_all = np.full((num_shards, s_max), dim_x_freq, dtype=np.int32)
    stick_y_all = np.zeros((num_shards, s_max), dtype=np.int32)
    zero_stick_shard, zero_stick_row = -1, 0
    for r, (vi, sticks) in enumerate(per_shard):
        value_indices[r, : vi.size] = vi
        stick_x_all[r, : sticks.size] = sticks // dim_y
        stick_y_all[r, : sticks.size] = sticks % dim_y
        if sticks.size and int(sticks[0]) == 0:
            zero_stick_shard, zero_stick_row = r, 0
    return DistributedParameters(
        transform_type=TransformType(transform_type),
        dim_x=int(dim_x), dim_y=int(dim_y), dim_z=int(dim_z), num_shards=num_shards,
        num_values_per_shard=num_values, num_sticks_per_shard=num_sticks,
        value_indices=value_indices, local_z_lengths=local_z_lengths, z_offsets=z_offsets,
        stick_x_all=stick_x_all, stick_y_all=stick_y_all,
        stick_xy_per_shard=stick_xy_per_shard,
        zero_stick_shard=zero_stick_shard, zero_stick_row=zero_stick_row,
    )


def stick_keys(triplets, dim_y: int) -> np.ndarray:
    """A sign-safe (x, y) stick key per value triplet, in the caller's index
    space: the grouping :func:`distribute_triplets` keeps whole."""
    t = np.asarray(triplets).reshape(-1, 3).astype(np.int64)
    return t[:, 0] * (4 * dim_y) + t[:, 1]


def distribute_triplets(triplets, num_shards: int, dim_y: int,
                        weights: Sequence[float] | None = None, *,
                        layout: tuple | None = None, dim_x: int | None = None) -> list:
    """Global triplets -> per-shard triplet arrays, z-sticks kept whole
    (reference: docs/source/details.rst:50-53), largest sticks first onto the
    shard with the least value count per weight (the reference tests'
    ``zStickDistribution``, tests/test_util/generate_indices.hpp:39-100); a
    shard of weight 0 gets nothing.

    ``layout=(P1, P2)`` splits for a 2-D pencil mesh (``dim_x`` required, to
    fold centred x indices): the x-sorted sticks are cut into P1 contiguous
    column groups balanced by value count, a group boundary never splitting
    an x column (an even split over the columns where that would leave a
    group empty), then each group's sticks go largest first over its
    column's P2 shards (shard ``a * P2 + b``). Every stick of group ``a``
    then lies in shard column ``a``, so the pencil engines' ownership-aligned
    x-groups keep exchange A inside the columns. ``weights`` are refused
    with ``layout``."""
    t = np.asarray(triplets).reshape(-1, 3)
    if num_shards < 1:
        raise InvalidParameterError("num_shards must be >= 1")
    uniq, inverse, counts = np.unique(stick_keys(t, dim_y), return_inverse=True,
                                      return_counts=True)
    inverse = inverse.reshape(-1)
    if layout is not None:
        stick_shard = _column_local_split(uniq, counts, num_shards, dim_y, layout, weights,
                                          dim_x)
        value_shard = stick_shard[inverse]
        return [t[value_shard == r] for r in range(num_shards)]
    weights = np.ones(num_shards) if weights is None else np.asarray(weights, dtype=np.float64)
    if weights.size != num_shards or (weights < 0).any() or weights.sum() == 0:
        raise InvalidParameterError("invalid shard weights")
    load = np.zeros(num_shards)
    stick_shard = np.zeros(counts.size, dtype=np.int64)
    for s in np.argsort(-counts):
        ratio = np.where(weights > 0, load / np.maximum(weights, 1e-300), np.inf)
        r = int(np.argmin(ratio))
        stick_shard[s] = r
        load[r] += counts[s]
    value_shard = stick_shard[inverse]
    return [t[value_shard == r] for r in range(num_shards)]


def _column_local_split(uniq, counts, num_shards, dim_y, layout, weights, dim_x):
    """The shard of each unique stick under ``layout=(P1, P2)``
    (:func:`distribute_triplets`)."""
    P1, P2 = int(layout[0]), int(layout[1])
    if P1 * P2 != num_shards:
        raise InvalidParameterError("layout does not match num_shards")
    if weights is not None:
        raise InvalidParameterError("weights are unsupported with layout")
    if dim_x is None:
        raise InvalidParameterError("layout requires dim_x")
    # storage x of each stick; rounding recovers a signed x exactly, since
    # |y| <= dim_y / 2 < 4 dim_y / 2
    raw_x = np.rint(uniq / (4 * dim_y)).astype(np.int64)
    storage_x = np.where(raw_x < 0, raw_x + dim_x, raw_x)
    xorder = np.argsort(storage_x, kind="stable")
    csum = np.cumsum(counts[xorder])
    group_of_sorted = np.minimum((csum - 1) * P1 // max(1, int(csum[-1])), P1 - 1)
    sx_sorted = storage_x[xorder]
    first_of_col = np.concatenate([[True], sx_sorted[1:] != sx_sorted[:-1]])
    col_sizes = np.diff(np.concatenate([np.flatnonzero(first_of_col), [sx_sorted.size]]))
    col_group = group_of_sorted[np.flatnonzero(first_of_col)]
    if not np.isin(np.arange(P1), col_group).all():
        n_cols = col_group.size
        col_group = np.minimum(np.arange(n_cols) * P1 // max(1, n_cols), P1 - 1)
    group_of_sorted = np.repeat(col_group, col_sizes)
    stick_shard = np.zeros(uniq.size, dtype=np.int64)
    for a in range(P1):
        members = xorder[group_of_sorted == a]
        load = np.zeros(P2)
        for s in members[np.argsort(-counts[members], kind="stable")]:
            b = int(np.argmin(load))
            stick_shard[s] = a * P2 + b
            load[b] += counts[s]
    return stick_shard


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


def from_jax_distributed_params(fields: Mapping) -> DistributedParameters:
    """The port's distributed plan from the JAX package's
    ``DistributedParameters``, given as a mapping of its plain fields (its
    ``dataclasses.asdict`` or ``vars``)."""
    arr = lambda name, dtype=np.int64: np.asarray(fields[name], dtype=dtype)
    num_shards = int(fields["num_shards"])
    value_indices = arr("value_indices", np.int32)
    if value_indices.shape[0] != num_shards:
        raise InvalidParameterError("value_indices has a row per shard")
    return DistributedParameters(
        transform_type=TransformType(int(fields["transform_type"])),
        dim_x=int(fields["dim_x"]), dim_y=int(fields["dim_y"]), dim_z=int(fields["dim_z"]),
        num_shards=num_shards,
        num_values_per_shard=arr("num_values_per_shard"),
        num_sticks_per_shard=arr("num_sticks_per_shard"),
        value_indices=value_indices,
        local_z_lengths=arr("local_z_lengths"), z_offsets=arr("z_offsets"),
        stick_x_all=arr("stick_x_all", np.int32), stick_y_all=arr("stick_y_all", np.int32),
        stick_xy_per_shard=tuple(np.asarray(s, dtype=np.int32)
                                 for s in fields["stick_xy_per_shard"]),
        zero_stick_shard=int(fields["zero_stick_shard"]),
        zero_stick_row=int(fields["zero_stick_row"]),
    )
