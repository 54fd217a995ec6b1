"""One rank's share of a cell that runs over a group, and the assembly of
what the ranks produce back into the global order the check reads.

A configuration with ``ranks`` runs a slab ``DistributedTransform``, one
shard a process (:mod:`perfbench.ranks`). Rank ``r`` holds:

- the values of its shard's triplets, ``(bands, 2, V_max)``: the columns of
  the global ``(bands, 2, n)`` values (:func:`perfbench.inputs.band_values`)
  at its triplets' rows, in the plan's shard order, zero past its count;
- its z-slab of the potential in the plan's native layout, ``(Y, X, 1,
  L_max)``: planes ``z0 .. z0 + length`` of the global ``(Y, X, Z)`` one,
  zero on the padding planes (which the plan neither writes nor reads).

Each band's result comes back as the rank's ``(2, V_max)`` values, each
sampled space as its ``(planes, Y, X, L_max)`` slab; :func:`gather_values`
and :func:`gather_spaces` bring them to rank 0 in the global triplet order
and in ``(Y, X, Z)``. :func:`exchange_bytes_per_pair` counts the bytes the
exchange has to move, the numerator of ``exchange_roofline``.
"""
from __future__ import annotations

import torch

from .drive import space_parts

# bands a gather carries at once: 32 bands of a 256^3 15 % shard are about 160 MB
GATHER_BANDS = 32


def storage_keys(trip: torch.Tensor, dims: tuple) -> torch.Tensor:
    """One int64 key a triplet: its storage ``(x, y, z)`` in the grid, row-major."""
    dim_x, dim_y, dim_z = dims
    x, y, z = (trip[:, i].long() % d for i, d in enumerate((dim_x, dim_y, dim_z)))
    return (x * dim_y + y) * dim_z + z


def shard_rows(trip: torch.Tensor, shard_trip: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The rows of the global triplets ``trip`` that hold ``shard_trip``'s,
    in ``shard_trip``'s order; raises where one is not among them."""
    keys = storage_keys(trip, dims)
    order = torch.argsort(keys)
    want = storage_keys(shard_trip.to(trip.device), dims)
    pos = torch.searchsorted(keys[order], want).clamp_(max=keys.numel() - 1)
    rows = order[pos]
    if not torch.equal(keys[rows], want):
        raise ValueError("a shard holds a triplet the global triplets do not")
    return rows


def local_values(values: torch.Tensor, rows: torch.Tensor, v_max: int) -> torch.Tensor:
    """The ``(bands, 2, V_max)`` values of a shard: the global values'
    columns at ``rows``, zero past them."""
    out = values.new_zeros((values.shape[0], 2, v_max))
    out[:, :, :rows.numel()] = values[:, :, rows]
    return out


def local_potential(potential: torch.Tensor, z0: int, length: int, l_max: int) -> torch.Tensor:
    """A rank's ``(Y, X, 1, L_max)`` slab of the global ``(Y, X, Z)``
    potential: planes ``z0 .. z0 + length``, zero on the padding planes."""
    dim_y, dim_x, _ = potential.shape
    out = potential.new_zeros((dim_y, dim_x, 1, l_max))
    out[:, :, 0, :length] = potential[:, :, z0:z0 + length]
    return out


def exchange_bytes_per_pair(shard_trip, dims: tuple, local_z_length: int,
                            itemsize: int = 8) -> int:
    """The bytes a rank's exchange has to move a pair: each of its sticks
    sends the ``Z - local_z_length`` planes that other ranks hold in the
    backward and receives them in the forward, ``itemsize`` bytes a complex
    value (8: complex64). A discipline's padding is not counted."""
    dim_x, dim_y, _ = dims
    trip = torch.as_tensor(shard_trip)
    sticks = torch.unique((trip[:, 0].long() % dim_x) * dim_y + trip[:, 1].long() % dim_y).numel()
    return 2 * sticks * (dims[2] - int(local_z_length)) * itemsize


def flat_values(result, v_max: int) -> torch.Tensor | None:
    """A forward's ``(re, im)`` values as one ``(2, V_max)`` tensor; None stays None."""
    if result is None:
        return None
    return torch.stack([part.reshape(-1)[:v_max] for part in result])


def slab(space) -> torch.Tensor:
    """A rank's native space, ``(Y, X, 1, L_max)`` parts, as one ``(planes,
    Y, X, L_max)`` tensor."""
    return torch.stack([part[:, :, 0] for part in space_parts(space)])


def _gather(tensor: torch.Tensor, group, rank: int, world: int) -> list | None:
    """``tensor`` of every rank, on rank 0 (None elsewhere)."""
    import torch.distributed as dist

    parts = [torch.empty_like(tensor) for _ in range(world)] if rank == 0 else None
    dist.gather(tensor, parts, dst=0, group=group)
    return parts


def gather_values(results: list, rows: list, n: int, v_max: int, group, rank: int,
                  world: int, device, dtype=torch.float32) -> list | None:
    """Every band's ``(2, n)`` result in the global triplet order, on rank 0
    (None elsewhere): ``results`` holds this rank's ``(2, V_max)`` a band,
    ``rows`` every rank's :func:`shard_rows`. A band that any rank left
    without a result is None."""
    bands = len(results)
    have = torch.tensor([r is not None for r in results], dtype=torch.uint8, device=device)
    have = _gather(have, group, rank, world)
    out = torch.zeros((bands, 2, n), dtype=dtype, device=device) if rank == 0 else None
    for b0 in range(0, bands, GATHER_BANDS):
        block = torch.zeros((min(GATHER_BANDS, bands - b0), 2, v_max), dtype=dtype,
                            device=device)
        for i, r in enumerate(results[b0:b0 + block.shape[0]]):
            if r is not None:
                block[i] = r
        parts = _gather(block, group, rank, world)
        if rank == 0:
            for s, part in enumerate(parts):
                out[b0:b0 + block.shape[0], :, rows[s]] = part[:, :, :rows[s].numel()]
    if rank != 0:
        return None
    whole = torch.stack(have).all(dim=0).tolist()
    return [out[b] if whole[b] else None for b in range(bands)]


def gather_spaces(kept: dict, sampled: list, shape: tuple, lengths: list, group, rank: int,
                  world: int, device, dtype=torch.float32) -> dict | None:
    """The sampled bands' spaces, ``(planes, Y, X, Z)`` each, on rank 0 (None
    elsewhere): ``kept`` holds this rank's :func:`slab` a band, of
    ``shape``; a band some rank kept no slab of is left out."""
    out = {}
    for b in sorted(sampled):
        mine = kept.get(b)
        block = torch.zeros(shape, dtype=dtype, device=device) if mine is None else mine
        have = _gather(torch.tensor([mine is not None], dtype=torch.uint8, device=device),
                       group, rank, world)
        parts = _gather(block.contiguous(), group, rank, world)
        if rank == 0 and all(bool(h) for h in have):
            out[b] = torch.cat([p[..., :length] for p, length in zip(parts, lengths)], dim=-1)
    return out if rank == 0 else None
