"""The benchmark's inputs, made from ``--seed`` on the device.

Every band of a configuration is one set of frequency values on the
configuration's triplets: ``(bands, 2, n)`` float32 (real and imaginary
planes), drawn by one ``torch.Generator`` on the device in one call. For R2C
the values are made hermitian-consistent where the stored half of the
spectrum holds both ``k`` and ``-k`` (the ``x == 0`` plane): the partner of
each pair takes the conjugate of the other, and a self-conjugate point is
real. The potential each pair's space is multiplied by (:func:`potential`)
is drawn from the seed as well. The seed changes the values, the potential
and the sampled bands, never a size.
"""
from __future__ import annotations

import hashlib
import random

import torch

from . import reference


def dims(cfg: dict) -> tuple:
    return tuple(int(d) for d in cfg["grid"])


def is_r2c(cfg: dict) -> bool:
    return cfg["transform"] == "r2c"


def triplets(cfg: dict, device) -> torch.Tensor:
    """The configuration's ``(n, 3)`` int32 triplets of the plane-wave
    sphere, on ``device``."""
    return reference.spherical_triplets(*dims(cfg),
                                        reference.radius_for_fraction(cfg["sphere_fraction"]),
                                        is_r2c(cfg), device=device)


def generator(seed: int, device, stream: str = "") -> torch.Generator:
    """A generator seeded by a hash of ``seed`` and ``stream`` (one stream
    of draws per purpose); ``seed`` may be any whole number: seeds that
    differ only above their low 32 bits still differ on the CPU, whose
    generator keeps only those."""
    digest = hashlib.sha256((str(int(seed)) + stream).encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def band_values(cfg: dict, trip: torch.Tensor, seed: int, device) -> torch.Tensor:
    """``(bands, 2, n)`` float32 values of every band, from ``seed``."""
    values = torch.randn((int(cfg["bands"]), 2, trip.shape[0]), generator=generator(seed, device),
                         device=device, dtype=torch.float32)
    if is_r2c(cfg):
        hermitian_plane(values, trip, dims(cfg))
    return values


def potential(cfg: dict, layout: str, seed: int, device) -> torch.Tensor:
    """A real local potential ``V(r)`` on the grid, float32 in the space's
    native ``layout`` (``"yxz"`` or ``"zyx"``), uniform in ``[0.5, 1.5)``:
    what a plane-wave code multiplies each band's space by between the
    backward and the forward (``V_eff`` applied to the wavefunction)."""
    size = dict(zip("xyz", dims(cfg)))
    v = torch.rand(tuple(size[a] for a in layout), generator=generator(seed, device, "potential"),
                   device=device, dtype=torch.float32)
    return v.add_(0.5)


def hermitian_plane(values: torch.Tensor, trip: torch.Tensor, grid: tuple) -> None:
    """In place: on the ``x == 0`` plane, the value at ``(0, -y, -z)`` is the
    conjugate of the one at ``(0, y, z)`` (the lower storage key keeps its
    draw), and a point that is its own partner is real."""
    _, dim_y, dim_z = grid
    rows = torch.nonzero(trip[:, 0] == 0, as_tuple=True)[0]
    y = trip[rows, 1].long() % dim_y
    z = trip[rows, 2].long() % dim_z
    key = y * dim_z + z
    partner_key = ((-y) % dim_y) * dim_z + (-z) % dim_z
    table = torch.full((dim_y * dim_z,), -1, dtype=torch.long, device=trip.device)
    table[key] = rows
    partner = table[partner_key]
    follow = (partner_key < key) & (partner >= 0)
    values[:, 0, rows[follow]] = values[:, 0, partner[follow]]
    values[:, 1, rows[follow]] = -values[:, 1, partner[follow]]
    values[:, 1, rows[key == partner_key]] = 0.0


def sampled_bands(seed: int, bands: int, count: int) -> list:
    """The bands whose backward spaces the check compares, drawn from ``seed``."""
    return sorted(random.Random(int(seed)).sample(range(bands), min(count, bands)))
