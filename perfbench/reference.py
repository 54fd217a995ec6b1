"""The plain reference the benchmark holds the port to.

Plain PyTorch, independent of the code under test: it imports nothing of
the port, and works out again from the benchmark's own inputs whatever the
port derives (the stick table, the hermitian fills, the DFT matrices).

- :func:`spherical_triplets`: a frozen copy of the plane-wave sphere's index
  triplets (centred indices inside a ball of radius ``fraction * dim / 2``,
  in ``(x, y, z)`` row-major order; for R2C only ``x >= 0``), made on the
  device. Both the port and the reference are given these triplets.
- :func:`backward`, :func:`forward_full`: the dense transform of the
  scattered values in complex128. The backward is unnormalised with the
  ``+i`` sign (``ifftn`` with ``norm="forward"``), the forward with ``-i``
  scaled by ``1 / N`` (SpFFT's ``ScalingType.FULL``). For R2C the grid is
  filled with each value's hermitian partner before the transform, and the
  space is the real part.

The control the check's limits are set against is not here: it is the
port's own path one precision step down (``precision="high"``), run by
``perfbench/calibrate.py`` through the harness's own window and check.
"""
from __future__ import annotations

import math

import torch


def radius_for_fraction(fraction: float) -> float:
    """The radius fraction whose ball holds ``fraction`` of the grid points."""
    return float((6.0 * fraction / math.pi) ** (1.0 / 3.0))


def spherical_triplets(dim_x, dim_y, dim_z, radius_fraction, hermitian, device="cpu"):
    """``(n, 3)`` int32 centred ``(x, y, z)`` triplets inside the sphere."""
    hx, hy, hz = dim_x // 2, dim_y // 2, dim_z // 2
    f64 = dict(dtype=torch.float64, device=device)
    xs = torch.arange(0 if hermitian else -((dim_x - 1) // 2), hx + 1, **f64)
    ys = torch.arange(-((dim_y - 1) // 2), hy + 1, **f64)
    zs = torch.arange(-((dim_z - 1) // 2), hz + 1, **f64)
    r2 = ((xs / max(hx, 1)) ** 2)[:, None, None] + ((ys / max(hy, 1)) ** 2)[None, :, None]
    r2 = r2 + ((zs / max(hz, 1)) ** 2)[None, None, :]
    ix, iy, iz = torch.nonzero(r2 <= radius_fraction**2, as_tuple=True)
    del r2
    return torch.stack([xs[ix], ys[iy], zs[iz]], dim=1).to(torch.int32)


def _wrapped(trip, dims):
    """Storage indices ``(z, y, x)`` of centred triplets in a ``(Z, Y, X)`` grid."""
    x, y, z = (trip[:, i].long() % dims[i] for i in range(3))
    return z, y, x


def scatter(values, trip, dims, r2c):
    """Values on the triplets -> the dense ``(Z, Y, X)`` complex128 spectrum;
    for R2C each value's partner at ``-k`` holds its conjugate."""
    dim_x, dim_y, dim_z = dims
    grid = torch.zeros((dim_z, dim_y, dim_x), dtype=torch.complex128, device=values.device)
    z, y, x = _wrapped(trip, dims)
    v = values.to(torch.complex128)
    if r2c:
        grid[(-z) % dim_z, (-y) % dim_y, (-x) % dim_x] = v.conj()
    grid[z, y, x] = v
    return grid


def gather(grid, trip, dims):
    z, y, x = _wrapped(trip, dims)
    return grid[z, y, x]


def backward(values, trip, dims, r2c):
    """Dense complex128 backward: the ``(Z, Y, X)`` space (real for R2C)."""
    space = torch.fft.ifftn(scatter(values, trip, dims, r2c), norm="forward")
    return space.real.contiguous() if r2c else space


def forward_full(space, trip, dims):
    """Dense complex128 forward with FULL scaling: the values on the triplets."""
    return gather(torch.fft.fftn(space.to(torch.complex128), norm="forward"), trip, dims)
