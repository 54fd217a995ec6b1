"""Hermitian symmetry completion for R2C transforms.

For R2C the caller supplies only non-redundant frequencies (x in [0, Nx/2]);
the omitted mirror values are rebuilt before the backward transform, as in
the reference (reference: src/symmetry/symmetry_host.hpp:40-97):

* *stick symmetry*: the z-column at (x=0, y=0) is mirrored along z,
* *plane symmetry*: the x=0 plane is mirrored along y, after the z transform.

Both keep the reference's nonzero-guarded two-pass order: an entry is written
only where its mirror source is nonzero, upper half first, then the lower half
reading the values pass 1 may have written.
"""
from __future__ import annotations

import torch


def _mirror(a, axis: int):
    """m[..., j, ...] = a[..., (n-j) % n, ...] along ``axis``."""
    n = a.shape[axis]
    idx = (-torch.arange(n, device=a.device)) % n
    return a.index_select(axis, idx)


def hermitian_fill_1d(a, axis: int):
    """:func:`hermitian_fill_1d_pair` on one complex tensor. Returns a new tensor."""
    re, im = hermitian_fill_1d_pair(a.real, a.imag, axis)
    return torch.complex(re, im)


def hermitian_fill_1d_pair(re, im, axis: int):
    """Two-pass nonzero-guarded hermitian completion of the pair (re, im)
    along ``axis`` (conj = negate im; nonzero = either part nonzero).

    Pass 1 writes targets [ceil(n/2), n-1] from the lower half; pass 2 writes
    targets [1, ceil(n/2)-1] from the upper half as pass 1 left it. Index 0 is
    its own mirror and is never written. Returns new tensors.
    """
    n = re.shape[axis]
    if n <= 1:
        return re, im
    shape = [1] * re.dim()
    shape[axis] = n
    j = torch.arange(n, device=re.device).reshape(shape)
    upper_targets = j >= (n - n // 2)  # ceil(n/2) .. n-1 (incl. Nyquist for even n)
    lower_targets = (j >= 1) & (j < (n - n // 2))
    for targets in (upper_targets, lower_targets):
        mre, mim = _mirror(re, axis), _mirror(im, axis)
        write = targets & ((mre != 0) | (mim != 0))
        re = torch.where(write, mre, re)
        im = torch.where(write, -mim, im)
    return re, im
