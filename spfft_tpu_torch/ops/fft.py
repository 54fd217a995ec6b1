"""DFT stages as matrix products.

A batched length-N DFT is one ``(batch, N) @ (N, N)`` product: O(N^2) work in
place of O(N log N), but each stage is a dense contraction over the fixed
``(Y, X, Z)`` native layout, with no transpose anywhere in the pipeline. Two
tricks ride the matrices for free:

* **permutation folding**: a static permutation or padding of the input axis
  folds into the DFT matrix rows (``row_perm``/``num_rows`` of :func:`c2c_matrix`),
* **scale folding**: the forward 1/(NxNyNz) scaling rides the forward-z matrix
  (the reference applies it in the compress loop,
  src/compression/compression_host.hpp:63).

Complex data is carried as (re, im) pairs of real tensors. Every stage is one
launch of kernel K1 (:mod:`.complex_matmul`) on strided views; the einsum spec
of each stage names its contraction.
"""
from __future__ import annotations

import numpy as np

from ..errors import InvalidParameterError
from ..types import ScalingType
from .complex_matmul import complex_matmul as _k1

# Padding quantum of the active-x extent (the JAX package's SPFFT_TPU_XPAD default).
X_PAD_QUANTUM = 8


def c2c_matrix(n: int, sign: int, scale: float = 1.0, row_perm=None, num_rows=None):
    """(rows, n) DFT matrix W[j, k] = scale * exp(sign * 2i pi p(j) k / n).

    ``row_perm`` maps matrix row j to logical input index p(j); entries < 0
    give zero rows (padding slots). This is the permutation-folding hook.
    """
    if row_perm is None:
        row_perm = np.arange(n)
    row_perm = np.asarray(row_perm, dtype=np.int64)
    if num_rows is not None and num_rows != row_perm.size:
        if num_rows < row_perm.size:
            raise InvalidParameterError("num_rows smaller than row_perm")
        row_perm = np.concatenate(
            [row_perm, np.full(num_rows - row_perm.size, -1, dtype=np.int64)]
        )
    k = np.arange(n)
    w = scale * np.exp(sign * 2j * np.pi * np.outer(row_perm, k) / n)
    w[row_perm < 0] = 0.0
    return w


def r2c_matrices(n: int, scale: float = 1.0):
    """Real pair (A, B) of the forward R2C x-stage: F = f@A + i f@B,
    F[k] = scale * sum_l f[l] exp(-2i pi k l / n), k in [0, n//2]."""
    nf = n // 2 + 1
    l, k = np.arange(n), np.arange(nf)
    theta = 2 * np.pi * np.outer(l, k) / n
    return scale * np.cos(theta), -scale * np.sin(theta)


def c2r_matrices(n: int, scale: float = 1.0):
    """Real pair (A, B) of the backward C2R x-stage: f = Fr@A - Fi@B, the
    unnormalised inverse of the half spectrum with hermitian weights c_k
    (1 for k=0 and the even-n Nyquist bin, else 2)."""
    nf = n // 2 + 1
    k, l = np.arange(nf), np.arange(n)
    c = np.full(nf, 2.0)
    c[0] = 1.0
    if n % 2 == 0:
        c[-1] = 1.0
    theta = 2 * np.pi * np.outer(k, l) / n
    return scale * (c[:, None] * np.cos(theta)), scale * (c[:, None] * np.sin(theta))


def matrix_pair(w, real_dtype):
    """Complex matrix -> (re, im) real numpy pair in ``real_dtype``."""
    return w.real.astype(real_dtype), w.imag.astype(real_dtype)


def zy_stage_matrices(dim_z: int, dim_y: int, total_size: int, real_dtype):
    """The z/y DFT matrices: backward z and y, forward y, and the forward-z
    pair per scaling with the FULL 1/(NxNyNz) scale folded in.
    Returns (wz_b, wy_b, wy_f, wz_f) as numpy pairs, wz_f keyed by ScalingType."""
    rt = real_dtype
    wz_f = {
        ScalingType.NONE: matrix_pair(c2c_matrix(dim_z, -1), rt),
        ScalingType.FULL: matrix_pair(c2c_matrix(dim_z, -1, scale=1.0 / total_size), rt),
    }
    return (
        matrix_pair(c2c_matrix(dim_z, +1), rt),
        matrix_pair(c2c_matrix(dim_y, +1), rt),
        matrix_pair(c2c_matrix(dim_y, -1), rt),
        wz_f,
    )


def compact_x_extent(num_unique: int, dim_x_freq: int) -> int:
    """Active-x extent of the unique-x compaction: the count of x rows that
    carry a stick, padded to :data:`X_PAD_QUANTUM` and capped at the full extent."""
    a = -(-max(1, int(num_unique)) // X_PAD_QUANTUM) * X_PAD_QUANTUM
    return min(a, dim_x_freq)


def x_stage_matrices(dim_x: int, ux, num_rows: int, r2c: bool, real_dtype):
    """(backward, forward) x-stage matrix pairs over the active-x subset.

    Backward maps the ``num_rows``-padded active x-frequency extent to the
    full ``dim_x`` space extent ((A, X), zero rows on padding slots); forward
    is the transposed selection ((X, A)). For R2C the pairs are the real
    c2r/r2c matrices restricted the same way. ``ux`` entries of -1 give zero rows.
    """
    ux = np.asarray(ux, dtype=np.int64)
    rt = real_dtype

    def pad_rows(m):
        out = np.zeros((num_rows, m.shape[1]), m.dtype)
        valid = np.flatnonzero(ux >= 0)
        out[valid] = m[ux[valid]]
        return out

    if r2c:
        a, b = c2r_matrices(dim_x)  # (Xf, X)
        wx_b = (pad_rows(a).astype(rt), pad_rows(b).astype(rt))  # (A, X)
        a, b = r2c_matrices(dim_x)  # (X, Xf)
        wx_f = (pad_rows(a.T).T.astype(rt), pad_rows(b.T).T.astype(rt))  # (X, A)
        return wx_b, wx_f

    wx_b = matrix_pair(c2c_matrix(dim_x, +1, row_perm=ux, num_rows=num_rows), rt)
    # the DFT matrix is symmetric, so the column-subset forward matrix is the
    # transpose of the row-subset one
    wx_f = matrix_pair(c2c_matrix(dim_x, -1, row_perm=ux, num_rows=num_rows).T, rt)
    return wx_b, wx_f


# ---- the stage contractions ---------------------------------------------------
# Each spec is the einsum of one engine stage; each maps onto one K1 launch:
#   "sz,zk->sk"                  sticks (S, Z) @ W (Z, Z)
#   "yxz,yk->kxz", "ykz,yl->lkz" W^T (Y, Y) @ G viewed as (Y, A*Z)
#   "kxz,xl->klz", "yxz,xk->ykz" batched over the leading axis: W^T @ G[b]

_ROWS = ("sz,zk->sk",)
_LEFT = ("yxz,yk->kxz", "ykz,yl->lkz")
_BATCHED_LEFT = ("kxz,xl->klz", "yxz,xk->ykz")


def operands(spec: str, xr, xi, wr, wi):
    """The K1 operands ``(ar, ai, br, bi)`` of stage ``spec`` as strided views
    (no copy), and the shape its ``(batch, M, N)`` result takes."""
    opt = lambda t, f: None if t is None else f(t)
    if spec in _ROWS:
        ops = (xr[None], opt(xi, lambda t: t[None]), wr[None], opt(wi, lambda t: t[None]))
        return ops, (xr.shape[0], wr.shape[1])
    if spec in _LEFT:
        y = xr.shape[0]
        flat = lambda t: t.reshape(y, -1)[None]
        ops = (wr.mT[None], opt(wi, lambda t: t.mT[None]), flat(xr), opt(xi, flat))
        return ops, (wr.shape[1], *xr.shape[1:])
    if spec in _BATCHED_LEFT:
        nb = xr.shape[0]
        shared = lambda t: t.mT.expand(nb, -1, -1)
        return (shared(wr), opt(wi, shared), xr, xi), (nb, wr.shape[1], xr.shape[2])
    raise InvalidParameterError(f"no stage contraction for spec {spec!r}")


def contract(spec: str, xr, xi, wr, wi, want_imag: bool = True, constant=None):
    """``(xr + i xi)`` contracted with ``(wr + i wi)`` by ``spec``, as one K1
    launch on strided views. ``xi``/``wi`` of None are real parts; returns
    ``(yr, yi)`` with ``yi`` None when ``want_imag`` is False. ``constant`` is
    the plan's :class:`~.complex_matmul.Constant` of ``(wr, wi)``, if it has one."""
    ops, shape = operands(spec, xr, xi, wr, wi)
    cr, ci = _k1(*ops, want_imag, constant=constant)
    return cr.reshape(shape), (None if ci is None else ci.reshape(shape))


def complex_matmul(xr, xi, wr, wi, spec: str, constant=None):
    """Complex data with a complex matrix: the four-product form, one launch."""
    return contract(spec, xr, xi, wr, wi, constant=constant)


def real_in_matmul(x, wr, wi, spec: str, constant=None):
    """Real data with a complex matrix (R2C forward x-stage)."""
    return contract(spec, x, None, wr, wi, constant=constant)


def real_out_matmul(xr, xi, a, b, spec: str, constant=None):
    """Real part ``xr@A - xi@B`` only (C2R backward x-stage)."""
    return contract(spec, xr, xi, a, b, want_imag=False, constant=constant)[0]
