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

from .. import knobs
from ..errors import InvalidParameterError
from ..types import ScalingType
from .complex_matmul import BF16_CONSTANT, PRECISIONS
from .complex_matmul import complex_matmul as _k1


def resolve_precision(precision) -> str:
    """A matrix-product precision name, any case, -> ``"highest"``, ``"high"``
    or ``"default"`` (the JAX package's ``lax.Precision`` names). Float32 runs
    K1 at that precision: FP32-accurate 3xTF32, bf16x3 or one bf16 pass."""
    key = str(precision).lower()
    if key not in PRECISIONS:
        raise InvalidParameterError(
            f"unknown matmul precision {precision!r} (expected one of {sorted(PRECISIONS)})"
        )
    return key


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


TWIDDLE_BF16_ENV = "SPFFT_TPU_TWIDDLE_BF16"


def twiddle_bf16_enabled() -> bool:
    """``SPFFT_TPU_TWIDDLE_BF16``: the matrix-product engines' DFT stage
    matrices rounded to bfloat16 (float32 plans only; a float64 plan keeps
    the precision it asked for). The JAX package stores them in bfloat16 and
    its contractions widen them to float32; here they are rounded and kept in
    float32, so both give the same numbers. At ``"highest"`` K1 then runs its
    ``"highest-bf16"`` form (:func:`k1_form`), which reads the constant as
    bfloat16, half its bytes; at ``"high"`` and ``"default"`` the knob only
    rounds. Such a plan is about 1e-3 from the exact transform, not within
    ``"highest"``'s bar: its card says so (``execution.k1_form``,
    ``execution.twiddle_dtype``)."""
    return knobs.get_bool(TWIDDLE_BF16_ENV)


def twiddle_dtype(real_dtype) -> str:
    """The dtype a plan's DFT matrices are exact in: ``"bfloat16"`` for a
    float32 plan under :func:`twiddle_bf16_enabled`, else ``real_dtype``'s
    name (the plan card's ``execution.twiddle_dtype``)."""
    if np.dtype(real_dtype) == np.dtype(np.float32) and twiddle_bf16_enabled():
        return "bfloat16"
    return np.dtype(real_dtype).name


def k1_form(precision: str, real_dtype) -> str:
    """K1's form for a plan at ``precision``: ``"highest-bf16"`` (half the
    constant's bytes, two tensor-core products for three) for a float32
    ``"highest"`` plan under :func:`twiddle_bf16_enabled`, whose matrices
    :func:`twiddle` makes exact in bfloat16; else the precision itself (at
    ``"high"`` and ``"default"`` the knob only rounds)."""
    if (precision == "highest" and np.dtype(real_dtype) == np.dtype(np.float32)
            and twiddle_bf16_enabled()):
        return BF16_CONSTANT
    return precision


def twiddle(m, real_dtype):
    """A real DFT stage matrix in ``real_dtype``, rounded to bfloat16 (to
    nearest, ties to even) under :func:`twiddle_bf16_enabled`."""
    m = np.asarray(m)
    if np.dtype(real_dtype) == np.dtype(np.float32) and twiddle_bf16_enabled():
        # bfloat16 keeps 8 significant bits: round the mantissa once, from
        # the float64 matrix, as a direct cast to bfloat16 does
        frac, exp = np.frexp(m.astype(np.float64))
        m = np.ldexp(np.rint(frac * 256.0), exp - 8)
    return m.astype(real_dtype)


def matrix_pair(w, real_dtype):
    """Complex matrix -> (re, im) real numpy pair in ``real_dtype`` (rounded
    to bfloat16 under ``SPFFT_TPU_TWIDDLE_BF16``)."""
    return twiddle(w.real, real_dtype), twiddle(w.imag, real_dtype)


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
    carry a stick, padded to the ``SPFFT_TPU_XPAD`` quantum (default 8) and
    capped at the full extent."""
    quantum = knobs.get_int("SPFFT_TPU_XPAD")
    a = -(-max(1, int(num_unique)) // quantum) * quantum
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
        wx_b = (twiddle(pad_rows(a), rt), twiddle(pad_rows(b), rt))  # (A, X)
        a, b = r2c_matrices(dim_x)  # (X, Xf)
        wx_f = (twiddle(pad_rows(a.T).T, rt), twiddle(pad_rows(b.T).T, rt))  # (X, A)
        return wx_b, wx_f

    wx_b = matrix_pair(c2c_matrix(dim_x, +1, row_perm=ux, num_rows=num_rows), rt)
    # the DFT matrix is symmetric, so the column-subset forward matrix is the
    # transpose of the row-subset one
    wx_f = matrix_pair(c2c_matrix(dim_x, -1, row_perm=ux, num_rows=num_rows).T, rt)
    return wx_b, wx_f


# ---- sparse-y planning ---------------------------------------------------------
# The y stage contracts only the rows that carry sticks. Copied from the JAX
# package (spfft_tpu/ops/fft.py), numpy only, with the same engagement policy.

# Per-slot sparse-y engages below Sy/Y = 0.6 (the integer test 5 Sy < 3 Y in
# plan_sparse_y); the value that describe_sparse_y reports.
SPARSE_Y_CROSSOVER = 0.6


def sparse_y_blocked_frac() -> float:
    """Blocked sparse-y engages when its padded bucket rows stay under this
    fraction of the dense extent (``SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC``, 0.8)."""
    return knobs.get_float("SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC")


def describe_sparse_y(per_slot: bool, blocked_buckets, sy: int = 0) -> dict:
    """The engaged sparse-y variant and the thresholds that chose it."""
    if per_slot:
        card = {"variant": "per-slot", "sy": int(sy)}
    elif blocked_buckets is not None:
        card = {"variant": "blocked", "num_buckets": len(blocked_buckets)}
    else:
        card = {"variant": "dense"}
    card["crossover_sy_over_y"] = SPARSE_Y_CROSSOVER
    card["blocked_engage_frac"] = sparse_y_blocked_frac()
    return card


def plan_sparse_y(xslot, ys, num_x_active: int, dim_y: int, real_dtype):
    """Per-slot sparse-y (C2C only; the caller gates): the sticks of each
    active-x slot in an ``(A, Sy, Z)`` table, so that the y-DFT contracts only
    them. ``SPFFT_TPU_SPARSE_Y`` is ``0`` (off), ``1`` (forced) or ``auto``
    (engage when ``5 Sy < 3 Y``). Returns None when it does not engage, else
    ``(Sy, row_of_stick, wy_backward_pair, wy_forward_pair)``: stick i sits at
    table row ``row_of_stick[i] = slot * Sy + j``, and the pairs are the
    ``(A, Sy, Y)`` per-slot DFT rows (zero on padding rows)."""
    mode = knobs.get_str("SPFFT_TPU_SPARSE_Y")
    xslot = np.asarray(xslot, dtype=np.int64)
    if mode == "0" or xslot.size == 0:
        return None
    A, Y = int(num_x_active), int(dim_y)
    cnt = np.bincount(xslot, minlength=A)
    sy_max = compact_x_extent(int(cnt.max()), Y)
    if sy_max >= Y or (mode != "1" and not (5 * sy_max < 3 * Y)):
        return None
    order = np.argsort(xslot, kind="stable")
    j = np.empty(xslot.size, dtype=np.int64)
    j[order] = np.arange(xslot.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    row_of = xslot * sy_max + j
    y_flat = np.full(A * sy_max, -1, dtype=np.int64)
    y_flat[row_of] = np.asarray(ys, dtype=np.int64)
    wyb = matrix_pair(c2c_matrix(Y, +1, row_perm=y_flat).reshape(A, sy_max, Y), real_dtype)
    wyf = matrix_pair(c2c_matrix(Y, -1, row_perm=y_flat).reshape(A, sy_max, Y), real_dtype)
    return sy_max, row_of, wyb, wyf


def plan_sparse_y_blocked(xslot, ys, dim_y: int, real_dtype, num_sticks: int,
                          dense_rows: int, dense_slots=()):
    """Blocked sparse-y: the active-x slots sorted by stick count and cut into
    ``G`` buckets (``SPFFT_TPU_SPARSE_Y_BLOCKS``: ``auto`` is 4 at
    ``dim_y <= 256``, else 8; ``0`` disables; a positive integer forces G),
    each padded to its own largest slot (quantum 8). The stick table stays
    exact; each bucket's y-DFT is one batched ``(Ag, Syg, Z) x (Ag, Syg, Y)``
    contraction, written into the ``(Y, A, Z)`` grid in bucket-major slot
    order (the x-stage matrices fold that order). Engages under ``auto`` when
    the padded rows are under ``SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC`` of
    ``dense_rows`` (A x Y).

    ``dense_slots`` (R2C's x == 0 slot) each become a trailing ``(1, Y)``
    bucket with the plain dense y matrices, their sticks at their natural y,
    so that the hermitian fill sees the whole plane.

    Returns None when it does not engage, else a dict: ``slot_perm`` (the
    original slot of each bucket-major position), ``buckets`` (per bucket
    ``(row_idx (Ag, Syg) int32 into the stick table, index num_sticks a zero
    row; wyb pair (Ag, Syg, Y); wyf pair)``), ``row_of_stick`` ((S,) int32:
    each stick's row in the buckets' concatenated flats) and ``dense_flat``
    ({dense slot: its flat row offset}).
    """
    mode = knobs.get_str("SPFFT_TPU_SPARSE_Y_BLOCKS")
    if mode == "0":
        return None
    if mode != "auto":
        try:
            forced_g = int(mode)
        except ValueError:
            forced_g = -1
        if forced_g < 1:
            raise InvalidParameterError(
                f"SPFFT_TPU_SPARSE_Y_BLOCKS={mode!r}: expected 'auto', '0' "
                "(disable), or a positive bucket count"
            )
    xslot = np.asarray(xslot, dtype=np.int64)
    ys = np.asarray(ys, dtype=np.int64)
    if xslot.size == 0:
        return None
    n_slots = int(xslot.max()) + 1
    counts = np.bincount(xslot, minlength=n_slots)
    dense_slots = tuple(int(s) for s in dense_slots if 0 <= int(s) < n_slots)
    sortable = np.asarray([s for s in range(n_slots) if s not in set(dense_slots)],
                          dtype=np.int64)
    G = (4 if dim_y <= 256 else 8) if mode == "auto" else forced_g
    G = min(G, sortable.size) if sortable.size else 0
    order = sortable[np.argsort(-counts[sortable], kind="stable")]
    bounds = np.linspace(0, order.size, G + 1).astype(np.int64)
    sy_of = lambda c: min(dim_y, -(-max(1, int(c)) // 8) * 8)
    padded_rows = sum(
        (bounds[g + 1] - bounds[g]) * sy_of(counts[order[bounds[g]]])
        for g in range(G)
        if bounds[g + 1] > bounds[g]
    ) + len(dense_slots) * dim_y
    if mode == "auto" and padded_rows >= sparse_y_blocked_frac() * dense_rows:
        return None
    by_slot = np.argsort(xslot, kind="stable")
    cum = np.cumsum(counts) - counts
    j_of = np.empty(xslot.size, dtype=np.int64)
    j_of[by_slot] = np.arange(xslot.size) - cum[xslot[by_slot]]
    buckets = []
    offsets = np.zeros(n_slots, dtype=np.int64)
    flat_off = 0
    for g in range(G):
        lo, hi = int(bounds[g]), int(bounds[g + 1])
        if hi <= lo:
            continue
        slots_g = order[lo:hi]
        Ag = hi - lo
        Syg = sy_of(counts[slots_g].max() if Ag else 1)
        row_idx = np.full((Ag, Syg), num_sticks, dtype=np.int64)
        y_flat = np.full(Ag * Syg, -1, dtype=np.int64)
        for a_local, s in enumerate(slots_g):
            members = by_slot[cum[s] : cum[s] + counts[s]]
            row_idx[a_local, : counts[s]] = members
            y_flat[a_local * Syg : a_local * Syg + counts[s]] = ys[members]
            offsets[s] = flat_off + a_local * Syg
        wyb = matrix_pair(c2c_matrix(dim_y, +1, row_perm=y_flat).reshape(Ag, Syg, dim_y),
                          real_dtype)
        wyf = matrix_pair(c2c_matrix(dim_y, -1, row_perm=y_flat).reshape(Ag, Syg, dim_y),
                          real_dtype)
        buckets.append((row_idx.astype(np.int32), wyb, wyf))
        flat_off += Ag * Syg
    dense_flat = {}
    for s in dense_slots:
        row_idx = np.full((1, dim_y), num_sticks, dtype=np.int64)
        members = by_slot[cum[s] : cum[s] + counts[s]]
        row_idx[0, ys[members]] = members
        wyb = matrix_pair(c2c_matrix(dim_y, +1).reshape(1, dim_y, dim_y), real_dtype)
        wyf = matrix_pair(c2c_matrix(dim_y, -1).reshape(1, dim_y, dim_y), real_dtype)
        buckets.append((row_idx.astype(np.int32), wyb, wyf))
        dense_flat[s] = flat_off
        flat_off += dim_y
    row_of_stick = offsets[xslot] + j_of
    for s in dense_slots:
        members = by_slot[cum[s] : cum[s] + counts[s]]
        row_of_stick[members] = dense_flat[s] + ys[members]
    return {
        "slot_perm": np.concatenate([order, np.asarray(dense_slots, dtype=np.int64)]),
        "buckets": buckets,
        "row_of_stick": row_of_stick.astype(np.int32),
        "dense_flat": dense_flat,
    }


# ---- the stage contractions ---------------------------------------------------
# Each spec is the einsum of one engine stage; each maps onto one K1 launch:
#   "sz,zk->sk"                  sticks (S, Z) @ W (Z, Z)
#   "yxz,yk->kxz", "ykz,yl->lkz" W^T (Y, Y) @ G viewed as (Y, A*Z)
#   "kxz,xl->klz", "yxz,xk->ykz" batched over the leading axis: W^T @ G[b]
#   "ajz,ajk->kaz"               per slot or bucket a: W[a]^T @ X[a], written
#                                into column a of the (Y, A, Z) grid
#   "yaz,ajy->ajz"               per slot or bucket a: W[a] @ G[:, a, :], read
#                                from column a of the grid

_ROWS = ("sz,zk->sk",)
# rows of a batch of strided windows (the OVERLAPPED exchange's z stage over
# the stick rows [c0, c1) of every stacked shard), one matrix for the batch
_BATCHED_ROWS = "bsz,zk->bsk"
_LEFT = ("yxz,yk->kxz", "ykz,yl->lkz")
_BATCHED_LEFT = ("kxz,xl->klz", "yxz,xk->ykz")
_SLOTS_OUT = "ajz,ajk->kaz"
_SLOTS_IN = "yaz,ajy->ajz"


def operands(spec: str, xr, xi, wr, wi):
    """The K1 operands ``(ar, ai, br, bi)`` of stage ``spec`` as strided views
    (no copy), and the shape its result takes."""
    opt = lambda t, f: None if t is None else f(t)
    if spec in _ROWS:
        ops = (xr[None], opt(xi, lambda t: t[None]), wr[None], opt(wi, lambda t: t[None]))
        return ops, (xr.shape[0], wr.shape[1])
    if spec == _BATCHED_ROWS:
        nb = xr.shape[0]
        shared = lambda t: t.expand(nb, -1, -1)
        return (xr, xi, shared(wr), opt(wi, shared)), (nb, xr.shape[1], wr.shape[1])
    if spec in _LEFT:
        y = xr.shape[0]
        flat = lambda t: t.reshape(y, -1)[None]
        ops = (wr.mT[None], opt(wi, lambda t: t.mT[None]), flat(xr), opt(xi, flat))
        return ops, (wr.shape[1], *xr.shape[1:])
    if spec in _BATCHED_LEFT:
        nb = xr.shape[0]
        shared = lambda t: t.mT.expand(nb, -1, -1)
        return (shared(wr), opt(wi, shared), xr, xi), (nb, wr.shape[1], xr.shape[2])
    if spec == _SLOTS_OUT:
        ops = (wr.mT, opt(wi, lambda t: t.mT), xr, xi)
        return ops, (wr.shape[2], xr.shape[0], xr.shape[2])
    if spec == _SLOTS_IN:
        cols = lambda t: t.permute(1, 0, 2)
        return (wr, wi, cols(xr), opt(xi, cols)), (wr.shape[0], wr.shape[1], xr.shape[2])
    raise InvalidParameterError(f"no stage contraction for spec {spec!r}")


def constant_operands(spec: str, constant):
    """The einsum operand ``(wr, wi)`` of stage ``spec`` that the plan's
    :class:`~.complex_matmul.Constant` holds: V itself, or V^T for the stage
    whose matrix is the left factor of the product (``"yaz,ajy->ajz"``,
    where K1's constant side is W^T)."""
    if spec == _SLOTS_IN:
        return constant.re.mT, (None if constant.im is None else constant.im.mT)
    return constant.pair


def result_view(spec: str, out):
    """The ``(batch, M, N)`` view of K1's result in ``out``, a tensor of the
    einsum's output shape: a view, so that K1 writes straight into ``out``."""
    if spec in _ROWS:
        return out[None]
    if spec in _LEFT:
        return out.view(out.shape[0], -1)[None]
    if spec == _SLOTS_OUT:
        return out.permute(1, 0, 2)
    return out


def contract(spec: str, xr, xi, wr, wi, want_imag: bool = True, constant=None,
             precision: str = "highest", out=None):
    """``(xr + i xi)`` contracted with ``(wr + i wi)`` by ``spec``, as one K1
    launch on strided views. ``xi``/``wi`` of None are real parts; returns
    ``(yr, yi)`` with ``yi`` None when ``want_imag`` is False. ``constant`` is
    the plan's :class:`~.complex_matmul.Constant` of ``(wr, wi)``, if it has
    one. ``out`` is an ``(re, im)`` pair (``im`` None without ``want_imag``)
    of the einsum's output shape, any strides, that K1 writes into; else the
    result is a new contiguous pair."""
    ops, shape = operands(spec, xr, xi, wr, wi)
    if out is None:
        new = lambda: xr.new_empty(shape)
        out = (new(), new() if want_imag else None)
    views = tuple(None if t is None else result_view(spec, t) for t in out)
    _k1(*ops, want_imag, constant=constant, precision=precision, out=views)
    return out


def complex_matmul(xr, xi, wr, wi, spec: str, constant=None, precision: str = "highest",
                   out=None):
    """Complex data with a complex matrix: the four-product form, one launch."""
    return contract(spec, xr, xi, wr, wi, constant=constant, precision=precision, out=out)


def real_in_matmul(x, wr, wi, spec: str, constant=None, precision: str = "highest"):
    """Real data with a complex matrix (R2C forward x-stage)."""
    return contract(spec, x, None, wr, wi, constant=constant, precision=precision)


def real_out_matmul(xr, xi, a, b, spec: str, constant=None, precision: str = "highest"):
    """Real part ``xr@A - xi@B`` only (C2R backward x-stage)."""
    return contract(spec, xr, xi, a, b, want_imag=False, constant=constant,
                    precision=precision)[0]
