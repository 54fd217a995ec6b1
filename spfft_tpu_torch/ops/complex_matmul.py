"""K1: planar batched strided complex matrix product, ``C[b] = A[b] @ B[b]``.

Replaces the TPU kernel ``spfft_tpu/ops/pallas_fft.py:95``
(``complex_matmul_fused``). The CUDA source, with its design and bound, is
``csrc/complex_matmul.cu``; :func:`complex_matmul_plain` beside it is the same
function in PyTorch, in the same four-product form.

Operands are 3-D ``(batch, rows, cols)`` real tensors, one per part, of any
strides: ``expand`` gives a shared matrix (batch stride 0) and ``.mT`` a
transposed one, with no copy. ``ai``/``bi`` of ``None`` is a real operand;
``want_imag=False`` keeps only the real part of the product.

In float32 the kernel runs 3xTF32 on the tensor cores: every f32 value is
split into two TF32 parts (:func:`split_tf32`) and each real product is
``lo.hi + hi.lo + hi.hi`` with FP32 sums (:func:`complex_matmul_3xtf32` is
that arithmetic in PyTorch). One operand, the shared DFT matrix of a stage,
goes to the kernel prepared: split and laid out in tiles
(:func:`tile_constant`), once per plan in a :class:`Constant`.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from ..errors import GPULaunchError, InvalidParameterError

# Launches of the CUDA kernel, keyed by (batch, M, K, N, a_imag, b_imag,
# want_imag). The wrapper adds one where it launches and nowhere else.
launches: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.float64)
# K per stage of the float32 kernel (csrc/complex_matmul.cu, tc::BK).
TILE_K = 32


def supports(batch: int, m: int, k: int, n: int, dtype) -> bool:
    """True if the CUDA kernel takes this shape and dtype (grid limits of
    ``csrc/complex_matmul.cu``: batch and M/64 at most 65535)."""
    return (
        dtype in _DTYPES and 1 <= batch <= 65535 and m >= 1 and n >= 1
        and k >= 0 and -(-m // 64) <= 65535
    )


def complex_matmul_plain(ar, ai, br, bi, want_imag: bool = True):
    """The four-product form of ``(ar + i ai) @ (br + i bi)`` with einsum."""
    return _four_products(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                          ar, ai, br, bi, want_imag)


def _four_products(dot, ar, ai, br, bi, want_imag):
    """``(cr, ci)`` of ``(ar + i ai) (br + i bi)`` from the real product ``dot``."""
    cr = dot(ar, br)
    if ai is not None and bi is not None:
        cr = cr - dot(ai, bi)
    if not want_imag:
        return cr, None
    if bi is not None:
        ci = dot(ar, bi)
        if ai is not None:
            ci = ci + dot(ai, br)
    elif ai is not None:
        ci = dot(ai, br)
    else:
        ci = torch.zeros_like(cr)
    return cr, ci


# ---- the 3xTF32 split ---------------------------------------------------------


def round_tf32(x):
    """float32 -> the nearest TF32 value (ties away from zero, as
    ``cvt.rna.tf32.f32``), still float32: the low 13 mantissa bits are zero."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x):
    """``x = hi + lo`` to within 2^-22 |x|, both TF32: ``hi`` is ``x``
    rounded, ``lo`` the rounded remainder (``x - hi`` is exact in float32)."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def complex_matmul_3xtf32(ar, ai, br, bi, want_imag: bool = True):
    """The float32 kernel's arithmetic in PyTorch: every real product
    ``a.b`` is ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` of TF32 parts, summed in
    float32 (the products of two TF32 values are exact in float32)."""
    parts = lambda t: None if t is None else split_tf32(t)
    mm = lambda x, y: torch.einsum("bmk,bkn->bmn", x, y)
    dot = lambda a, b: mm(a[1], b[0]) + mm(a[0], b[1]) + mm(a[0], b[0])
    return _four_products(dot, parts(ar), parts(ai), parts(br), parts(bi), want_imag)


def tile_q(q: int) -> int:
    """The kernel's Q tile for a constant of ``q`` columns, 64 or 88: the one
    that pads ``q`` least (88 for q = 176 and 88), 64 on a tie."""
    return min((-(-q // bn) * bn, bn) for bn in (64, 88))[1]


def tile_constant(vr, vi=None):
    """A constant ``V`` (``(K, Q)`` or ``(batch, K, Q)``, float32) in the
    float32 kernel's layout: ``(batch, Q/bn, K/32, planes, bn, 32)`` with
    planes re_hi, re_lo[, im_hi, im_lo] from :func:`split_tf32`, each tile
    ``V^T`` (K-major), zero-padded to whole tiles, its 16-byte chunk c of row r
    at chunk ``c ^ (r % 8)`` (wgmma's 128-byte swizzle). One (Q tile, K tile)
    is one contiguous block, so that a linear copy puts it in shared memory as
    the kernel reads it."""
    parts = [vr] if vi is None else [vr, vi]
    v = torch.stack([p if p.dim() == 3 else p[None] for p in parts], 1)  # (b, parts, K, Q)
    b, _, k, q = v.shape
    bn = tile_q(q)
    qt, kt = -(-q // bn), -(-k // TILE_K)
    planes = torch.stack(split_tf32(v.float()), 2).flatten(1, 2)  # (b, planes, K, Q)
    npl = planes.shape[1]
    t = planes.new_zeros((b, npl, qt * bn, kt * TILE_K))
    t[:, :, :q, :k] = planes.mT
    t = t.reshape(b, npl, qt, bn, kt, TILE_K).permute(0, 2, 4, 1, 3, 5)
    r = torch.arange(bn, device=v.device)[:, None]
    c = torch.arange(TILE_K, device=v.device)[None, :]
    swizzle = (((c >> 2) ^ (r & 7)) << 2) | (c & 3)  # (bn, 32): logical k of chunk slot
    return torch.gather(t, 5, swizzle.expand(t.shape)).contiguous()


class Constant:
    """A stage's DFT matrix ``V`` (``(K, Q)``), shared by every launch of a
    plan: the raw ``(re, im)`` pair, which the plain version and the operand
    views use, and on a CUDA float32 plan its tiles (:func:`tile_constant`),
    made once here."""

    def __init__(self, re, im=None):
        self.re, self.im = re, im
        f32_cuda = re.device.type == "cuda" and re.dtype == torch.float32
        self.tiles = tile_constant(re, im) if f32_cuda else None

    @property
    def pair(self):
        return self.re, self.im


# ---- the wrapper ----------------------------------------------------------------


def _check(ar, ai, br, bi):
    if ar.dim() != 3 or br.dim() != 3:
        raise InvalidParameterError("complex_matmul operands are (batch, rows, cols)")
    batch, m, k = ar.shape
    if br.shape[0] != batch or br.shape[1] != k:
        raise InvalidParameterError(
            f"complex_matmul shapes do not chain: {tuple(ar.shape)} @ {tuple(br.shape)}"
        )
    for name, t, like in (("ai", ai, ar), ("bi", bi, br)):
        if t is not None and (t.shape != like.shape or t.stride() != like.stride()):
            raise InvalidParameterError(f"{name} must match its real part in shape and strides")
    parts = [t for t in (ar, ai, br, bi) if t is not None]
    if any(t.dtype != ar.dtype for t in parts) or any(t.device != ar.device for t in parts):
        raise InvalidParameterError("complex_matmul operands differ in dtype or device")
    return batch, m, k, br.shape[2]


def complex_matmul(ar, ai, br, bi, want_imag: bool = True, constant: Constant | None = None):
    """``C[b] = A[b] @ B[b]`` -> ``(cr, ci)`` of shape ``(batch, M, N)``.

    ``ci`` is ``None`` when ``want_imag`` is False. CPU tensors take
    :func:`complex_matmul_plain`; CUDA tensors launch the kernel or raise.
    ``constant`` is the :class:`Constant` that ``B`` or ``A^T`` views (every
    batch the same matrix): the float32 kernel takes its prepared tiles.
    Without it, the float32 kernel prepares the shared operand, or ``B``,
    on each call.
    """
    batch, m, k, n = _check(ar, ai, br, bi)
    if ar.device.type == "cpu":
        return complex_matmul_plain(ar, ai, br, bi, want_imag)
    if ar.device.type != "cuda":
        raise InvalidParameterError(f"complex_matmul runs on cpu or cuda, not {ar.device}")
    if batch == 0 or m == 0 or n == 0:
        empty = torch.empty((batch, m, n), dtype=ar.dtype, device=ar.device)
        return empty, (torch.empty_like(empty) if want_imag else None)
    if not supports(batch, m, k, n, ar.dtype):
        raise InvalidParameterError(
            f"complex_matmul kernel does not take batch={batch} M={m} K={k} N={n} {ar.dtype}"
        )
    cr = torch.empty((batch, m, n), dtype=ar.dtype, device=ar.device)
    ci = torch.empty_like(cr) if want_imag else None
    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(ar.device):
        stream = torch.cuda.current_stream(ar.device).cuda_stream
        if ar.dtype == torch.float64:
            err = lib.spfft_complex_matmul_f64(
                ar.data_ptr(), ptr(ai), *ar.stride(), br.data_ptr(), ptr(bi), *br.stride(),
                cr.data_ptr(), ptr(ci), *cr.stride(), batch, m, n, k, stream,
            )
        else:
            err = _launch_tf32x3(lib, ar, ai, br, bi, cr, ci, constant, stream)
    if err:
        raise GPULaunchError(f"complex_matmul launch failed: cudaError {err}")
    launches[(batch, m, k, n, ai is not None, bi is not None, want_imag)] += 1
    return cr, ci


def _views(t, w) -> bool:
    """True if every batch of the 3-D ``t`` is the 2-D tensor ``w`` itself."""
    return (
        (t.shape[0] == 1 or t.stride(0) == 0) and t.shape[1:] == w.shape
        and t.stride()[1:] == w.stride() and t.data_ptr() == w.data_ptr()
    )


def _shared(t) -> bool:
    return t.shape[0] == 1 or t.stride(0) == 0


def _launch_tf32x3(lib, ar, ai, br, bi, cr, ci, constant, stream) -> int:
    """O = D @ V on the float32 kernel: V is the constant side (B, or A^T
    when the constant is A's transpose), D the data side."""
    batch, m, k = ar.shape
    n = br.shape[2]
    if constant is not None:
        if _views(br, constant.re):
            transposed = False
        elif _views(ar.mT, constant.re):
            transposed = True
        else:
            raise InvalidParameterError("complex_matmul constant is neither B nor A^T")
        if constant.tiles is None or (constant.im is None) != ((ai if transposed else bi) is None):
            raise InvalidParameterError("complex_matmul constant does not match its operand")
        tiles = constant.tiles
    else:
        transposed = _shared(ar) and not _shared(br)
        v_r, v_i = (ar.mT, None if ai is None else ai.mT) if transposed else (br, bi)
        tiles = tile_constant(v_r[:1] if _shared(v_r) else v_r,
                              None if v_i is None else (v_i[:1] if _shared(v_i) else v_i))
    if transposed:  # C^T = B^T A^T: D = B^T (N x K), O = C^T
        d_r, d_i, p, q = br.mT, (None if bi is None else bi.mT), n, m
        o_strides = (cr.stride(0), cr.stride(2), cr.stride(1))
    else:
        d_r, d_i, p, q = ar, ai, m, n
        o_strides = cr.stride()
    d_sb, d_sp, d_sk = d_r.stride()
    kmajor = d_sk == 1 or (d_sp != 1 and abs(d_sk) <= abs(d_sp))
    inner, outer = (d_sk, d_sp) if kmajor else (d_sp, d_sk)
    aligned = all(t.data_ptr() % 16 == 0 for t in (d_r, d_i) if t is not None)
    tma = inner == 1 and outer % 4 == 0 and (batch == 1 or d_sb % 4 == 0) and aligned
    v_sb = tiles.stride(0) if tiles.shape[0] > 1 else 0
    return lib.spfft_complex_matmul_tf32x3(
        d_r.data_ptr(), None if d_i is None else d_i.data_ptr(), d_sb, d_sp, d_sk,
        int(kmajor), int(tma), tiles.data_ptr(), v_sb, int(tiles.shape[3] == 4), tiles.shape[4],
        cr.data_ptr(), None if ci is None else ci.data_ptr(), *o_strides,
        batch, p, q, k, stream,
    )


def _library():
    lib = _build.library("complex_matmul")
    f64, tf32 = lib.spfft_complex_matmul_f64, lib.spfft_complex_matmul_tf32x3
    if not f64.argtypes:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f64.argtypes = [p, p, i64, i64, i64, p, p, i64, i64, i64,
                        p, p, i64, i64, i64, i64, i64, i64, i64, p]
        f64.restype = ctypes.c_int
        tf32.argtypes = [p, p, i64, i64, i64, i32, i32, p, i64, i32, i32,
                         p, p, i64, i64, i64, i64, i64, i64, i64, p]
        tf32.restype = ctypes.c_int
    return lib
