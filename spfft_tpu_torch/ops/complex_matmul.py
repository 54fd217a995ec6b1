"""K1: planar batched strided complex matrix product, ``C[b] = A[b] @ B[b]``.

Replaces the TPU kernel ``spfft_tpu/ops/pallas_fft.py:95``
(``complex_matmul_fused``). The CUDA sources, with their design and bound,
are ``csrc/complex_matmul.cu`` (float32) and ``csrc/complex_matmul_f64.cu``
(float64); :func:`complex_matmul_plain` beside them is the same function in
PyTorch, in the four-product form.

Operands are 3-D ``(batch, rows, cols)`` real tensors, one per part, of any
strides: ``expand`` gives a shared matrix (batch stride 0) and ``.mT`` a
transposed one, with no copy. ``ai``/``bi`` of ``None`` is a real operand;
``want_imag=False`` keeps only the real part of the product.

In float32 the kernel runs on the tensor cores at one of three precisions,
the JAX package's names: ``"highest"`` is 3xTF32, every f32 value split into
two TF32 parts (:func:`split_tf32`) and each real product
``lo.hi + hi.lo + hi.hi`` with FP32 sums, at FP32 accuracy
(:func:`complex_matmul_3xtf32` is that arithmetic in PyTorch); ``"high"`` is
the same with BF16 parts (:func:`split_bf16`, :func:`complex_matmul_bf16x3`);
``"default"`` is one BF16 product ``hi.hi`` (:func:`complex_matmul_bf16x1`).
The plans' fourth form, ``"highest-bf16"`` (``SPFFT_TPU_TWIDDLE_BF16``), is
``"highest"`` with a plan constant exact in BF16: its TF32 lo part is zero,
so the kernel loads the constant's hi planes alone and issues
``lo.hi + hi.hi``, the sums of 3xTF32 on that constant.
Float64 ignores the precision: its kernel (``csrc/complex_matmul_f64.cu``) runs
on the FP64 tensor cores, in Gauss's three-product form where all four parts
exist (:func:`complex_matmul_gauss` is that arithmetic in PyTorch). One
operand, the DFT matrix of a stage (shared by the batch, or one per batch
entry), goes to the kernel prepared: split and laid out in tiles
(:func:`tile_constant`; float64: :func:`tile_constant_f64`), once per plan in
a :class:`Constant`. Results go to new tensors or, through ``out=``, into
strided views that the caller owns.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from ..errors import GPULaunchError, InvalidParameterError
from ..obs import hlo

# Launches of the CUDA kernel, keyed by (batch, M, K, N, a_imag, b_imag,
# want_imag, precision). The wrapper adds one where it launches and nowhere else.
launches: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.float64)
PRECISIONS = ("highest", "high", "default")
# The float32 kernel forms: the precisions, and "highest" with a bfloat16
# plan constant (a plan's K1 form, never a caller's precision).
BF16_CONSTANT = "highest-bf16"
FORMS = PRECISIONS + (BF16_CONSTANT,)
# Per float32 form: the library (csrc/<name>.cu) and its C entry point.
LIBRARIES = {
    "highest": ("complex_matmul", "spfft_complex_matmul_tf32x3"),
    BF16_CONSTANT: ("complex_matmul_tf32x2", "spfft_complex_matmul_tf32x2"),
    "high": ("complex_matmul_bf16x3", "spfft_complex_matmul_bf16x3"),
    "default": ("complex_matmul_bf16x1", "spfft_complex_matmul_bf16x1"),
}
# The float64 library and its C entry point.
LIBRARY_F64 = ("complex_matmul_f64", "spfft_complex_matmul_f64")
# K per stage of the tensor-core kernel (csrc/k1_tc.cuh, tc::bk): one
# 128-byte row of V, 32 tf32 or 64 bf16.
TILE_K = 32
TILE_K_BF16 = 64
# The float64 kernel's tiles (csrc/complex_matmul_f64.cu): Q and K of V per
# stage, and K per DMMA (m16n8k8).
F64_TILE_Q = 64
F64_TILE_K = 32
F64_MMA_K = 8
_INT32_MAX = 2**31 - 1


def supports(batch: int, m: int, k: int, n: int, dtype) -> bool:
    """True if the CUDA kernel takes this shape and dtype. Both kernels walk
    their output tiles (at least 64 x 64) with persistent blocks, counting
    them in 32 bits; the float32 kernel takes at most 65535 batches."""
    if dtype not in _DTYPES or batch < 1 or m < 1 or n < 1 or k < 0:
        return False
    tiles = -(-m // 64) * -(-n // 64)
    if dtype == torch.float64:
        return batch * tiles <= _INT32_MAX
    return batch <= 65535 and tiles <= _INT32_MAX


def _mm(a, b):
    return torch.einsum("bmk,bkn->bmn", a, b)


def complex_matmul_plain(ar, ai, br, bi, want_imag: bool = True):
    """The four-product form of ``(ar + i ai) @ (br + i bi)`` with einsum."""
    return _four_products(_mm, ar, ai, br, bi, want_imag)


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


def complex_matmul_gauss(ar, ai, br, bi, want_imag: bool = True):
    """The float64 kernel's arithmetic in PyTorch: where all four parts exist,
    Gauss's three products ``t1 = ar.br``, ``t2 = ai.bi``,
    ``t3 = (ar + ai).(br + bi)`` and ``(t1 - t2, (t3 - t1) - t2)``, as the JAX
    package's ``complex_matmul`` (``spfft_tpu/ops/fft.py:524-543``); the forms
    with a part missing are the four-product form's."""
    if ai is None or bi is None or not want_imag:
        return _four_products(_mm, ar, ai, br, bi, want_imag)
    t1, t2 = _mm(ar, br), _mm(ai, bi)
    return t1 - t2, (_mm(ar + ai, br + bi) - t1) - t2


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
    """The "highest" kernel's arithmetic in PyTorch: every real product
    ``a.b`` is ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` of TF32 parts, summed in
    float32 (the products of two TF32 values are exact in float32)."""
    return _split_products(split_tf32, 3, ar, ai, br, bi, want_imag)


def _split_products(split, passes, ar, ai, br, bi, want_imag):
    """The four-product form with every real product ``a.b`` built from the
    parts of ``split``: ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` (``passes`` 3)
    or ``a_hi.b_hi`` (1), summed in float32."""
    if passes == 3:
        dot = lambda a, b: _mm(a[1], b[0]) + _mm(a[0], b[1]) + _mm(a[0], b[0])
    else:
        dot = lambda a, b: _mm(a[0], b[0])
    parts = lambda t: None if t is None else split(t)
    return _four_products(dot, parts(ar), parts(ai), parts(br), parts(bi), want_imag)


# ---- the bf16 split ("high", "default") -------------------------------------------


def round_bf16(x):
    """float32 -> the nearest BF16 value (ties to even, as ``cvt.rn.bf16.f32``),
    still float32: the low 16 bits are zero."""
    return x.to(torch.bfloat16).to(torch.float32)


def split_bf16(x):
    """``x = hi + lo`` to within about 2^-16 |x|, both BF16: ``hi`` is ``x``
    rounded, ``lo`` the rounded remainder (``x - hi`` is exact in float32)."""
    hi = round_bf16(x)
    return hi, round_bf16(x - hi)


def complex_matmul_bf16x3(ar, ai, br, bi, want_imag: bool = True):
    """The "high" kernel's arithmetic in PyTorch: every real product ``a.b``
    is ``a_lo.b_hi + a_hi.b_lo + a_hi.b_hi`` of BF16 parts (:func:`split_bf16`),
    summed in float32 (the products of two BF16 values are exact in float32)."""
    return _split_products(split_bf16, 3, ar, ai, br, bi, want_imag)


def complex_matmul_bf16x1(ar, ai, br, bi, want_imag: bool = True):
    """The "default" kernel's arithmetic in PyTorch: every real product
    ``a.b`` is ``a_hi.b_hi`` of the BF16 roundings, summed in float32."""
    return _split_products(split_bf16, 1, ar, ai, br, bi, want_imag)


# The float32 kernel's arithmetic at each form ("highest-bf16": 3xTF32's,
# whose hi.lo products of a BF16-exact constant are exact zeros).
ARITHMETIC = {"highest": complex_matmul_3xtf32, "high": complex_matmul_bf16x3,
              "default": complex_matmul_bf16x1, BF16_CONSTANT: complex_matmul_3xtf32}


def tile_q(q: int) -> int:
    """The kernel's Q tile for a constant of ``q`` columns, 64 or 88: the one
    that pads ``q`` least (88 for q = 176 and 88), 64 on a tie."""
    return min((-(-q // bn) * bn, bn) for bn in (64, 88))[1]


def tile_constant(vr, vi=None, precision: str = "highest"):
    """A constant ``V`` (``(K, Q)`` or ``(batch, K, Q)``, float32, any
    strides) in the tensor-core kernel's layout at ``precision``:
    ``(batch, Q/bn, K/tk, planes, bn, tk)``, each tile ``V^T`` (K-major),
    zero-padded to whole tiles, one 128-byte row per q. ``"highest"``: float32
    TF32 parts from :func:`split_tf32`, tk = 32, planes re_hi, re_lo[, im_hi,
    im_lo]. ``"high"``: bfloat16 parts from :func:`split_bf16`, tk = 64, the
    same planes. ``"default"``: bfloat16, tk = 64, planes re[, im] rounded.
    ``"highest-bf16"``: float32, tk = 32, planes re[, im] rounded to BF16
    (their TF32 lo parts are zero).
    The 16-byte chunk c of row r sits at chunk ``c ^ (r % 8)`` (wgmma's
    128-byte swizzle). One (Q tile, K tile) is one contiguous block, so that a
    linear copy puts it in shared memory as the kernel reads it."""
    parts = [vr] if vi is None else [vr, vi]
    v = torch.stack([p if p.dim() == 3 else p[None] for p in parts], 1)  # (b, parts, K, Q)
    b, _, k, q = v.shape
    v = v.float()
    if precision == "highest":
        tk, dtype, split = TILE_K, torch.float32, split_tf32
    elif precision == BF16_CONSTANT:
        tk, dtype, split = TILE_K, torch.float32, lambda t: (round_bf16(t),)
    elif precision in ("high", "default"):
        tk, dtype = TILE_K_BF16, torch.bfloat16
        split = split_bf16 if precision == "high" else (lambda t: (round_bf16(t),))
    else:
        raise InvalidParameterError(f"unknown matmul precision {precision!r}")
    bn = tile_q(q)
    qt, kt = -(-q // bn), -(-k // tk)
    planes = torch.stack(split(v), 2).flatten(1, 2).to(dtype)  # (b, planes, K, Q)
    npl = planes.shape[1]
    t = planes.new_zeros((b, npl, qt * bn, kt * tk))
    t[:, :, :q, :k] = planes.mT
    t = t.reshape(b, npl, qt, bn, kt, tk).permute(0, 2, 4, 1, 3, 5)
    chunk = 16 // planes.element_size()  # values per 16-byte chunk
    r = torch.arange(bn, device=v.device)[:, None]
    c = torch.arange(tk, device=v.device)[None, :]
    swizzle = ((c // chunk) ^ (r & 7)) * chunk + c % chunk  # (bn, tk): logical k of the slot
    return torch.gather(t, 5, swizzle.expand(t.shape)).contiguous()


def tile_constant_f64(vr, vi=None):
    """A float64 constant ``V`` (``(K, Q)`` or ``(batch, K, Q)``, any strides)
    in the float64 kernel's layout: ``(batch, Q/64, K/32, planes, 8, 4, 32,
    2)``, zero-padded to whole tiles, the planes ``vr`` and ``vi`` if it has
    one (the kernel adds ``vr + vi`` for Gauss's third product itself). Per
    (Q tile, K tile), one contiguous block of the planes, which a bulk copy
    puts in shared memory; in each plane, per n tile ``j`` of 8 columns and
    k step ``s`` of 8 rows, lane ``4 g + t`` holds the pair
    ``V[k0 + 8 s + 2 t + c, q0 + 8 j + g]``, ``c = 0, 1``: its DMMA B
    fragment (k slots ``t`` and ``t + 4``), one 16-byte load."""
    parts = [vr] if vi is None else [vr, vi]
    v = torch.stack([p if p.dim() == 3 else p[None] for p in parts], 1).double()
    b, npl, k, q = v.shape
    tq, tk, ki = F64_TILE_Q, F64_TILE_K, F64_MMA_K
    qt, kt = -(-q // tq), -(-k // tk)
    t = v.new_zeros((b, npl, kt * tk, qt * tq))
    t[:, :, :k, :q] = v
    # k = kt tk + s ki + 2 (lane % 4) + c, q = qt tq + 8 j + lane // 4
    t = t.reshape(b, npl, kt, tk // ki, 4, 2, qt, tq // 8, 8)
    t = t.permute(0, 6, 2, 1, 7, 3, 8, 4, 5).contiguous()
    return t.view(b, qt, kt, npl, tq // 8, tk // ki, 32, 2)


class Constant:
    """A stage's DFT matrix ``V`` (``(K, Q)``, or ``(batch, K, Q)`` with one
    matrix per batch entry), shared by every launch of a plan: the raw
    ``(re, im)`` pair, which the plain version and the operand views use, and
    on a CUDA plan its tiles, made once here: float32 at the plan's
    ``precision`` (:func:`tile_constant`), float64 for the DMMA kernel
    (:func:`tile_constant_f64`)."""

    def __init__(self, re, im=None, precision: str = "highest"):
        if precision == BF16_CONSTANT and not all(
                torch.equal(round_bf16(t.float()), t) for t in (re, im) if t is not None):
            raise InvalidParameterError(
                f"a {BF16_CONSTANT!r} constant must hold bfloat16 values (SPFFT_TPU_TWIDDLE_BF16)")
        self.re, self.im, self.precision = re, im, precision
        self.tiles = None
        if re.device.type == "cuda":
            self.tiles = (tile_constant_f64(re, im) if re.dtype == torch.float64
                          else tile_constant(re, im, precision))

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


def _check_out(out, batch, m, n, want_imag, like):
    cr, ci = out
    if cr is None or (ci is None) == want_imag:
        raise InvalidParameterError("complex_matmul out is (re, im), im None without want_imag")
    for t in (cr, ci):
        if t is not None and (t.shape != (batch, m, n) or t.dtype != like.dtype
                              or t.device != like.device or t.stride() != cr.stride()):
            raise InvalidParameterError(
                f"complex_matmul out must be ({batch}, {m}, {n}) {like.dtype} on {like.device}, "
                "both parts with the same strides"
            )


@hlo.kernel_entry
def complex_matmul(ar, ai, br, bi, want_imag: bool = True, constant: Constant | None = None,
                   precision: str = "highest", out=None):
    """``C[b] = A[b] @ B[b]`` -> ``(cr, ci)`` of shape ``(batch, M, N)``.

    ``ci`` is ``None`` when ``want_imag`` is False. CPU tensors take
    :func:`complex_matmul_plain`; CUDA tensors launch the kernel or raise.
    ``precision`` picks the float32 kernel form (:data:`FORMS`; float64
    ignores it: one DMMA kernel). ``constant`` is the :class:`Constant` that
    ``B`` or ``A^T`` views (every batch the same matrix, or one per batch),
    prepared at ``precision``; the ``"highest-bf16"`` form needs one.
    Without it, the float32 kernel prepares the shared operand, or ``B``,
    on each call. ``out`` is a ``(cr, ci)`` pair of ``(batch, M, N)`` tensors
    of any strides (the same for both) that receives the result.
    """
    batch, m, k, n = _check(ar, ai, br, bi)
    if precision not in FORMS:
        raise InvalidParameterError(f"unknown matmul precision {precision!r}")
    if precision == BF16_CONSTANT and constant is None:
        raise InvalidParameterError(f"the {BF16_CONSTANT!r} form needs its prepared constant")
    if out is not None:
        _check_out(out, batch, m, n, want_imag, ar)
    if ar.device.type not in ("cpu", "cuda"):
        raise InvalidParameterError(f"complex_matmul runs on cpu or cuda, not {ar.device}")
    if out is None and (ar.device.type == "cuda" or batch == 0 or m == 0 or n == 0):
        cr = torch.empty((batch, m, n), dtype=ar.dtype, device=ar.device)
        out = (cr, torch.empty_like(cr) if want_imag else None)
    if batch == 0 or m == 0 or n == 0:  # nothing to compute, on either device
        return out[0], out[1]
    if ar.device.type == "cpu":
        result = complex_matmul_plain(ar, ai, br, bi, want_imag)
        hlo.kernel_ran(hlo.K1, ar)  # where the card launches the kernel
        if out is None:
            return result
        for o, r in zip(out, result):
            if o is not None:
                o.copy_(r)
        return out
    cr, ci = out
    if not supports(batch, m, k, n, ar.dtype):
        raise InvalidParameterError(
            f"complex_matmul kernel does not take batch={batch} M={m} K={k} N={n} {ar.dtype}"
        )
    with torch.cuda.device(ar.device):
        stream = torch.cuda.current_stream(ar.device).cuda_stream
        if ar.dtype == torch.float64:
            precision = "highest"  # one body at every precision
            err = _launch_f64(_library_f64().spfft_complex_matmul_f64, ar, ai, br, bi, cr, ci,
                              constant, stream)
        else:
            entry = getattr(_library(precision), LIBRARIES[precision][1])
            err = _launch_tc(entry, ar, ai, br, bi, cr, ci, constant, stream, precision)
    if err:
        raise GPULaunchError(f"complex_matmul launch failed: cudaError {err}")
    launches[(batch, m, k, n, ai is not None, bi is not None, want_imag, precision)] += 1
    hlo.kernel_ran(hlo.K1, ar)
    return cr, ci


def _views(t, w) -> bool:
    """True if every batch of the 3-D ``t`` is ``w`` itself: the 2-D ``w``
    (shared by the batch), or the 3-D ``w`` batch for batch."""
    if w.dim() == 3:
        return t.shape == w.shape and t.stride() == w.stride() and t.data_ptr() == w.data_ptr()
    return (
        (t.shape[0] == 1 or t.stride(0) == 0) and t.shape[1:] == w.shape
        and t.stride()[1:] == w.stride() and t.data_ptr() == w.data_ptr()
    )


def _shared(t) -> bool:
    return t.shape[0] == 1 or t.stride(0) == 0


def _sides(ar, ai, br, bi, cr, constant, prepare, precision=None):
    """The kernels' O = D @ V view of ``C = A @ B``: V is the constant side
    (B, or A^T when the constant is A's transpose), prepared by ``prepare``
    (``(vr, vi) -> tiles``) unless ``constant`` holds its tiles; D the data
    side. Returns ``(tiles, v_im, v_sb, d_r, d_i, kmajor, P, Q, o_strides)``:
    ``v_sb`` the tiles' batch stride in bytes (0 when shared), ``kmajor``
    whether D's k axis has the smaller stride. ``precision`` (float32) must
    be the one the constant was prepared at."""
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
        if precision is not None and constant.precision != precision:
            raise InvalidParameterError(
                f"complex_matmul constant prepared for {constant.precision!r}, not {precision!r}"
            )
        tiles, v_im = constant.tiles, constant.im is not None
    else:
        transposed = _shared(ar) and not _shared(br)
        v_r, v_i = (ar.mT, None if ai is None else ai.mT) if transposed else (br, bi)
        tiles = prepare(v_r[:1] if _shared(v_r) else v_r,
                        None if v_i is None else (v_i[:1] if _shared(v_i) else v_i))
        v_im = v_i is not None
    if transposed:  # C^T = B^T A^T: D = B^T (N x K), O = C^T
        d_r, d_i, p, q = br.mT, (None if bi is None else bi.mT), n, m
        o_strides = (cr.stride(0), cr.stride(2), cr.stride(1))
    else:
        d_r, d_i, p, q = ar, ai, m, n
        o_strides = cr.stride()
    _, d_sp, d_sk = d_r.stride()
    kmajor = d_sk == 1 or (d_sp != 1 and abs(d_sk) <= abs(d_sp))
    v_sb = tiles.stride(0) * tiles.element_size() if tiles.shape[0] > 1 else 0
    return tiles, v_im, v_sb, d_r, d_i, kmajor, p, q, o_strides


def _launch_tc(entry, ar, ai, br, bi, cr, ci, constant, stream, precision="highest") -> int:
    """O = D @ V on the float32 tensor-core kernel ``entry`` of ``precision``
    (:func:`_sides`)."""
    tiles, v_im, v_sb, d_r, d_i, kmajor, p, q, o_strides = _sides(
        ar, ai, br, bi, cr, constant, lambda vr, vi: tile_constant(vr, vi, precision), precision)
    batch, k = ar.shape[0], ar.shape[2]
    d_sb, d_sp, d_sk = d_r.stride()
    inner, outer = (d_sk, d_sp) if kmajor else (d_sp, d_sk)
    aligned = all(t.data_ptr() % 16 == 0 for t in (d_r, d_i) if t is not None)
    tma = inner == 1 and outer % 4 == 0 and (batch == 1 or d_sb % 4 == 0) and aligned
    return entry(
        d_r.data_ptr(), None if d_i is None else d_i.data_ptr(), d_sb, d_sp, d_sk,
        int(kmajor), int(tma), tiles.data_ptr(), v_sb, int(v_im), tiles.shape[4],
        cr.data_ptr(), None if ci is None else ci.data_ptr(), *o_strides,
        batch, p, q, k, stream,
    )


def _launch_f64(entry, ar, ai, br, bi, cr, ci, constant, stream) -> int:
    """O = D @ V on the float64 DMMA kernel ``entry`` (:func:`_sides`). D's
    pairs of values along its contiguous axis go as one 16-byte copy where
    that axis has stride 1 and every pair starts 16-byte aligned."""
    tiles, v_im, v_sb, d_r, d_i, kmajor, p, q, o_strides = _sides(
        ar, ai, br, bi, cr, constant, tile_constant_f64)
    d_sb, d_sp, d_sk = d_r.stride()
    inner, outer = (d_sk, d_sp) if kmajor else (d_sp, d_sk)
    aligned = all(t.data_ptr() % 16 == 0 for t in (d_r, d_i) if t is not None)
    vec = inner == 1 and outer % 2 == 0 and (ar.shape[0] == 1 or d_sb % 2 == 0) and aligned
    return entry(
        d_r.data_ptr(), None if d_i is None else d_i.data_ptr(), d_sb, d_sp, d_sk, int(kmajor),
        int(vec), tiles.data_ptr(), v_sb, int(v_im),
        cr.data_ptr(), None if ci is None else ci.data_ptr(), *o_strides,
        ar.shape[0], p, q, ar.shape[2], stream,
    )


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _bound(name: str, entry: str, argtypes):
    """The loaded library ``csrc/<name>.cu``, its entry's argument types set."""
    lib = _build.library(name)
    fn = getattr(lib, entry)
    if not fn.argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _library(precision: str):
    """The loaded float32 library of K1 at ``precision``."""
    return _bound(*LIBRARIES[precision], [_P, _P, _I64, _I64, _I64, _I32, _I32, _P, _I64, _I32,
                                          _I32, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                                          _I64, _P])


def _library_f64():
    """The loaded float64 library of K1."""
    return _bound(*LIBRARY_F64, [_P, _P, _I64, _I64, _I64, _I32, _I32, _P, _I64, _I32, _P, _P,
                                 _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P])
