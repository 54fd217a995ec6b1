"""K1: planar batched strided complex matrix product, ``C[b] = A[b] @ B[b]``.

Replaces the TPU kernel ``spfft_tpu/ops/pallas_fft.py:95``
(``complex_matmul_fused``). The CUDA source, with its design and bound, is
``csrc/complex_matmul.cu``; :func:`complex_matmul_plain` beside it is the same
function in PyTorch, in the same four-product form.

Operands are 3-D ``(batch, rows, cols)`` real tensors, one per part, of any
strides: ``expand`` gives a shared matrix (batch stride 0) and ``.mT`` a
transposed one, with no copy. ``ai``/``bi`` of ``None`` is a real operand;
``want_imag=False`` keeps only the real part of the product.
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

_DTYPES = {torch.float32: 0, torch.float64: 1}


def supports(batch: int, m: int, k: int, n: int, dtype) -> bool:
    """True if the CUDA kernel takes this shape and dtype (grid limits of
    ``csrc/complex_matmul.cu``: batch and M/64 at most 65535)."""
    return (
        dtype in _DTYPES and 1 <= batch <= 65535 and m >= 1 and n >= 1
        and k >= 0 and -(-m // 64) <= 65535
    )


def complex_matmul_plain(ar, ai, br, bi, want_imag: bool = True):
    """The four-product form of ``(ar + i ai) @ (br + i bi)`` with einsum."""
    dot = lambda a, b: torch.einsum("bmk,bkn->bmn", a, b)
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


def complex_matmul(ar, ai, br, bi, want_imag: bool = True):
    """``C[b] = A[b] @ B[b]`` -> ``(cr, ci)`` of shape ``(batch, M, N)``.

    ``ci`` is ``None`` when ``want_imag`` is False. CPU tensors take
    :func:`complex_matmul_plain`; CUDA tensors launch the kernel or raise.
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
        err = lib.spfft_complex_matmul(
            _DTYPES[ar.dtype],
            ar.data_ptr(), ptr(ai), *ar.stride(),
            br.data_ptr(), ptr(bi), *br.stride(),
            cr.data_ptr(), ptr(ci), *cr.stride(),
            batch, m, n, k, torch.cuda.current_stream(ar.device).cuda_stream,
        )
    if err:
        raise GPULaunchError(f"complex_matmul launch failed: cudaError {err}")
    launches[(batch, m, k, n, ai is not None, bi is not None, want_imag)] += 1
    return cr, ci


def _library():
    lib = _build.library("complex_matmul")
    fn = lib.spfft_complex_matmul
    if not fn.argtypes:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ctypes.c_int, p, p, i64, i64, i64, p, p, i64, i64, i64,
                       p, p, i64, i64, i64, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    return lib
