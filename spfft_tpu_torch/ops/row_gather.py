"""K2: row gather, ``out[r, :] = src[idx[r], :]`` where ``0 <= idx[r] < len(src)``,
else a zero row.

Replaces the TPU row-gather kernels of ``programs/microbench_pallas_dma.py``
(:140, :193), ``microbench_pallas_dma2.py:112`` and
``microbench_pallas_dma3.py:119``: the gather that the accelerator engine's
expand and pack, and the slab exchange's pack and unpack, perform. Both
planes of a complex pair go through one launch. The CUDA kernel
(``csrc/row_gather.cu``, where its design and bound are) copies bytes: it
treats the output as a flat list of 16-, 8- or 4-byte vectors (the widest
that the row width, both row strides and the four plane pointers allow), so
that every lane of a warp is busy however narrow the rows, one vector a
thread. :func:`row_gather_plain` beside it is the same function in PyTorch.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .. import _build
from ..errors import GPULaunchError, InvalidParameterError
from ..obs import hlo

# Launches of the CUDA kernel, keyed by (n_rows, n_src, width, planes). The
# wrapper adds one where it launches and nowhere else.
launches: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.float64: 1}


def row_gather_plain(src, idx):
    """``index_select`` on ``src`` padded with one zero row, which every
    out-of-range index is sent to."""
    n_src = src.shape[0]
    padded = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    i = idx.long()
    i = torch.where((i >= 0) & (i < n_src), i, torch.full_like(i, n_src))
    return padded.index_select(0, i)


def _row_strided(t) -> bool:
    """A 2-D plane whose rows are unit-stride runs ``stride(0) >= W`` apart."""
    return t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1) and (
        t.shape[0] <= 1 or t.stride(0) >= t.shape[1])


@hlo.kernel_entry
def row_gather(src_re, src_im, idx, out=None):
    """Gather rows of the ``(n_src, W)`` planes ``src_re`` and (unless None)
    ``src_im`` by the int32 table ``idx`` -> ``(out_re, out_im)`` of shape
    ``(len(idx), W)``. A plane may be row-strided (a column block of a wider
    buffer); ``out``, a pair like the result, receives the rows in place of
    new tensors and may be row-strided too. The same operands are refused on
    every device. CPU tensors take :func:`row_gather_plain`; CUDA tensors
    launch the kernel or raise."""
    planes = [t for t in (src_re, src_im) if t is not None]
    if any(t.dim() != 2 or t.shape != src_re.shape for t in planes) or idx.dim() != 1:
        raise InvalidParameterError("row_gather takes (n_src, W) planes and a 1-D index")
    if any(t.dtype != src_re.dtype or t.device != src_re.device for t in planes):
        raise InvalidParameterError("row_gather planes differ in dtype or device")
    if idx.device != src_re.device:
        raise InvalidParameterError("row_gather index lies on another device")
    n_src, width = src_re.shape
    n_rows = idx.shape[0]
    if out is not None:
        dst = [t for t in out if t is not None]
        if len(dst) != len(planes) or any(
                t.shape != (n_rows, width) or t.dtype != src_re.dtype or t.device != src_re.device
                or not _row_strided(t) or t.stride(0) != dst[0].stride(0) for t in dst):
            raise InvalidParameterError(
                "row_gather out= takes one (len(idx), W) plane per source plane, row-strided "
                "alike, of the source's dtype and device")
    if src_re.dtype not in _DTYPES or idx.dtype != torch.int32:
        raise InvalidParameterError("row_gather takes float32/float64 rows and int32 indices")
    if not (all(_row_strided(t) and t.stride(0) == src_re.stride(0) for t in planes)
            and idx.is_contiguous()):
        raise InvalidParameterError(
            "row_gather takes row-strided planes of one row stride and a contiguous index")
    if src_re.device.type not in ("cpu", "cuda"):
        raise InvalidParameterError(f"row_gather runs on cpu or cuda, not {src_re.device}")
    if out is None and (src_re.device.type == "cuda" or n_rows == 0 or width == 0):
        out = [torch.empty((n_rows, width), dtype=src_re.dtype, device=src_re.device)
               for _ in planes]
    if n_rows == 0 or width == 0:  # nothing to gather, on either device
        return out[0], (out[1] if src_im is not None else None)
    if src_re.device.type == "cpu":
        got = [None if t is None else row_gather_plain(t, idx) for t in (src_re, src_im)]
        hlo.kernel_ran(hlo.K2, src_re)  # where the card launches the kernel
        if out is None:
            return tuple(got)
        for o, g in zip(out, got):
            if o is not None:
                o.copy_(g)
        return tuple(out)
    out_re, out_im = out[0], (out[1] if src_im is not None else None)
    lib = _library()
    ld_src = src_re.stride(0) if n_src > 1 else width
    ld_out = out_re.stride(0) if n_rows > 1 else width
    with torch.cuda.device(src_re.device):
        err = lib.spfft_row_gather(
            _DTYPES[src_re.dtype], src_re.data_ptr(),
            None if src_im is None else src_im.data_ptr(),
            out_re.data_ptr(), None if out_im is None else out_im.data_ptr(),
            idx.data_ptr(), n_rows, n_src, width, ld_src, ld_out,
            torch.cuda.current_stream(src_re.device).cuda_stream,
        )
    if err:
        raise GPULaunchError(f"row_gather launch failed: cudaError {err}")
    launches[(n_rows, n_src, width, len(planes))] += 1
    hlo.kernel_ran(hlo.K2, src_re)
    return out_re, out_im


def _library():
    lib = _build.library("row_gather")
    fn = lib.spfft_row_gather
    if not fn.argtypes:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, i64, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    return lib
