"""The line FFT: a batched radix FFT of power-of-two length along one axis,
in float32 on the CUDA cores, for the local engine's z and x stages.

It replaces no TPU kernel. It takes two stages from K1
(``ops/complex_matmul.py``, the counterpart of
``spfft_tpu/ops/pallas_fft.py:95``), which keeps the y stage and every plan
this rule leaves out: a float32 plan whose K1 form is ``"highest"`` runs its
z stage (length Z) and its x stage (length X) here wherever that length is a
power of two in ``[MIN_N, MAX_N]`` (``MxuLocalExecution``). K1 computes a
length-N DFT as a dense product, O(N^2) work a line on the tensor cores; as
an FFT the same line is O(N log N), and on an H100 the stage is then bound
by the bytes it moves through HBM, not by arithmetic. The CUDA source, with
its design, is ``csrc/line_fft.cu``; :func:`fft_plain` beside it is the same
arithmetic in PyTorch, op for op, so that on the card the two agree to the
bit.

The algorithm is Stockham's autosort FFT over the radices of
:func:`radices` (8, then one 2 or 4): pass ``p`` with stride ``Ns`` (the
product of the radices before it) and radix ``R`` takes butterfly ``j`` from
the positions ``j + r N / R``, multiplies element ``r`` by the twiddle
``w^(r (j mod Ns) N / (Ns R))`` of the table, runs a radix-R DFT (radix-2
decimation in frequency, in registers) and writes output ``q`` to
``(j div Ns) Ns R + (j mod Ns) + q Ns``. The twiddles ``w^m = exp(2 pi i m /
N)`` come from one table per length, computed in float64 and rounded once to
float32 (:func:`twiddle_table`); the backward stages are the +1 DFT, the
forward ones the -1 DFT (the table's conjugate).

Three forms, each a mode of the kernel:

* :func:`rows`: the z stage, both directions: rows of a ``(rows, N)``
  table, the forward one with the plan's scaling on its output;
* :func:`to_space`: the backward x stage, the ``(Y, A, Z)`` grid to the
  ``(Y, X, Z)`` space: slot ``a`` goes to line position ``ux[a]`` (the
  plan's slot order), a position no slot fills is zero. Real output (C2R):
  the half spectrum weighted by the hermitian weights (1 at 0 and at N/2,
  else 2), a full complex FFT, its real part stored: ``Fr A - Fi B`` of
  ``ops/fft.c2r_matrices``;
* :func:`from_space`: the forward x stage, the space (complex, or real with
  zero imaginary part) to the grid: slot ``a`` takes position ``ux[a]``,
  a padding slot (``ux = -1``) zero.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from .. import _build
from ..errors import GPULaunchError, InvalidParameterError
from ..obs import hlo

# The line lengths the kernel takes: powers of two in [MIN_N, MAX_N].
MIN_N = 64
MAX_N = 1024
# Values of a line each thread holds: every pass's radix divides it.
PER_THREAD = 8
# The kernel's modes (csrc/line_fft.cu).
ROWS, TO_SPACE, FROM_SPACE = 0, 1, 2
MODES = {ROWS: "rows", TO_SPACE: "to_space", FROM_SPACE: "from_space"}

# Launches of the CUDA kernel, keyed by (mode, n, lines, sign, real). The
# wrapper adds one where it launches and nowhere else.
launches: collections.Counter = collections.Counter()

_HALF_SQRT2 = torch.tensor(np.sqrt(0.5), dtype=torch.float32)


def supports(n: int) -> bool:
    """True if the kernel takes lines of length ``n``."""
    n = int(n)
    return MIN_N <= n <= MAX_N and n & (n - 1) == 0


def radices(n: int) -> tuple:
    """The passes' radices: 8 while 8 divides, then the 2 or 4 left."""
    out = []
    while n % 8 == 0 and n > 1:
        out.append(8)
        n //= 8
    if n > 1:
        out.append(n)
    return tuple(out)


def twiddle_table(n: int) -> np.ndarray:
    """``(n, 2)`` float32: ``cos``, ``sin`` of ``2 pi m / n``, computed in
    float64 and rounded once."""
    theta = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)


class Lines:
    """One stage's lines of length ``n`` on ``device``: the twiddle table
    and, for an x stage, the slot maps: ``ux`` (``(A,)`` int32, the line
    position of each slot, -1 on padding slots) and ``inv`` (``(n,)``
    int32, the slot at each position, -1 where none is)."""

    def __init__(self, n: int, device, slot_x=None, num_slots: int | None = None):
        if not supports(n):
            raise InvalidParameterError(f"line_fft takes power-of-two lengths in "
                                        f"[{MIN_N}, {MAX_N}], not {n}")
        self.n = int(n)
        self.table = torch.from_numpy(twiddle_table(self.n)).to(device)
        self.ux = self.inv = None
        if slot_x is not None:
            self.place(slot_x, num_slots)

    def place(self, slot_x, num_slots: int) -> None:
        """Set the slot maps of an x stage of ``num_slots`` slots: slot ``a``
        at line position ``slot_x[a]``, the slots past ``slot_x`` padding."""
        slot_x = np.asarray(slot_x, dtype=np.int64)
        ux = np.full(int(num_slots), -1, dtype=np.int64)
        ux[:slot_x.size] = slot_x
        inv = np.full(self.n, -1, dtype=np.int64)
        valid = np.flatnonzero(ux >= 0)
        inv[ux[valid]] = valid
        device = self.table.device
        self.ux = torch.from_numpy(ux.astype(np.int32)).to(device)
        self.inv = torch.from_numpy(inv.astype(np.int32)).to(device)


# ---- the plain version -----------------------------------------------------------------


def _radix(ur, ui, sign: int):
    """The radix-R DFT of the lists ``ur``, ``ui`` (R tensors each) by
    radix-2 decimation in frequency, as the kernel's ``dft`` computes it:
    the twiddles of W8 as exact sign changes, swaps and products with
    ``sqrt(1/2)``; the outputs in natural order."""
    R = len(ur)
    xr, xi = list(ur), list(ui)
    h = R // 2
    while h >= 1:
        for b in range(0, R, 2 * h):
            for i in range(h):
                ar, ai, cr, ci = xr[b + i], xi[b + i], xr[b + i + h], xi[b + i + h]
                xr[b + i], xi[b + i] = ar + cr, ai + ci
                dr, di = ar - cr, ai - ci
                k = 4 * i // h  # the power of W8
                if k == 1:
                    dr, di = _HALF_SQRT2 * (dr - sign * di), _HALF_SQRT2 * (di + sign * dr)
                elif k == 2:
                    dr, di = -sign * di, sign * dr
                elif k == 3:
                    dr, di = -(_HALF_SQRT2 * (dr + sign * di)), _HALF_SQRT2 * (sign * dr - di)
                xr[b + i + h], xi[b + i + h] = dr, di
        h //= 2
    bits = R.bit_length() - 1
    rev = [int(format(q, f"0{bits}b")[::-1], 2) for q in range(R)]
    return [xr[r] for r in rev], [xi[r] for r in rev]


def fft_plain(re, im, table, sign: int):
    """The kernel's FFT of the lines along the last axis of ``re``, ``im``
    (``im`` None: a real line), in PyTorch: the same passes, twiddles and
    float32 operations in the same order. Returns new ``(re, im)``."""
    n = re.shape[-1]
    lead = re.shape[:-1]
    xr = re.reshape(-1, n)
    xi = torch.zeros_like(xr) if im is None else im.reshape(-1, n)
    T = n // PER_THREAD
    t = torch.arange(T, device=re.device)
    cos, sin = table[:, 0], table[:, 1]
    ns = 1
    for R in radices(n):
        vr, vi = xr.reshape(-1, PER_THREAD, T), xi.reshape(-1, PER_THREAD, T)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        step = PER_THREAD // R
        for m in range(step):
            j = t + m * T
            k = j % ns
            ur = [vr[:, m + r * step] for r in range(R)]
            ui = [vi[:, m + r * step] for r in range(R)]
            if ns > 1:
                for r in range(1, R):
                    idx = r * k * (n // (ns * R))
                    c, ws = cos[idx], sign * sin[idx]
                    ur[r], ui[r] = ur[r] * c - ui[r] * ws, ur[r] * ws + ui[r] * c
            outr, outi = _radix(ur, ui, sign)
            base = (j // ns) * ns * R + k
            for q in range(R):
                yr[:, base + q * ns], yi[:, base + q * ns] = outr[q], outi[q]
        xr, xi = yr, yi
        ns *= R
    return xr.reshape(*lead, n), xi.reshape(*lead, n)


def hermitian_weights(n: int, device=None):
    """The C2R weights c_k of ``ops/fft.c2r_matrices`` at every position of
    a length-``n`` line: 1 at 0 and at n/2, else 2 (exact in float32)."""
    k = torch.arange(n, device=device)
    return torch.where((k == 0) | (k == n // 2), 1.0, 2.0).to(torch.float32)


def rows_plain(re, im, lines: Lines, sign: int, scale: float = 1.0):
    """:func:`rows` in PyTorch."""
    out = fft_plain(re, im, lines.table, sign)
    return out if scale == 1.0 else tuple(t * scale for t in out)


def to_space_plain(gre, gim, lines: Lines, real_out: bool):
    """:func:`to_space` in PyTorch: the grid's slots placed on the lines (a
    zero slot at the positions no slot fills), weighted for a real output,
    transformed, and ``(Y, X, Z)`` out."""
    n = lines.n
    inv = lines.inv.long()
    take = lambda g: torch.cat([g, g.new_zeros((g.shape[0], 1, g.shape[2]))], 1)[
        :, torch.where(inv >= 0, inv, g.shape[1])].permute(0, 2, 1)  # (Y, Z, n)
    xr, xi = take(gre), take(gim)
    if real_out:
        w = hermitian_weights(n, gre.device)
        xr, xi = xr * w, xi * w
    yr, yi = fft_plain(xr, xi, lines.table, +1)
    space = lambda t: t.permute(0, 2, 1).contiguous()
    return space(yr) if real_out else (space(yr), space(yi))


def from_space_plain(sre, sim, lines: Lines):
    """:func:`from_space` in PyTorch: the space's lines transformed, each
    slot taking its position, a padding slot zero; ``(Y, A, Z)`` out."""
    lines_of = lambda t: None if t is None else t.permute(0, 2, 1)  # (Y, Z, n)
    yr, yi = fft_plain(lines_of(sre), lines_of(sim), lines.table, -1)
    ux = lines.ux.long()
    keep = ux >= 0
    pick = lambda t: torch.where(keep[None, :, None],
                                 t[:, :, torch.where(keep, ux, 0)].permute(0, 2, 1),
                                 t.new_zeros(()))
    return pick(yr).contiguous(), pick(yi).contiguous()


# ---- the wrapper ------------------------------------------------------------------------


def _check_planes(what, planes):
    """Every plane float32 on one device (cpu or cuda), one shape and one
    set of strides, unit stride along the last axis."""
    first = planes[0]
    for t in planes:
        if t.dtype != torch.float32:
            raise InvalidParameterError(f"line_fft {what} takes float32 planes, not {t.dtype}")
        if t.device != first.device or t.shape != first.shape or t.stride() != first.stride():
            raise InvalidParameterError(
                f"line_fft {what}: the planes differ in device, shape or strides")
    if first.device.type not in ("cpu", "cuda"):
        raise InvalidParameterError(f"line_fft runs on cpu or cuda, not {first.device}")
    if first.dim() and first.shape[-1] > 1 and first.stride(-1) != 1:
        raise InvalidParameterError(f"line_fft {what}: the last axis must have unit stride")


def _check_lines(lines: Lines, device, slots: bool):
    if lines.table.device != device:
        raise InvalidParameterError("line_fft: the twiddle table lies on another device")
    if slots and lines.ux is None:
        raise InvalidParameterError("line_fft: an x stage needs the lines' slot maps")


@hlo.kernel_entry
def rows(re, im, lines: Lines, sign: int, scale: float = 1.0):
    """The z stage: the FFT of every row of the ``(rows, N)`` planes ``re``,
    ``im`` (``sign`` +1 backward, -1 forward), times ``scale``. Returns new
    ``(re, im)``."""
    if sign not in (1, -1):
        raise InvalidParameterError(f"line_fft sign is +1 or -1, not {sign}")
    _check_planes("rows", [re, im])
    if re.dim() != 2 or re.shape[1] != lines.n:
        raise InvalidParameterError(f"line_fft rows takes (rows, {lines.n}) planes")
    _check_lines(lines, re.device, slots=False)
    if re.device.type == "cpu":
        out = rows_plain(re, im, lines, sign, scale)
        hlo.kernel_ran(hlo.FFT, re)  # where the card launches the kernel
        return out
    out = (torch.empty(re.shape, dtype=re.dtype, device=re.device),
           torch.empty(re.shape, dtype=re.dtype, device=re.device))
    if re.shape[0]:
        _launch(ROWS, sign, re, im, *out, lines, None, (re.shape[0], 0, 0),
                (re.stride(0), 0), (out[0].stride(0), 0), scale)
    return out


@hlo.kernel_entry
def to_space(gre, gim, lines: Lines, real_out: bool):
    """The backward x stage: the ``(Y, A, Z)`` grid planes -> the ``(Y, X,
    Z)`` space, ``(re, im)``, or its real plane alone where ``real_out``
    (C2R, with the hermitian weights)."""
    _check_planes("to_space", [gre, gim])
    if gre.dim() != 3 or lines.ux is None or gre.shape[1] != lines.ux.shape[0]:
        raise InvalidParameterError("line_fft to_space takes (Y, A, Z) planes, A the lines' slots")
    _check_lines(lines, gre.device, slots=True)
    if gre.device.type == "cpu":
        out = to_space_plain(gre, gim, lines, real_out)
        hlo.kernel_ran(hlo.FFT, gre)
        return out
    Y, A, Z = gre.shape
    new = lambda: torch.empty((Y, lines.n, Z), dtype=gre.dtype, device=gre.device)
    out_re, out_im = new(), (None if real_out else new())
    if Y and Z:
        _launch(TO_SPACE, +1, gre, gim, out_re, out_im, lines, lines.inv, (Y, A, Z),
                gre.stride()[:2], out_re.stride()[:2], 1.0)
    return out_re if real_out else (out_re, out_im)


@hlo.kernel_entry
def from_space(sre, sim, lines: Lines):
    """The forward x stage: the ``(Y, X, Z)`` space planes (``sim`` None: a
    real space) -> the ``(Y, A, Z)`` grid ``(re, im)``."""
    _check_planes("from_space", [t for t in (sre, sim) if t is not None])
    if sre.dim() != 3 or sre.shape[1] != lines.n:
        raise InvalidParameterError(f"line_fft from_space takes (Y, {lines.n}, Z) planes")
    _check_lines(lines, sre.device, slots=True)
    if sre.device.type == "cpu":
        out = from_space_plain(sre, sim, lines)
        hlo.kernel_ran(hlo.FFT, sre)
        return out
    Y, _, Z = sre.shape
    A = lines.ux.shape[0]
    out = (torch.empty((Y, A, Z), dtype=sre.dtype, device=sre.device),
           torch.empty((Y, A, Z), dtype=sre.dtype, device=sre.device))
    if Y and Z and A:
        _launch(FROM_SPACE, -1, sre, sim, *out, lines, lines.ux, (Y, A, Z),
                sre.stride()[:2], out[0].stride()[:2], 1.0)
    return out


def _launch(mode, sign, in_re, in_im, out_re, out_im, lines, slot_map, dims, in_strides,
            out_strides, scale):
    """One launch of the kernel on the current stream; raises if refused."""
    lib = _library()
    with torch.cuda.device(in_re.device):
        err = lib.spfft_line_fft(
            mode, lines.n, sign, in_re.data_ptr(), None if in_im is None else in_im.data_ptr(),
            out_re.data_ptr(), None if out_im is None else out_im.data_ptr(),
            lines.table.data_ptr(), None if slot_map is None else slot_map.data_ptr(),
            *dims, *in_strides, *out_strides, float(scale),
            torch.cuda.current_stream(in_re.device).cuda_stream)
    if err:
        raise GPULaunchError(f"line_fft launch failed: cudaError {err}")
    lines_count = dims[0] if mode == ROWS else dims[0] * dims[2]
    launches[(MODES[mode], lines.n, lines_count, sign, in_im is None or out_im is None)] += 1
    hlo.kernel_ran(hlo.FFT, in_re)


def _library():
    lib = _build.library("line_fft")
    fn = lib.spfft_line_fft
    if not fn.argtypes:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        fn.argtypes = [i32, i32, i32, p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib
