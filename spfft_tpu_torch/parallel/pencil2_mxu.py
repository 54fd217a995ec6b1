"""The matrix-product pencil engine: every DFT stage one K1 launch over all
stacked shards, every exchange direction one K2 gather (or pack and unpack).

The port of ``spfft_tpu/parallel/pencil2_mxu.py`` over the layouts of
:mod:`.pencil2`:

* z: ``sz,zk->sk`` over the ``(P_local * S_max, Z)`` stick table, with the
  z-slab split folded into the matrix (a column per padded slab plane, zero
  on padding planes), so the stick rows of exchange A come out of K1;
* y: the dense y-DFT over the ``(Y, P_local * Ax, Lz)`` y-pencil grid
  (``yxz,yk->kxz``; the pencil engine has no sparse-y plans);
* x: over the ``(P_local * Ly, P1 * Ax, Lz)`` slab side (``kxz,xl->klz``),
  the (group, slot) -> x map folded into the matrix (zero rows on empty
  slots, ``ops/fft.x_stage_matrices``), so the slab side needs no column
  scatter; R2C takes the real-out and real-in forms. The result is each
  shard's ``(Ly, X, Lz)`` block, the local engine's ``yxz`` layout.

Forward reverses it; the FULL scaling rides the forward-z matrix. (re, im)
pairs on every edge.

Not ported: the lane-copy value plans and their alignment rotations
(``_phase_tables``/``apply_alignment_phase``, the TPU's lane alignment of
decompress and compress); one index copy over the stacked values computes
the same function (``ops/compression.py``).
"""
from __future__ import annotations

import numpy as np

from ..execution_mxu import MxuLocalExecution
from ..ops import fft as offt
from ..ops import symmetry
from ..types import ScalingType
from .execution_mxu import MxuDistributedExecution
from .pencil2 import Pencil2Helpers


class MxuPencil2Execution(Pencil2Helpers, MxuDistributedExecution):
    """The matrix-product engine over a pencil mesh: the slab engine's
    decompress and compress, the local engine's z, dense y and x stage
    bodies at the pencil's shapes."""

    def __init__(self, params, real_dtype, mesh, exchange_type, precision="highest",
                 overlap=1, fuse=None):
        def columns(g):  # the slab side holds the (group, slot) columns
            return np.arange(g.P1 * g.Ax), g.P1 * g.Ax

        self._setup_pencil(params, real_dtype, mesh, exchange_type, columns, planes=2,
                           overlap=overlap)
        self.precision = offt.resolve_precision(precision)
        self.k1_precision = offt.k1_form(self.precision, self.real_dtype)
        self.twiddle_dtype = offt.twiddle_dtype(self.real_dtype)
        p, g, rt = params, self.geometry, self.real_dtype
        Z, Y = p.dim_z, p.dim_y
        self.sy, self.buckets = 0, None  # the dense y plan
        self.num_x_active = g.P1 * g.Ax
        perm = np.where(self._pack_z2 < Z, self._pack_z2, -1)
        self._wz_b = self._const(offt.matrix_pair(offt.c2c_matrix(Z, +1, row_perm=perm).T, rt))
        self._wz_f = {
            ScalingType.NONE: self._const(offt.matrix_pair(
                offt.c2c_matrix(Z, -1, row_perm=perm), rt)),
            ScalingType.FULL: self._const(offt.matrix_pair(
                offt.c2c_matrix(Z, -1, scale=1.0 / p.total_size, row_perm=perm), rt)),
        }
        self._wy_b = self._const(offt.matrix_pair(offt.c2c_matrix(Y, +1), rt))
        self._wy_f = self._const(offt.matrix_pair(offt.c2c_matrix(Y, -1), rt))
        slot_to_x = np.where(g.xcol < p.dim_x_freq, g.xcol, -1)
        wx_b, wx_f = offt.x_stage_matrices(p.dim_x, slot_to_x, slot_to_x.size, self.is_r2c, rt)
        self._wx_b, self._wx_f = self._const(wx_b), self._const(wx_f)
        self._init_ir(fuse)

    def describe(self) -> dict:
        return {"pipeline": "matmul DFT stages + exchange gathers (pencil)",
                "matmul_precision": self.precision.upper(), "k1_form": self.k1_precision,
                "twiddle_dtype": self.twiddle_dtype, **self._geometry()}

    def _rows(self, *parts, width=None):
        return [t.reshape(-1, width or self._Lz) for t in parts]

    def _shaped(self, rows, shape, tag, direction):
        return tuple(t.view(shape) for t in rows)

    # ---- stage bodies (the nodes of ir.lower._lower_pencil) ---------------------
    # decompress, stick symmetry, z, dense y and compress are the slab and
    # local engines' bodies.

    def _st_plane_symmetry(self, gre, gim):
        # in place: the exchange A edge is read by this node alone
        c = self._x0_cols
        if c is not None:
            gre[:, c], gim[:, c] = symmetry.hermitian_fill_1d_pair(gre[:, c], gim[:, c], axis=0)
        return gre, gim

    def _st_x_backward(self, gre, gim):
        """The slab side -> each shard's ``(Ly, X, Lz)`` block, stacked."""
        out = MxuLocalExecution._st_x_backward(self, gre, gim)
        shape = (self.num_local, self._Ly, self.params.dim_x, self._Lz)
        return out.view(shape) if self.is_r2c else tuple(t.view(shape) for t in out)

    def _st_x_forward(self, space_re, space_im, zwin=None):
        """Each shard's ``(Ly, X, Lz)`` block, or its z window ``zwin`` (a
        strided view: K1 reads it in place), -> the slab side."""
        c0, c1 = (0, self._Lz) if zwin is None else zwin
        flat = lambda t: None if t is None else t.reshape(-1, self.params.dim_x, self._Lz)[
            :, :, c0:c1]
        return MxuLocalExecution._st_x_forward(self, flat(space_re), flat(space_im))

    def _st_x_backward_window(self, c0, c1, space, gre, gim):
        """An OVERLAPPED chunk's x stage: K1 writes straight into its z
        window of the native space (None: a new one), which it returns."""
        p = self.params
        if space is None:
            shape = (self.num_local, self._Ly, p.dim_x, self._Lz)
            space = gre.new_empty(shape) if self.is_r2c else (gre.new_empty(shape),
                                                                gim.new_empty(shape))
        parts = (space,) if self.is_r2c else space
        out = tuple(t.view(-1, p.dim_x, self._Lz)[:, :, c0:c1] for t in parts)
        w = self._wx_b
        if self.is_r2c:
            offt.contract("kxz,xl->klz", gre, gim, *w.pair, want_imag=False, constant=w,
                          precision=self.k1_precision, out=(out[0], None))
        else:
            self._mm(gre, gim, w, "kxz,xl->klz", out=out)
        return space

    # ---- the legacy path (ir_lower_failed): _lower_pencil's nodes in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        cur = self._st_decompress(values_re, values_im)
        if self.is_r2c and self._zero_stick_id is not None:
            cur = self._st_stick_symmetry(*cur)
        cur = self._legacy_pencil_exchange("A", "backward", *self._st_z_backward(*cur))
        if self.is_r2c and self._x0_cols is not None:
            cur = self._st_plane_symmetry(*cur)
        cur = self._legacy_pencil_exchange("B", "backward", *self._st_y_dense_backward(*cur))
        return self._st_x_backward(*cur)

    def _legacy_forward(self, scaling, space_re, space_im):
        cur = self._legacy_pencil_exchange("B", "forward", *self._st_x_forward(space_re, space_im))
        cur = self._legacy_pencil_exchange("A", "forward", *self._st_y_dense_forward(*cur))
        return self._st_compress(*self._st_z_forward(*cur, scaling))
