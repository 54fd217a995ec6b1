"""The accelerator engine: every DFT stage a matrix product.

The port of the JAX package's ``MxuLocalExecution``: the same function, the
same ``(Y, X, Z)`` native space layout with z minor (z-sticks are rows), and
no transpose anywhere in the pipeline.

* **unique-x compaction**: the y/x stages touch only the A x-rows that carry a
  stick (padded to ``SPFFT_TPU_XPAD``, 8), so the intermediate grid is
  ``(Y, A, Z)`` and the x-stage matrices are rectangular (reference: the
  "uniqueXIndices" optimisation, src/execution/execution_host.cpp:138-144),
* every DFT stage is one launch of kernel K1 at the plan's precision
  (``"highest"``: FP32-accurate 3xTF32, ``"high"``: bf16x3, ``"default"``:
  one bf16 pass; float64 ignores it), on strided views, but for the z and
  x stages of a float32 plan whose K1 form is ``"highest"``: each of them
  whose length (Z, X) is a power of two that the line FFT takes
  (``ops/line_fft.supports``) is one launch of that kernel, an O(N log N)
  FFT in FP32 bound by HBM bytes, in place of K1's dense N x N product
  (``describe()``: ``z_stage``, ``x_stage``). The mesh engines, which fold
  a z permutation into their z matrix, keep K1,
* the y stage has three plans, chosen by the JAX package's policy
  (``ops/fft.py``: ``plan_sparse_y``, ``plan_sparse_y_blocked`` and their knobs):

  - **dense**: expand the ``(S, Z)`` sticks to the grid (one K2 launch), one
    y-DFT over all Y rows, pack back (one K2 launch);
  - **per-slot** (C2C only, where the fullest x slot has under 0.6 Y sticks):
    the stick table is ``(A, Sy, Z)``, each slot's sticks padded to Sy, and
    the y-DFT of every slot is one batched K1 launch from and into the
    table: no expand and no pack;
  - **blocked** (C2C and R2C, above that crossover): the slots sorted by
    stick count and cut into buckets, each padded to its own Syg. Backward:
    one K2 gather builds every bucket's ``(Ag, Syg, Z)`` table, then one K1
    launch per bucket writes its columns of the grid. Forward: one K1 launch
    per bucket into one flat buffer, then one K2 regather to the sticks. For
    R2C the x == 0 slot is a trailing dense ``(1, Y)`` bucket, where its
    plane gets the hermitian fill,

* decompress/compress are index scatter/gather on the flat stick table, and the
  hermitian fills of R2C are plain tensor code.

Backward: decompress -> stick symmetry (R2C) -> z -> y (with its plane
symmetry for R2C) -> x (C2R for R2C). Forward reverses it; the FULL scaling
rides the forward-z matrix, or the line FFT's store. Each step is a stage
body (``_st_*``, ``_expand``, ``_pack``, ``_compress``) that ``ir.lower``
makes a node of.
"""
from __future__ import annotations

import numpy as np
import torch

from .execution import ExecutionBase
from .ops import compression, line_fft, symmetry
from .ops import fft as offt
from .ops.complex_matmul import Constant
from .ops.row_gather import row_gather
from .parameters import LocalParameters
from .types import ScalingType

_SLOTS_OUT, _SLOTS_IN = "ajz,ajk->kaz", "yaz,ajy->ajz"


class MxuLocalExecution(ExecutionBase):
    """Single-device pipeline for one plan, run as its stage graphs
    (:mod:`spfft_tpu_torch.ir`). Pair I/O on the plan's device; space-domain
    tensors are ``(Y, X, Z)`` native."""

    NATIVE_LAYOUT = "yxz"
    # The z and x stages' line FFTs (ops/line_fft.py): None where K1 runs the
    # stage, as it does on every mesh engine.
    _z_lines = None
    _x_lines = None

    def __init__(self, params: LocalParameters, real_dtype, device, precision="highest",
                 fuse=None):
        super().__init__(params, real_dtype, device)
        p = params
        S, Z = p.num_sticks, p.dim_z
        self.precision = offt.resolve_precision(precision)
        self.k1_precision = offt.k1_form(self.precision, self.real_dtype)
        self.twiddle_dtype = offt.twiddle_dtype(self.real_dtype)
        self._zs = Z  # the z extent of the (Y, A, Z) grid
        fft = self.k1_precision == "highest" and self.real_dtype == np.dtype(np.float32)

        if S:
            ux = np.unique(np.asarray(p.stick_x, dtype=np.int64))
            xslot = np.searchsorted(ux, np.asarray(p.stick_x, dtype=np.int64))
        else:
            ux = np.zeros(1, dtype=np.int64)
            xslot = np.zeros(0, dtype=np.int64)
        self.num_x_active = offt.compact_x_extent(ux.size, p.dim_x_freq)

        if fft and line_fft.supports(Z):
            self._z_lines = line_fft.Lines(Z, self.device)
        else:
            wz_b, _, _, wz_f = offt.zy_stage_matrices(Z, p.dim_y, p.total_size, self.real_dtype)
            self._wz_b = self._const(wz_b)
            self._wz_f = {s: self._const(w) for s, w in wz_f.items()}
        if fft and line_fft.supports(p.dim_x):
            self._x_lines = line_fft.Lines(p.dim_x, self.device)  # its slots: _plan_y

        xslot, row_of_stick = self._plan_y(xslot, p.stick_y, ux, S,
                                           has_x0=bool(S) and int(ux[0]) == 0)
        value_indices = np.asarray(p.value_indices, dtype=np.int64)
        self._table_rows = S
        if self.sy:  # per-slot: decompress straight into the (A, Sy, Z) table
            value_indices = row_of_stick[value_indices // Z] * Z + value_indices % Z
            self._table_rows = self.num_x_active * self.sy
        elif self.buckets is not None:
            self._bucket_rows = self.put(self._bucket_rows_np)
            self._row_of_stick = self.put(row_of_stick)
        self._vi = self.put(value_indices, torch.int64)
        if self.y_plan == "dense":
            # expand: (y, slot) row -> stick id, S (out of range) -> zero row
            A = self.num_x_active
            yx_map = np.full(p.dim_y * A, S, dtype=np.int32)
            keys = p.stick_y.astype(np.int64) * A + xslot
            yx_map[keys] = np.arange(S)
            self._yx_map = self.put(yx_map)
            # pack: stick id -> (y, slot) row
            self._stick_keys = self.put(keys.astype(np.int32))
        self._init_ir(fuse)

    # ---- introspection ----------------------------------------------------------

    @property
    def y_plan(self) -> str:
        """The engaged y plan: ``"per-slot"``, ``"blocked"`` or ``"dense"``."""
        return "per-slot" if self.sy else ("blocked" if self.buckets is not None else "dense")

    def _y_stage_scope(self) -> str:
        return {"per-slot": "y transform sparse", "blocked": "y transform blocked"}.get(
            self.y_plan, "y transform")

    def describe(self) -> dict:
        """The engine's plan decisions, as the JAX engine's ``describe()``
        gives those the port has."""
        return {
            "matmul_precision": self.precision.upper(),
            "k1_form": self.k1_precision,
            "twiddle_dtype": self.twiddle_dtype,
            "num_x_active": int(self.num_x_active),
            "dim_x_freq": int(self.params.dim_x_freq),
            "sparse_y": offt.describe_sparse_y(bool(self.sy), self.buckets, self.sy),
            "z_stage": "k1" if self._z_lines is None else "fft",
            "x_stage": "k1" if self._x_lines is None else "fft",
        }

    # ---- the y plan and the x matrices (shared with the mesh engine) -----------

    def _const(self, w):
        """A stage's DFT matrix V (K x Q), prepared once for K1 (on a float32
        CUDA plan: split and laid out in the kernel's tiles)."""
        return Constant(*self.put_pair(w), self.k1_precision)

    def _const_t(self, w):
        """The same for a stage whose matrix is the product's left factor: V = W^T."""
        return Constant(*(t.mT for t in self.put_pair(w)), self.k1_precision)

    def _plan_y(self, xslot, ys, ux, num_sticks, has_x0, blocked=True):
        """Choose the y plan as the JAX engine does (C2C tries per-slot
        first, then blocked unless ``blocked`` is False, else dense) for
        sticks at active-x slots ``xslot`` and rows ``ys``; make the y and x
        stage matrices. ``ux``: the x of each slot. Returns ``(xslot,
        row_of_stick)`` in the plan's slot order (bucket-major when blocked):
        ``row_of_stick`` is each stick's table row (per-slot) or bucket flat
        row (blocked), else None. A blocked plan also leaves
        ``_bucket_rows_np``: every bucket's stick per row, ``num_sticks`` for
        none. ``_slot_x`` is the x of each slot in the plan's order: the x
        stage's matrices fold it, or the line FFT's slot maps where
        ``_x_lines`` runs that stage."""
        A, Y, rt = self.num_x_active, self.params.dim_y, self.real_dtype
        self.sy = 0  # per-slot: sticks per slot; 0 otherwise
        self.buckets = None  # blocked: per bucket (Ag, Syg, backward V, forward V)
        self._x0_bucket = None
        row_of_stick = None
        per_slot = (None if self.is_r2c or not num_sticks
                    else offt.plan_sparse_y(xslot, ys, A, Y, rt))
        if per_slot is not None:
            self.sy, row_of_stick, wyb, wyf = per_slot
            self._wy_b, self._wy_f = self._const(wyb), self._const_t(wyf)
        elif num_sticks and blocked:
            dense_slots = (0,) if self.is_r2c and has_x0 else ()
            blk = offt.plan_sparse_y_blocked(xslot, ys, Y, rt, num_sticks, A * Y,
                                             dense_slots=dense_slots)
            if blk is not None:
                self.buckets = [(*r.shape, self._const(wyb), self._const_t(wyf))
                                for r, wyb, wyf in blk["buckets"]]
                if dense_slots:  # the x == 0 plane is the last bucket
                    self._x0_bucket = len(self.buckets) - 1
                self._bucket_rows_np = np.concatenate(
                    [r.reshape(-1) for r, _, _ in blk["buckets"]])
                row_of_stick = blk["row_of_stick"]
                # bucket-major slot order: the x-stage matrices fold it
                perm = blk["slot_perm"]
                ux = ux[perm]
                pos = np.empty(perm.size, dtype=np.int64)
                pos[perm] = np.arange(perm.size)
                xslot = pos[xslot]
        if not self.sy and self.buckets is None:
            self._wy_b = self._const(offt.matrix_pair(offt.c2c_matrix(Y, +1), rt))
            self._wy_f = self._const(offt.matrix_pair(offt.c2c_matrix(Y, -1), rt))
        self._slot_x = np.asarray(ux)
        if self._x_lines is None:
            wx_b, wx_f = offt.x_stage_matrices(self.params.dim_x, ux, A, self.is_r2c, rt)
            self._wx_b, self._wx_f = self._const(wx_b), self._const(wx_f)
        else:
            self._x_lines.place(ux, A)
        # the x == 0 plane's slot, in the plan's slot order, where dense-y
        # R2C plane symmetry acts
        x0 = np.flatnonzero(np.asarray(ux) == 0) if has_x0 else np.empty(0)
        self._x0_slot = int(x0[0]) if x0.size else None
        return xslot, row_of_stick

    # ---- stage bodies (the nodes of ir.lower._lower_local_mxu) ----------------------
    # The same K1/K2 launches as one hand-ordered pipeline would make. The
    # hermitian fills write in place, each into an edge that no other node
    # reads (this call's decompress, expand or bucket-gather buffers).

    def _mm(self, xr, xi, w, spec, out=None):
        """One K1 stage with the plan constant ``w``."""
        return offt.complex_matmul(xr, xi, *offt.constant_operands(spec, w), spec, constant=w,
                                   precision=self.k1_precision, out=out)

    def _st_decompress(self, values_re, values_im):
        """Packed values -> the (table rows, Z) stick table."""
        p, dt = self.params, self.torch_dtype
        return tuple(compression.decompress(v.to(dt), self._vi, self._table_rows, p.dim_z)
                     for v in (values_re, values_im))

    def _st_stick_symmetry(self, sre, sim):
        # in place: the decompress edge is read by this node alone
        i = self._zero_stick_id
        sre[i], sim[i] = symmetry.hermitian_fill_1d_pair(sre[i], sim[i], axis=0)
        return sre, sim

    def _st_z_backward(self, sre, sim):
        if self._z_lines is not None:
            return line_fft.rows(sre, sim, self._z_lines, +1)
        return self._mm(sre, sim, self._wz_b, "sz,zk->sk")

    def _expand(self, sre, sim):
        """(S, Z) sticks -> (Y, A, Z) active-x planes: one K2 launch."""
        p = self.params
        gre, gim = row_gather(sre, sim, self._yx_map)
        shape = (p.dim_y, self.num_x_active, p.dim_z)
        return gre.reshape(shape), gim.reshape(shape)

    def _st_plane_symmetry(self, gre, gim):
        # in place: the expand edge is read by this node alone
        s = self._x0_slot
        gre[:, s, :], gim[:, s, :] = symmetry.hermitian_fill_1d_pair(
            gre[:, s, :], gim[:, s, :], axis=0
        )
        return gre, gim

    def _st_y_dense_backward(self, gre, gim):
        return self._mm(gre, gim, self._wy_b, "yxz,yk->kxz")

    def _st_y_sparse_backward(self, sre, sim):
        """Per slot: the y-DFT straight off the (A, Sy, Z) table into the grid."""
        A, Z = self.num_x_active, self._zs
        return self._mm(sre.view(A, self.sy, Z), sim.view(A, self.sy, Z), self._wy_b, _SLOTS_OUT)

    def _st_y_blocked_backward(self, sre, sim):
        """One K2 gather builds every bucket's (Ag, Syg, Z) table, then one K1
        launch per bucket writes its columns of the (Y, A, Z) grid."""
        return self._y_blocked_from_tables(*row_gather(sre, sim, self._bucket_rows))

    def _y_blocked_from_tables(self, tre, tim):
        """One K1 launch per bucket, from the buckets' concatenated
        (rows, Z) tables into its columns of the (Y, A, Z) grid."""
        Y, A, Z = self.params.dim_y, self.num_x_active, self._zs
        gre, gim = tre.new_empty((Y, A, Z)), tim.new_empty((Y, A, Z))
        cols = sum(ag for ag, _, _, _ in self.buckets)
        gre[:, cols:], gim[:, cols:] = 0, 0  # padding slots: no bucket writes them
        row = col = 0
        for b, (ag, syg, wb, _) in enumerate(self.buckets):
            xr, xi = (t[row:row + ag * syg].view(ag, syg, Z) for t in (tre, tim))
            if b == self._x0_bucket:
                # R2C: the x == 0 plane, its rows at their own y; in place in
                # this node's own gather buffer
                xr[0], xi[0] = symmetry.hermitian_fill_1d_pair(xr[0], xi[0], axis=0)
            self._mm(xr, xi, wb, _SLOTS_OUT, out=(gre[:, col:col + ag], gim[:, col:col + ag]))
            row, col = row + ag * syg, col + ag
        return gre, gim

    def _st_x_backward(self, gre, gim):
        """The (Y, A, Z) grid -> (Y, X, Z) space: (re, im), or real for R2C."""
        if self._x_lines is not None:
            return line_fft.to_space(gre, gim, self._x_lines, real_out=self.is_r2c)
        w = self._wx_b
        if self.is_r2c:
            return offt.real_out_matmul(gre, gim, *w.pair, "kxz,xl->klz", constant=w,
                                        precision=self.k1_precision)
        return self._mm(gre, gim, w, "kxz,xl->klz")

    def _st_x_forward(self, space_re, space_im):
        """(Y, X, Z) space (``space_im`` None for R2C) -> the (Y, A, Z) grid."""
        if self._x_lines is not None:
            return line_fft.from_space(space_re, space_im, self._x_lines)
        w = self._wx_f
        if self.is_r2c:
            return offt.real_in_matmul(space_re, *w.pair, "yxz,xk->ykz", constant=w,
                                       precision=self.k1_precision)
        return self._mm(space_re, space_im, w, "yxz,xk->ykz")

    def _st_y_dense_forward(self, gre, gim):
        return self._mm(gre, gim, self._wy_f, "ykz,yl->lkz")

    def _pack(self, gre, gim):
        """(Y, A, Z) planes -> (S, Z) sticks: one K2 launch."""
        rows = self.params.dim_y * self.num_x_active
        z = self.params.dim_z
        return row_gather(gre.reshape(rows, z), gim.reshape(rows, z), self._stick_keys)

    def _st_y_sparse_forward(self, gre, gim):
        """Per slot: the y-DFT from the grid straight into the stick table."""
        Z = self._zs
        sre, sim = self._mm(gre, gim, self._wy_f, _SLOTS_IN)
        return sre.view(-1, Z), sim.view(-1, Z)

    def _st_y_blocked_forward(self, gre, gim):
        """One K1 launch per bucket into one flat buffer, then one K2 regather
        to the sticks."""
        return row_gather(*self._y_blocked_to_flat(gre, gim), self._row_of_stick)

    def _y_blocked_to_flat(self, gre, gim):
        """One K1 launch per bucket, from its grid columns into the buckets'
        concatenated (rows, Z) flat buffer."""
        Z = self._zs
        rows = sum(ag * syg for ag, syg, _, _ in self.buckets)
        fre, fim = gre.new_empty((rows, Z)), gim.new_empty((rows, Z))
        row = col = 0
        for ag, syg, _, wf in self.buckets:
            out = tuple(t[row:row + ag * syg].view(ag, syg, Z) for t in (fre, fim))
            self._mm(gre[:, col:col + ag], gim[:, col:col + ag], wf, _SLOTS_IN, out=out)
            row, col = row + ag * syg, col + ag
        return fre, fim

    def _st_z_forward(self, sre, sim, scaling):
        """The z-DFT, with the FULL scaling in its matrix (in the line FFT's
        store)."""
        if self._z_lines is not None:
            full = ScalingType(scaling) == ScalingType.FULL
            return line_fft.rows(sre, sim, self._z_lines, -1,
                                 1.0 / self.params.total_size if full else 1.0)
        return self._mm(sre, sim, self._wz_f[ScalingType(scaling)], "sz,zk->sk")

    def _compress(self, sre, sim):
        return compression.compress(sre, self._vi), compression.compress(sim, self._vi)

    # ---- the legacy path (ir_lower_failed): the stage bodies in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        cur = self._st_decompress(values_re, values_im)
        if self.is_r2c and self._zero_stick_id is not None:
            cur = self._st_stick_symmetry(*cur)
        cur = self._st_z_backward(*cur)
        if self.y_plan == "per-slot":
            cur = self._st_y_sparse_backward(*cur)
        elif self.y_plan == "blocked":
            cur = self._st_y_blocked_backward(*cur)
        else:
            cur = self._expand(*cur)
            if self.is_r2c and self._x0_slot is not None:
                cur = self._st_plane_symmetry(*cur)
            cur = self._st_y_dense_backward(*cur)
        return self._st_x_backward(*cur)

    def _legacy_forward(self, scaling, space_re, space_im):
        cur = self._st_x_forward(space_re, space_im)
        if self.y_plan == "per-slot":
            cur = self._st_y_sparse_forward(*cur)
        elif self.y_plan == "blocked":
            cur = self._st_y_blocked_forward(*cur)
        else:
            cur = self._pack(*self._st_y_dense_forward(*cur))
        return self._compress(*self._st_z_forward(*cur, scaling))
