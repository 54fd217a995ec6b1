"""The accelerator mesh engine: every DFT stage a matrix product (K1), every
move a row gather (K2), over the shards stacked on one device.

The port of the JAX package's ``MxuDistributedExecution``
(``spfft_tpu/parallel/execution_mxu.py``), with its plan decisions:

* the **global active-x compaction**: the y/x stages touch only the x rows
  that carry a stick on any shard (``SPFFT_TPU_XPAD``); at the full extent
  the slots are the x values themselves;
* the **y plan** (dense, per-slot for C2C, or blocked; blocked only below
  the full x extent) planned from the **global** stick arrays with the local
  engine's planners, so every shard agrees;
* the **exchange** over the engaged y plan's slab slots (plane slots, the
  per-slot ``(A, Sy)`` table rows or the blocked bucket rows).

The layout (:mod:`.execution`): the z stage writes ``(P_local * S_max, P *
L_max)`` stick rows, with the slab split folded into its DFT matrix (a
column per packed plane, zero on padding planes), so ragged z costs nothing
extra; the slab side is the local engine's table and grid with z extent
``P_local * L_max``, so the y and x stages are the local engine's stage
bodies, each one K1 launch over all local shards. Without a process group
the exchange is one K2 gather per direction, from the z stage's rows straight
into the y stage's table (it replaces the local engine's expand, bucket
gather, pack or regather); with one it is a pack gather, the collective and
an unpack gather.

Not ported: the lane-copy value plans and their phase rotations (the TPU's
lane alignment of the same decompress/compress; here one index copy over
the stacked ``(P_local, V_max)`` values) and the JAX engine's bucket-matrix
budget veto (its ``SPARSE_Y_MATRIX_MB`` knob: PyTorch embeds no constants).
"""
from __future__ import annotations

import numpy as np

from ..execution_mxu import MxuLocalExecution
from ..ops import fft as offt
from ..types import ScalingType
from .execution import PaddingHelpers
from .ragged import make_exchange


class MxuDistributedExecution(PaddingHelpers, MxuLocalExecution):
    """The MXU engine over a :class:`~.mesh.ShardMesh`; the boundary of
    :class:`~.execution.DistributedExecution`, pair data throughout."""

    def __init__(self, params, real_dtype, mesh, exchange_type, precision="highest",
                 fuse=None):
        self._setup(params, real_dtype, mesh, exchange_type)
        self.precision = offt.resolve_precision(precision)
        self.k1_precision = offt.k1_form(self.precision, self.real_dtype)
        self.twiddle_dtype = offt.twiddle_dtype(self.real_dtype)
        p = params
        S, L, Z, Y, Xf, P = self._S, self._L, p.dim_z, p.dim_y, p.dim_x_freq, p.num_shards
        self._zs = self.num_local * L  # the slab grid's z extent

        # global active-x compaction (spfft_tpu/parallel/execution_mxu.py:287-305)
        sx = p.stick_x_all.reshape(-1).astype(np.int64)
        valid = sx < Xf
        ux = np.unique(sx[valid])
        if ux.size == 0:
            ux = np.zeros(1, dtype=np.int64)
        A = offt.compact_x_extent(ux.size, Xf)
        self.num_x_active = A
        if A == Xf:
            ux, xslot_of = np.arange(Xf, dtype=np.int64), np.arange(Xf, dtype=np.int64)
        else:
            xslot_of = np.zeros(Xf, dtype=np.int64)
            xslot_of[ux] = np.arange(ux.size)
        vrows = np.flatnonzero(valid)  # global stick rows (r * S_max + s) that are sticks
        ys = p.stick_y_all.reshape(-1).astype(np.int64)[vrows]
        xslot, row_of = self._plan_y(
            xslot_of[sx[vrows]], ys, ux, vrows.size, has_x0=bool((sx[vrows] == 0).any()),
            blocked=A < Xf)

        # the slab slot each stick fills (backward) and is read back from (forward)
        if self.buckets is not None:
            num_slots, slot_of_valid = self._bucket_rows_np.size, row_of
        else:
            num_slots = A * self.sy if self.sy else Y * A
            slot_of_valid = row_of if self.sy else ys * A + xslot
        stick_slot = np.full(P * S, -1, dtype=np.int64)
        stick_slot[vrows] = slot_of_valid
        self._num_slots = num_slots
        self._exchange = make_exchange(mesh, p, stick_slot, num_slots, exchange_type,
                                       real_dtype, planes=2)

        # the z stages with the slab split folded in: (Z, P * L) and (P * L, Z)
        pack_z = p.pack_z_map().astype(np.int64)
        perm = np.where(pack_z < Z, pack_z, -1)
        rt = self.real_dtype
        self._wz_b = self._const(offt.matrix_pair(offt.c2c_matrix(Z, +1, row_perm=perm).T, rt))
        self._wz_f = {
            ScalingType.NONE: self._const(offt.matrix_pair(
                offt.c2c_matrix(Z, -1, row_perm=perm), rt)),
            ScalingType.FULL: self._const(offt.matrix_pair(
                offt.c2c_matrix(Z, -1, scale=1.0 / p.total_size, row_perm=perm), rt)),
        }
        self._init_ir(fuse)

    def describe(self) -> dict:
        return {**MxuLocalExecution.describe(self), **self._geometry(),
                "plane_slots": int(self._num_slots)}

    # ---- stage bodies (the nodes of ir.lower._lower_slab) -----------------------
    # z, y, x and the hermitian fills are the local engine's bodies.

    def _st_decompress(self, values_re, values_im):
        dt = self.torch_dtype
        return self._decompress_values(values_re.to(dt)), self._decompress_values(values_im.to(dt))

    def _rows(self, *parts):
        return [t.reshape(-1, self._L) for t in parts]

    def _slab_side(self, parts):
        """Slab rows -> the y stage's input: the ``(Y, A, Zs)`` grid (dense)
        or the ``(rows, Zs)`` table (per-slot, blocked)."""
        if self.y_plan == "dense":
            shape = (self.params.dim_y, self.num_x_active, self._zs)
        else:
            shape = (-1, self._zs)
        return tuple(t.view(shape) for t in parts)

    def _stick_side(self, parts):
        return tuple(t.view(-1, self.params.num_shards * self._L) for t in parts)

    def _st_x_backward(self, gre, gim):
        """The local x stage, its ``(Y, X, Zs)`` result seen as the stacked slabs."""
        out = super()._st_x_backward(gre, gim)
        shape = (self.params.dim_y, self.params.dim_x, self.num_local, self._L)
        return out.view(shape) if self.is_r2c else tuple(t.view(shape) for t in out)

    def _st_x_forward(self, space_re, space_im):
        flat = lambda t: None if t is None else t.reshape(*t.shape[:2], self._zs)
        return super()._st_x_forward(flat(space_re), flat(space_im))

    def _st_compress(self, sre, sim):
        return self._compress_values(sre), self._compress_values(sim)

    # ---- the legacy path (ir_lower_failed): _lower_slab's nodes in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        cur = self._st_decompress(values_re, values_im)
        if self.is_r2c and self._zero_stick_id is not None:
            cur = self._st_stick_symmetry(*cur)
        cur = self._legacy_exchange("backward", *self._st_z_backward(*cur))
        if self.y_plan == "per-slot":
            cur = self._st_y_sparse_backward(*cur)
        elif self.y_plan == "blocked":
            cur = self._y_blocked_from_tables(*cur)
        else:
            if self.is_r2c and self._x0_slot is not None:
                cur = self._st_plane_symmetry(*cur)
            cur = self._st_y_dense_backward(*cur)
        return self._st_x_backward(*cur)

    def _legacy_forward(self, scaling, space_re, space_im):
        cur = self._st_x_forward(space_re, space_im)
        if self.y_plan == "per-slot":
            cur = self._st_y_sparse_forward(*cur)
        elif self.y_plan == "blocked":
            cur = self._y_blocked_to_flat(*cur)
        else:
            cur = self._st_y_dense_forward(*cur)
        cur = self._legacy_exchange("forward", *cur)
        return self._st_compress(*self._st_z_forward(*cur, scaling))
