"""The accelerator engine: every DFT stage a matrix product, dense y.

The port of the JAX package's ``MxuLocalExecution``: the same function, the
same ``(Y, X, Z)`` native space layout with z minor (z-sticks are rows), and
no transpose anywhere in the pipeline.

* **unique-x compaction**: the y/x stages touch only the A x-rows that carry a
  stick (padded to 8), so the intermediate grid is ``(Y, A, Z)`` and the
  x-stage matrices are rectangular (reference: the "uniqueXIndices"
  optimisation, src/execution/execution_host.cpp:138-144),
* every DFT stage (z, y, x; both directions) is one launch of kernel K1,
* the stick <-> plane moves (expand, pack) are one launch each of kernel K2,
* decompress/compress are index scatter/gather on the flat stick table, and the
  hermitian fills of R2C are plain tensor code.

Backward: decompress -> stick symmetry (R2C) -> z -> expand -> plane symmetry
(R2C) -> y -> x (C2R for R2C). Forward reverses it; the FULL scaling rides
the forward-z matrix.
"""
from __future__ import annotations

import numpy as np
import torch

from .execution import ExecutionBase
from .ops import compression, symmetry
from .ops import fft as offt
from .ops.complex_matmul import Constant
from .ops.row_gather import row_gather
from .parameters import LocalParameters
from .types import ScalingType


class MxuLocalExecution(ExecutionBase):
    """Single-device pipeline for one plan. Pair I/O on the plan's device;
    space-domain tensors are ``(Y, X, Z)`` native."""

    NATIVE_LAYOUT = "yxz"

    def __init__(self, params: LocalParameters, real_dtype, device):
        super().__init__(params, real_dtype, device)
        p = params
        rt = self.real_dtype
        S, Z = p.num_sticks, p.dim_z

        if S:
            ux = np.unique(np.asarray(p.stick_x, dtype=np.int64))
            xslot = np.searchsorted(ux, np.asarray(p.stick_x, dtype=np.int64))
        else:
            ux = np.zeros(1, dtype=np.int64)
            xslot = np.zeros(0, dtype=np.int64)
        A = offt.compact_x_extent(ux.size, p.dim_x_freq)
        self.num_x_active = A

        # Each stage's DFT matrix, prepared once for K1 (on a float32 CUDA
        # plan: split into TF32 parts and laid out in the kernel's tiles).
        const = lambda w: Constant(*self.put_pair(w))
        wz_b, wy_b, wy_f, wz_f = offt.zy_stage_matrices(Z, p.dim_y, p.total_size, rt)
        self._wz_b, self._wy_b, self._wy_f = const(wz_b), const(wy_b), const(wy_f)
        self._wz_f = {s: const(w) for s, w in wz_f.items()}
        wx_b, wx_f = offt.x_stage_matrices(p.dim_x, ux, A, self.is_r2c, rt)
        self._wx_b, self._wx_f = const(wx_b), const(wx_f)

        # The x == 0 plane's slot, where R2C plane symmetry acts.
        x0 = np.flatnonzero(ux == 0) if S else np.empty(0)
        self._x0_slot = int(x0[0]) if x0.size else None

        self._vi = self.put(p.value_indices, torch.int64)
        # expand: (y, slot) row -> stick id, S (out of range) -> zero row
        yx_map = np.full(p.dim_y * A, S, dtype=np.int32)
        keys = p.stick_y.astype(np.int64) * A + xslot
        yx_map[keys] = np.arange(S)
        self._yx_map = self.put(yx_map)
        # pack: stick id -> (y, slot) row
        self._stick_keys = self.put(keys.astype(np.int32))

    # ---- stages ---------------------------------------------------------------

    def _expand(self, sre, sim):
        """(S, Z) sticks -> (Y, A, Z) active-x planes: one K2 launch."""
        p = self.params
        gre, gim = row_gather(sre, sim, self._yx_map)
        shape = (p.dim_y, self.num_x_active, p.dim_z)
        return gre.reshape(shape), gim.reshape(shape)

    def _pack(self, gre, gim):
        """(Y, A, Z) planes -> (S, Z) sticks: one K2 launch."""
        rows = self.params.dim_y * self.num_x_active
        z = self.params.dim_z
        return row_gather(gre.reshape(rows, z), gim.reshape(rows, z), self._stick_keys)

    def _stick_symmetry(self, sre, sim):
        # in place: sre/sim are this call's own decompress buffers
        i = self._zero_stick_id
        sre[i], sim[i] = symmetry.hermitian_fill_1d_pair(sre[i], sim[i], axis=0)

    def _plane_symmetry(self, gre, gim):
        # in place: gre/gim are this call's own expand buffers
        s = self._x0_slot
        gre[:, s, :], gim[:, s, :] = symmetry.hermitian_fill_1d_pair(
            gre[:, s, :], gim[:, s, :], axis=0
        )

    # ---- pipelines ------------------------------------------------------------

    def backward_pair(self, values_re, values_im):
        """(re, im) packed values -> space: (re, im) ``(Y, X, Z)`` for C2C,
        the real ``(Y, X, Z)`` tensor for R2C."""
        p = self.params
        sre = compression.decompress(values_re, self._vi, p.num_sticks, p.dim_z)
        sim = compression.decompress(values_im, self._vi, p.num_sticks, p.dim_z)
        if self.is_r2c and self._zero_stick_id is not None:
            self._stick_symmetry(sre, sim)
        w = self._wz_b
        sre, sim = offt.complex_matmul(sre, sim, *w.pair, "sz,zk->sk", constant=w)
        gre, gim = self._expand(sre, sim)
        if self.is_r2c and self._x0_slot is not None:
            self._plane_symmetry(gre, gim)
        w = self._wy_b
        gre, gim = offt.complex_matmul(gre, gim, *w.pair, "yxz,yk->kxz", constant=w)
        w = self._wx_b
        if self.is_r2c:
            return offt.real_out_matmul(gre, gim, *w.pair, "kxz,xl->klz", constant=w)
        return offt.complex_matmul(gre, gim, *w.pair, "kxz,xl->klz", constant=w)

    def forward_pair(self, space_re, space_im, scaling=ScalingType.NONE):
        """``(Y, X, Z)`` space (``space_im`` None for R2C) -> (re, im) packed values."""
        w = self._wx_f
        if self.is_r2c:
            gre, gim = offt.real_in_matmul(space_re, *w.pair, "yxz,xk->ykz", constant=w)
        else:
            gre, gim = offt.complex_matmul(space_re, space_im, *w.pair, "yxz,xk->ykz",
                                           constant=w)
        w = self._wy_f
        gre, gim = offt.complex_matmul(gre, gim, *w.pair, "ykz,yl->lkz", constant=w)
        sre, sim = self._pack(gre, gim)
        w = self._wz_f[ScalingType(scaling)]
        sre, sim = offt.complex_matmul(sre, sim, *w.pair, "sz,zk->sk", constant=w)
        return compression.compress(sre, self._vi), compression.compress(sim, self._vi)
