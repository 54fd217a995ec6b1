"""The execution engines' shared boundary, and the ``torch.fft`` engine.

Complex data crosses the engine boundary as (re, im) pairs of real tensors on
the plan's ``torch.device``. The transforms are unnormalised DFTs: backward is
N * ifft (reference: docs/source/details.rst:4-13,42-44).

:class:`LocalExecution` is the port of the JAX package's ``jnp.fft`` engine
(``spfft_tpu/execution.py`` ``LocalExecution``): the same stage bodies and the
same native ``(Z, Y, X)`` space layout, with each 1-D DFT one ``torch.fft``
call on its axis (cuFFT on the card, pocketfft on the CPU), where the JAX
package calls ``jnp.fft`` outside any Pallas kernel. Each engine runs its
pipeline as the stage graphs of :mod:`spfft_tpu_torch.ir`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import obs
from .ops import compression, symmetry
from .parameters import LocalParameters
from .types import ScalingType, TransformType


def as_pair(values, real_dtype):
    """Host-side: complex array -> (re, im) contiguous numpy pair."""
    values = np.asarray(values)
    return (
        np.ascontiguousarray(values.real, dtype=real_dtype),
        np.ascontiguousarray(values.imag, dtype=real_dtype),
    )


def from_pair(pair):
    """(re, im) tensors -> one complex tensor."""
    return torch.complex(pair[0], pair[1])


class ExecutionBase:
    """Boundary state of the single-device engines: the plan, its dtypes, its
    device, the id of the (0, 0) stick that R2C stick symmetry fills, and the
    entry points, which run the engine's stage graphs (``self._ir``)."""

    def __init__(self, params: LocalParameters, real_dtype, device: torch.device):
        self.params = params
        self.real_dtype = np.dtype(real_dtype)
        self.torch_dtype = torch.float32 if self.real_dtype == np.float32 else torch.float64
        self.device = torch.device(device)
        # Sorted stick keys => a (0,0) stick, if present, is always row 0.
        self._zero_stick_id = (
            0 if (params.num_sticks > 0 and int(params.stick_xy_indices[0]) == 0) else None
        )

    def _init_ir(self, fuse) -> None:
        from .ir.compile import init_engine_ir

        self._ir = init_engine_ir(self, fuse)

    @property
    def is_r2c(self) -> bool:
        return self.params.transform_type == TransformType.R2C

    def put(self, array, dtype=None):
        """Host numpy array (or tensor) -> tensor on the plan's device."""
        return torch.as_tensor(array, dtype=dtype, device=self.device)

    def put_pair(self, pair):
        """(re, im) numpy pair -> pair of real tensors of the plan's dtype."""
        return tuple(self.put(np.ascontiguousarray(p), self.torch_dtype) for p in pair)

    def values_pair(self, values):
        """Packed complex values (numpy or tensor) -> (re, im) on the device."""
        if torch.is_tensor(values):
            v = values.to(self.device).reshape(-1)
            if v.is_complex():
                return (v.real.to(self.torch_dtype).contiguous(),
                        v.imag.to(self.torch_dtype).contiguous())
            re = v.to(self.torch_dtype).contiguous()
            return re, torch.zeros_like(re)
        pair = as_pair(np.asarray(values).reshape(-1), self.real_dtype)
        obs.counter("staged_bytes_total", direction="host_to_device").inc(
            pair[0].nbytes + pair[1].nbytes)
        return self.put_pair(pair)

    # ---- the perf layer's model (spfft_tpu_torch.obs.perf) -------------------------

    def _y_stage_scope(self) -> str:
        """The :data:`~spfft_tpu_torch.obs.STAGES` label of the y stage."""
        return "y transform"

    def stage_accounting(self) -> list:
        """Analytic per-stage flop/byte rows of one backward+forward pair, the
        JAX package's ``ExecutionBase.stage_accounting``: the shared head and
        tail rows (``obs.perf.pipeline_head_rows``/``pipeline_tail_rows``)
        and, on the dense-y path, the ``expand``/``pack`` rows of the stick
        <-> grid relayout (the sparse-y plans contract straight from the
        sticks and have neither)."""
        from .obs.perf import pipeline_head_rows, pipeline_tail_rows

        p = self.params
        Z, Y, X = p.dim_z, p.dim_y, p.dim_x
        c_item = 2 * self.real_dtype.itemsize
        S = int(p.num_sticks)
        grid_elems = Z * Y * int(self.num_x_active)
        rows = pipeline_head_rows(int(p.num_values), S, Z, c_item,
                                  stick_symmetry=self.is_r2c and self._zero_stick_id is not None)
        y_scope = self._y_stage_scope()
        if y_scope == "y transform":
            relayout = (S * Z + grid_elems) * c_item
            rows.append({"stage": "expand", "flops": 0, "bytes": relayout})
            rows.append({"stage": "pack", "flops": 0, "bytes": relayout})
        return rows + pipeline_tail_rows(Z, Y, X, Z * int(self.num_x_active), c_item,
                                         plane_symmetry=self.is_r2c, y_scope=y_scope)

    # ---- entry points: the stage graphs, fused or staged ---------------------------

    def backward_pair(self, values_re, values_im):
        """(re, im) packed values -> space in the native layout: the (re, im)
        pair for C2C, the real tensor for R2C."""
        return self._ir.run_backward(values_re, values_im)

    def forward_pair(self, space_re, space_im, scaling=ScalingType.NONE):
        """Native space (``space_im`` None for R2C) -> (re, im) packed values."""
        return self._ir.run_forward(scaling, space_re, space_im)

    def backward_pair_batch(self, values_re, values_im):
        """Stacked ``(B, V)`` value pairs -> stacked native space, as one
        program; None when batching is unavailable (the caller loops)."""
        return self._ir.run_backward_batch(values_re, values_im)

    def forward_pair_batch(self, space_re, space_im, scaling=ScalingType.NONE):
        """Stacked native space -> stacked ``(B, V)`` value pairs, or None."""
        return self._ir.run_forward_batch(scaling, space_re, space_im)


class LocalExecution(ExecutionBase):
    """The ``torch.fft`` engine for one plan: decompress, z-DFT over the
    sticks, expand the sticks into the zeroed ``(Z, Y, Xf)`` grid, y- and
    x-DFTs over the grid (C2R for R2C); forward reverses it, with the FULL
    scaling applied in compress. Space is ``(Z, Y, X)`` native."""

    NATIVE_LAYOUT = "zyx"

    def __init__(self, params: LocalParameters, real_dtype, device, fuse=None):
        super().__init__(params, real_dtype, device)
        p = params
        # as the JAX engine's accounting: the grid spans every x frequency
        self.num_x_active = p.dim_x_freq
        self._vi = self.put(np.asarray(p.value_indices), torch.int64)
        self._stick_y = self.put(np.asarray(p.stick_y), torch.int64)
        self._stick_x = self.put(np.asarray(p.stick_x), torch.int64)
        self._init_ir(fuse)

    def describe(self) -> dict:
        """This engine makes no plan decisions (JAX: ``LocalExecution.describe``)."""
        return {"pipeline": "torch.fft + scatter/gather"}

    # ---- stage bodies (the nodes of ir.lower._lower_local_xla) ---------------------
    # The inverse DFTs run with norm="forward", i.e. unscaled: the backward
    # transform is unnormalised, so the JAX engine's 1/N of each ifft and the
    # final multiply by N cancel, and here neither runs.

    def _st_decompress(self, values_re, values_im):
        p = self.params
        values = torch.complex(values_re.to(self.torch_dtype), values_im.to(self.torch_dtype))
        return compression.decompress(values, self._vi, p.num_sticks, p.dim_z)

    def _st_stick_symmetry(self, sticks):
        # in place: the decompress edge is read by this node alone
        i = self._zero_stick_id
        if i is not None:
            sticks[i] = symmetry.hermitian_fill_1d(sticks[i], axis=0)
        return sticks

    def _st_z_backward(self, sticks):
        if sticks.shape[0] == 0:  # an empty plan: no batch to transform
            return sticks
        return torch.fft.ifft(sticks, dim=1, norm="forward")

    def _st_expand(self, sticks):
        """Scatter each z-stick into its (y, x) column of the zeroed grid."""
        p = self.params
        grid = sticks.new_zeros((p.dim_z, p.dim_y, p.dim_x_freq))
        grid.permute(1, 2, 0).index_put_((self._stick_y, self._stick_x), sticks)
        return grid

    def _st_plane_symmetry(self, grid):
        # in place: the expand edge is read by this node alone
        grid[:, :, 0] = symmetry.hermitian_fill_1d(grid[:, :, 0], axis=1)
        return grid

    def _st_y_backward(self, grid):
        return torch.fft.ifft(grid, dim=1, norm="forward")

    def _st_x_backward(self, grid):
        if self.is_r2c:
            return torch.fft.irfft(grid, n=self.params.dim_x, dim=2, norm="forward")
        out = torch.fft.ifft(grid, dim=2, norm="forward")
        return out.real, out.imag

    def _st_x_forward(self, space_re, space_im):
        if self.is_r2c:
            return torch.fft.rfft(space_re.to(self.torch_dtype), n=self.params.dim_x, dim=2)
        space = torch.complex(space_re.to(self.torch_dtype), space_im.to(self.torch_dtype))
        return torch.fft.fft(space, dim=2)

    def _st_y_forward(self, grid):
        return torch.fft.fft(grid, dim=1)

    def _st_pack(self, grid):
        """Gather each stick's (y, x) column of the grid: ``(S, Z)``."""
        return grid.permute(1, 2, 0)[self._stick_y, self._stick_x]

    def _st_z_forward(self, sticks):
        if sticks.shape[0] == 0:  # an empty plan: no batch to transform
            return sticks
        return torch.fft.fft(sticks, dim=1)

    def _st_compress(self, sticks, scaling):
        values = compression.compress(sticks, self._vi)
        if ScalingType(scaling) == ScalingType.FULL:
            values = values * (1.0 / self.params.total_size)
        return values.real, values.imag

    # ---- the legacy path (ir_lower_failed): the stage bodies in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        sticks = self._st_decompress(values_re, values_im)
        if self.is_r2c:
            sticks = self._st_stick_symmetry(sticks)
        grid = self._st_expand(self._st_z_backward(sticks))
        if self.is_r2c:
            grid = self._st_plane_symmetry(grid)
        return self._st_x_backward(self._st_y_backward(grid))

    def _legacy_forward(self, scaling, space_re, space_im):
        sticks = self._st_pack(self._st_y_forward(self._st_x_forward(space_re, space_im)))
        return self._st_compress(self._st_z_forward(sticks), scaling)
