"""The mesh engines' shared boundary, and the ``torch.fft`` mesh engine.

The port of ``spfft_tpu/parallel/execution.py``. The P shards of a process
sit stacked on its one device (:class:`~.mesh.ShardMesh`), and each stage
runs over all of them at once:

* frequency side: the ``(P_local, V_max)`` value pairs, decompressed into
  one ``(P_local * S_max, Z)`` stick table; the z stage writes each stick's
  z-slabs side by side, ``(P_local * S_max, P * L_max)``, the exchange's
  stick rows (:mod:`.ragged`);
* space side: the stacked slab ``(Y, X, P_local, L_max)``: the local
  engine's ``(Y, X, Z)`` grid with z cut into the local shards' padded
  slabs, so that every y and x stage is one pass over all of them.

:class:`PaddingHelpers` moves per-shard caller data in and out of that
layout; across processes each process supplies and receives only its own
shards (``None`` stands for another process's). :class:`DistributedExecution`
is the ``torch.fft`` engine (cuFFT on the card), the JAX package's
``DistributedExecution``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import faults, obs
from ..errors import InvalidParameterError, MPIParameterMismatchError
from ..execution import ExecutionBase
from ..ops import symmetry
from ..types import RAGGED_EXCHANGES, ScalingType, TransformType, wire_scalar_bytes
from .mesh import ShardMesh, fft_mesh_size
from .ragged import make_exchange


def chunk_ranges(n: int, chunks: int) -> list:
    """``chunks`` contiguous near-equal ``(start, stop)`` ranges covering
    ``[0, n)``, the first ``n % chunks`` one longer (the JAX package's
    OVERLAPPED chunk split)."""
    chunks = max(1, min(int(chunks), int(n)))
    base, extra = divmod(int(n), chunks)
    out, start = [], 0
    for i in range(chunks):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


class PaddingHelpers(ExecutionBase):
    """What both mesh engines share: the padded geometry (``_S``, ``_L``,
    ``_V``), the stacked value <-> stick-table moves, the caller-data
    padding and the wire accounting. ``NATIVE_LAYOUT`` names the stacked
    space ``(Y, X, P_local, L_max)``."""

    NATIVE_LAYOUT = "yxz"

    def _setup(self, params, real_dtype, mesh, exchange_type, overlap=1) -> None:
        if not isinstance(mesh, ShardMesh):
            raise InvalidParameterError(
                f"expected a ShardMesh (make_fft_mesh), got {type(mesh).__name__}")
        if fft_mesh_size(mesh) != params.num_shards:
            raise MPIParameterMismatchError(
                f"plan has {params.num_shards} shards but the mesh holds {fft_mesh_size(mesh)}")
        faults.site("exchange.build")
        self.params, self.mesh = params, mesh
        self.real_dtype = np.dtype(real_dtype)
        self.torch_dtype = torch.float32 if self.real_dtype == np.float32 else torch.float64
        self.device = mesh.device
        self.exchange_type = exchange_type
        p = params
        self._S, self._L, self._V = p.max_num_sticks, max(1, p.max_local_z_length), p.max_num_values
        # The OVERLAPPED exchange (spfft_tpu/parallel/execution.py:625-634):
        # the padded exchange split into C chunk collectives along the stick
        # axis, chunk k's exchange pipelined against chunk k+1's z stage.
        # Padded disciplines only (the exact-count ones clamp to 1), clamped
        # to the stick extent; one shard has no exchange.
        if exchange_type in RAGGED_EXCHANGES or p.num_shards <= 1:
            self._overlap = 1
        else:
            self._overlap = max(1, min(int(overlap), self._S))
        self._chunks = chunk_ranges(self._S, self._overlap)
        self._local = list(mesh.local_shards)
        Pl, S, Z, V = mesh.num_local, self._S, p.dim_z, self._V
        # the (0, 0) stick's row in this process's stick table, R2C's stick symmetry
        owner = p.zero_stick_shard
        self._zero_stick_id = (self._local.index(owner) * S + p.zero_stick_row
                               if owner in self._local else None)
        # packed value -> flat stick-table slot; padding -> a dump slot (scatter)
        # or slot 0 then zeroed (gather)
        vi = p.value_indices[self._local].astype(np.int64) + (np.arange(Pl) * S * Z)[:, None]
        valid = np.arange(V)[None, :] < p.num_values_per_shard[self._local][:, None]
        self._vi_scatter = self.put(np.where(valid, vi, Pl * S * Z).reshape(-1), torch.int64)
        self._vi_gather = self.put(np.where(valid, vi, 0).reshape(-1), torch.int64)
        self._vi_pad = self.put(~valid)
        # the slot of each value in the stacked (P_local, V_max) values
        self._vi_rows = self.put(np.flatnonzero(valid.reshape(-1)), torch.int64)

    @property
    def is_r2c(self) -> bool:
        return self.params.transform_type == TransformType.R2C

    @property
    def num_local(self) -> int:
        return self.mesh.num_local

    @property
    def collective(self) -> bool:
        """True where the exchange is a ``torch.distributed`` collective."""
        return self._exchange.collective

    def _decompress_values(self, values):
        """``(P_local, V_max)`` values (one real or complex tensor) -> the
        zeroed ``(P_local * S_max, Z)`` stick table holding them."""
        n = self.num_local * self._S * self.params.dim_z
        flat = values.new_zeros(n + 1)
        flat.index_copy_(0, self._vi_scatter, values.reshape(-1))
        return flat[:n].view(-1, self.params.dim_z)

    def _compress_values(self, sticks):
        """The stick table -> its ``(P_local, V_max)`` values, padding zero."""
        out = sticks.reshape(-1).index_select(0, self._vi_gather).view(self.num_local, self._V)
        return out.masked_fill_(self._vi_pad, 0)

    # ---- caller data <-> the stacked layout ----------------------------------------

    def _shard_list(self, items, what):
        items = list(items)
        if len(items) != self.params.num_shards:
            raise InvalidParameterError(
                f"{what}: one entry per shard ({self.params.num_shards}; None for the "
                f"shards of other processes), got {len(items)}")
        return items

    def _tensor(self, a):
        return (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))).to(self.device)

    def pad_values(self, values_per_shard):
        """Per-shard packed values (numpy or tensors; None for another
        process's shards) -> the stacked ``(P_local, V_max)`` (re, im) pair."""
        values = self._shard_list(values_per_shard, "values")
        mine = []
        for r in self._local:
            if values[r] is None:
                raise InvalidParameterError(f"shard {r} is this process's: its values are required")
            v = self._tensor(values[r]).reshape(-1)
            n = int(self.params.num_values_per_shard[r])
            if v.numel() != n:
                raise InvalidParameterError(f"shard {r}: expected {n} values, got {v.numel()}")
            mine.append(v)
        if not all(torch.is_tensor(values[r]) for r in self._local):
            obs.counter("staged_bytes_total", direction="host_to_device").inc(
                2 * self.num_local * self._V * self.real_dtype.itemsize)
        flat = torch.cat(mine) if len(mine) > 1 else mine[0]
        re = torch.zeros(self.num_local * self._V, dtype=self.torch_dtype, device=self.device)
        im = torch.zeros_like(re)
        re.index_copy_(0, self._vi_rows, (flat.real if flat.is_complex() else flat).to(re.dtype))
        if flat.is_complex():
            im.index_copy_(0, self._vi_rows, flat.imag.to(im.dtype))
        return re.view(self.num_local, self._V), im.view(self.num_local, self._V)

    def unpad_values(self, pair):
        """The stacked value pair -> per-shard complex tensors on the device
        (None for another process's shards)."""
        values = torch.complex(pair[0], pair[1])
        out = [None] * self.params.num_shards
        for j, r in enumerate(self._local):
            out[r] = values[j, :int(self.params.num_values_per_shard[r])]
        return out

    def _slab(self, r):
        return int(self.params.local_z_lengths[r]), int(self.params.z_offsets[r])

    def pad_space(self, space):
        """A global ``(Z, Y, X)`` array or tensor, or a per-shard list of
        ``(local_z_length, Y, X)`` slabs (None for another process's) -> the
        stacked native space: the (re, im) pair, or (re, None) for R2C."""
        p = self.params
        shape = (p.dim_y, p.dim_x, self.num_local, self._L)
        parts = [torch.zeros(shape, dtype=self.torch_dtype, device=self.device)
                 for _ in range(1 if self.is_r2c else 2)]
        per_shard = isinstance(space, (list, tuple))
        if per_shard:
            space = self._shard_list(space, "space")
            host = not all(torch.is_tensor(space[r]) for r in self._local)
        else:
            host = not torch.is_tensor(space)
            space = self._tensor(space)
            if space.numel() != p.total_size:
                raise InvalidParameterError(
                    f"expected {p.total_size} space-domain elements, got {space.numel()}")
            space = space.reshape(p.dim_z, p.dim_y, p.dim_x)
        if host:
            obs.counter("staged_bytes_total", direction="host_to_device").inc(
                len(parts) * self.num_local * self._L * p.dim_y * p.dim_x
                * self.real_dtype.itemsize)
        for j, r in enumerate(self._local):
            l, o = self._slab(r)
            slab = self._tensor(space[r]) if per_shard else space[o:o + l]
            if tuple(slab.shape) != (l, p.dim_y, p.dim_x):
                raise InvalidParameterError(
                    f"shard {r}: expected a ({l}, {p.dim_y}, {p.dim_x}) slab, "
                    f"got {tuple(slab.shape)}")
            slab = slab.permute(1, 2, 0)
            parts[0][:, :, j, :l] = slab.real if slab.is_complex() else slab
            if not self.is_r2c and slab.is_complex():
                parts[1][:, :, j, :l] = slab.imag
        return parts[0], (None if self.is_r2c else parts[1])

    def unpad_space(self, out):
        """Native space -> the global ``(Z, Y, X)`` tensor (complex for C2C)
        when this process holds every shard, else per-shard
        ``(local_z_length, Y, X)`` slabs (None for another process's). With
        equal slabs the global tensor is a view of the native one, as the
        local plan's result is of its ``(Y, X, Z)`` space."""
        p = self.params
        full = out if self.is_r2c else torch.complex(out[0], out[1])
        if len(self._local) == p.num_shards and (p.local_z_lengths == self._L).all():
            return full.view(p.dim_y, p.dim_x, p.dim_z).permute(2, 0, 1)
        slabs = [None] * p.num_shards
        for j, r in enumerate(self._local):
            l, _ = self._slab(r)
            slabs[r] = full[:, :, j, :l].permute(2, 0, 1)
        if len(self._local) < p.num_shards:
            return [None if s is None else s.contiguous() for s in slabs]
        return torch.cat(slabs)

    # ---- the perf layer's model (spfft_tpu_torch.obs.perf) -------------------------

    def stage_accounting(self) -> list:
        """Analytic per-stage flop/byte rows of one backward+forward pair, the
        JAX package's ``PaddingHelpers.stage_accounting``: the shared head and
        tail rows, and the slab exchange between them: ``pack``/``unpack``
        rows for the padded disciplines, only the slab ``unpack`` for the
        exact-count ones, and the ``exchange`` row of the wire bytes that
        the plan card reports (forward and backward). An OVERLAPPED plan's
        exchange row is ``exchange overlapped``, with an ``overlap`` record
        naming the stage its chunks hide behind (the z stage)."""
        from ..obs.perf import pipeline_head_rows, pipeline_tail_rows

        p = self.params
        P = int(p.num_shards)
        Z, Y, X, Xf = p.dim_z, p.dim_y, p.dim_x, p.dim_x_freq
        c_item = 2 * self.real_dtype.itemsize
        total_sticks = int(np.asarray(p.num_sticks_per_shard).sum())
        rows = pipeline_head_rows(int(np.asarray(p.num_values_per_shard).sum()), total_sticks,
                                  Z, c_item,
                                  stick_symmetry=self.is_r2c and p.zero_stick_shard >= 0)
        if P > 1:
            if self.exchange_type not in RAGGED_EXCHANGES:
                buf = P * P * self._L * self._S  # padded buffers, all shards
                ends = P * (self._S * Z + self._L * Y * Xf)  # stage endpoints
                for stage in ("pack", "unpack"):
                    rows.append({"stage": stage, "flops": 0, "bytes": (2 * buf + ends) * c_item})
            else:
                rows.append({"stage": "unpack", "flops": 0, "bytes": Z * Y * Xf * c_item})
            # the exact wire bytes under both labels: overlap changes the
            # exposure (obs.perf), never the volume
            row = {"stage": "exchange" if self._overlap == 1 else "exchange overlapped",
                   "flops": 0, "bytes": 2 * self.exchange_wire_bytes()}
            if self._overlap > 1:
                row["overlap"] = {"chunks": int(self._overlap), "hides": "z transform"}
            rows.append(row)
        return rows + pipeline_tail_rows(Z, Y, X, Z * int(self.num_x_active), c_item,
                                         plane_symmetry=self.is_r2c,
                                         y_scope=self._y_stage_scope())

    # ---- wire accounting -----------------------------------------------------------

    def exchange_wire_bytes(self) -> int:
        """Off-shard bytes one exchange direction puts on the wire, over the
        mesh (the JAX package's accounting: padded blocks, COMPACT's window,
        or UNBUFFERED's exact rows, each ``L_max`` planes wide)."""
        return self._exchange.offwire_elems() * 2 * wire_scalar_bytes(
            self.exchange_type, self.real_dtype)

    def exchange_rounds(self) -> int:
        """Collective rounds a direction: one, or the OVERLAPPED exchange's C."""
        return self._exchange.rounds()

    def exchange_transport(self) -> str:
        """How the exchange moves: a K2 gather on this device (no group), or
        the named collective; ``chunked`` for the OVERLAPPED exchange."""
        if self._overlap > 1:
            return "chunked all_to_all" if self.collective else "chunked device gather"
        return self._exchange.name if self._exchange.collective else "device gather"

    def _geometry(self) -> dict:
        return {"overlap_chunks": int(self._overlap),
                "padded_geometry": {"s_max": int(self._S), "l_max": int(self._L),
                                    "v_max": int(self._V)},
                "num_local_shards": self.num_local, "transport": self.exchange_transport()}

    # ---- the exchange's nodes (ir.lower._lower_slab) -----------------------------
    # Each engine maps its edges to the exchange's real row planes (``_rows``)
    # and back (``_slab_side``, ``_stick_side``).

    def _st_exchange_backward(self, *z):
        return self._slab_side(self._exchange.backward.run(self._rows(*z)))

    def _st_exchange_forward(self, *y):
        return self._stick_side(self._exchange.forward.run(self._rows(*y)))

    # the collective route's nodes (a plan with a process group)
    def _st_pack_backward(self, *z):
        return self._exchange.backward.pack(self._rows(*z))

    def _st_exchange_rows_backward(self, send):
        return self._exchange.backward.exchange(send)

    def _st_unpack_backward(self, recv):
        return self._slab_side(self._exchange.backward.unpack(recv))

    def _st_pack_forward(self, *y):
        return self._exchange.forward.pack(self._rows(*y))

    def _st_exchange_rows_forward(self, send):
        return self._exchange.forward.exchange(send)

    def _st_unpack_forward(self, recv):
        return self._stick_side(self._exchange.forward.unpack(recv))

    # the OVERLAPPED exchange's nodes (ir.lower._split_slab_*): chunk k of
    # the exchange, the stick rows [c0, c1) of every local shard. Backward:
    # each chunk's rows reach one receive buffer, which one unpack reads;
    # forward: each chunk's own stick rows, and its own unpack over a group.

    def _st_exchange_chunk_backward(self, k, recv, *z):
        return self._exchange.backward_chunks.gather(k, self._rows(*z), recv)

    def _st_pack_chunk_backward(self, k, *z):
        return self._exchange.backward_chunks.pack_chunk(k, self._rows(*z))

    def _st_exchange_rows_chunk_backward(self, k, pending, send):
        return self._exchange.backward_chunks.exchange_chunk(k, send, pending)

    def _st_unpack_chunks_backward(self, recv):
        return self._slab_side(self._exchange.backward_chunks.unpack(recv))

    def _st_exchange_chunk_forward(self, k, *y):
        return self._chunk_stick_side(self._exchange.forward_chunks[k].run(self._rows(*y)))

    def _st_pack_chunk_forward(self, k, *y):
        return self._exchange.forward_chunks[k].pack(self._rows(*y))

    def _st_exchange_rows_chunk_forward(self, k, send):
        return self._exchange.forward_chunks[k].exchange(send, async_op=True)

    def _st_unpack_chunk_forward(self, k, pending):
        return self._chunk_stick_side(self._exchange.forward_chunks[k].unpack(pending))

    def _legacy_exchange(self, direction, *parts):
        """The legacy path's exchange: ``_lower_slab``'s exchange nodes of
        ``direction`` called in order (one gather, or pack, the collective
        and unpack over a process group)."""
        if not self.collective:
            return getattr(self, f"_st_exchange_{direction}")(*parts)
        send = getattr(self, f"_st_pack_{direction}")(*parts)
        return getattr(self, f"_st_unpack_{direction}")(
            getattr(self, f"_st_exchange_rows_{direction}")(send))


class DistributedExecution(PaddingHelpers):
    """The ``torch.fft`` mesh engine: decompress, z-DFT over the stick
    table, exchange into the stacked ``(Y, Xf, P_local * L_max)`` grid (every
    x, as the JAX engine), y- and x-DFTs (C2R for R2C); forward reverses it,
    the FULL scaling applied in compress. Complex data; the exchange moves
    its ``(re, im)`` interleaved rows."""

    def __init__(self, params, real_dtype, mesh, exchange_type, overlap=1, fuse=None):
        self._setup(params, real_dtype, mesh, exchange_type, overlap)
        p = params
        Y, Xf = p.dim_y, p.dim_x_freq
        self.num_x_active = Xf
        self._zs = self.num_local * self._L
        sx, sy = (a.reshape(-1).astype(np.int64) for a in (p.stick_x_all, p.stick_y_all))
        stick_slot = np.where(sx < Xf, sy * Xf + sx, -1)
        self._exchange = make_exchange(mesh, p, stick_slot, Y * Xf, exchange_type, real_dtype,
                                       planes=1, chunks=self._chunks)
        pack_z = p.pack_z_map().astype(np.int64)  # dim_z: the zero column appended
        self._pack_z = self.put(pack_z, torch.int64)
        self._unpack_z = self.put(p.unpack_z_map(), torch.int64)
        self._init_ir(fuse)

    def describe(self) -> dict:
        return {"pipeline": "torch.fft + exchange gathers", **self._geometry()}

    # ---- stage bodies (the nodes of ir.lower._lower_slab) -----------------------
    # Inverse DFTs are unscaled (norm="forward"), as in the local engine.

    def _st_decompress(self, values_re, values_im):
        dt = self.torch_dtype
        return self._decompress_values(torch.complex(values_re.to(dt), values_im.to(dt)))

    def _st_stick_symmetry(self, sticks):
        # in place: the decompress edge is read by this node alone
        i = self._zero_stick_id
        sticks[i] = symmetry.hermitian_fill_1d(sticks[i], axis=0)
        return sticks

    def _st_z_backward(self, sticks):
        """z-DFT, then each stick's planes cut into the P padded z-slabs:
        ``(P_local * S_max, P * L_max)``."""
        z = torch.fft.ifft(sticks, dim=1, norm="forward")
        return torch.nn.functional.pad(z, (0, 1)).index_select(1, self._pack_z)

    def _st_z_backward_window(self, c0, c1, sticks):
        """The z stage of the stick rows ``[c0, c1)`` of every local shard
        (an OVERLAPPED chunk): ``(P_local, W, P * L_max)``."""
        win = sticks.view(self.num_local, self._S, -1)[:, c0:c1]
        z = torch.fft.ifft(win, dim=2, norm="forward")
        return torch.nn.functional.pad(z, (0, 1)).index_select(2, self._pack_z)

    def _chunk_stick_side(self, rows):
        """A chunk's stick rows -> its complex ``(P_local, W, Z)`` sticks."""
        c = torch.view_as_complex(rows[0].view(self.num_local, -1,
                                               self.params.num_shards * self._L, 2))
        return c.index_select(2, self._unpack_z)

    def _st_z_forward_window(self, c0, c1, table, sticks):
        """The z stage of an OVERLAPPED chunk's sticks into its rows of the
        ``(P_local * S_max, Z)`` table (None: a new one), which it returns."""
        z = torch.fft.fft(sticks, dim=2)
        if table is None:
            table = z.new_empty((self.num_local * self._S, self.params.dim_z))
        table.view(self.num_local, self._S, -1)[:, c0:c1] = z
        return table

    def _rows(self, c):
        """A complex table -> its real ``(rows, 2 L_max)`` exchange rows."""
        return [torch.view_as_real(c.contiguous()).reshape(-1, 2 * self._L)]

    def _slab_side(self, rows):
        """Slab rows -> the complex ``(Y, Xf, P_local * L_max)`` grid."""
        p = self.params
        return torch.view_as_complex(rows[0].view(p.dim_y, p.dim_x_freq, self._zs, 2))

    def _st_plane_symmetry(self, grid):
        # in place: the exchange edge is read by this node alone
        grid[:, 0, :] = symmetry.hermitian_fill_1d(grid[:, 0, :], axis=0)
        return grid

    def _st_y_backward(self, grid):
        return torch.fft.ifft(grid, dim=0, norm="forward")

    def _st_x_backward(self, grid):
        if self.is_r2c:
            out = torch.fft.irfft(grid, n=self.params.dim_x, dim=1, norm="forward")
            return out.contiguous().view(*out.shape[:2], self.num_local, self._L)
        out = torch.fft.ifft(grid, dim=1, norm="forward")
        shape = (*out.shape[:2], self.num_local, self._L)
        return out.real.contiguous().view(shape), out.imag.contiguous().view(shape)

    def _st_x_forward(self, space_re, space_im):
        flat = lambda t: t.to(self.torch_dtype).reshape(*t.shape[:2], self._zs)
        if self.is_r2c:
            return torch.fft.rfft(flat(space_re), n=self.params.dim_x, dim=1)
        return torch.fft.fft(torch.complex(flat(space_re), flat(space_im)), dim=1)

    def _st_y_forward(self, grid):
        return torch.fft.fft(grid, dim=0)

    def _stick_side(self, rows):
        """Stick rows -> the ``(P_local * S_max, Z)`` complex stick table."""
        c = torch.view_as_complex(rows[0].view(-1, self.params.num_shards * self._L, 2))
        return c.index_select(1, self._unpack_z)

    def _st_z_forward(self, sticks):
        return torch.fft.fft(sticks, dim=1)

    def _st_compress(self, sticks, scaling):
        values = self._compress_values(sticks)
        if ScalingType(scaling) == ScalingType.FULL:
            values = values * (1.0 / self.params.total_size)
        return values.real.contiguous(), values.imag.contiguous()

    # ---- the legacy path (ir_lower_failed): _lower_slab's nodes in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        sticks = self._st_decompress(values_re, values_im)
        if self.is_r2c and self._zero_stick_id is not None:
            sticks = self._st_stick_symmetry(sticks)
        grid = self._legacy_exchange("backward", self._st_z_backward(sticks))
        if self.is_r2c:
            grid = self._st_plane_symmetry(grid)
        return self._st_x_backward(self._st_y_backward(grid))

    def _legacy_forward(self, scaling, space_re, space_im):
        grid = self._st_y_forward(self._st_x_forward(space_re, space_im))
        sticks = self._legacy_exchange("forward", grid)
        return self._st_compress(self._st_z_forward(sticks), scaling)
