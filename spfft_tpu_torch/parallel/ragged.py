"""The slab <-> pencil exchange: row geometry, gathers and the one transport.

Both mesh engines exchange whole rows of ``L_max`` planes (the JAX package's
row-granular exchanges, ``spfft_tpu/parallel/ragged.py``):

* the **stick side** of a process is its z-transformed stick table viewed as
  ``(P_local * S_max * P, W)`` rows: row ``(i * S_max + s) * P + d`` holds the
  planes of shard ``d``'s z-slab of stick ``s`` of local shard ``i`` (the
  engines fold the z-slab split into the z stage, so this is a view);
* the **slab side** is the engine's slot table viewed as
  ``(num_slots * P_local, W)`` rows: row ``k * P_local + j`` holds slot ``k``
  (a (y, x) plane slot, a per-slot sparse-y table row or a blocked bucket
  row) on local shard ``j``'s planes. The slab side is thus the local
  engine's ``(slots, Z)`` table with z cut into ``P_local`` padded slabs.

Each shard pair ``i -> j`` ships ``rows[i, j]`` stick rows; the discipline
sets the count (:func:`make_exchange`). Padded (BUFFERED): ``S_max``.
COMPACT_*: the JAX package's COMPACT chain window, ``max_i sticks_i``, which
is the padded block again. UNBUFFERED: exactly ``sticks_i`` rows, the
reference's ``MPI_Alltoallw`` (src/transpose/transpose_mpi_unbuffered_host.cpp:51-176).
Every discipline takes **one** collective round: ``all_to_all_single`` takes
uneven split sizes on every backend, so the JAX package's ppermute chain
(P-1 rounds, which exists because XLA lacks a ragged all-to-all off the TPU)
is not reproduced.

Transport, one rule (:class:`SlabExchange`): with a process group, a pack
gather (kernel K2) writes the rows rank by rank into one send buffer, each
row holding every plane side by side (``(rows, planes * W)``); one
``all_to_all_single`` moves it, and an unpack gather (K2) reads each plane
straight out of the received buffer. Without a group one process holds every
shard, and the pack, the permute that the collective would do and the unpack
compose into **one** K2 gather straight from the stick rows to the slab rows,
with no collective. The ``*_FLOAT``/``*_BF16`` disciplines cast the payload
to the wire dtype around the collective (or the composed gather) only, so
both routes give bitwise the same rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidParameterError, MPIError
from ..ops.row_gather import row_gather
from ..types import ExchangeType, RAGGED_EXCHANGES, wire_dtype


def value_order_map(plan_triplets, request_triplets):
    """The static permutation ``src`` with ``plan_packed[i] ==
    request_values[src[i]]`` between two packings of the same triplet set,
    or None when the sets differ (the JAX package's serving coalescing map)."""
    a = np.asarray(plan_triplets, dtype=np.int64).reshape(-1, 3)
    b = np.asarray(request_triplets, dtype=np.int64).reshape(-1, 3)
    if a.shape != b.shape:
        return None
    oa = np.lexsort((a[:, 2], a[:, 1], a[:, 0]))
    ob = np.lexsort((b[:, 2], b[:, 1], b[:, 0]))
    if not np.array_equal(a[oa], b[ob]):
        return None
    src = np.empty(a.shape[0], dtype=np.int64)
    src[oa] = ob
    return src


def all_to_all_rows(send, send_rows, recv_rows, group, wire):
    """The exchange's collective: the real ``(rows, U)`` buffer ``send``,
    laid out rank by rank (``send_rows[r]`` rows for rank ``r``), goes to its
    ranks in one ``all_to_all_single``, cast to ``wire`` on the way; returns
    the received ``(sum(recv_rows), U)`` rows in rank order."""
    import torch.distributed as dist

    dtype, unit = send.dtype, send.shape[1]
    send = send.to(wire).reshape(-1)
    recv = send.new_empty(sum(recv_rows) * unit)
    try:
        dist.all_to_all_single(recv, send, output_split_sizes=[c * unit for c in recv_rows],
                               input_split_sizes=[c * unit for c in send_rows], group=group)
    except (RuntimeError, ValueError) as e:
        raise MPIError(f"exchange all_to_all_single failed: {e}") from e
    return recv.view(-1, unit).to(dtype)


class SlabExchange:
    """One plan's exchange: its row geometry, gather tables and transport.

    ``rows``: the ``(P, P)`` stick rows each shard pair ships, [stick shard,
    slab shard]. ``slot_stick``: per backward slab slot, the global stick row
    ``r * S_max + s`` it takes, -1 for none. ``stick_slot``: per global
    stick row, the forward slab slot it takes, -1 for none (padding sticks).
    ``planes``: the real planes of a row (2 for the (re, im) pairs of the MXU
    engine, 1 for the ``torch.fft`` engine's interleaved rows)."""

    def __init__(self, mesh, rows, s_max, l_max, slot_stick, stick_slot, num_fwd_slots,
                 wire, planes, name):
        self.mesh, self.name, self.wire, self.planes = mesh, name, wire, int(planes)
        self.P, self.Pl, self.world, self.rank = (
            mesh.num_shards, mesh.num_local, mesh.world, mesh.rank)
        self.S, self.L = int(s_max), int(l_max)
        self.rows = np.asarray(rows, dtype=np.int64)
        self.collective = mesh.group is not None
        slot_stick = np.asarray(slot_stick, dtype=np.int64)
        stick_slot = np.asarray(stick_slot, dtype=np.int64)
        self.num_fwd_slots = int(num_fwd_slots)
        put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=mesh.device)
        if self.collective:
            tables = self._collective_tables(slot_stick, stick_slot)
            self._bwd = tuple(put(t) if k < 2 else t for k, t in enumerate(tables[0]))
            self._fwd = tuple(put(t) if k < 2 else t for k, t in enumerate(tables[1]))
        else:
            self._bwd_index = put(self._local_backward_index(slot_stick))
            self._fwd_index = put(self._local_forward_index(stick_slot))

    # ---- geometry -----------------------------------------------------------------

    def offwire_elems(self) -> int:
        """Off-shard complex elements of one exchange direction, over the
        mesh: ``L_max``-wide rows, the self-blocks excluded."""
        return int((self.rows.sum() - np.trace(self.rows)) * self.L)

    def rounds(self) -> int:
        """Collective rounds per exchange: one on this transport, for every
        discipline (the JAX package's COMPACT chain takes P-1)."""
        return 1
    def _local_backward_index(self, slot_stick):
        """No group: slab row ``k * P + d`` <- stick row ``g(k) * P + d``."""
        P = self.P
        rows = self.Pl * self.S * P
        src = np.where(slot_stick[:, None] >= 0, slot_stick[:, None] * P + np.arange(P), rows)
        return src.reshape(-1)

    def _local_forward_index(self, stick_slot):
        """No group: stick row ``g * P + d`` <- slab row ``slot(g) * P + d``."""
        P = self.P
        rows = self.num_fwd_slots * P
        src = np.where(stick_slot[:, None] >= 0, stick_slot[:, None] * P + np.arange(P), rows)
        return src.reshape(-1)

    def _collective_tables(self, slot_stick, stick_slot):
        """Per direction: (pack index, unpack index, rows sent per rank, rows
        received per rank). Within a rank's chunk the blocks run stick shard
        major, slab shard minor, in both directions."""
        P, Pl, S, me, c = self.P, self.Pl, self.S, self.rank, self.rows
        # backward: this process's stick shards -> every slab shard
        pack, sent = [], []
        for dr in range(self.world):
            n0 = len(pack)
            for i in range(Pl):
                ig = me * Pl + i
                for dj in range(Pl):
                    dg = dr * Pl + dj
                    pack += [(i * S + s) * P + dg for s in range(c[ig, dg])]
            sent.append(len(pack) - n0)
        off, got, total = {}, [], 0
        for sr in range(self.world):
            n0 = total
            for si in range(Pl):
                for dj in range(Pl):
                    off[sr * Pl + si, dj] = total
                    total += c[sr * Pl + si, me * Pl + dj]
            got.append(total - n0)
        unpack = np.full((slot_stick.size, Pl), total, dtype=np.int64)
        for k, g in enumerate(slot_stick):
            if g >= 0:
                unpack[k] = [off[g // S, dj] + g % S for dj in range(Pl)]
        backward = (np.asarray(pack), unpack.reshape(-1), sent, got)
        # forward: this process's slab shards -> every stick shard
        sentinel_f = self.num_fwd_slots * Pl
        pack, sent = [], []
        for dr in range(self.world):
            n0 = len(pack)
            for si in range(Pl):
                rg = dr * Pl + si
                for dj in range(Pl):
                    for s in range(c[rg, me * Pl + dj]):
                        f = stick_slot[rg * S + s]
                        pack.append(f * Pl + dj if f >= 0 else sentinel_f)
            sent.append(len(pack) - n0)
        unpack = np.full((Pl, S, P), -1, dtype=np.int64)
        got, total = [], 0
        for sr in range(self.world):
            n0 = total
            for si in range(Pl):
                for dj in range(Pl):
                    d = sr * Pl + dj
                    k = c[me * Pl + si, d]
                    unpack[si, :k, d] = total + np.arange(k)
                    total += k
            got.append(total - n0)
        unpack[unpack < 0] = total
        return backward, (np.asarray(pack), unpack.reshape(-1), sent, got)

    # ---- the two directions -------------------------------------------------------

    def _gather(self, parts, index):
        out = row_gather(parts[0], parts[1] if len(parts) > 1 else None, index)
        return [o for o in out if o is not None]

    def _cast(self, parts):
        """The wire round trip of the composed (no-group) route."""
        if self.wire == parts[0].dtype:
            return parts
        return [p.to(self.wire).to(p.dtype) for p in parts]

    def backward(self, parts):
        """Stick rows ``(P_local * S_max * P, W)`` -> slab rows
        ``(num_slots * P_local, W)``, for each real part."""
        if not self.collective:
            return self._cast(self._gather(parts, self._bwd_index))
        return self.unpack_backward(self.exchange_backward(self.pack_backward(parts)))

    def forward(self, parts):
        """Slab rows ``(num_fwd_slots * P_local, W)`` -> stick rows."""
        if not self.collective:
            return self._cast(self._gather(parts, self._fwd_index))
        return self.unpack_forward(self.exchange_forward(self.pack_forward(parts)))

    # the collective route's three steps, the nodes of a staged plan
    def _pack(self, parts, index):
        """K2 writes plane ``q`` into column block ``q`` of one send buffer."""
        w = parts[0].shape[1]
        send = parts[0].new_empty((index.shape[0], self.planes * w))
        cols = [send[:, q * w:(q + 1) * w] for q in range(self.planes)]
        row_gather(parts[0], parts[1] if self.planes > 1 else None, index,
                   out=(cols[0], cols[1] if self.planes > 1 else None))
        return send

    def _unpack(self, recv, index):
        """K2 reads each plane out of its column block of the received rows."""
        w = recv.shape[1] // self.planes
        cols = [recv[:, q * w:(q + 1) * w] for q in range(self.planes)]
        return self._gather(cols, index)

    def pack_backward(self, parts):
        return self._pack(parts, self._bwd[0])

    def exchange_backward(self, send):
        return all_to_all_rows(send, self._bwd[2], self._bwd[3], self.mesh.group, self.wire)

    def unpack_backward(self, recv):
        return self._unpack(recv, self._bwd[1])

    def pack_forward(self, parts):
        return self._pack(parts, self._fwd[0])

    def exchange_forward(self, send):
        return all_to_all_rows(send, self._fwd[2], self._fwd[3], self.mesh.group, self.wire)

    def unpack_forward(self, recv):
        return self._unpack(recv, self._fwd[1])


def make_exchange(mesh, params, slot_stick, stick_slot, num_fwd_slots, exchange_type,
                  real_dtype, planes) -> SlabExchange:
    """The exchange of ``exchange_type`` (not DEFAULT: the plan resolves it
    first) for one plan's slab slots, with ``planes`` real planes a row."""
    exchange_type = ExchangeType(exchange_type)
    if exchange_type == ExchangeType.DEFAULT:
        raise InvalidParameterError("resolve ExchangeType.DEFAULT before building the exchange")
    P, n = params.num_shards, np.asarray(params.num_sticks_per_shard, dtype=np.int64)
    if exchange_type == ExchangeType.UNBUFFERED:
        rows, name = np.repeat(n[:, None], P, axis=1), "one-shot all_to_all_single"
    else:
        rows = np.full((P, P), params.max_num_sticks, dtype=np.int64)
        name = "compact all_to_all" if exchange_type in RAGGED_EXCHANGES else "padded all_to_all"
    return SlabExchange(mesh, rows, params.max_num_sticks, max(1, params.max_local_z_length),
                        slot_stick, stick_slot, num_fwd_slots,
                        wire_dtype(exchange_type, real_dtype), planes, name)
