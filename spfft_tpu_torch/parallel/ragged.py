"""The exchanges between shards: row blocks, gathers and the one transport.

Every exchange moves whole rows (the JAX package's row-granular exchanges,
``spfft_tpu/parallel/ragged.py``). A :class:`BlockExchange` is one
direction of one exchange: each shard pair ``s -> d`` ships a block of rows
of ``s``'s source tensor into rows of ``d``'s destination tensor, the
discipline setting how many rows a block holds. Padded (BUFFERED): the
padded block. COMPACT_*: the JAX package's COMPACT chain window (for the
slab exchange, ``max_i sticks_i``, the padded block again). UNBUFFERED:
the exact rows, the reference's ``MPI_Alltoallw``
(src/transpose/transpose_mpi_unbuffered_host.cpp:51-176). Every discipline
takes **one** collective round: ``all_to_all_single`` takes uneven split
sizes on every backend, so the JAX package's ppermute chain (P-1 rounds,
which exists because XLA lacks a ragged all-to-all off the TPU) is not
reproduced.

Transport, one rule: with a process group, a pack gather (kernel K2) writes
the rows rank by rank into one send buffer, each row holding every plane side
by side (``(rows, planes * W)``); one ``all_to_all_single`` moves it, and an
unpack gather (K2) reads each plane straight out of the received buffer.
Without a group one process holds every shard, and the pack, the permute
that the collective would do and the unpack compose into **one** K2 gather
from the source rows to the destination rows, with no collective. The
``*_FLOAT``/``*_BF16`` disciplines cast the payload to the wire dtype around
the collective (or the composed gather) only, so both routes give bitwise
the same rows.

The slab exchange (:class:`SlabExchange`, both slab engines): the **stick
side** of a process is its z-transformed stick table viewed as
``(P_local * S_max * P, W)`` rows: row ``(i * S_max + s) * P + d`` holds the
planes of shard ``d``'s z-slab of stick ``s`` of local shard ``i`` (the
engines fold the z-slab split into the z stage, so this is a view); the
**slab side** is the engine's slot table viewed as ``(num_slots * P_local,
W)`` rows: row ``k * P_local + j`` holds slot ``k`` (a (y, x) plane slot, a
per-slot sparse-y table row or a blocked bucket row) on local shard ``j``'s
planes, the local engine's ``(slots, Z)`` table with z cut into ``P_local``
padded slabs. The pencil engines' exchanges A and B are laid out in
:mod:`.pencil2`.
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


def all_to_all_rows(send, send_rows, recv_rows, group, wire, async_op=False, out=None):
    """The exchange's collective: the real ``(rows, U)`` buffer ``send``,
    laid out rank by rank (``send_rows[r]`` rows for rank ``r``), goes to its
    ranks in one ``all_to_all_single``, cast to ``wire`` on the way; returns
    the received ``(sum(recv_rows), U)`` rows in rank order.

    ``async_op=True`` returns at once a :class:`Pending` receive (its
    ``Work`` and the wire-dtype buffer); :func:`received` waits on it.
    ``out``: a flat contiguous wire-dtype buffer of ``sum(recv_rows) * U``
    elements (a slice of a larger one) to receive into."""
    import torch.distributed as dist

    dtype, unit = send.dtype, send.shape[1]
    send = send.to(wire).reshape(-1)
    recv = send.new_empty(sum(recv_rows) * unit) if out is None else out
    try:
        work = dist.all_to_all_single(recv, send, output_split_sizes=[c * unit for c in recv_rows],
                                      input_split_sizes=[c * unit for c in send_rows],
                                      group=group, async_op=async_op)
    except (RuntimeError, ValueError) as e:
        raise MPIError(f"exchange all_to_all_single failed: {e}") from e
    if async_op:
        return Pending(recv, unit, dtype, [work])
    return recv.view(-1, unit).to(dtype)


class Pending:
    """Receives in flight: the flat wire-dtype buffer ``recv`` of ``U``-wide
    rows, the real ``dtype`` they are read in, and the ``Work`` of every
    collective that writes into it."""

    def __init__(self, recv, unit, dtype, works):
        self.recv, self.unit, self.dtype, self.works = recv, unit, dtype, list(works)


def received(pending):
    """Wait on every collective of ``pending`` (on the card: the current
    stream waits on NCCL's) -> its ``(rows, U)`` rows in the real dtype. A
    failed wait is an :class:`MPIError`, as a failed collective is."""
    try:
        for work in pending.works:
            work.wait()
    except (RuntimeError, ValueError) as e:
        raise MPIError(f"exchange all_to_all_single failed: {e}") from e
    return pending.recv.view(-1, pending.unit).to(pending.dtype)


class SlabExchange:
    """One slab plan's exchange: a :class:`BlockExchange` each way
    (``backward``: stick rows to slab rows; ``forward``: back), with its
    name and wire accounting.

    ``rows``: the ``(P, P)`` stick rows each shard pair ships, [stick shard,
    slab shard]; shard ``s`` ships its stick rows ``0 .. rows[s, d] - 1``
    to ``d``. ``stick_slot``: per global stick row ``s * S_max + r``, the
    slab slot it fills and is read back from, -1 for none (padding sticks).
    ``planes``: the real planes of a row (2 for the (re, im) pairs of the MXU
    engine, 1 for the ``torch.fft`` engine's interleaved rows)."""

    def __init__(self, mesh, rows, s_max, l_max, stick_slot, num_slots, wire, planes, name,
                 chunks):
        self.name, self.L = name, int(l_max)
        P, Pl, S = mesh.num_shards, mesh.num_local, int(s_max)
        rows = np.asarray(rows, dtype=np.int64)
        stick_slot = np.asarray(stick_slot, dtype=np.int64)

        def blocks_of(c0, c1):
            """The blocks of the stick rows ``[c0, c1)`` of every shard, the
            source rows those of a ``(P_local * (c1 - c0) * P, L)`` table."""
            out = {}
            for s in range(P):
                for d in range(P):
                    r = np.arange(c0, min(c1, rows[s, d]))
                    slot = stick_slot[s * S + r]
                    out[s, d] = ((s % Pl * (c1 - c0) + r - c0) * P + d,
                                 np.where(slot >= 0, slot * Pl + d % Pl, -1))
            return out

        blocks = blocks_of(0, S)
        sticks, slots = Pl * S * P, int(num_slots) * Pl
        self.backward = BlockExchange(mesh, blocks, sticks, slots, wire, planes)
        self.forward = BlockExchange(mesh, flipped(blocks), slots, sticks, wire, planes)
        self.collective = self.backward.collective
        # the OVERLAPPED exchange: chunk k ships the stick rows [c0, c1) of
        # every shard, its index tables built here, once
        self.chunks = list(chunks)
        self.backward_chunks = self.forward_chunks = None
        if len(self.chunks) > 1:
            per = [blocks_of(c0, c1) for c0, c1 in self.chunks]
            n_src = [Pl * (c1 - c0) * P for c0, c1 in self.chunks]
            self.backward_chunks = ChunkedExchange(mesh, per, n_src, slots, wire, planes)
            self.forward_chunks = [BlockExchange(mesh, flipped(b), slots, n, wire, planes)
                                   for b, n in zip(per, n_src)]

    def offwire_elems(self) -> int:
        """Off-shard complex elements of one exchange direction, over the
        mesh: ``L_max``-wide rows, the self-blocks excluded."""
        return self.backward.offwire_rows() * self.L

    def rounds(self) -> int:
        """Collective rounds per exchange: one on this transport, for every
        discipline (the JAX package's COMPACT chain takes P-1); C chunk
        collectives for the OVERLAPPED exchange."""
        return len(self.chunks)


def make_exchange(mesh, params, stick_slot, num_slots, exchange_type, real_dtype,
                  planes, chunks) -> SlabExchange:
    """The exchange of ``exchange_type`` (not DEFAULT: the plan resolves it
    first) for one plan's ``num_slots`` slab slots, with ``planes`` real
    planes a row; ``chunks``: the stick-row ranges of its collectives (one,
    ``[(0, S_max)]``, but for the OVERLAPPED exchange)."""
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
                        stick_slot, num_slots, wire_dtype(exchange_type, real_dtype), planes,
                        name, chunks)


def flipped(blocks) -> dict:
    """The blocks of the opposite direction: ``d`` ships back to ``s`` the
    rows that ``s`` shipped to ``d``."""
    return {(d, s): (dst, src) for (s, d), (src, dst) in blocks.items()}


class BlockExchange:
    """One direction of an exchange, over arbitrary row blocks.

    ``blocks[s, d]`` is the block that shard ``s`` ships to shard ``d``: a
    pair ``(src, dst)`` of equal-length int arrays, ``src`` rows of the
    source tensor of ``s``'s process and ``dst`` rows of the destination
    tensor of ``d``'s process (the processes' stacked layouts), -1 where a
    row is padding (sent as zeros, or dropped on arrival). A pair absent
    from ``blocks`` ships nothing. ``n_src`` and ``n_dst``: this process's
    source and destination rows. Destination rows no block writes are zero.

    Without a process group the blocks compose into one K2 gather from the
    source rows to the destination rows; with one, a K2 pack into one send
    buffer (rank by rank, source shard major, destination shard minor,
    every plane of a row side by side), one ``all_to_all_single`` and a K2
    unpack. The wire dtype cast wraps the collective, or the composed gather,
    so that both routes give bitwise the same rows."""

    def __init__(self, mesh, blocks, n_src, n_dst, wire, planes):
        self.mesh, self.wire, self.planes = mesh, wire, int(planes)
        self.n_src, self.n_dst = int(n_src), int(n_dst)
        P = mesh.num_shards
        self.collective = mesh.group is not None
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        block = lambda s, d: blocks.get((s, d), empty)
        self.rows = np.asarray([[len(block(s, d)[0]) for d in range(P)] for s in range(P)],
                               dtype=np.int64)
        put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=mesh.device)
        if not self.collective:
            index = np.full(n_dst, n_src, dtype=np.int64)
            for (s, d), (src, dst) in blocks.items():
                keep = dst >= 0
                index[dst[keep]] = np.where(src[keep] >= 0, src[keep], n_src)
            self._index = put(index)
            return
        pack, self._sent = _pack_order(mesh, block, n_src)
        unpack = np.full(n_dst, -1, dtype=np.int64)
        self._got, total = _recv_order(mesh, block, unpack, 0)
        unpack[unpack < 0] = total
        self._pack = put(pack)
        self._unpack = put(unpack)

    def offwire_rows(self) -> int:
        """Rows that leave their shard, over the mesh (self-blocks excluded)."""
        return int(self.rows.sum() - np.trace(self.rows))

    def _gather(self, parts, index, out=None):
        got = row_gather(parts[0], parts[1] if len(parts) > 1 else None, index, out=out)
        return [o for o in got if o is not None]

    def run(self, parts, out=None):
        """Source rows (a list of real planes, each ``(n_src, W)``) ->
        destination rows, by either route; ``out``: row-strided planes (a
        column window of wider ones) that receive them."""
        if self.collective:
            return self.unpack(self.exchange(self.pack(parts)), out)
        got = self._gather(parts, self._index, out)
        return _wire_round_trip(got, self.wire)

    # the collective route's three steps, each a node of the plan's graph
    def pack(self, parts):
        """K2 writes plane ``q`` into column block ``q`` of one send buffer."""
        w = parts[0].shape[1]
        send = parts[0].new_empty((self._pack.shape[0], self.planes * w))
        cols = [send[:, q * w:(q + 1) * w] for q in range(self.planes)]
        self._gather(parts, self._pack, out=(cols[0], cols[1] if self.planes > 1 else None))
        return send

    def exchange(self, send, async_op=False):
        """The collective; ``async_op``: a :class:`Pending` receive, which
        :meth:`unpack` waits on."""
        return all_to_all_rows(send, self._sent, self._got, self.mesh.group, self.wire,
                               async_op=async_op)

    def unpack(self, recv, out=None):
        """K2 reads each plane out of its column block of the received rows
        (a :class:`Pending` receive is waited on first)."""
        if isinstance(recv, Pending):
            recv = received(recv)
        w = recv.shape[1] // self.planes
        return self._gather([recv[:, q * w:(q + 1) * w] for q in range(self.planes)],
                            self._unpack, out)


class ChunkedExchange(BlockExchange):
    """One direction of the OVERLAPPED exchange whose source comes in C
    chunks and whose destination is one tensor (the slab exchange's
    backward): chunk ``k``'s blocks ``chunk_blocks[k]`` ship rows of its own
    ``(chunk_n_src[k], W)`` source. Every chunk's received rows land in one
    receive buffer, chunk after chunk, each chunk rank by rank, which one
    unpack gather (K2) reads into the destination.

    Without a process group a chunk's pack gather (K2) writes its rows
    straight into its part of the receive buffer (one process: the send
    layout is the receive layout); with one, the pack writes a send buffer
    and the chunk's ``all_to_all_single`` is issued asynchronously into its
    part of a wire-dtype receive buffer, and the unpack waits on every
    chunk's ``Work``. Each chunk's index table is built here, once."""

    def __init__(self, mesh, chunk_blocks, chunk_n_src, n_dst, wire, planes):
        self.mesh, self.wire, self.planes = mesh, wire, int(planes)
        self.n_dst = int(n_dst)
        self.collective = mesh.group is not None
        put = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32), device=mesh.device)
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        unpack = np.full(n_dst, -1, dtype=np.int64)
        self._chunks, total = [], 0
        for blocks, n_src in zip(chunk_blocks, chunk_n_src):
            block = lambda s, d, b=blocks: b.get((s, d), empty)
            pack, sent = _pack_order(mesh, block, n_src)
            got, end = _recv_order(mesh, block, unpack, total)
            self._chunks.append((put(pack), sent, got, total, end))
            total = end
        unpack[unpack < 0] = total
        self._unpack, self.total = put(unpack), total

    def _buffer(self, like, width):
        """The receive buffer of every chunk: ``(total, planes * W)``."""
        return like.new_empty((self.total, self.planes * width))

    def gather(self, k, parts, recv=None):
        """Chunk ``k`` without a group: its pack gather into its rows of the
        receive buffer ``recv`` (None: a new one), wire cast in place."""
        pack, _, _, r0, r1 = self._chunks[k]
        w = parts[0].shape[1]
        recv = self._buffer(parts[0], w) if recv is None else recv
        rows = recv[r0:r1]
        cols = [rows[:, q * w:(q + 1) * w] for q in range(self.planes)]
        _wire_round_trip(self._gather(parts, pack, (cols[0], cols[1] if self.planes > 1
                                                    else None)), self.wire)
        return recv

    def pack_chunk(self, k, parts):
        """Chunk ``k``'s send buffer, one K2 gather (a process group)."""
        pack = self._chunks[k][0]
        w = parts[0].shape[1]
        send = parts[0].new_empty((pack.shape[0], self.planes * w))
        cols = [send[:, q * w:(q + 1) * w] for q in range(self.planes)]
        self._gather(parts, pack, out=(cols[0], cols[1] if self.planes > 1 else None))
        return send

    def exchange_chunk(self, k, send, pending=None):
        """Chunk ``k``'s collective, issued asynchronously into its part of
        the wire-dtype receive buffer of ``pending`` (None: a new one);
        returns the :class:`Pending` of every chunk so far."""
        _, sent, got, r0, r1 = self._chunks[k]
        unit = send.shape[1]
        if pending is None:
            pending = Pending(send.new_empty(self.total * unit, dtype=self.wire), unit,
                              send.dtype, [])
        part = all_to_all_rows(send, sent, got, self.mesh.group, self.wire, async_op=True,
                               out=pending.recv[r0 * unit:r1 * unit])
        return Pending(pending.recv, unit, pending.dtype, pending.works + part.works)


def _wire_round_trip(parts, wire):
    """Planes cast to the ``wire`` dtype and back, in place (the payload of
    a ``*_FLOAT``/``*_BF16`` discipline); unchanged where it is their dtype."""
    for p in parts:
        if p is not None and p.dtype != wire:
            p.copy_(p.to(wire))
    return parts


def _pack_order(mesh, block, n_src):
    """The send layout of one exchange direction: the source rows rank by
    rank (this process's shards major, the destination shards of the rank
    minor), padding sent as the zero row ``n_src``; and the rows per rank."""
    Pl, world, me = mesh.num_local, mesh.world, mesh.rank
    pack, sent = [], []
    for r in range(world):
        n0 = sum(len(p) for p in pack)
        for s in range(me * Pl, (me + 1) * Pl):
            for d in range(r * Pl, (r + 1) * Pl):
                src = block(s, d)[0]
                pack.append(np.where(src >= 0, src, n_src))
        sent.append(sum(len(p) for p in pack) - n0)
    return (np.concatenate(pack) if pack else np.zeros(0, np.int64)), sent


def _recv_order(mesh, block, unpack, total):
    """The receive layout from row ``total`` on: each destination row's row
    of it written into ``unpack``; returns the rows per rank and the end."""
    Pl, world, me = mesh.num_local, mesh.world, mesh.rank
    got = []
    for r in range(world):
        n0 = total
        for s in range(r * Pl, (r + 1) * Pl):
            for d in range(me * Pl, (me + 1) * Pl):
                dst = block(s, d)[1]
                keep = dst >= 0
                unpack[dst[keep]] = total + np.flatnonzero(keep)
                total += len(dst)
        got.append(total - n0)
    return got, total
