"""2-D pencil decomposition: scaling past the slab decomposition's ``dim_z`` cap.

The port of ``spfft_tpu/parallel/pencil2.py``. The slab engines cut space
into z-slabs, so at most ``dim_z`` shards hold any of it (reference:
docs/source/details.rst:50-52). The pencil engines run over a ``(P1, P2)``
mesh (:func:`~.mesh.make_fft_mesh2`), shard ``s = (a, b) = (s // P2, s % P2)``:

* frequency domain: whole z-sticks over all ``P1 * P2`` shards;
* intermediate domain: y-pencils. Shard ``(a, b)`` holds x-group ``a`` (a
  subset of the active x values, :func:`x_group_assignment`) and z-slab
  ``b``, over the full y extent;
* space domain: shard ``(a, b)`` holds z-slab ``b`` and y-slab ``a``, full x.

Backward: z-DFT -> exchange A (stick z-slabs -> y-pencils, over the whole
mesh) -> y-DFT -> exchange B (y-pencils -> slabs, among the shards of one
z-slab) -> x-DFT. Forward reverses it. R2C stays shard-local: the (0, 0)
stick's fill before exchange A on its owner, the x = 0 plane's fill after
it on the shards of the x-group that holds x = 0, which see every y.

The stacked layouts of a process's ``P_local`` shards (``j`` the local
index), every row ``Lz`` planes wide, z minor:

* stick side: the z stage writes each stick's z-slabs side by side,
  ``(P_local * S_max, P2 * Lz)``, that is rows ``(j * S_max + r) * P2 + b``;
* y-pencil grid ``(Y, P_local * Ax, Lz)``: rows ``(y * P_local + j) * Ax + g``
  for slot ``g`` of the shard's x-group, so that the y stage is one pass
  over every shard;
* slab side ``(P_local * Ly, C, Lz)``: rows ``(j * Ly + l) * C + c``, y-row
  ``l`` of the shard's y-slab and column ``c``: the ``P1 * Ax`` (group, slot)
  columns on the matrix-product engine (the x stage's matrix maps them to
  x), the ``Xf`` x frequencies on the ``torch.fft`` engine;
* native space ``(P_local, Ly, X, Lz)``: each shard's ``(y, x, z)`` block.

Each exchange direction is a :class:`~.ragged.BlockExchange`: one K2 gather
without a process group, else a K2 pack, one ``all_to_all_single`` and a K2
unpack. Exchange B's collective runs over the whole group, with no rows for
peers outside the z-slab. The row counts of the blocks follow the
discipline: padded (BUFFERED) ``SG`` and ``Ly`` rows, the exact counts
(UNBUFFERED), or the JAX package's COMPACT chain's window per rotation step,
in one round. ``ExchangeType.DEFAULT`` resolves by the JAX package's cost
model with the one-shot exchange supported (:func:`resolve_pencil2_default`).
:class:`Pencil2Execution` is the ``torch.fft`` engine; the matrix-product
engine is :mod:`.pencil2_mxu`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidParameterError
from ..ops import symmetry
from ..types import RAGGED_EXCHANGES, ExchangeType, wire_dtype, wire_scalar_bytes
from .execution import DistributedExecution, PaddingHelpers
from .mesh import is_pencil2_mesh
from .ragged import BlockExchange, flipped

# The JAX package's default latency of one collective round in byte
# equivalents (spfft_tpu/parallel/policy.py, its EXCH_ROUND_COST_KB knob):
# the cost model DEFAULT is resolved by, without the knob.
ROUND_COST_BYTES = 128 << 10


def ceil_split(n: int, parts: int) -> np.ndarray:
    """Balanced contiguous split sizes (the first ``n % parts`` one longer)."""
    base, extra = divmod(int(n), int(parts))
    return np.asarray([base + (1 if i < extra else 0) for i in range(parts)], dtype=np.int64)


def x_group_assignment(ux, sx_all, valid, P1, P2, aligned):
    """The active x values ``ux`` (sorted) over the P1 x-groups: ``(group,
    slot, Ax)`` per value and the slots of the fullest group.

    Balanced (``aligned`` False): round robin over ``ux``, which evens the
    per-(shard, group) stick counts that the padded exchange A ships.
    Ownership-aligned: each x goes to the group of the shard column
    (``s // P2``) that owns most of its sticks, which keeps exchange A inside
    the columns when the sticks lie column by column
    (``distribute_triplets(layout=...)``) and profits the exact-count
    disciplines."""
    ux = np.asarray(ux, dtype=np.int64)
    if not aligned:
        return np.arange(ux.size) % P1, np.arange(ux.size) // P1, max(1, -(-ux.size // P1))
    weight = np.zeros((ux.size, P1), dtype=np.int64)
    col_of_shard = np.broadcast_to((np.arange(sx_all.shape[0]) // P2)[:, None], sx_all.shape)
    np.add.at(weight, (np.searchsorted(ux, sx_all[valid]), col_of_shard[valid]), 1)
    group = np.argmax(weight, axis=1)
    slot = _occurrence(group)
    fill = np.bincount(group, minlength=P1)
    return group, slot, max(1, int(fill.max()))


def _occurrence(keys) -> np.ndarray:
    """Per entry, how many equal keys come before it."""
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]])) if k.size else k
    run = np.repeat(starts, np.diff(np.concatenate([starts, [k.size]])))
    out = np.empty(keys.size, dtype=np.int64)
    out[order] = np.arange(k.size) - run
    return out


def _volumes(counts, ax, lz, ly, Lz, P1, P2):
    """Off-shard complex elements of exchanges A and B under one x-group
    assignment, per discipline: (padded, exact, chain) each, the JAX
    package's accounting (the chain's per-step windows of max rows by max
    valid columns)."""
    Pn, Ly = P1 * P2, max(1, int(ly.max()))
    a_of, b_of = np.arange(Pn) // P2, np.arange(Pn) % P2
    s, q = np.arange(Pn), np.arange(P1)
    rows_a, cols_a = counts[:, a_of], lz[b_of]
    a_pad = Pn * (Pn - 1) * max(1, int(counts.max())) * Lz
    a_exact = Lz * int(rows_a.sum() - np.trace(rows_a))
    a_chain = Pn * sum(max(1, int(rows_a[s, (s + k) % Pn].max()))
                       * max(1, int(cols_a[(s + k) % Pn].max())) for k in range(1, Pn))
    b_pad = Pn * (P1 - 1) * Lz * Ly * ax
    b_exact = P2 * (P1 - 1) * int(ly.sum()) * ax * Lz
    b_chain = P2 * P1 * sum(max(1, int(ly[(q + k) % P1].max())) * ax * Lz for k in range(1, P1))
    return (a_pad, a_exact, a_chain), (b_pad, b_exact, b_chain)


def resolve_pencil2_default(assign, lz, ly, Lz, Ly, P1, P2, wire_scalar_bytes):
    """``ExchangeType.DEFAULT`` of a pencil plan, by the JAX package's cost
    model (``spfft_tpu/parallel/pencil2.py`` ``_resolve_pencil2_default``):
    ``wire bytes + rounds * ROUND_COST_BYTES`` over both exchanges, the
    padded discipline with the balanced x-groups, the exact-count ones with
    the aligned; ``assign[aligned]`` is ``(group, slot, Ax, counts)``.
    ``all_to_all_single`` takes split sizes, so the one-shot exchange is
    supported and chooses. Returns the discipline and the cost tables of
    both flags of one-shot support, in the plan card's ``exchange_policy``
    shape without the ``chosen`` marks (the chain's rounds are the JAX
    chain's, P-1 and P1-1; the port's transport takes one round an
    exchange)."""
    Pn = P1 * P2
    (a_pad, _, _), (b_pad, _, _) = _volumes(assign[False][3], assign[False][2], lz, ly, Lz,
                                            P1, P2)
    (_, a_exact, a_chain), (_, b_exact, b_chain) = _volumes(assign[True][3], assign[True][2],
                                                            lz, ly, Lz, P1, P2)
    cost = lambda vol, rounds: vol * 2 * wire_scalar_bytes + rounds * ROUND_COST_BYTES
    chain_rounds = (Pn - 1) + (P1 - 1)
    buffered = (a_pad + b_pad, 2, cost(a_pad + b_pad, 2))
    oneshot = (a_exact + b_exact, 2, cost(a_exact + b_exact, 2))
    chain = (a_chain + b_chain, chain_rounds, cost(a_chain + b_chain, chain_rounds))

    def table(one_shot):
        rows = {ExchangeType.BUFFERED: buffered,
                ExchangeType.UNBUFFERED: oneshot if one_shot else chain,
                ExchangeType.COMPACT_BUFFERED: chain}
        return {"round_cost_bytes": ROUND_COST_BYTES, "one_shot_supported": bool(one_shot),
                "alternatives": [{"discipline": d.name,
                                  "wire_bytes": int(v * 2 * wire_scalar_bytes),
                                  "rounds": int(r), "cost_bytes": int(c)}
                                 for d, (v, r, c) in rows.items()]}

    choice = min((buffered[2], 0, ExchangeType.BUFFERED), (oneshot[2], 1, ExchangeType.UNBUFFERED),
                 (chain[2], 2, ExchangeType.COMPACT_BUFFERED))[2]
    return choice, {flag: table(flag) for flag in (False, True)}


class PencilGeometry:
    """The static 2-D geometry of one pencil plan (numpy, global): the z and
    y splits (``lz``, ``zo``, ``ly``, ``yo``, padded ``Lz``, ``Ly``), the
    discipline (DEFAULT resolved) and its x-group assignment
    (``group_of_x``/``slot_of_x`` with sentinel group P1, ``Ax`` slots a
    group, ``xcol``: the x of each (group, slot), ``Xf`` for none), the
    stick tables (``counts[s, a]`` sticks of shard s in group a, at local
    rows ``rows[s, a, j]`` and plane columns ``cols[s, a, j] = y * Ax +
    slot``, ``SG`` the most), and the R2C x = 0 site."""

    def __init__(self, params, P1, P2, exchange_type, real_dtype):
        p = params
        self.P1, self.P2, self.Pn = int(P1), int(P2), int(P1) * int(P2)
        Pn, Z, Y, Xf = self.Pn, p.dim_z, p.dim_y, p.dim_x_freq
        sx_all = p.stick_x_all.astype(np.int64)
        sy_all = p.stick_y_all.astype(np.int64)
        valid = sx_all < Xf
        ux = np.unique(sx_all[valid])
        if ux.size == 0:
            ux = np.zeros(1, dtype=np.int64)
        self.lz, self.ly = ceil_split(Z, P2), ceil_split(Y, P1)
        self.zo = np.concatenate([[0], np.cumsum(self.lz)[:-1]])
        self.yo = np.concatenate([[0], np.cumsum(self.ly)[:-1]])
        self.Lz, self.Ly = max(1, int(self.lz.max())), max(1, int(self.ly.max()))
        assign = {}

        def get_assign(aligned):
            if aligned not in assign:
                g, slot, ax = x_group_assignment(ux, sx_all, valid, P1, P2, aligned)
                g_of_x = np.full(Xf, P1, dtype=np.int64)
                g_of_x[ux] = g
                counts = np.zeros((Pn, P1), dtype=np.int64)
                for s in range(Pn):
                    np.add.at(counts[s], g_of_x[sx_all[s, valid[s]]], 1)
                assign[aligned] = (g, slot, ax, counts)
            return assign[aligned]

        exchange_type = ExchangeType(exchange_type)
        self.policy_tables = None
        if exchange_type == ExchangeType.DEFAULT:
            get_assign(False), get_assign(True)
            exchange_type, self.policy_tables = resolve_pencil2_default(
                assign, self.lz, self.ly, self.Lz, self.Ly, P1, P2,
                np.dtype(real_dtype).itemsize)
        self.exchange_type = exchange_type
        if exchange_type in RAGGED_EXCHANGES:
            # the assignment that ships fewer rows under this discipline's
            # rows: exact for UNBUFFERED, the chain's windows for COMPACT_*
            which = 1 if exchange_type == ExchangeType.UNBUFFERED else 2

            def volume(aligned):
                _, _, ax, counts = get_assign(aligned)
                a, b = _volumes(counts, ax, self.lz, self.ly, self.Lz, P1, P2)
                return a[which] + b[which]

            self.aligned = bool(volume(True) < volume(False))
        else:
            self.aligned = False
        group, slot, self.Ax, self.counts = get_assign(self.aligned)
        self.group_of_x = np.full(Xf, P1, dtype=np.int64)
        self.slot_of_x = np.zeros(Xf, dtype=np.int64)
        self.group_of_x[ux], self.slot_of_x[ux] = group, slot
        self.SG = max(1, int(self.counts.max()))
        S, Ax, SG = p.max_num_sticks, self.Ax, self.SG
        self.rows = np.full((Pn, P1, SG), S, dtype=np.int64)
        self.cols = np.full((Pn, P1, SG), Y * Ax, dtype=np.int64)
        for s in range(Pn):
            r = np.flatnonzero(valid[s])
            a = self.group_of_x[sx_all[s, r]]
            j = _occurrence(a)
            self.rows[s, a, j] = r
            self.cols[s, a, j] = sy_all[s, r] * Ax + self.slot_of_x[sx_all[s, r]]
        self.xcol = np.full(P1 * Ax, Xf, dtype=np.int64)
        self.xcol[group * Ax + slot] = ux
        self.have_x0 = bool((ux == 0).any())
        self.x0_group = int(self.group_of_x[0]) if self.have_x0 else 0
        self.x0_slot = int(self.slot_of_x[0]) if self.have_x0 else 0

    def block_rows(self, exchange_type):
        """``(R_A, Rl)``: per shard pair ``(s, d)`` the rows of exchange A's
        block, and the y-rows of exchange B's (times ``Ax`` rows; zero
        between shards of different z-slabs), under ``exchange_type``."""
        P1, P2, Pn = self.P1, self.P2, self.Pn
        s, d = np.meshgrid(np.arange(Pn), np.arange(Pn), indexing="ij")
        exact_a = self.counts[s, d // P2]
        q, a = s // P2, d // P2
        exact_b = self.ly[a]
        if exchange_type == ExchangeType.UNBUFFERED:
            ra, rl = exact_a, exact_b
        elif exchange_type in RAGGED_EXCHANGES:
            # the JAX chain's window at each rotation step k: the most rows
            # over the step's shard pairs
            step_a = (d - s) % Pn
            ka = np.asarray([max(1, int(exact_a[np.arange(Pn), (np.arange(Pn) + k) % Pn].max()))
                             for k in range(Pn)])
            step_b = (a - q) % P1
            kb = np.asarray([max(1, int(self.ly[(np.arange(P1) + k) % P1].max()))
                             for k in range(P1)])
            ra, rl = ka[step_a], kb[step_b]
        else:
            ra, rl = np.full((Pn, Pn), self.SG), np.full((Pn, Pn), self.Ly)
        rl = np.where(s % P2 == d % P2, rl, 0)
        return ra.astype(np.int64), rl.astype(np.int64)


class Pencil2Helpers(PaddingHelpers):
    """What both pencil engines share: the geometry, the four exchange
    directions, the caller-data padding of the 2-D blocks, the per-shard
    layout accessors and the wire accounting. ``NATIVE_LAYOUT`` names each
    shard's ``(Ly, X, Lz)`` block of the stacked ``(P_local, Ly, X, Lz)``."""

    NATIVE_LAYOUT = "yxz"

    def _setup_pencil(self, params, real_dtype, mesh, exchange_type, slot_columns, planes):
        """The pencil half of the constructor; ``slot_columns``: the slab
        side's column of each (group, slot) (-1 for none) and its width."""
        if not is_pencil2_mesh(mesh):
            raise InvalidParameterError("a pencil plan needs a pencil mesh (make_fft_mesh2)")
        self._setup(params, real_dtype, mesh, ExchangeType.BUFFERED)  # resolved below
        P1, P2 = mesh.shape
        g = self.geometry = PencilGeometry(params, P1, P2, exchange_type, real_dtype)
        self.exchange_type = g.exchange_type
        self.P1, self.P2 = P1, P2
        self._Lz, self._Ly, self._Ax, self._SG = g.Lz, g.Ly, g.Ax, g.SG
        col_of_slot, self._C = slot_columns(g)
        self._exchanges = self._build_exchanges(col_of_slot, planes)
        # the z stage's columns: each stick's z-slabs side by side, padding
        # columns zero (the global z of each column, dim_z for none)
        Z = params.dim_z
        self._pack_z2 = np.full(P2 * g.Lz, Z, dtype=np.int64)
        unpack = np.zeros(Z, dtype=np.int64)
        for b in range(P2):
            l, o = int(g.lz[b]), int(g.zo[b])
            self._pack_z2[b * g.Lz:b * g.Lz + l] = np.arange(o, o + l)
            unpack[o:o + l] = b * g.Lz + np.arange(l)
        self._unpack_z2 = unpack
        # the R2C x = 0 plane: its slot column on this process's shards of its group
        Pl = self.num_local
        self._x0_cols = None
        if self.is_r2c and g.have_x0:
            cols = [j * g.Ax + g.x0_slot for j, s in enumerate(self._local)
                    if s // P2 == g.x0_group]
            self._x0_cols = self.put(np.asarray(cols), torch.int64) if cols else None
        self._pencil_shape = (params.dim_y, Pl * g.Ax, g.Lz)
        self._slab_shape = (Pl * g.Ly, self._C, g.Lz)

    def _build_exchanges(self, col_of_slot, planes) -> dict:
        """The four directions ``{(tag, direction): BlockExchange}``, tag
        ``"A"`` or ``"B"`` (the module docstring's layouts)."""
        g, p, mesh = self.geometry, self.params, self.mesh
        P1, P2, Pn, Ax, Lz, Ly = g.P1, g.P2, g.Pn, g.Ax, g.Lz, g.Ly
        Pl, S, Y = mesh.num_local, p.max_num_sticks, p.dim_y
        loc = lambda s: s % Pl  # a shard's place among its process's shards
        ra, rl = g.block_rows(self.exchange_type)
        a_bwd, b_bwd = {}, {}
        for s in range(Pn):
            for d in range(Pn):
                a, b = divmod(d, P2)
                n = int(g.counts[s, a])
                src = np.full(ra[s, d], -1, dtype=np.int64)
                dst = np.full(ra[s, d], -1, dtype=np.int64)
                r, c = g.rows[s, a, :n], g.cols[s, a, :n]
                src[:n] = (loc(s) * S + r) * P2 + b
                dst[:n] = ((c // Ax) * Pl + loc(d)) * Ax + c % Ax
                a_bwd[s, d] = (src, dst)
                if rl[s, d]:  # s = (q, b) holds the y-pencils, d = (a, b) the slab
                    q = s // P2
                    ll, gg = np.meshgrid(np.arange(rl[s, d]), np.arange(Ax), indexing="ij")
                    ok = ll < g.ly[a]
                    col = col_of_slot[q * Ax + gg]
                    src = np.where(ok, ((g.yo[a] + ll) * Pl + loc(s)) * Ax + gg, -1)
                    dst = np.where(ok & (col >= 0), (loc(d) * Ly + ll) * self._C + col, -1)
                    b_bwd[s, d] = (src.reshape(-1), dst.reshape(-1))
        wire = wire_dtype(self.exchange_type, self.real_dtype)
        n_stick, n_pencil = Pl * S * P2, Y * Pl * Ax
        n_slab = Pl * Ly * self._C
        return {
            ("A", "backward"): BlockExchange(mesh, a_bwd, n_stick, n_pencil, wire, planes),
            ("A", "forward"): BlockExchange(mesh, flipped(a_bwd), n_pencil, n_stick, wire, planes),
            ("B", "backward"): BlockExchange(mesh, b_bwd, n_pencil, n_slab, wire, planes),
            ("B", "forward"): BlockExchange(mesh, flipped(b_bwd), n_slab, n_pencil, wire, planes),
        }

    @property
    def collective(self) -> bool:
        return self._exchanges["A", "backward"].collective

    # ---- the exchanges' nodes (ir.lower._lower_pencil) --------------------------
    # Each engine maps tensors to real row planes (``_rows``) and row planes
    # to its tensor of a shape (``_shaped``).

    def _out_shape(self, tag, direction):
        if (tag, direction) == ("A", "forward"):
            return (self.num_local * self._S, self.P2 * self._Lz)
        if (tag, direction) == ("B", "backward"):
            return self._slab_shape
        return self._pencil_shape

    def _st_exchange(self, tag, direction, *parts):
        rows = self._exchanges[tag, direction].run(self._rows(*parts))
        return self._shaped(rows, self._out_shape(tag, direction), tag, direction)

    def _st_pack(self, tag, direction, *parts):
        return self._exchanges[tag, direction].pack(self._rows(*parts))

    def _st_collective(self, tag, direction, send):
        return self._exchanges[tag, direction].exchange(send)

    def _st_unpack(self, tag, direction, recv):
        rows = self._exchanges[tag, direction].unpack(recv)
        return self._shaped(rows, self._out_shape(tag, direction), tag, direction)

    def _legacy_pencil_exchange(self, tag, direction, *parts):
        """The legacy path's exchange ``tag``: ``_lower_pencil``'s nodes of
        it called in order (one gather, or pack, the collective and unpack
        over a process group)."""
        if not self.collective:
            return self._st_exchange(tag, direction, *parts)
        send = self._st_pack(tag, direction, *parts)
        return self._st_unpack(tag, direction, self._st_collective(tag, direction, send))

    # ---- caller data <-> the stacked 2-D blocks -------------------------------

    def _block(self, r):
        """Shard ``r``'s ``(lz, zo, ly, yo)``."""
        g = self.geometry
        a, b = divmod(r, self.P2)
        return int(g.lz[b]), int(g.zo[b]), int(g.ly[a]), int(g.yo[a])

    def pad_space(self, space):
        """A global ``(Z, Y, X)`` array or tensor, or a per-shard list of
        ``(local_z_length, local_y_length, X)`` blocks (None for another
        process's) -> the stacked native space: the (re, im) pair, or (re,
        None) for R2C."""
        from .. import obs

        p = self.params
        shape = (self.num_local, self._Ly, p.dim_x, self._Lz)
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
                len(parts) * parts[0].numel() * self.real_dtype.itemsize)
        for j, r in enumerate(self._local):
            lz, zo, ly, yo = self._block(r)
            blk = self._tensor(space[r]) if per_shard else space[zo:zo + lz, yo:yo + ly]
            if tuple(blk.shape) != (lz, ly, p.dim_x):
                raise InvalidParameterError(
                    f"shard {r}: expected a ({lz}, {ly}, {p.dim_x}) block, got {tuple(blk.shape)}")
            blk = blk.permute(1, 2, 0)
            parts[0][j, :ly, :, :lz] = blk.real if blk.is_complex() else blk
            if not self.is_r2c and blk.is_complex():
                parts[1][j, :ly, :, :lz] = blk.imag
        return parts[0], (None if self.is_r2c else parts[1])

    def local_block(self, out, shard):
        """Shard ``shard``'s ``(lz, ly, X)`` block of the native result
        ``out`` (complex for C2C), a view."""
        j = self._local.index(shard)
        lz, _, ly, _ = self._block(shard)
        blk = out[j] if self.is_r2c else torch.complex(out[0][j], out[1][j])
        return blk[:ly, :, :lz].permute(2, 0, 1)

    def unpad_space(self, out):
        """Native space -> the global ``(Z, Y, X)`` tensor (complex for C2C)
        when this process holds every shard, else per-shard ``(lz, ly, X)``
        blocks (None for another process's)."""
        p = self.params
        blocks = [None] * p.num_shards
        for r in self._local:
            blocks[r] = self.local_block(out, r)
        if len(self._local) < p.num_shards:
            return [None if b is None else b.contiguous() for b in blocks]
        dst = blocks[0].new_empty((p.dim_z, p.dim_y, p.dim_x))
        for r, blk in enumerate(blocks):
            lz, zo, ly, yo = self._block(r)
            dst[zo:zo + lz, yo:yo + ly] = blk
        return dst

    # ---- per-shard 2-D layout (DistributedTransform's accessors) --------------

    def local_z_length(self, shard: int) -> int:
        return self._block(shard)[0]

    def local_z_offset(self, shard: int) -> int:
        return self._block(shard)[1]

    def local_y_length(self, shard: int) -> int:
        return self._block(shard)[2]

    def local_y_offset(self, shard: int) -> int:
        return self._block(shard)[3]

    def local_slice_size(self, shard: int) -> int:
        return self.local_z_length(shard) * self.local_y_length(shard) * self.params.dim_x

    # ---- wire accounting and the perf layer's model ---------------------------

    def _exchange_elems(self) -> tuple:
        """(exchange A, exchange B) off-shard complex elements of one
        direction, over the mesh: the rows the blocks ship, ``Lz`` wide."""
        return tuple(self._exchanges[t, "backward"].offwire_rows() * self._Lz for t in "AB")

    def exchange_wire_bytes(self) -> int:
        """Off-shard bytes of one direction, exchanges A and B together."""
        return sum(self._exchange_elems()) * 2 * wire_scalar_bytes(self.exchange_type,
                                                                   self.real_dtype)

    def exchange_rounds(self) -> int:
        """Collective rounds a direction: one for A and one for B."""
        return 2

    def exchange_transport(self) -> str:
        if not self.collective:
            return "device gather"
        if self.exchange_type == ExchangeType.UNBUFFERED:
            return "one-shot all_to_all_single"
        return ("compact all_to_all" if self.exchange_type in RAGGED_EXCHANGES
                else "padded all_to_all")

    def _geometry(self) -> dict:
        g = self.geometry
        return {"overlap_chunks": 1,
                "pencil_geometry": {"p1": int(g.P1), "p2": int(g.P2), "lz_max": int(g.Lz),
                                    "ly_max": int(g.Ly), "ax": int(g.Ax), "sg_max": int(g.SG)},
                "x_group_strategy": "ownership-aligned" if g.aligned else "balanced",
                "num_local_shards": self.num_local, "transport": self.exchange_transport()}

    def stage_accounting(self) -> list:
        """Analytic per-stage flop/byte rows of one backward+forward pair, the
        JAX package's ``Pencil2Execution.stage_accounting``: the shared head
        and tail rows and, between them, pack/exchange/unpack rows of
        exchanges A and B, the exchange rows the wire bytes of both
        directions."""
        from ..obs.perf import pipeline_head_rows, pipeline_tail_rows

        p, g = self.params, self.geometry
        P = int(p.num_shards)
        Z, Y, X, Xf = p.dim_z, p.dim_y, p.dim_x, p.dim_x_freq
        c_item = 2 * self.real_dtype.itemsize
        wire = wire_scalar_bytes(self.exchange_type, self.real_dtype)
        rows = pipeline_head_rows(int(np.asarray(p.num_values_per_shard).sum()),
                                  int(np.asarray(p.num_sticks_per_shard).sum()), Z, c_item,
                                  stick_symmetry=self.is_r2c and p.zero_stick_shard >= 0)
        bufs = (P * P * g.SG * g.Lz, P * g.P1 * g.Lz * g.Ly * g.Ax)
        for tag, buf, elems in zip("AB", bufs, self._exchange_elems()):
            rows.append({"stage": f"pack {tag}", "flops": 0, "bytes": 2 * 2 * buf * c_item})
            rows.append({"stage": f"exchange {tag}", "flops": 0, "bytes": 2 * elems * 2 * wire})
            rows.append({"stage": f"unpack {tag}", "flops": 0, "bytes": 2 * 2 * buf * c_item})
        return rows + pipeline_tail_rows(Z, Y, X, Z * min(Xf, g.Ax * g.P1), c_item,
                                         plane_symmetry=self.is_r2c)


class Pencil2Execution(Pencil2Helpers, DistributedExecution):
    """The ``torch.fft`` pencil engine (cuFFT on the card): the slab
    engine's decompress, z-DFT and compress, with the z stage's columns cut
    into the P2 padded z-slabs, the y-DFT over the stacked y-pencil grid and
    the x-DFT (C2R for R2C) over the slab side's ``Xf`` columns. Complex
    data; the exchanges move its interleaved rows."""

    def __init__(self, params, real_dtype, mesh, exchange_type, fuse=None):
        def columns(g):  # the slab side holds every x frequency
            col = np.where(g.xcol < params.dim_x_freq, g.xcol, -1)
            return col, params.dim_x_freq

        self._setup_pencil(params, real_dtype, mesh, exchange_type, columns, planes=1)
        self.num_x_active = params.dim_x_freq
        self._pack_z = self.put(self._pack_z2, torch.int64)
        self._unpack_z = self.put(self._unpack_z2, torch.int64)
        self._init_ir(fuse)

    def describe(self) -> dict:
        return {"pipeline": "torch.fft + exchange gathers (pencil)", **self._geometry()}

    def _rows(self, c):
        return [torch.view_as_real(c.contiguous()).reshape(-1, 2 * self._Lz)]

    def _shaped(self, rows, shape, tag, direction):
        c = torch.view_as_complex(rows[0].view(*shape, 2))
        return c.index_select(1, self._unpack_z) if (tag, direction) == ("A", "forward") else c

    def _st_plane_symmetry(self, grid):
        # in place: the exchange A edge is read by this node alone
        if self._x0_cols is not None:
            grid[:, self._x0_cols] = symmetry.hermitian_fill_1d(grid[:, self._x0_cols], axis=0)
        return grid

    def _st_x_backward(self, slab):
        p = self.params
        shape = (self.num_local, self._Ly, p.dim_x, self._Lz)
        if self.is_r2c:
            return torch.fft.irfft(slab, n=p.dim_x, dim=1, norm="forward").contiguous().view(shape)
        out = torch.fft.ifft(slab, dim=1, norm="forward")
        return out.real.contiguous().view(shape), out.imag.contiguous().view(shape)

    def _st_x_forward(self, space_re, space_im):
        flat = lambda t: t.to(self.torch_dtype).reshape(-1, self.params.dim_x, self._Lz)
        if self.is_r2c:
            return torch.fft.rfft(flat(space_re), n=self.params.dim_x, dim=1)
        return torch.fft.fft(torch.complex(flat(space_re), flat(space_im)), dim=1)

    # ---- the legacy path (ir_lower_failed): _lower_pencil's nodes in order, no graph ----

    def _legacy_backward(self, values_re, values_im):
        sticks = self._st_decompress(values_re, values_im)
        if self.is_r2c and self._zero_stick_id is not None:
            sticks = self._st_stick_symmetry(sticks)
        grid = self._legacy_pencil_exchange("A", "backward", self._st_z_backward(sticks))
        if self.is_r2c and self._x0_cols is not None:
            grid = self._st_plane_symmetry(grid)
        slab = self._legacy_pencil_exchange("B", "backward", self._st_y_backward(grid))
        return self._st_x_backward(slab)

    def _legacy_forward(self, scaling, space_re, space_im):
        grid = self._legacy_pencil_exchange("B", "forward", self._st_x_forward(space_re, space_im))
        sticks = self._legacy_pencil_exchange("A", "forward", self._st_y_forward(grid))
        return self._st_compress(self._st_z_forward(sticks), scaling)
