"""Lowering: each engine's pipeline as one stage graph per direction.

One builder per engine class turns the engine's stage bodies (its ``_st_*``
methods) into a :class:`~spfft_tpu_torch.ir.graph.StageGraph` per direction,
with the node order and labels of the JAX package's builders
(``spfft_tpu/ir/lower.py`` ``_lower_local_xla``, ``_lower_local_mxu``,
``_lower_slab_xla``, ``_lower_slab_mxu``, ``_lower_pencil``). The graphs are what the engine
runs (:mod:`spfft_tpu_torch.ir.compile`): a stage missing here is a stage
the plan does not run.

Where a node writes in place (the R2C hermitian fills), it writes into an
edge that no other node reads, so fused and staged runs see the same values.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from ..errors import InvalidParameterError
from ..types import ScalingType
from .graph import EdgeMeta, StageGraph

SCALINGS = (ScalingType.NONE, ScalingType.FULL)


def lower_engine(engine) -> dict:
    """``{"backward": graph, "forward": {scaling: graph}}`` of ``engine``,
    by its class (or a base class with a builder); an engine with none
    raises."""
    for klass in type(engine).__mro__:
        builder = _BUILDERS.get(klass.__name__)
        if builder is not None:
            return builder(engine)
    raise InvalidParameterError(f"ir: no lowering registered for engine {type(engine).__name__!r}")


def _complex(real_dtype):
    return np.dtype(np.complex64 if np.dtype(real_dtype) == np.float32 else np.complex128)


def _lower_local_xla(e):
    p = e.params
    rt, ct = e.real_dtype, _complex(e.real_dtype)
    n = int(p.num_values)
    S, Z, Y, Xf, X = int(p.num_sticks), p.dim_z, p.dim_y, p.dim_x_freq, p.dim_x

    def backward():
        g = StageGraph("backward")
        g.add_input("values_re", dtype=rt, shape=(n,))
        g.add_input("values_im", dtype=rt, shape=(n,))
        g.batch_inputs = ("values_re", "values_im")
        g.add("compression", e._st_decompress, ("values_re", "values_im"), ("sticks",),
              out_meta={"sticks": EdgeMeta(ct, (S, Z))})
        g.expect_dtype("compression", "values_re", rt)
        g.expect_dtype("compression", "values_im", rt)
        cur = "sticks"
        if e.is_r2c:
            g.add("stick symmetry", e._st_stick_symmetry, (cur,), ("sticks_h",),
                  out_meta={"sticks_h": EdgeMeta(ct, (S, Z))})
            cur = "sticks_h"
        g.add("z transform", e._st_z_backward, (cur,), ("z_sticks",),
              out_meta={"z_sticks": EdgeMeta(ct, (S, Z))})
        g.add("expand", e._st_expand, ("z_sticks",), ("grid",),
              out_meta={"grid": EdgeMeta(ct, (Z, Y, Xf))})
        cur = "grid"
        if e.is_r2c:
            g.add("plane symmetry", e._st_plane_symmetry, (cur,), ("grid_h",),
                  out_meta={"grid_h": EdgeMeta(ct, (Z, Y, Xf))})
            cur = "grid_h"
        g.add("y transform", e._st_y_backward, (cur,), ("grid_y",),
              out_meta={"grid_y": EdgeMeta(ct, (Z, Y, Xf))})
        if e.is_r2c:
            g.add("x transform", e._st_x_backward, ("grid_y",), ("space",),
                  out_meta={"space": EdgeMeta(rt, (Z, Y, X))})
            g.set_outputs(["space"])
        else:
            g.add("x transform", e._st_x_backward, ("grid_y",), ("space_re", "space_im"),
                  out_meta={"space_re": EdgeMeta(rt, (Z, Y, X)),
                            "space_im": EdgeMeta(rt, (Z, Y, X))})
            g.set_outputs(["space_re", "space_im"])
        return g

    def forward(s):
        g = StageGraph("forward")
        g.add_input("space_re", dtype=rt, shape=(Z, Y, X))
        g.add_input("space_im", dtype=rt)  # None for R2C
        g.batch_inputs = ("space_re", "space_im")
        g.add("x transform", e._st_x_forward, ("space_re", "space_im"), ("grid",),
              out_meta={"grid": EdgeMeta(ct, (Z, Y, Xf))})
        g.add("y transform", e._st_y_forward, ("grid",), ("grid_y",),
              out_meta={"grid_y": EdgeMeta(ct, (Z, Y, Xf))})
        g.add("pack", e._st_pack, ("grid_y",), ("sticks",),
              out_meta={"sticks": EdgeMeta(ct, (S, Z))})
        g.add("z transform", e._st_z_forward, ("sticks",), ("z_sticks",),
              out_meta={"z_sticks": EdgeMeta(ct, (S, Z))})
        g.add("compression", lambda sticks: e._st_compress(sticks, s), ("z_sticks",),
              ("out_re", "out_im"),
              out_meta={"out_re": EdgeMeta(rt, (n,)), "out_im": EdgeMeta(rt, (n,))})
        g.set_outputs(["out_re", "out_im"])
        return g

    return {"backward": backward(), "forward": {s: forward(s) for s in SCALINGS}}


def _lower_local_mxu(e):
    p = e.params
    rt = e.real_dtype
    n = int(p.num_values)
    Z, R = p.dim_z, e._table_rows
    table = lambda *names: {k: EdgeMeta(rt, (R, Z)) for k in names}

    def backward():
        g = StageGraph("backward")
        g.add_input("values_re", dtype=rt, shape=(n,))
        g.add_input("values_im", dtype=rt, shape=(n,))
        g.batch_inputs = ("values_re", "values_im")
        g.add("compression", e._st_decompress, ("values_re", "values_im"), ("sre", "sim"),
              out_meta=table("sre", "sim"))
        cur = ("sre", "sim")
        if e.is_r2c and e._zero_stick_id is not None:
            g.add("stick symmetry", e._st_stick_symmetry, cur, ("shre", "shim"),
                  out_meta=table("shre", "shim"))
            cur = ("shre", "shim")
        g.add("z transform", e._st_z_backward, cur, ("zre", "zim"), out_meta=table("zre", "zim"))
        if e.y_plan == "per-slot":
            g.add("y transform sparse", e._st_y_sparse_backward, ("zre", "zim"), ("gre", "gim"))
        elif e.y_plan == "blocked":
            g.add("y transform blocked", e._st_y_blocked_backward, ("zre", "zim"), ("gre", "gim"))
        else:
            g.add("expand", e._expand, ("zre", "zim"), ("ere", "eim"))
            cur = ("ere", "eim")
            if e.is_r2c and e._x0_slot is not None:
                g.add("plane symmetry", e._st_plane_symmetry, cur, ("pre", "pim"))
                cur = ("pre", "pim")
            g.add("y transform", e._st_y_dense_backward, cur, ("gre", "gim"))
        if e.is_r2c:
            g.add("x transform", e._st_x_backward, ("gre", "gim"), ("space",))
            g.set_outputs(["space"])
        else:
            g.add("x transform", e._st_x_backward, ("gre", "gim"), ("space_re", "space_im"))
            g.set_outputs(["space_re", "space_im"])
        return g

    def forward(s):
        g = StageGraph("forward")
        g.add_input("space_re", dtype=rt)
        g.add_input("space_im", dtype=rt)  # None for R2C
        g.batch_inputs = ("space_re", "space_im")
        g.add("x transform", e._st_x_forward, ("space_re", "space_im"), ("gre", "gim"))
        if e.y_plan == "per-slot":
            g.add("y transform sparse", e._st_y_sparse_forward, ("gre", "gim"), ("sre", "sim"))
        elif e.y_plan == "blocked":
            g.add("y transform blocked", e._st_y_blocked_forward, ("gre", "gim"), ("sre", "sim"))
        else:
            g.add("y transform", e._st_y_dense_forward, ("gre", "gim"), ("yre", "yim"))
            g.add("pack", e._pack, ("yre", "yim"), ("sre", "sim"))
        g.add("z transform", lambda sre, sim: e._st_z_forward(sre, sim, s), ("sre", "sim"),
              ("zre", "zim"))
        g.add("compression", e._compress, ("zre", "zim"), ("out_re", "out_im"),
              out_meta={"out_re": EdgeMeta(rt, (n,)), "out_im": EdgeMeta(rt, (n,))})
        g.set_outputs(["out_re", "out_im"])
        return g

    return {"backward": backward(), "forward": {s: forward(s) for s in SCALINGS}}


def _lower_slab(e):
    """Both mesh engines (1-D slab): the per-shard pipeline of the JAX
    builders over the stacked shards. The exchange is one ``exchange`` node
    (a gather on the device) without a process group, else ``pack``,
    ``exchange`` (the collective) and ``unpack``, joined by one send and one
    receive buffer that hold every plane of a row. The MXU engine carries
    (re, im) pairs on every edge, the ``torch.fft`` engine complex tensors."""
    pair = hasattr(e, "y_plan")
    rt = e.real_dtype
    V, Pl = e._V, e.num_local
    edge = (lambda name: (name + "re", name + "im")) if pair else (lambda name: (name,))
    collective = e._exchange.collective

    def exchange(g, direction, src, dst):
        if not collective:
            g.add("exchange", getattr(e, f"_st_exchange_{direction}"), src, dst)
            return
        g.add("pack", getattr(e, f"_st_pack_{direction}"), src, ("send",))
        g.add("exchange", getattr(e, f"_st_exchange_rows_{direction}"), ("send",), ("recv",))
        g.add("unpack", getattr(e, f"_st_unpack_{direction}"), ("recv",), dst)

    def backward():
        g = StageGraph("backward")
        g.add_input("values_re", dtype=rt, shape=(Pl, V))
        g.add_input("values_im", dtype=rt, shape=(Pl, V))
        g.batch_inputs = ("values_re", "values_im")
        g.add("compression", e._st_decompress, ("values_re", "values_im"), edge("s"))
        cur = edge("s")
        if e.is_r2c and e._zero_stick_id is not None:
            g.add("stick symmetry", e._st_stick_symmetry, cur, edge("sh"))
            cur = edge("sh")
        cur_sticks = cur
        g.add("z transform", e._st_z_backward, cur, edge("z"))
        exchange(g, "backward", edge("z"), edge("g"))
        cur = edge("g")
        y_plan = e.y_plan if pair else "dense"
        if e.is_r2c and y_plan == "dense" and (not pair or e._x0_slot is not None):
            g.add("plane symmetry", e._st_plane_symmetry, cur, edge("p"))
            cur = edge("p")
        if not pair:
            g.add("y transform", e._st_y_backward, cur, edge("y"))
        elif y_plan == "per-slot":
            g.add("y transform sparse", e._st_y_sparse_backward, cur, edge("y"))
        elif y_plan == "blocked":
            g.add("y transform blocked", e._y_blocked_from_tables, cur, edge("y"))
        else:
            g.add("y transform", e._st_y_dense_backward, cur, edge("y"))
        outputs = ("space",) if e.is_r2c else ("space_re", "space_im")
        g.add("x transform", e._st_x_backward, edge("y"), outputs)
        g.set_outputs(list(outputs))
        if e._overlap > 1:
            _split_slab_backward(g, e, edge, cur_sticks, collective)
        return g

    def forward(s):
        g = StageGraph("forward")
        g.add_input("space_re", dtype=rt)
        g.add_input("space_im", dtype=rt)  # None for R2C
        g.batch_inputs = ("space_re", "space_im")
        g.add("x transform", e._st_x_forward, ("space_re", "space_im"), edge("x"))
        if not pair:
            g.add("y transform", e._st_y_forward, edge("x"), edge("y"))
        elif e.y_plan == "per-slot":
            g.add("y transform sparse", e._st_y_sparse_forward, edge("x"), edge("y"))
        elif e.y_plan == "blocked":
            g.add("y transform blocked", e._y_blocked_to_flat, edge("x"), edge("y"))
        else:
            g.add("y transform", e._st_y_dense_forward, edge("x"), edge("y"))
        exchange(g, "forward", edge("y"), edge("s"))
        z = (lambda sre, sim: e._st_z_forward(sre, sim, s)) if pair else e._st_z_forward
        g.add("z transform", z, edge("s"), edge("z"))
        compress = e._st_compress if pair else (lambda sticks: e._st_compress(sticks, s))
        g.add("compression", compress, edge("z"), ("out_re", "out_im"),
              out_meta={"out_re": EdgeMeta(rt, (Pl, V)), "out_im": EdgeMeta(rt, (Pl, V))})
        g.set_outputs(["out_re", "out_im"])
        if e._overlap > 1:
            _split_slab_forward(g, e, edge, s, collective)
        return g

    return {"backward": backward(), "forward": {s: forward(s) for s in SCALINGS}}


# ---- the OVERLAPPED exchange, as graph rewrites ---------------------------------
# The bulk graph is built first; the rewrite removes its z-stage-and-exchange
# segment and adds C chunk chains with the JAX package's node names
# (spfft_tpu/ir/lower.py _split_slab_backward, _split_slab_forward, the pencil
# tails): the ``exchange* overlapped@k`` nodes are the ones ir.compile runs on
# a side stream. A node that writes its chunk into a tensor shared by the
# chunks (a receive buffer, a stick table, the native space) takes the
# previous chunk's edge of it and passes it on; the first one makes it.


def _chained(fn, lead, n_prev):
    """``fn(lead, prev, *rest)`` as a node body whose first ``n_prev``
    inputs are the previous chunk's edges of the shared tensor (``prev``
    None for chunk 0, the tensor, or the tuple of its parts)."""
    def body(*args):
        prev = None if n_prev == 0 else (args[0] if n_prev == 1 else args[:n_prev])
        return fn(lead, prev, *args[n_prev:])
    return body


def _split_slab_backward(g, e, edge, sticks, collective):
    """[z transform -> (pack ->) exchange (-> unpack)] becomes C chains
    ``z transform@k -> (pack@k ->) exchange overlapped@k``, all reaching one
    receive buffer, and one ``unpack`` that reads it."""
    for name in ("z transform", "pack", "exchange", "unpack") if collective else (
            "z transform", "exchange"):
        g.remove(name)
    recv = ()
    for k, (c0, c1) in enumerate(e._chunks):
        sfx = f"@{k}"
        z = edge(f"z{sfx}")
        g.add("z transform", partial(e._st_z_backward_window, c0, c1), sticks, z,
              name=f"z transform{sfx}")
        if collective:
            g.add("pack", partial(e._st_pack_chunk_backward, k), z, (f"send{sfx}",),
                  name=f"pack{sfx}")
            g.add("exchange overlapped",
                  _chained(e._st_exchange_rows_chunk_backward, k, len(recv)),
                  (*recv, f"send{sfx}"), (f"recv{sfx}",), name=f"exchange overlapped{sfx}")
        else:
            g.add("exchange overlapped", _chained(e._st_exchange_chunk_backward, k, len(recv)),
                  (*recv, *z), (f"recv{sfx}",), name=f"exchange overlapped{sfx}")
        recv = (f"recv{sfx}",)
    g.add("unpack", e._st_unpack_chunks_backward, recv, edge("g"))
    g.nodes = g.toposort()


def _split_slab_forward(g, e, edge, scaling, collective):
    """[(pack ->) exchange (-> unpack) -> z transform] becomes C chains
    ``(pack@k ->) exchange overlapped@k (-> unpack@k) -> z transform@k`` off
    the y stage's result, each z stage writing its chunk's rows of the stick
    table that compression reads."""
    pair = hasattr(e, "y_plan")
    for name in ("pack", "exchange", "unpack", "z transform") if collective else (
            "exchange", "z transform"):
        g.remove(name)
    table = ()
    last = len(e._chunks) - 1
    for k, (c0, c1) in enumerate(e._chunks):
        sfx = f"@{k}"
        c = edge(f"c{sfx}")
        if collective:
            g.add("pack", partial(e._st_pack_chunk_forward, k), edge("y"), (f"send{sfx}",),
                  name=f"pack{sfx}")
            g.add("exchange overlapped", partial(e._st_exchange_rows_chunk_forward, k),
                  (f"send{sfx}",), (f"recv{sfx}",), name=f"exchange overlapped{sfx}")
            g.add("unpack", partial(e._st_unpack_chunk_forward, k), (f"recv{sfx}",), c,
                  name=f"unpack{sfx}")
        else:
            g.add("exchange overlapped", partial(e._st_exchange_chunk_forward, k), edge("y"), c,
                  name=f"exchange overlapped{sfx}")
        if pair:
            z = lambda c0, prev, *parts, c1=c1: e._st_z_forward_window(c0, c1, scaling, prev,
                                                                         *parts)
        else:
            z = lambda c0, prev, *parts, c1=c1: e._st_z_forward_window(c0, c1, prev, *parts)
        out = edge("z") if k == last else edge(f"t{sfx}")
        g.add("z transform", _chained(z, c0, len(table)), (*table, *c), out,
              name=f"z transform{sfx}")
        table = out
    g.nodes = g.toposort()


def _lower_pencil(e):
    """Both pencil engines: the JAX builders' per-shard pipeline over the
    stacked shards, two exchanges a direction. Each is one ``exchange A`` /
    ``exchange B`` node (a gather on the device) without a process group,
    else ``pack``, ``exchange`` (the collective) and ``unpack`` nodes of its
    tag. Pair edges on the matrix-product engine, complex ones on the
    ``torch.fft`` engine."""
    from functools import partial

    pair = hasattr(e, "y_plan")
    rt = e.real_dtype
    V, Pl = e._V, e.num_local
    edge = (lambda name: (name + "re", name + "im")) if pair else (lambda name: (name,))

    def exchange(g, tag, direction, src, dst):
        zwin = e._zwin(tag, direction)
        if not e.collective:
            g.add(f"exchange {tag}", partial(e._st_exchange, tag, direction, zwin), src, dst)
            return
        send, recv = f"send{tag}", f"recv{tag}"
        g.add(f"pack {tag}", partial(e._st_pack, tag, direction, zwin), src, (send,))
        g.add(f"exchange {tag}", partial(e._st_collective, tag, direction), (send,), (recv,))
        g.add(f"unpack {tag}", partial(e._st_unpack, tag, direction), (recv,), dst)

    def backward():
        g = StageGraph("backward")
        g.add_input("values_re", dtype=rt, shape=(Pl, V))
        g.add_input("values_im", dtype=rt, shape=(Pl, V))
        g.batch_inputs = ("values_re", "values_im")
        g.add("compression", e._st_decompress, ("values_re", "values_im"), edge("s"))
        cur = edge("s")
        if e.is_r2c and e._zero_stick_id is not None:
            g.add("stick symmetry", e._st_stick_symmetry, cur, edge("sh"))
            cur = edge("sh")
        g.add("z transform", e._st_z_backward, cur, edge("z"))
        exchange(g, "A", "backward", edge("z"), edge("g"))
        cur = edge("g")
        if e.is_r2c and e._x0_cols is not None:
            g.add("plane symmetry", e._st_plane_symmetry, cur, edge("p"))
            cur = edge("p")
        y = e._st_y_dense_backward if pair else e._st_y_backward
        g.add("y transform", y, cur, edge("y"))
        exchange(g, "B", "backward", edge("y"), edge("b"))
        outputs = ("space",) if e.is_r2c else ("space_re", "space_im")
        g.add("x transform", e._st_x_backward, edge("b"), outputs)
        g.set_outputs(list(outputs))
        if e._overlap > 1:
            _split_pencil_backward(g, e, edge, pair)
        return g

    def forward(s):
        g = StageGraph("forward")
        g.add_input("space_re", dtype=rt)
        g.add_input("space_im", dtype=rt)  # None for R2C
        g.batch_inputs = ("space_re", "space_im")
        g.add("x transform", e._st_x_forward, ("space_re", "space_im"), edge("x"))
        exchange(g, "B", "forward", edge("x"), edge("g"))
        y = e._st_y_dense_forward if pair else e._st_y_forward
        g.add("y transform", y, edge("g"), edge("y"))
        exchange(g, "A", "forward", edge("y"), edge("s"))
        z = (lambda sre, sim: e._st_z_forward(sre, sim, s)) if pair else e._st_z_forward
        g.add("z transform", z, edge("s"), edge("z"))
        compress = e._st_compress if pair else (lambda sticks: e._st_compress(sticks, s))
        g.add("compression", compress, edge("z"), ("out_re", "out_im"),
              out_meta={"out_re": EdgeMeta(rt, (Pl, V)), "out_im": EdgeMeta(rt, (Pl, V))})
        g.set_outputs(["out_re", "out_im"])
        if e._overlap > 1:
            _split_pencil_forward(g, e, edge, pair)
        return g

    return {"backward": backward(), "forward": {s: forward(s) for s in SCALINGS}}


def _pencil_exchange_names(tag, collective):
    return ([f"pack {tag}", f"exchange {tag}", f"unpack {tag}"] if collective
            else [f"exchange {tag}"])


def _split_pencil_backward(g, e, edge, pair):
    """The post-z pipeline becomes one chain per z window ``[c0, c1)``:
    ``(pack A@k ->) exchange A overlapped@k (-> unpack A@k) -> (plane
    symmetry@k ->) y transform@k -> (pack B@k ->) exchange B overlapped@k
    (-> unpack B@k) -> x transform@k``, each x stage writing its window of
    the native space."""
    collective = e.collective
    plane = e.is_r2c and e._x0_cols is not None
    for name in (_pencil_exchange_names("A", collective) + ["plane symmetry"] * plane
                 + ["y transform"] + _pencil_exchange_names("B", collective)
                 + ["x transform"]):
        g.remove(name)
    y = e._st_y_dense_backward if pair else e._st_y_backward
    space = ()
    last = len(e._chunks) - 1
    outputs = ("space",) if e.is_r2c else ("space_re", "space_im")
    for k, (c0, c1) in enumerate(e._chunks):
        sfx = f"@{k}"
        grid = edge(f"g{sfx}")
        if collective:
            g.add("pack A", partial(e._st_pack, "A", "backward", (c0, c1)), edge("z"),
                  (f"sendA{sfx}",), name=f"pack A{sfx}")
            g.add("exchange A overlapped",
                  partial(e._st_collective, "A", "backward", async_op=True), (f"sendA{sfx}",),
                  (f"recvA{sfx}",), name=f"exchange A overlapped{sfx}")
            g.add("unpack A", partial(e._st_unpack, "A", "backward"), (f"recvA{sfx}",),
                  grid, name=f"unpack A{sfx}")
        else:
            g.add("exchange A overlapped", partial(e._st_exchange, "A", "backward",
                                                   (c0, c1)), edge("z"), grid,
                  name=f"exchange A overlapped{sfx}")
        if plane:
            g.add("plane symmetry", e._st_plane_symmetry, grid, edge(f"p{sfx}"),
                  name=f"plane symmetry{sfx}")
            grid = edge(f"p{sfx}")
        g.add("y transform", y, grid, edge(f"y{sfx}"), name=f"y transform{sfx}")
        slab = edge(f"b{sfx}")
        if collective:
            g.add("pack B", partial(e._st_pack, "B", "backward", None), edge(f"y{sfx}"),
                  (f"sendB{sfx}",), name=f"pack B{sfx}")
            g.add("exchange B overlapped",
                  partial(e._st_collective, "B", "backward", async_op=True), (f"sendB{sfx}",),
                  (f"recvB{sfx}",), name=f"exchange B overlapped{sfx}")
            g.add("unpack B", partial(e._st_unpack, "B", "backward"), (f"recvB{sfx}",),
                  slab, name=f"unpack B{sfx}")
        else:
            g.add("exchange B overlapped", partial(e._st_exchange, "B", "backward", None),
                  edge(f"y{sfx}"), slab, name=f"exchange B overlapped{sfx}")
        out = outputs if k == last else tuple(f"{o}{sfx}" for o in outputs)
        x = lambda c0, prev, *parts, c1=c1: e._st_x_backward_window(c0, c1, prev, *parts)
        g.add("x transform", _chained(x, c0, len(space)), (*space, *slab), out,
              name=f"x transform{sfx}")
        space = out
    g.nodes = g.toposort()


def _split_pencil_forward(g, e, edge, pair):
    """The pipeline up to the z stage becomes one chain per z window:
    ``x transform@k -> (pack B@k ->) exchange B overlapped@k (-> unpack
    B@k) -> y transform@k -> (pack A@k ->) exchange A overlapped@k``, each
    window's rows reaching its columns of the stick table (over a group
    through one ``unpack A`` of every window's receive)."""
    collective = e.collective
    for name in (["x transform"] + _pencil_exchange_names("B", collective) + ["y transform"]
                 + _pencil_exchange_names("A", collective)):
        g.remove(name)
    y = e._st_y_dense_forward if pair else e._st_y_forward
    table, pending = (), []
    last = len(e._chunks) - 1
    for k, (c0, c1) in enumerate(e._chunks):
        sfx = f"@{k}"
        g.add("x transform", lambda sre, sim, w=(c0, c1): e._st_x_forward(sre, sim, zwin=w),
              ("space_re", "space_im"), edge(f"x{sfx}"), name=f"x transform{sfx}")
        grid = edge(f"g{sfx}")
        if collective:
            g.add("pack B", partial(e._st_pack, "B", "forward", None), edge(f"x{sfx}"),
                  (f"sendB{sfx}",), name=f"pack B{sfx}")
            g.add("exchange B overlapped",
                  partial(e._st_collective, "B", "forward", async_op=True), (f"sendB{sfx}",),
                  (f"recvB{sfx}",), name=f"exchange B overlapped{sfx}")
            g.add("unpack B", partial(e._st_unpack, "B", "forward"), (f"recvB{sfx}",),
                  grid, name=f"unpack B{sfx}")
        else:
            g.add("exchange B overlapped", partial(e._st_exchange, "B", "forward", None),
                  edge(f"x{sfx}"), grid, name=f"exchange B overlapped{sfx}")
        g.add("y transform", y, grid, edge(f"y{sfx}"), name=f"y transform{sfx}")
        if collective:
            g.add("pack A", partial(e._st_pack, "A", "forward", None), edge(f"y{sfx}"),
                  (f"sendA{sfx}",), name=f"pack A{sfx}")
            g.add("exchange A overlapped",
                  partial(e._st_collective, "A", "forward", async_op=True), (f"sendA{sfx}",),
                  (f"recvA{sfx}",), name=f"exchange A overlapped{sfx}")
            pending.append(f"recvA{sfx}")
        else:
            out = edge("s") if k == last else edge(f"t{sfx}")
            a = lambda c0, prev, *parts, c1=c1, done=k == last: e._st_exchange_window_into(
                c0, c1, done, prev, *parts)
            g.add("exchange A overlapped", _chained(a, c0, len(table)),
                  (*table, *edge(f"y{sfx}")), out, name=f"exchange A overlapped{sfx}")
            table = out
    if collective:
        g.add("unpack A", e._st_unpack_windows, tuple(pending), edge("s"))
    g.nodes = g.toposort()


_BUILDERS = {
    "LocalExecution": _lower_local_xla,
    "MxuLocalExecution": _lower_local_mxu,
    "DistributedExecution": _lower_slab,
    "MxuDistributedExecution": _lower_slab,
    "Pencil2Execution": _lower_pencil,
    "MxuPencil2Execution": _lower_pencil,
}
