"""The port's 2-D pencil decomposition against the JAX package's.

The same numpy-seeded triplets and values go into
``spfft_tpu.DistributedTransform(..., mesh=spfft_tpu.make_fft_mesh2(p1, p2),
engine="xla")`` and the port's plan over ``make_fft_mesh2(p1, p2,
device="cpu")``. The JAX MXU pencil engine cannot be imported on this jax,
so the port's ``"mxu"`` pencil engine (``tests/test_torch_pencil2_mxu.py``)
is held against JAX's ``"xla"`` one too: they compute the same function.
Tolerance, max abs diff over max |JAX|: 1e-11 in float64, 1e-5 in float32;
a ``*_FLOAT`` wire 1e-6 and a ``*_BF16`` wire 3e-2 against JAX's same
discipline (the wire rounds values that the two packages scale differently:
JAX's inverse DFTs are normalised). DEFAULT resolves as the JAX package
resolves it where the one-shot exchange exists (``jax_pencil_engine``).
"""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.parallel import pencil2 as jax_pencil2
from spfft_tpu.parallel import ragged as jax_ragged
from spfft_tpu_torch.parallel import pencil2 as port_pencil2
from utils import storage

DIMS = (8, 9, 10)
TOL = {np.float64: 1e-11, np.float32: 1e-5}
WIRE_TOL = {tp.ExchangeType.BUFFERED_FLOAT: 1e-6, tp.ExchangeType.COMPACT_BUFFERED_FLOAT: 1e-6,
            tp.ExchangeType.BUFFERED_BF16: 3e-2, tp.ExchangeType.COMPACT_BUFFERED_BF16: 3e-2}
EXPLICIT = [e for e in tp.ExchangeType if e != tp.ExchangeType.DEFAULT]
JOIN_SECONDS = 120


def problem(r2c, P, seed, dims=DIMS, radius=0.85, layout=None, weights=None):
    """Per-shard triplets and values; R2C values are the spectrum of a real
    field, so that the result is real. ``layout``: the column-local split."""
    rng = np.random.default_rng(seed)
    trip = tp.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=r2c)
    kw = {"layout": layout, "dim_x": dims[0]} if layout else {"weights": weights}
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, P, dims[1], **kw)]
    if r2c:
        spec = np.fft.fftn(rng.standard_normal(dims[::-1]))
        vals = [spec[storage(t[:, 2], dims[2]), storage(t[:, 1], dims[1]), t[:, 0]] for t in per]
    else:
        vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals


def jax_pencil_engine(r2c, p1, p2, per, dtype, exchange, dims=DIMS, monkeypatch=None):
    """The JAX package's pencil engine for these shards, built with the
    one-shot exchange supported (its TPU answer), unrun: its geometry and
    its DEFAULT."""
    params = spfft_tpu.parameters.make_distributed_parameters(int(r2c), *dims, per)
    monkeypatch.setattr(jax_ragged, "_ragged_a2a_supported", lambda mesh: True)
    return jax_pencil2.Pencil2Execution(params, dtype, spfft_tpu.make_fft_mesh2(p1, p2),
                                        spfft_tpu.ExchangeType(int(exchange)))


def jax_plan(r2c, p1, p2, per, dtype, exchange, dims=DIMS):
    return spfft_tpu.DistributedTransform(
        spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, [t.copy() for t in per],
        mesh=spfft_tpu.make_fft_mesh2(p1, p2), dtype=dtype, engine="xla",
        exchange_type=spfft_tpu.ExchangeType(int(exchange)))


def port_plan(r2c, p1, p2, per, dtype=np.float64, exchange=tp.ExchangeType.DEFAULT,
              engine="xla", dims=DIMS, **kw):
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *dims, per,
                                   mesh=tp.make_fft_mesh2(p1, p2, device="cpu"), dtype=dtype,
                                   engine=engine, exchange_type=exchange, **kw)


def close(got, ref, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def check_against(ref, port, vals, tol, twice=True):
    """Backward (global space; twice: the zeroing check), forward at NONE on
    the given space and FULL on the retained one, per-shard values."""
    space_ref = ref.backward(vals)
    close(port.backward(vals), space_ref, tol)
    if twice:
        close(port.backward(vals), space_ref, tol)
    for s in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        want = ref.forward(space_ref, spfft_tpu.ScalingType(int(s)))
        got = port.forward(space_ref if s == tp.ScalingType.NONE else None, s)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)


def against_jax(r2c, p1, p2, per, vals, dtype, exchange, engine, monkeypatch, dims=DIMS):
    """The port's plan held against JAX's ``xla`` pencil plan of the
    discipline the port runs; DEFAULT must resolve as JAX's one-shot model."""
    port = port_plan(r2c, p1, p2, per, dtype, exchange, engine, dims)
    assert port.engine == ("pencil2-mxu" if engine == "mxu" else "pencil2")
    if exchange == tp.ExchangeType.DEFAULT:
        want = jax_pencil_engine(r2c, p1, p2, per, dtype, exchange, dims, monkeypatch)
        monkeypatch.undo()
        assert port.exchange_type == tp.ExchangeType(int(want.exchange_type))
    else:
        assert port.exchange_type == exchange
    ref = jax_plan(r2c, p1, p2, per, dtype, port.exchange_type, dims)
    check_against(ref, port, vals, WIRE_TOL.get(exchange, TOL[dtype]))
    return port, ref


@pytest.mark.parametrize("p1,p2", [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)])
def test_mesh_shapes_c2c_match_jax(p1, p2, monkeypatch):
    per, vals = problem(False, p1 * p2, 41 + p1)
    against_jax(False, p1, p2, per, vals, np.float64, tp.ExchangeType.DEFAULT, "xla",
                monkeypatch)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("p1,p2", [(2, 2), (4, 2)])
def test_r2c_matches_jax(p1, p2, dtype, monkeypatch):
    per, vals = problem(True, p1 * p2, 7 + p1)
    against_jax(True, p1, p2, per, vals, dtype, tp.ExchangeType.DEFAULT, "xla", monkeypatch)


def test_beyond_slab_limit():
    """P = 8 > dim_z = 2: every shard holds a z x y block of space."""
    dims = (8, 8, 2)
    per, vals = problem(False, 8, 43, dims=dims, radius=0.7)
    port = port_plan(False, 4, 2, per, exchange=tp.ExchangeType.BUFFERED, dims=dims)
    ref = jax_plan(False, 4, 2, per, np.float64, tp.ExchangeType.BUFFERED, dims)
    check_against(ref, port, vals, TOL[np.float64])
    assert all(port.local_slice_size(r) == 1 * 2 * 8 for r in range(8))


@pytest.mark.parametrize("exchange", [tp.ExchangeType.BUFFERED, tp.ExchangeType.UNBUFFERED],
                         ids=lambda e: e.name)
def test_imbalanced_sticks(exchange):
    per, vals = problem(False, 4, 13, weights=(5, 1, 1, 1))
    port = port_plan(False, 2, 2, per, exchange=exchange)
    check_against(jax_plan(False, 2, 2, per, np.float64, exchange), port, vals, TOL[np.float64])


def test_r2c_partial_spectrum():
    """R2C values on part of the non-redundant half only (no hermitian
    completion left to do on most sticks)."""
    rng = np.random.default_rng(9)
    trip = np.asarray(tp.create_spherical_cutoff_triplets(*DIMS, 0.85, hermitian_symmetry=True))
    trip = trip[rng.random(len(trip)) < 0.6]
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, 4, DIMS[1])]
    spec = np.fft.fftn(rng.standard_normal(DIMS[::-1]))
    vals = [spec[storage(t[:, 2], DIMS[2]), storage(t[:, 1], DIMS[1]), t[:, 0]] for t in per]
    port = port_plan(True, 2, 2, per, exchange=tp.ExchangeType.BUFFERED)
    check_against(jax_plan(True, 2, 2, per, np.float64, tp.ExchangeType.BUFFERED), port, vals,
                  TOL[np.float64])


@pytest.mark.parametrize("exchange", EXPLICIT, ids=lambda e: e.name)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_every_discipline_matches_jax(r2c, exchange, monkeypatch):
    """Each explicit discipline, both wire casts, on a column-local split
    (the exact counts then ship less) with ragged z- and y-slabs."""
    per, vals = problem(r2c, 6, 3 + int(exchange), layout=(3, 2))
    port, ref = against_jax(r2c, 3, 2, per, vals, np.float64, exchange, "xla", monkeypatch)
    assert port.exchange_rounds() == 2
    # the wire bytes: the JAX package's accounting (one-shot UNBUFFERED; the
    # COMPACT chain's windows, whose columns equal the port's rows' width
    # where dim_z splits evenly over P2, as here)
    jax_engine = jax_pencil_engine(r2c, 3, 2, per, np.float64, exchange,
                                   monkeypatch=monkeypatch)
    assert DIMS[2] % 2 == 0
    assert port.exchange_wire_bytes() == jax_engine.exchange_wire_bytes()


def test_default_resolution_and_geometry_match_jax(monkeypatch):
    """Ax, SG, the x-group map, DEFAULT's choice, the x-group strategy and
    both policy tables equal the JAX engine's with the one-shot exchange."""
    cases = [(False, 2, 2, None, None), (True, 4, 2, None, None), (False, 2, 3, (2, 3), None),
             (False, 2, 2, None, (4, 1, 1, 1)), (True, 3, 2, (3, 2), None)]
    for r2c, p1, p2, layout, weights in cases:
        per, _ = problem(r2c, p1 * p2, 17, layout=layout, weights=weights)
        for exchange in (tp.ExchangeType.DEFAULT, *EXPLICIT):
            for dtype in (np.float64, np.float32):
                ref = jax_pencil_engine(r2c, p1, p2, per, dtype, exchange,
                                        monkeypatch=monkeypatch)
                params = tp.make_distributed_parameters(int(r2c), *DIMS, per)
                g = port_pencil2.PencilGeometry(params, p1, p2, exchange, dtype)
                what = (r2c, p1, p2, layout, weights, exchange.name)
                assert g.exchange_type == tp.ExchangeType(int(ref.exchange_type)), what
                assert (g.Ax, g.SG, g.Lz, g.Ly) == (ref._Ax, ref._SG, ref._Lz, ref._Ly), what
                assert g.aligned == ref._aligned_x_groups, what
                np.testing.assert_array_equal(g.xcol, ref._xcol)
                np.testing.assert_array_equal(g.rows, ref._rows)
                np.testing.assert_array_equal(g.cols, ref._cols)
                assert (g.have_x0, g.x0_group, g.x0_slot) == (
                    ref._have_x0, ref._x0_group, ref._x0_slot)
                if exchange == tp.ExchangeType.DEFAULT:
                    assert g.policy_tables == ref._policy_tables, what
                else:
                    assert g.policy_tables is None


@pytest.mark.parametrize("aligned", [False, True])
def test_x_group_assignment_matches_jax(aligned):
    for p1, p2, seed in ((2, 2, 1), (4, 2, 2), (3, 3, 3)):
        per, _ = problem(False, p1 * p2, seed, layout=(p1, p2) if aligned else None)
        params = tp.make_distributed_parameters(0, *DIMS, per)
        sx = params.stick_x_all.astype(np.int64)
        valid = sx < params.dim_x_freq
        ux = np.unique(sx[valid])
        got = port_pencil2.x_group_assignment(ux, sx, valid, p1, p2, aligned)
        want = jax_pencil2._x_group_assignment(ux, sx, valid, p1, p2, aligned)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims,layout,r2c", [
    ((8, 9, 10), (2, 2), False), ((16, 16, 16), (4, 2), True), ((12, 8, 9), (3, 1), False),
    ((9, 10, 8), (1, 4), True)])
def test_distribute_triplets_layout_matches_jax(dims, layout, r2c):
    trip = np.asarray(tp.create_spherical_cutoff_triplets(*dims, 0.8, hermitian_symmetry=r2c))
    P = layout[0] * layout[1]
    got = tp.distribute_triplets(trip, P, dims[1], layout=layout, dim_x=dims[0])
    want = spfft_tpu.parameters.distribute_triplets(trip, P, dims[1], layout=layout,
                                                    dim_x=dims[0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for bad in ({"layout": (P, 2), "dim_x": dims[0]}, {"layout": layout},
                {"layout": layout, "dim_x": dims[0], "weights": np.ones(P)}):
        with pytest.raises(tp.InvalidParameterError):
            tp.distribute_triplets(trip, P, dims[1], **bad)


def test_global_triplets_split_column_by_column():
    """Plain global triplets on a pencil mesh go through the layout split,
    as the JAX package's plan splits them."""
    trip = np.asarray(tp.create_spherical_cutoff_triplets(*DIMS, 0.85))
    rng = np.random.default_rng(4)
    vals = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    port = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, trip,
                                   mesh=tp.make_fft_mesh2(2, 2, device="cpu"), engine="xla")
    ref = spfft_tpu.DistributedTransform(spfft_tpu.ProcessingUnit.HOST, 0, *DIMS, trip,
                                         mesh=spfft_tpu.make_fft_mesh2(2, 2), engine="xla",
                                         exchange_type=spfft_tpu.ExchangeType(
                                             int(port.exchange_type)))
    for r in range(4):
        assert port.num_local_elements(r) == ref.num_local_elements(r)
    per = tp.distribute_triplets(trip, 4, DIMS[1], layout=(2, 2), dim_x=DIMS[0])
    key = lambda t: (t[:, 0] * 64 + t[:, 1]) * 64 + t[:, 2]
    pos = {k: i for i, k in enumerate(key(trip))}
    shard_vals = [vals[[pos[k] for k in key(t)]] for t in per]
    check_against(ref, port, shard_vals, TOL[np.float64], twice=False)


def test_explicit_space_and_local_blocks():
    """An explicit-space forward, and per-shard blocks and accessors equal
    to JAX's: ``space_domain_data_local``, ``local_y_length``/``_offset``."""
    per, vals = problem(False, 6, 21)
    port = port_plan(False, 3, 2, per, exchange=tp.ExchangeType.BUFFERED)
    ref = jax_plan(False, 3, 2, per, np.float64, tp.ExchangeType.BUFFERED)
    space = np.random.default_rng(1).standard_normal(DIMS[::-1]) + 0j
    for g, w in zip(port.forward(space), ref.forward(space)):
        close(g, w, TOL[np.float64])
    ref.backward(vals)
    got = port.backward(vals)
    for r in range(6):
        for acc in ("local_z_length", "local_z_offset", "local_y_length", "local_y_offset",
                    "local_slice_size", "num_local_elements"):
            assert getattr(port, acc)(r) == getattr(ref, acc)(r), (acc, r)
        close(port.space_domain_data_local(r), ref.space_domain_data_local(r), TOL[np.float64])
    np.testing.assert_array_equal(port.space_domain_data(), got.numpy())
    blocks = port.space_domain_data(tp.ProcessingUnit.GPU)
    assert blocks[0].shape == (6, port._exec._Ly, DIMS[0], port._exec._Lz)
    assert port.space_domain_layout == "yxz"
    # per-shard blocks in, the same values out
    per_block = [port.space_domain_data_local(r) for r in range(6)]
    for g, w in zip(port.forward(per_block), port.forward(got)):
        close(g, w, 1e-15)


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("exchange", [tp.ExchangeType.BUFFERED, tp.ExchangeType.UNBUFFERED],
                         ids=lambda e: e.name)
def test_fused_equals_staged(exchange, r2c):
    per, vals = problem(r2c, 4, 5)
    fused = port_plan(r2c, 2, 2, per, exchange=exchange)
    staged = port_plan(r2c, 2, 2, per, exchange=exchange, fuse=False)
    assert fused.fused and not staged.fused
    assert torch.equal(fused.backward(vals), staged.backward(vals))
    for a, b in zip(fused.forward(scaling=tp.ScalingType.FULL),
                    staged.forward(scaling=tp.ScalingType.FULL)):
        assert torch.equal(a, b)


def test_batch_and_multi_transform():
    per, vals = problem(False, 4, 31)
    t = port_plan(False, 2, 2, per, exchange=tp.ExchangeType.BUFFERED)
    other = [v * (0.5 - 0.25j) for v in vals]
    singles = [t.backward(v).clone() for v in (vals, other)]
    for a, b in zip(t.backward_batch([vals, other]), singles):
        assert torch.equal(a, b)
    spaces = tp.multi_transform_backward([t, port_plan(True, 2, 2, problem(True, 4, 31)[0])],
                                         [vals, problem(True, 4, 31)[1]])
    assert torch.equal(spaces[0], singles[0])


def test_mesh_errors():
    with pytest.raises(tp.InvalidParameterError):
        tp.make_fft_mesh2(0, 2, device="cpu")
    with pytest.raises(tp.InvalidParameterError):
        tp.make_fft_mesh2(2, -1, device="cpu")
    per, _ = problem(False, 4, 1)
    with pytest.raises(tp.MPIParameterMismatchError):
        tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per,
                                mesh=tp.make_fft_mesh2(3, 2, device="cpu"))
    with pytest.raises(tp.MPIParameterMismatchError):
        tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per[:2] + per[2:],
                                mesh=tp.make_fft_mesh2(1, 2, device="cpu"))
    mesh = tp.make_fft_mesh2(2, 2, device="cpu")
    assert tp.is_pencil2_mesh(mesh) and not tp.is_pencil2_mesh(tp.make_fft_mesh(4, device="cpu"))
    assert mesh.shape == (2, 2) and mesh.num_shards == 4
    # overlap > 1 is the OVERLAPPED exchange: chunks of the local z window
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh, overlap=2,
                                exchange_type=tp.ExchangeType.BUFFERED)
    assert t.overlap_chunks == min(2, t._exec._Lz) and t.exchange_rounds() == 2 * t.overlap_chunks
    with pytest.raises(tp.InvalidParameterError):
        tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh, overlap=0)
    if not torch.cuda.is_available():
        with pytest.raises(tp.GPUNoDeviceError):
            tp.make_fft_mesh2(2, 2)


def test_plan_card_perf_report_and_accounting(monkeypatch):
    """The card's pencil decomposition and policy table, JAX's validator on
    it, the perf report's pencil rows, and the stage accounting equal to
    JAX's (BUFFERED: both ship the padded blocks)."""
    from spfft_tpu.obs import plancard as jax_plancard

    per, _ = problem(True, 4, 8)
    t = port_plan(True, 2, 2, per)
    card = t.report()
    assert card["decomposition"] == "pencil2" and card["mesh"] == {"fft": 2, "fft2": 2}
    assert card["engine"] == "pencil2"
    assert jax_plancard.validate_plan_card(card) == []
    policy = card["exchange_policy"]
    ref = jax_pencil_engine(True, 2, 2, per, np.float64, tp.ExchangeType.DEFAULT,
                            monkeypatch=monkeypatch)
    table = ref._policy_tables[True]
    assert [a["discipline"] for a in policy["alternatives"]] == [
        a["discipline"] for a in table["alternatives"]]
    assert [dict(a, chosen=None) for a in policy["alternatives"]] == [
        dict(a, chosen=None) for a in table["alternatives"]]
    assert sum(a["chosen"] for a in policy["alternatives"]) == 1
    assert policy["chosen"] == t.exchange_type.name
    perf = tp.obs.perf.perf_report(t, 1e-3)
    assert perf["decomposition"] == "pencil2" and tp.obs.perf.validate_perf_report(perf) == []
    assert {"exchange A", "exchange B"} <= {r["stage"] for r in perf["stages"]}
    buffered = port_plan(True, 2, 2, per, exchange=tp.ExchangeType.BUFFERED)
    jax_buffered = jax_pencil_engine(True, 2, 2, per, np.float64, tp.ExchangeType.BUFFERED,
                                     monkeypatch=monkeypatch)
    assert buffered._exec.stage_accounting() == jax_buffered.stage_accounting()


# ---- over a gloo process group ---------------------------------------------------

PG_PLANS = [("xla", tp.ExchangeType.BUFFERED), ("mxu", tp.ExchangeType.UNBUFFERED),
            ("xla", tp.ExchangeType.COMPACT_BUFFERED_FLOAT), ("mxu", tp.ExchangeType.DEFAULT)]


def _pg_problem(r2c):
    return problem(r2c, 4, 61 + int(r2c), weights=(2, 1, 1, 1))


def _pg_run(mesh, r2c, engine, exchange, per, vals):
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *DIMS, per, mesh=mesh,
                                engine=engine, exchange_type=exchange)
    mine = set(mesh.local_shards)
    space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
    back = t.forward(scaling=tp.ScalingType.FULL)
    if not isinstance(space, list):  # one process: cut the global result into blocks
        space = [t._exec.local_block(t.space_domain_data(tp.ProcessingUnit.GPU), r)
                 for r in range(4)]
    return t, [None if s is None else s.numpy() for s in space], \
        [None if b is None else b.numpy() for b in back]


def _pg_worker(rank, world, port, r2c, queue):
    import torch.distributed as dist

    try:
        group = tp.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
        mesh = tp.make_fft_mesh2(2, 2, device="cpu", group=group)
        per, vals = _pg_problem(r2c)
        results = []
        for engine, exchange in PG_PLANS:
            t, space, back = _pg_run(mesh, r2c, engine, exchange, per, vals)
            stages = t.describe()["ir"]["stages"]["backward"]
            results.append((space, back, t.fused, stages, t.exchange_wire_bytes()))
        queue.put((rank, results, None))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, None, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("world", [4, 2], ids=["world4x1", "world2x2"])
def test_process_group_equals_stacked(world, r2c):
    """Spawned gloo processes on a 2 x 2 mesh: their blocks and values
    equal the stacked plan's to 1e-13, fused, with JAX's stage names."""
    per, vals = _pg_problem(r2c)
    want = [_pg_run(tp.make_fft_mesh2(2, 2, device="cpu"), r2c, e, x, per, vals)
            for e, x in PG_PLANS]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_pg_worker, args=(rank, world, port, r2c, queue))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        got = [queue.get(timeout=JOIN_SECONDS) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=JOIN_SECONDS)
            if p.is_alive():
                p.kill()
    assert all(err is None for *_, err in got), [err for *_, err in got]
    per_proc = 4 // world
    for rank, results, _ in got:
        mine = range(rank * per_proc, (rank + 1) * per_proc)
        for (space, back, fused, stages, wire), (t, want_space, want_back) in zip(results, want):
            assert fused and wire == t.exchange_wire_bytes()
            assert [s for s in stages if s.endswith(("A", "B"))] == [
                "pack A", "exchange A", "unpack A", "pack B", "exchange B", "unpack B"]
            for r in range(4):
                if r not in mine:
                    assert space[r] is None and back[r] is None
                    continue
                assert np.abs(space[r] - want_space[r]).max() <= 1e-13 * np.abs(
                    want_space[r]).max()
                assert np.abs(back[r] - want_back[r]).max() <= 1e-13 * np.abs(
                    want_back[r]).max()
