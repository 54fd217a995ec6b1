"""The distributed transform's execution layer on the CPU: fused against
staged (bitwise: the same stage bodies in the same order), batches against
single calls, a multi-transform batch of local and distributed members,
clone, the Grid that hands out distributed plans, the OVERLAPPED exchange
(fused against staged too), and what raises."""
import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp
from spfft_tpu_torch import ir
from test_torch_distributed import port_plan, problem

DIMS = (24, 24, 8)
ENGINES = ["xla", "mxu"]


def _equal(a, b):
    a, b = ([x] if torch.is_tensor(x) else x for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_fused_equals_staged(r2c, engine):
    per, vals = problem(r2c, 4, 3, dims=DIMS, weights=(1, 2, 1, 1), radius=0.6)
    fused = port_plan(r2c, 4, per, np.float32, dims=DIMS, engine=engine)
    staged = port_plan(r2c, 4, per, np.float32, dims=DIMS, engine=engine, fuse=False)
    assert fused.fused and not staged.fused
    ir.dispatches.clear()
    a = fused.backward(vals)
    fa = fused.forward(scaling=tp.ScalingType.FULL)
    assert dict(ir.dispatches) == {("fused", "backward"): 1, ("fused", "forward"): 1}
    b = staged.backward(vals)
    fb = staged.forward(scaling=tp.ScalingType.FULL)
    assert torch.equal(a, b) and _equal(fa, fb)
    stages = staged.describe()["ir"]["stages"]
    assert "exchange" in stages["backward"] and "exchange" in stages["forward"]
    assert ir.dispatches["staged", "backward"] == len(stages["backward"])


@pytest.mark.parametrize("overlap", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_fused_equals_staged_slab_overlap(r2c, dtype, overlap):
    """The JAX package's ``test_parity_fused_vs_staged_slab`` (tests/test_ir.py):
    fused and staged bitwise at overlap 1 and 4, both engines, and the
    overlapped graphs carry the JAX node names and validate."""
    per, vals = problem(r2c, 4, 6, dims=DIMS, radius=0.6)
    for engine in ENGINES:
        plans = [port_plan(r2c, 4, per, dtype, tp.ExchangeType.BUFFERED, dims=DIMS,
                           engine=engine, overlap=overlap, fuse=fuse) for fuse in (True, False)]
        assert [t.fused for t in plans] == [True, False]
        assert 1 <= plans[0].overlap_chunks <= overlap
        outs = [(t.backward(vals), t.forward(scaling=tp.ScalingType.FULL)) for t in plans]
        assert torch.equal(outs[0][0], outs[1][0]) and _equal(outs[0][1], outs[1][1])
        graphs = plans[1]._exec._ir.graphs
        names = {n.name for n in graphs["backward"].nodes}
        if overlap > 1:
            C = plans[1].overlap_chunks
            assert {f"z transform@{k}" for k in range(C)} <= names
            assert {f"exchange overlapped@{k}" for k in range(C)} <= names
            assert "unpack" in names and "exchange" not in names
            fnames = {n.name for n in graphs["forward"][tp.ScalingType.NONE].nodes}
            assert {f"exchange overlapped@{k}" for k in range(C)} <= fnames
            assert {f"z transform@{k}" for k in range(C)} <= fnames
        for g in (graphs["backward"], *graphs["forward"].values()):
            g.validate()


@pytest.mark.parametrize("overlap", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_equals_staged_pencil_overlap(dtype, overlap):
    """The JAX package's ``test_parity_fused_vs_staged_pencil``: the pencil
    engines fused and staged bitwise at overlap 1 and 4."""
    trip = tp.create_spherical_cutoff_triplets(8, 9, 10, 0.8)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, 4, 9, layout=(2, 2), dim_x=8)]
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    for engine in ENGINES:
        plans = [tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, 8, 9, 10, per,
                                         mesh=tp.make_fft_mesh2(2, 2, device="cpu"),
                                         dtype=dtype, engine=engine, overlap=overlap,
                                         exchange_type=tp.ExchangeType.BUFFERED, fuse=fuse)
                 for fuse in (True, False)]
        assert plans[0].overlap_chunks == min(overlap, 5)
        assert plans[0].exchange_rounds() == 2 * plans[0].overlap_chunks
        outs = [(t.backward(vals), t.forward(scaling=tp.ScalingType.FULL)) for t in plans]
        assert torch.equal(outs[0][0], outs[1][0]) and _equal(outs[0][1], outs[1][1])
        if overlap > 1:
            stages = plans[1].describe()["ir"]["stages"]
            assert stages["backward"].count("exchange A overlapped") == plans[1].overlap_chunks
            assert stages["forward"].count("exchange B overlapped") == plans[1].overlap_chunks


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_batches_equal_single_calls(r2c, engine):
    per, vals = problem(r2c, 4, 5, dims=DIMS, radius=0.6)
    t = port_plan(r2c, 4, per, np.float64, dims=DIMS, engine=engine)
    batch = [[v * (b + 1) for v in vals] for b in range(3)]
    singles = [t.backward(v) for v in batch]
    fsingles = [t.forward(s, tp.ScalingType.FULL) for s in singles]
    ir.dispatches.clear()
    spaces = t.backward_batch(batch)
    freqs = t.forward_batch(spaces, tp.ScalingType.FULL)
    assert dict(ir.dispatches) == {("batched", "backward"): 1, ("batched", "forward"): 1}
    assert all(torch.equal(a, b) for a, b in zip(spaces, singles))
    assert all(_equal(a, b) for a, b in zip(freqs, fsingles))
    assert len(t.backward_batch(batch, count=2)) == 2
    staged = port_plan(r2c, 4, per, np.float64, dims=DIMS, engine=engine, fuse=False)
    assert staged.backward_batch(batch, fallback=False) is None
    looped = staged.backward_batch(batch)
    assert all(torch.equal(a, b) for a, b in zip(looped, singles))


def test_multi_transform_mixes_local_and_distributed():
    per, vals = problem(False, 4, 6, dims=DIMS, radius=0.6)
    dist = port_plan(False, 4, per, np.float64, dims=DIMS, engine="mxu")
    dist_r2c_per, dist_r2c_vals = problem(True, 2, 7, dims=DIMS, radius=0.6)
    dist_r2c = port_plan(True, 2, dist_r2c_per, np.float64, dims=DIMS)
    trip = np.concatenate(per)
    local = tp.Transform(tp.ProcessingUnit.HOST, 0, *DIMS, indices=trip, engine="mxu")
    flat = np.concatenate(vals)
    members, inputs = [dist, local, dist_r2c], [vals, flat, dist_r2c_vals]
    singles = [m.backward(v) for m, v in zip(members, inputs)]
    fsingles = [m.forward(scaling=tp.ScalingType.FULL) for m in members]
    spaces = tp.multi_transform_backward(members, inputs)
    freqs = tp.multi_transform_forward(members, None, tp.ScalingType.FULL)
    assert all(torch.equal(a, b) for a, b in zip(spaces, singles))
    assert all(_equal(a, b) for a, b in zip(freqs, fsingles))
    assert np.abs(spaces[0].numpy() - spaces[1].numpy()).max() <= 1e-11 * np.abs(
        spaces[1].numpy()).max()
    with pytest.raises(tp.InvalidParameterError):
        tp.multi_transform_backward([dist, dist], [vals, vals])


@pytest.mark.parametrize("fuse", [True, False])
def test_clone_keeps_the_plan(fuse):
    per, vals = problem(True, 4, 8, dims=DIMS, radius=0.6)
    t = port_plan(True, 4, per, np.float64, tp.ExchangeType.COMPACT_BUFFERED_FLOAT, dims=DIMS,
                  engine="mxu", fuse=fuse)
    c = t.clone()
    assert c is not t and c.fused == t.fused and c.engine == "mxu"
    assert c.exchange_type == t.exchange_type and c.describe()["ir"] == t.describe()["ir"]
    assert torch.equal(c.backward(vals), t.backward(vals))
    with pytest.raises(tp.InvalidParameterError):
        c.space_domain_data_local(4)


def test_grid_hands_out_distributed_plans():
    per, vals = problem(False, 4, 9, dims=DIMS, radius=0.6)
    mesh = tp.make_fft_mesh(4, device="cpu")
    grid = tp.Grid(*DIMS, 500, tp.ProcessingUnit.HOST, mesh=mesh,
                   exchange_type=tp.ExchangeType.UNBUFFERED, max_local_z_length=2)
    assert grid.num_shards == 4 and grid.mesh is mesh and grid.device == mesh.device
    t = grid.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, *DIMS, indices=per)
    assert isinstance(t, tp.DistributedTransform) and t.grid is grid
    assert t.exchange_type == tp.ExchangeType.UNBUFFERED
    ref = port_plan(False, 4, per, np.float64, tp.ExchangeType.UNBUFFERED, dims=DIMS)
    assert torch.equal(t.backward(vals), ref.backward(vals))
    with pytest.raises(tp.InvalidParameterError):  # slabs above max_local_z_length
        grid.create_transform(tp.ProcessingUnit.HOST, 0, *DIMS, indices=per,
                              local_z_length=(5, 1, 1, 1))
    with pytest.raises(tp.InvalidParameterError):
        tp.Grid(*DIMS, 10, tp.ProcessingUnit.HOST, mesh=mesh).create_transform(
            tp.ProcessingUnit.HOST, 0, *DIMS, indices=per)
    with pytest.raises(tp.InvalidParameterError):
        tp.Grid(*DIMS, 500).create_transform(tp.ProcessingUnit.HOST, 0, *DIMS,
                                             indices=np.concatenate(per), overlap=2)
    assert tp.Grid(*DIMS, 500).num_shards == 1


def test_what_is_not_ported_raises():
    per, vals = problem(False, 2, 1, dims=DIMS, radius=0.6)
    # overlap > 1 is the OVERLAPPED exchange, as in the JAX package: C chunk
    # collectives on a padded discipline (clamped to S_max), 1 on the
    # exact-count ones, the same numbers as the one-collective twin
    bulk = port_plan(False, 2, per, np.float64, tp.ExchangeType.BUFFERED, dims=DIMS)
    for overlap in (2, 4):
        t = port_plan(False, 2, per, np.float64, tp.ExchangeType.BUFFERED, dims=DIMS,
                      overlap=overlap)
        assert t.overlap_chunks == min(overlap, t.params.max_num_sticks) == t.exchange_rounds()
        assert torch.equal(t.backward(vals), bulk.backward(vals))
        for ragged in (tp.ExchangeType.UNBUFFERED, tp.ExchangeType.COMPACT_BUFFERED):
            assert port_plan(False, 2, per, np.float64, ragged, dims=DIMS,
                             overlap=overlap).overlap_chunks == 1
    # policy="tuned" is ported: on the CPU without trials it takes the model
    tuned = port_plan(False, 2, per, np.float64, dims=DIMS, policy="tuned")
    assert tuned._tuning["provenance"] == "model"
    with pytest.raises(tp.InvalidParameterError):
        tp.make_fft_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(tp.GPUNoDeviceError):
            tp.make_fft_mesh(4)


def test_init_distributed_validates_its_arguments():
    from spfft_tpu.parallel.mesh import validate_distributed_args as jax_validate
    from spfft_tpu_torch.parallel.mesh import validate_distributed_args

    bad = [("localhost", 2, 0), ("localhost:0", 2, 0), (":80", 2, 0), ("h:80", 0, 0),
           ("h:80", 2, 2), (None, None, 1), ("h:x", 2, 0)]
    for args in bad:
        with pytest.raises(tp.InvalidParameterError):
            validate_distributed_args(*args)
        with pytest.raises(Exception):
            jax_validate(*args)
    validate_distributed_args("localhost:29500", 2, 1)
    validate_distributed_args(None, None, None)


def test_an_exchange_that_cannot_be_built_raises_mpi_error(monkeypatch):
    """A process group that fails while the exchange is built fails the plan
    with MPIError, and no engine takes its place. A runtime failure of
    another layer takes the JAX package's ladder: the mxu engine falls back
    to torch.fft, and a failure with no rung below raises MPIError with the
    failure as its cause; a typed error keeps its own class."""
    import torch.distributed as dist

    from spfft_tpu_torch.parallel import execution, execution_mxu
    from spfft_tpu_torch.parallel.mesh import ShardMesh

    def refuse(group):
        raise RuntimeError("the process group refused the exchange")

    monkeypatch.setattr(dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(dist, "get_rank", refuse)
    mesh = ShardMesh(torch.device("cpu"), 2, group=object())
    per, _ = problem(False, 4, 1, dims=DIMS, radius=0.6)
    for engine in ENGINES:
        with pytest.raises(tp.MPIError, match="refused"):
            tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                    engine=engine)

    def broken(*args, **kwargs):
        raise RuntimeError("a kernel failed to build")

    monkeypatch.setattr(execution, "make_exchange", broken)
    monkeypatch.setattr(execution_mxu, "make_exchange", broken)
    for engine in ENGINES:
        with pytest.raises(tp.MPIError, match="kernel") as info:
            port_plan(False, 4, per, np.float64, dims=DIMS, engine=engine)
        assert isinstance(info.value.__cause__, RuntimeError)

    def typed(*args, **kwargs):
        raise tp.GPUSupportError("a kernel failed to build")

    monkeypatch.setattr(execution, "make_exchange", typed)
    monkeypatch.setattr(execution_mxu, "make_exchange", typed)
    for engine in ENGINES:
        with pytest.raises(tp.GPUSupportError, match="kernel"):
            port_plan(False, 4, per, np.float64, dims=DIMS, engine=engine)
