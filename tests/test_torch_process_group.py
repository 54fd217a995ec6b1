"""The distributed transform across processes: torch.distributed on gloo.

Spawned CPU processes (world 4 x 1 shard, world 2 x 2 shards) each build the
plan over a process group and pass only their own shards' values; their
slabs and forward values must equal the single-process P = 4 plan's to
1e-13 (float64; both run the same stages, the exchange only moves data).
A plan over the group runs fused by default and takes ``fuse=True``; each
case builds it with ``fuse`` (the default, or staged) and its twin with the
other path (staged, or ``fuse=True``), and the two must agree bitwise.
Each spawn gets a free port and its own join timeout, so that a hang fails
its test and not the suite.
"""
import multiprocessing
import socket

import numpy as np
import pytest

import spfft_tpu_torch as tp
from utils import storage

DIMS = (10, 8, 9)
TOL = 1e-13
JOIN_SECONDS = 120
# (engine, exchange) per plan in every worker: the equal-split and the uneven
# all_to_all_single, and float32 and bfloat16 wires (on the torch.fft engine,
# whose results before the wire do not depend on how many shards a process
# stacks, so that the wire's rounding falls alike)
PLANS = [("xla", tp.ExchangeType.BUFFERED), ("mxu", tp.ExchangeType.UNBUFFERED),
         ("xla", tp.ExchangeType.COMPACT_BUFFERED_FLOAT), ("xla", tp.ExchangeType.BUFFERED_BF16)]


def _problem(r2c):
    rng = np.random.default_rng(7 + int(r2c))
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.85, hermitian_symmetry=r2c)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, 4, DIMS[1], weights=(2, 1, 1, 1))]
    if r2c:
        spec = np.fft.fftn(rng.standard_normal(DIMS[::-1]))
        vals = [spec[storage(t[:, 2], DIMS[2]), storage(t[:, 1], DIMS[1]), t[:, 0]] for t in per]
    else:
        vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals, (3, 2, 2, 2)


def _run(mesh, r2c, engine, exchange, per, vals, lz, fuse=None):
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *DIMS, per, mesh=mesh,
                                engine=engine, exchange_type=exchange, local_z_lengths=lz,
                                fuse=fuse)
    mine = set(mesh.local_shards)
    space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
    back = t.forward(scaling=tp.ScalingType.FULL)
    if not isinstance(space, list):  # one process: cut the global result into slabs
        space = [space[t.local_z_offset(r):t.local_z_offset(r) + t.local_z_length(r)]
                 for r in range(4)]
    return t, [None if s is None else s.numpy() for s in space], \
        [None if b is None else b.numpy() for b in back]


def _same(a, b) -> bool:
    return all((x is None and y is None) or np.array_equal(x, y) for x, y in zip(a, b))


def _worker(rank, world, port, r2c, fuse, queue):
    import torch.distributed as dist

    try:
        group = tp.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
        mesh = tp.make_fft_mesh(4 // world, device="cpu", group=group)
        per, vals, lz = _problem(r2c)
        results = []
        for engine, exchange in PLANS:
            t, space, back = _run(mesh, r2c, engine, exchange, per, vals, lz, fuse)
            # the twin on the other path: staged, or fused by the kwarg
            twin, tspace, tback = _run(mesh, r2c, engine, exchange, per, vals, lz,
                                       fuse is False)
            results.append((space, back, t.fused, t.describe()["ir"].get("staged_because"),
                            twin.fused, _same(space, tspace) and _same(back, tback)))
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


@pytest.mark.parametrize("fuse", [None, False], ids=["fused", "staged"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("world", [4, 2], ids=["world4x1", "world2x2"])
def test_process_group_equals_single_process(world, r2c, fuse):
    per, vals, lz = _problem(r2c)
    want = [_run(tp.make_fft_mesh(4, device="cpu"), r2c, e, x, per, vals, lz)[1:]
            for e, x in PLANS]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(rank, world, port, r2c, fuse, queue))
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
        for (space, back, fused, because, twin_fused, same), (want_space, want_back) in zip(
                results, want):
            # a group plan is fused unless asked not to be, and never says why not
            assert fused == (fuse is not False) and twin_fused == (not fused)
            assert because is None
            assert same  # bitwise its twin on the other path
            for r in range(4):
                if r not in mine:
                    assert space[r] is None and back[r] is None
                    continue
                scale = np.abs(want_space[r]).max()
                assert np.abs(space[r] - want_space[r]).max() <= TOL * scale
                assert np.abs(back[r] - want_back[r]).max() <= TOL * np.abs(want_back[r]).max()
