"""The OVERLAPPED exchange across processes, and meshes over sub-groups.

Four spawned CPU processes join one gloo world and split it into two
sub-groups of two ranks (``dist.new_group``): {0, 1} and {2, 3}, then
{1, 3} and {0, 2}. Each sub-group builds ``make_fft_mesh(1, group=sub)``,
a two-shard slab mesh, and runs both engines at overlap 1 and 2: each chunk's
``all_to_all_single`` issued with ``async_op=True`` and waited on by the
unpack that reads it. Every rank's slab and forward values must equal the
single-process two-shard plan's to 1e-12 (float64). The spawn has its own
join timeout, so that a hang fails this test and not the suite.
"""
import multiprocessing
import socket

import numpy as np
import pytest

import spfft_tpu_torch as tp

DIMS = (10, 8, 9)
TOL = 1e-12
JOIN_SECONDS = 150
LAYOUTS = {"pairs": ([0, 1], [2, 3]), "strided": ([1, 3], [0, 2])}
PLANS = [(engine, overlap) for engine in ("xla", "mxu") for overlap in (1, 2)]


def _problem():
    rng = np.random.default_rng(11)
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.85)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, 2, DIMS[1])]
    vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals


def _run(mesh, engine, overlap, per, vals):
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                engine=engine, exchange_type=tp.ExchangeType.BUFFERED,
                                overlap=overlap)
    mine = set(mesh.local_shards)
    space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
    back = t.forward(scaling=tp.ScalingType.FULL)
    if not isinstance(space, list):  # one process: cut the global result into slabs
        space = [space[t.local_z_offset(r):t.local_z_offset(r) + t.local_z_length(r)]
                 for r in range(2)]
    return t, [None if s is None else s.numpy() for s in space], \
        [None if b is None else b.numpy() for b in back]


def _worker(rank, port, layout, queue):
    import torch.distributed as dist

    try:
        tp.init_distributed(f"localhost:{port}", 4, rank, backend="gloo")
        # every rank makes every sub-group, in the same order
        groups = [(members, dist.new_group(members)) for members in LAYOUTS[layout]]
        members, sub = next((m, g) for m, g in groups if rank in m)
        mesh = tp.make_fft_mesh(1, device="cpu", group=sub)
        per, vals = _problem()
        results = []
        for engine, overlap in PLANS:
            t, space, back = _run(mesh, engine, overlap, per, vals)
            results.append((space, back, t.overlap_chunks, t.exchange_rounds(),
                            t._exec.exchange_transport()))
        queue.put((rank, members.index(rank), results, None))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, None, None, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sub_group_meshes_overlap_equal_the_two_shard_plan(layout):
    per, vals = _problem()
    want = [_run(tp.make_fft_mesh(2, device="cpu"), e, ov, per, vals)[1:] for e, ov in PLANS]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(rank, port, layout, queue)) for rank in range(4)]
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
    assert sorted(r for r, *_ in got) == [0, 1, 2, 3]
    for rank, shard, results, _ in got:
        for (space, back, chunks, rounds, transport), (want_space, want_back), (_, ov) in zip(
                results, want, PLANS):
            assert chunks == ov == rounds
            assert transport == ("chunked all_to_all" if ov > 1 else "padded all_to_all")
            assert space[1 - shard] is None and back[1 - shard] is None
            scale = np.abs(want_space[shard]).max()
            assert np.abs(space[shard] - want_space[shard]).max() <= TOL * scale
            assert np.abs(back[shard] - want_back[shard]).max() <= TOL * np.abs(
                want_back[shard]).max()
