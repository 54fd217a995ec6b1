"""Fused plans over a process group: gloo, spawned worlds of 2 and 4.

A plan over a process group runs fused, as the JAX package's ``shard_map``
program does (on the card each direction's CUDA graph holds NCCL's
kernels; on the CPU the fused program is one eager call of the composed
body, so gloo runs inside it). Spawned CPU processes hold, bitwise:

* each fused group plan against its staged twin and against the plan of
  the same shards in one process, on slab and pencil meshes, both engines,
  overlap 1 and 2 (to 1e-15 where a process holds one slab shard of the
  matrix-product engine: the CPU's matmul then runs at a quarter of the
  one-process plan's rows, which BLAS may block differently);
* ``backward_batch``/``forward_batch`` over the group against the looped
  pairs, and a split-phase multi-transform of two group plans against
  their single calls;
* the step invariant of a program's first call: a capture refused on one
  process, a plan built staged on one process and a batched program
  refused on one process leave every process on the same path with equal
  results; a first call whose eager run fails on one process raises
  ``MPIError`` there and in its peers, and nothing hangs.

And, to 1e-12, a pencil mesh over two-rank sub-groups of a 4-process world
({0, 1}/{2, 3} and {1, 3}/{0, 2}, overlap 1 and 2) against the
single-process 2-shard pencil plan. Each spawn gets a free port and its
own join timeout, so that a hang fails its test and not the suite.
"""
import datetime
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp

DIMS = (10, 8, 9)
TOL = 1e-12
JOIN_SECONDS = 150
GROUP_TIMEOUT = datetime.timedelta(seconds=30)  # a peer that left fails the collective
PLANS = [(layout, engine, overlap) for layout in ("slab", "pencil")
         for engine in ("xla", "mxu") for overlap in (1, 2)]
LAYOUTS = {"pairs": ([0, 1], [2, 3]), "strided": ([1, 3], [0, 2])}
FAILURES = ["capture", "build", "batch", "eager"]


def _problem(layout, shards, seed=5):
    rng = np.random.default_rng(seed)
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.85)
    if layout == "pencil":
        shape = (2, shards // 2) if shards >= 4 else (1, shards)
        per = tp.distribute_triplets(trip, shards, DIMS[1], layout=shape, dim_x=DIMS[0])
    else:
        shape, per = None, tp.distribute_triplets(trip, shards, DIMS[1])
    per = [np.asarray(t) for t in per]
    vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return shape, per, vals


def _mesh(layout, shape, shards, group, world):
    if layout == "pencil":
        return tp.make_fft_mesh2(*shape, device="cpu", group=group)
    return tp.make_fft_mesh(shards // world, device="cpu", group=group)


def _plan(mesh, per, engine, overlap, **kw):
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                   engine=engine, exchange_type=tp.ExchangeType.BUFFERED,
                                   overlap=overlap, **kw)


def _mine(mesh, vals):
    shards = set(mesh.local_shards)
    return [v if r in shards else None for r, v in enumerate(vals)]


def _blocks(t, space, shards):
    """Per-shard blocks of a backward's result (a one-process plan's global
    space is cut as the group's processes get theirs)."""
    if isinstance(space, list):
        return [None if s is None else s.numpy() for s in space]
    if t.engine.startswith("pencil2"):
        native = t.space_domain_data(tp.ProcessingUnit.GPU)
        return [t._exec.local_block(native, r).numpy() for r in range(shards)]
    return [space[t.local_z_offset(r):t.local_z_offset(r) + t.local_z_length(r)].numpy()
            for r in range(shards)]


def _pair(t, vals, shards):
    space = _blocks(t, t.backward(vals), shards)
    back = [None if b is None else b.numpy() for b in t.forward(scaling=tp.ScalingType.FULL)]
    return space, back


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a, b))


def _close(a, b, tol) -> bool:
    return all(x is None or np.abs(x - y).max() <= tol * max(np.abs(y).max(), 1e-300)
               for x, y in zip(a, b))


def _spawn(target, world, *args):
    """Run ``target(rank, world, port, *args, queue)`` in ``world`` spawned
    processes; their reports, by rank."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=target, args=(rank, world, port, *args, queue))
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
    return dict(sorted((rank, report) for rank, report in got))


def _join(world, rank, port, group_ranks=None):
    """Join the gloo world; ``group_ranks``: the sub-groups every process
    makes, in one order; returns this process's (sub-)group."""
    import torch.distributed as dist

    group = tp.init_distributed(f"localhost:{port}", world, rank, backend="gloo",
                                timeout=GROUP_TIMEOUT)
    if group_ranks is None:
        return group
    subs = [(members, dist.new_group(members)) for members in group_ranks]
    return next(g for members, g in subs if rank in members)


def _leave():
    tp.shutdown_distributed()


# ---- fused group plans against their staged twins and the one-process plan ----------


def _plans_worker(rank, world, port, queue):
    try:
        group = _join(world, rank, port)
        rows = []
        for layout, engine, overlap in PLANS:
            shape, per, vals = _problem(layout, 4)
            mesh = _mesh(layout, shape, 4, group, world)
            t = _plan(mesh, per, engine, overlap)
            twin = _plan(mesh, per, engine, overlap, fuse=False)
            got = _pair(t, _mine(mesh, vals), 4)
            staged = _pair(twin, _mine(mesh, vals), 4)
            again = _pair(t, _mine(mesh, vals), 4)  # a later call, past the first's step
            rows.append({"plan": (layout, engine, overlap), "fused": t.fused,
                         "twin_fused": twin.fused, "chunks": t.overlap_chunks,
                         "because": t.describe()["ir"].get("staged_because"),
                         "degradations": t.report()["degradations"],
                         "twin_equal": _same(got[0], staged[0]) and _same(got[1], staged[1]),
                         "again_equal": _same(got[0], again[0]) and _same(got[1], again[1]),
                         "space": got[0], "back": got[1]})
        queue.put((rank, {"rows": rows}))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, {"error": repr(e)}))
    finally:
        _leave()


@pytest.mark.parametrize("world", [2, 4])
def test_fused_group_plans_equal_staged_twins_and_the_one_process_plan(world):
    want = {}
    for layout, engine, overlap in PLANS:
        shape, per, vals = _problem(layout, 4)
        t = _plan(_mesh(layout, shape, 4, None, 1), per, engine, overlap)
        want[layout, engine, overlap] = _pair(t, vals, 4)
    got = _spawn(_plans_worker, world)
    assert all("error" not in r for r in got.values()), got
    for rank, report in got.items():
        mine = range(rank * 4 // world, (rank + 1) * 4 // world)
        for row in report["rows"]:
            plan = row["plan"]
            assert row["fused"] and not row["twin_fused"] and row["because"] is None, plan
            assert row["degradations"] == [], plan
            assert row["chunks"] == plan[2], plan
            assert row["twin_equal"] and row["again_equal"], plan
            want_space, want_back = want[plan]
            exact = not (plan[:2] == ("slab", "mxu") and world == 4)
            for r in range(4):
                if r not in mine:
                    assert row["space"][r] is None and row["back"][r] is None
                    continue
                got_r = [row["space"][r], row["back"][r]]
                want_r = [want_space[r], want_back[r]]
                assert _same(got_r, want_r) if exact else _close(got_r, want_r, 1e-15), (plan, r)


# ---- batched entries and the split-phase multi-transform over a group ----------------


def _batch_worker(rank, world, port, queue):
    from spfft_tpu_torch import ir

    try:
        group = _join(world, rank, port)
        rows = []
        plans = []
        for layout, engine in (("slab", "mxu"), ("pencil", "xla")):
            shape, per, vals = _problem(layout, 4)
            mesh = _mesh(layout, shape, 4, group, world)
            t = _plan(mesh, per, engine, 2)
            batch = [_mine(mesh, [v * (b + 1) + b for v in vals]) for b in range(3)]
            ir.dispatches.clear()
            spaces = t.backward_batch(batch)
            backs = t.forward_batch(spaces, tp.ScalingType.FULL)
            dispatched = dict(ir.dispatches)
            loop = [(t.backward(v), t.forward(scaling=tp.ScalingType.FULL)) for v in batch]
            same = all(
                _same([None if x is None else x.numpy() for x in s],
                      [None if x is None else x.numpy() for x in ls])
                and _same([None if x is None else x.numpy() for x in b],
                          [None if x is None else x.numpy() for x in lb])
                for s, b, (ls, lb) in zip(spaces, backs, loop))
            rows.append({"plan": (layout, engine), "equal": same,
                         "batched": dispatched.get(("batched", "backward"), 0),
                         "batched_forward": dispatched.get(("batched", "forward"), 0),
                         "card": t.report()["batch"]})
            plans.append((t, mesh, vals))
        # split-phase: both plans dispatched before either is waited on
        ts = [t for t, _, _ in plans]
        inputs = [_mine(mesh, vals) for _, mesh, vals in plans]
        singles = [(t.backward(v), t.forward(scaling=tp.ScalingType.FULL))
                   for t, v in zip(ts, inputs)]
        spaces = tp.multi_transform_backward(ts, inputs)
        backs = tp.multi_transform_forward(ts, None, tp.ScalingType.FULL)
        as_np = lambda xs: [None if x is None else x.numpy() for x in xs]
        multi = all(_same(as_np(s), as_np(ss)) and _same(as_np(b), as_np(sb))
                    for s, b, (ss, sb) in zip(spaces, backs, singles))
        queue.put((rank, {"rows": rows, "multi": multi}))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, {"error": repr(e)}))
    finally:
        _leave()


@pytest.mark.parametrize("world", [2, 4])
def test_batched_entries_and_multi_transform_over_a_group_equal_the_looped_pairs(world):
    got = _spawn(_batch_worker, world)
    assert all("error" not in r for r in got.values()), got
    for report in got.values():
        assert report["multi"]
        for row in report["rows"]:
            assert row["equal"], row["plan"]
            # one batched program a direction: the batch axis ran over the group
            assert row["batched"] == 1 and row["batched_forward"] == 1, row
            assert row["card"]["enabled"] and row["card"]["sizes"] == [3], row


# ---- the step invariant of a program's first call -----------------------------------


def _failure_worker(rank, world, port, failure, queue):
    from spfft_tpu_torch import faults
    from spfft_tpu_torch.ir import compile as ircompile

    try:
        group = _join(world, rank, port)
        shape, per, vals = _problem("slab", 4)
        mesh = _mesh("slab", shape, 4, group, world)
        engine = "xla" if failure == "eager" else "mxu"
        if failure == "capture" and rank == 1:
            def refused(self, args, warm=True):
                raise RuntimeError("operation not permitted when stream is capturing")

            ircompile._Program._capture = refused
        if failure == "eager" and rank == 1:
            def flaky(self, *values):
                raise RuntimeError("an engine failure before the exchange")

            tp.parallel.execution.DistributedExecution._st_decompress = flaky
        if failure == "build" and rank == 1:
            with faults.inject("ir" + ".compile=" + "rai" + "se"):
                t = _plan(mesh, per, engine, 2)
        else:
            t = _plan(mesh, per, engine, 2)
        built = t.describe()["ir"]["path"]
        report = {"built": built}
        if failure == "batch":
            batch = [_mine(mesh, [v * (b + 1) for v in vals]) for b in range(2)]
            if rank == 1:
                with faults.inject("ir" + ".batch=" + "rai" + "se"):
                    spaces = t.backward_batch(batch)
            else:
                spaces = t.backward_batch(batch)
            loop = [t.backward(v) for v in batch]
            report["equal"] = all(_same([None if x is None else x.numpy() for x in s],
                                        [None if x is None else x.numpy() for x in ls])
                                  for s, ls in zip(spaces, loop))
            report["batch"] = t.report()["batch"]
        else:
            try:
                got = [_pair(t, _mine(mesh, vals), 4) for _ in range(2)]
            except tp.GenericError as e:
                queue.put((rank, {**report, "raised": type(e).__name__}))
                return
            twin = _plan(mesh, per, engine, 2, fuse=False)
            staged = _pair(twin, _mine(mesh, vals), 4)
            report["equal"] = all(_same(g[0], staged[0]) and _same(g[1], staged[1])
                                  for g in got)
        report["path"] = t.describe()["ir"]["path"]
        report["events"] = [d["event"] for d in t.report()["degradations"]]
        queue.put((rank, report))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, {"error": repr(e)}))
    finally:
        _leave()


@pytest.mark.parametrize("failure", FAILURES)
def test_a_first_call_failure_on_one_process_keeps_the_group_in_step(failure):
    """One process's first call fails; every process ends on one path with
    equal results, or raises the same typed error, and none hangs."""
    got = _spawn(_failure_worker, 2, failure)
    assert all("error" not in r for r in got.values()), got
    if failure == "eager":
        # the process whose eager run failed cannot run it again in step;
        # its peer's collective fails when it leaves the group
        assert [r["raised"] for r in got.values()] == ["MPIError", "MPIError"], got
        return
    assert all(r["equal"] for r in got.values()), got
    if failure == "batch":
        # every process loops: the batch axis is off on both
        assert all(r["batch"]["failed"] and not r["batch"]["enabled"]
                   for r in got.values()), got
        assert all(r["events"] == ["batch_fuse_failed"] and r["path"] == "fused"
                   for r in got.values()), got
        return
    assert [r["built"] for r in got.values()] == (
        ["fused", "staged"] if failure == "build" else ["fused", "fused"])
    # every process took the rung at the first call, and runs staged
    assert all(r["path"] == "staged" and r["events"] == ["fuse_compile_failed"]
               for r in got.values()), got


# ---- a pencil mesh over sub-groups ----------------------------------------------------


def _sub_worker(rank, world, port, layout, queue):
    import torch.distributed as dist

    try:
        sub = _join(world, rank, port, LAYOUTS[layout])
        shape, per, vals = _problem("pencil", 2)
        mesh = tp.make_fft_mesh2(*shape, device="cpu", group=sub)
        rows = []
        for engine in ("xla", "mxu"):
            for overlap in (1, 2):
                t = _plan(mesh, per, engine, overlap)
                space, back = _pair(t, _mine(mesh, vals), 2)
                rows.append({"plan": (engine, overlap), "fused": t.fused,
                             "chunks": t.overlap_chunks, "space": space, "back": back})
        queue.put((rank, {"index": dist.get_rank(sub), "rows": rows}))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, {"error": repr(e)}))
    finally:
        _leave()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pencil_mesh_over_sub_groups_equals_the_two_shard_plan(layout):
    shape, per, vals = _problem("pencil", 2)
    want = {}
    for engine in ("xla", "mxu"):
        for overlap in (1, 2):
            t = _plan(tp.make_fft_mesh2(*shape, device="cpu"), per, engine, overlap)
            want[engine, overlap] = _pair(t, vals, 2)
    got = _spawn(_sub_worker, 4, layout)
    assert all("error" not in r for r in got.values()), got
    for report in got.values():
        me = report["index"]
        for row in report["rows"]:
            want_space, want_back = want[row["plan"]]
            assert row["fused"] and row["chunks"] == row["plan"][1], row["plan"]
            assert row["space"][1 - me] is None and row["back"][1 - me] is None
            assert _close([row["space"][me]], [want_space[me]], TOL), row["plan"]
            assert _close([row["back"][me]], [want_back[me]], TOL), row["plan"]


def test_shutdown_releases_the_graphs_that_hold_a_collective():
    """NCCL's communicator cannot be destroyed while a CUDA graph holds its
    kernels, so ``shutdown_distributed`` drops every captured program of a
    plan over a group before it destroys the group; such a program then
    raises ``MPIError``, and programs without a collective keep theirs."""
    from spfft_tpu_torch.ir import compile as ircompile

    def program(collective):
        prog = ircompile._Program(lambda x: x, lambda x: x, torch.device("cpu"), None, "ir[t]",
                                  lambda: None, collective=collective)
        prog._captured = ("graph", [], None)
        if collective:
            ircompile._COLLECTIVE_GRAPHS.add(prog)
        return prog

    grouped, local = program(True), program(False)
    tp.shutdown_distributed()  # no process group here: only the graphs go
    assert grouped._captured is None and local._captured is not None
    with pytest.raises(tp.MPIError, match="shut down"):
        grouped(torch.zeros(1))
    assert torch.equal(local(torch.ones(1)), torch.ones(1))
    assert ircompile.release_collective_graphs() == 0


def test_a_cuda_plan_over_a_gloo_group_is_refused_the_capture(monkeypatch):
    """Gloo runs its collectives on CUDA tensors through the host, so a CUDA
    plan over a gloo group stays staged and names the backend; NCCL's
    group, and every CPU plan, capture (checked here on the engine's
    attributes alone: this machine has no card)."""
    import torch.distributed as dist

    from spfft_tpu_torch.ir.compile import capture_refusal

    class Engine:
        collective = True
        device = torch.device("cuda", 0)
        mesh = tp.parallel.mesh.ShardMesh(torch.device("cuda", 0), 4, group=object())

    monkeypatch.setattr(dist, "get_backend", lambda group: "gloo")
    assert "gloo process group" in capture_refusal(Engine())
    monkeypatch.setattr(dist, "get_backend", lambda group: "nccl")
    assert capture_refusal(Engine()) is None
    Engine.device = torch.device("cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group: "gloo")
    assert capture_refusal(Engine()) is None
