"""Verification across processes: a mesh over a 2-process gloo group verifies.

Spawned CPU processes build a slab mesh (2 processes x 1 shard) and a 2x2
pencil mesh (2 shards a process) over a gloo group, with ``verify=True``,
``"strict"`` and ``SPFFT_TPU_VERIFY=1``, C2C and R2C, float64. Each process
passes only its own shards' values and space blocks. Against them:

* the unverified plan's results, bitwise;
* the verdict rows (check, verdict) of the single-process plan with every
  shard stacked, and of the JAX package's plan on the same triplets over its
  CPU mesh; the scalars each row compares (measured, expected) within 1e-12
  of the call's largest;
* the reference rung (``engine.execute`` armed to raise in both processes):
  the single-process plan's recovery, bitwise;
* a forward that every process gives the whole global space: the stacked
  plan's verdict rows, and its reference rung's result bitwise.

A second spawn arms ``verify.check`` in one process only: every process
must raise :class:`VerificationError` (no hang: each spawn has its own join
timeout), and both breakers must trip and heal in step. In it, too, a
non-finite input on one process under guard raises the same typed error on
both, and an engine breaker that a plan of one process alone opens does not
reach the group plan's breaker.
"""
import multiprocessing
import os
import socket

import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.verify import checks as jax_checks
from spfft_tpu_torch.verify import checks as port_checks
from utils import storage

DIMS = (10, 8, 9)
SCALAR_TOL = 1e-12
JOIN_SECONDS = 180
MESHES = ("slab2x1", "pencil2x2")
MODES = {"verify": {"verify": True}, "strict": {"verify": "strict"}, "env": {}}
CASES = [(m, r2c, mode) for m in MESHES for r2c in (False, True) for mode in MODES]


def _layout(mesh_name):
    return (2, None) if mesh_name == "slab2x1" else (4, (2, 2))


def _problem(mesh_name, r2c):
    P, layout = _layout(mesh_name)
    rng = np.random.default_rng(11 + int(r2c))
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.85, hermitian_symmetry=r2c)
    per = [np.asarray(t) for t in tp.distribute_triplets(
        trip, P, DIMS[1], **({} if layout is None else {"layout": layout, "dim_x": DIMS[0]}))]
    if r2c:
        spec = np.fft.fftn(rng.standard_normal(DIMS[::-1]))
        vals = [spec[storage(t[:, 2], DIMS[2]), storage(t[:, 1], DIMS[1]), t[:, 0]] for t in per]
    else:
        vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals


def _port_mesh(mesh_name, group=None):
    P, layout = _layout(mesh_name)
    world = 1 if group is None else 2
    if layout is None:
        return tp.make_fft_mesh(P // world, device="cpu", group=group)
    return tp.make_fft_mesh2(*layout, device="cpu", group=group)


def _recorded(module, rows):
    """Wrap ``module.run_checks`` so that each call's rows land in ``rows``."""
    inner = module.run_checks

    def run_checks(**kw):
        got = inner(**kw)
        rows.append([(kw["direction"], r["check"], r["verdict"], r["measured"], r["expected"])
                     for r in got])
        return got

    return inner, run_checks


def _drive(pkg, mesh, r2c, per, vals, mine, **kw):
    """backward of this process's values, forward of the retained space at
    FULL and of the backward's result at NONE: the results as numpy."""
    t = pkg.DistributedTransform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS,
                                 [p.copy() for p in per], mesh=mesh, dtype=np.float64,
                                 engine="xla", **kw)
    space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
    full = t.forward(scaling=pkg.ScalingType.FULL)
    none = t.forward(space, pkg.ScalingType.NONE)
    arr = lambda a: None if a is None else np.asarray(a)
    return ([arr(s) for s in space] if isinstance(space, list) else arr(space),
            [arr(v) for v in full], [arr(v) for v in none])


def _port_case(mesh, r2c, mode, per, vals):
    """(verified results, unverified results, rows) of one case on ``mesh``."""
    mine = set(mesh.local_shards)
    rows = []
    inner, wrapped = _recorded(port_checks, rows)
    port_checks.run_checks = wrapped
    try:
        if mode == "env":
            os.environ["SPFFT_TPU_VERIFY"] = "1"
        got = _drive(tp, mesh, r2c, per, vals, mine, **MODES[mode])
    finally:
        os.environ.pop("SPFFT_TPU_VERIFY", None)
        port_checks.run_checks = inner
    plain = _drive(tp, mesh, r2c, per, vals, mine, verify=False)
    return got, plain, rows


def _reference_case(mesh, r2c, per, vals):
    """Results of a verified plan whose engine raises at every attempt: the
    reference rung's, and the plan card's rungs."""
    from spfft_tpu_torch import faults
    from spfft_tpu_torch.verify import breaker

    breaker.reset()  # the failed episodes of earlier cases would trip it
    mine = set(mesh.local_shards)
    with faults.inject("engine.execute=raise"):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *DIMS,
                                    [p.copy() for p in per], mesh=mesh, dtype=np.float64,
                                    engine="xla", verify=True)
        space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
        back = t.forward(scaling=tp.ScalingType.FULL)
    arr = lambda a: None if a is None else np.asarray(a)
    return (([arr(s) for s in space] if isinstance(space, list) else arr(space)),
            [arr(v) for v in back], [d["event"] for d in t.report()["degradations"]])


def _whole_space(r2c):
    rng = np.random.default_rng(23)
    space = rng.standard_normal(DIMS[::-1])
    return space if r2c else space + 1j * rng.standard_normal(DIMS[::-1])


def _whole_case(mesh, r2c, per):
    """forward of the whole global space, given to every process: the
    verified values, the unverified plan's, the rows, and the values of
    the reference rung (``engine.execute`` armed to raise)."""
    from spfft_tpu_torch import faults
    from spfft_tpu_torch.verify import breaker

    make = lambda **kw: tp.DistributedTransform(
        tp.ProcessingUnit.HOST, int(r2c), *DIMS, [p.copy() for p in per], mesh=mesh,
        dtype=np.float64, engine="xla", **kw)
    space = _whole_space(r2c)
    arr = lambda vs: [None if v is None else np.asarray(v) for v in vs]
    rows = []
    inner, wrapped = _recorded(port_checks, rows)
    port_checks.run_checks = wrapped
    try:
        got = make(verify=True).forward(space, tp.ScalingType.FULL)
    finally:
        port_checks.run_checks = inner
    plain = make(verify=False).forward(space, tp.ScalingType.FULL)
    breaker.reset()
    with faults.inject("engine.execute=raise"):
        recovered = make(verify=True).forward(space, tp.ScalingType.FULL)
    return arr(got), arr(plain), rows, arr(recovered)


def _clean_worker(rank, port, queue):
    import torch.distributed as dist

    os.environ["SPFFT_TPU_VERIFY_BACKOFF_S"] = "0"
    try:
        group = tp.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
        out = {}
        for mesh_name, r2c, mode in CASES:
            per, vals = _problem(mesh_name, r2c)
            out[mesh_name, r2c, mode] = _port_case(_port_mesh(mesh_name, group), r2c, mode,
                                                   per, vals)
        for mesh_name in MESHES:
            for r2c in (False, True):
                per, vals = _problem(mesh_name, r2c)
                out[mesh_name, r2c, "reference"] = _reference_case(
                    _port_mesh(mesh_name, group), r2c, per, vals)
                out[mesh_name, r2c, "whole"] = _whole_case(_port_mesh(mesh_name, group), r2c, per)
        queue.put((rank, out, None))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, None, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _fault_worker(rank, port, queue):
    """``verify.check`` armed in rank 0 only, in "on" and "strict" mode, then
    the breaker (K = 1) tripped by it and healed with the site disarmed; a
    NaN input on one rank under guard; the engine's breaker opened in rank 0
    by a plan of its own, then a verified group call."""
    import torch.distributed as dist

    from spfft_tpu_torch import faults
    from spfft_tpu_torch.verify import breaker

    os.environ["SPFFT_TPU_VERIFY_BACKOFF_S"] = "0"
    try:
        group = tp.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
        mesh = _port_mesh("pencil2x2", group)
        per, vals = _problem("pencil2x2", False)
        mine = set(mesh.local_shards)
        mine_vals = [v if r in mine else None for r, v in enumerate(vals)]
        out = {}
        for mode in ("on", "strict"):
            breaker.reset()
            t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                        dtype=np.float64, verify=mode)
            with faults.inject("verify.check=raise" if rank == 0 else ""):
                try:
                    t.backward(mine_vals)
                    out[mode] = None
                except tp.GenericError as e:
                    out[mode] = type(e).__name__
        breaker.reset()
        os.environ["SPFFT_TPU_VERIFY_BREAKER_K"] = "1"
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                    dtype=np.float64, verify=True)
        with faults.inject("verify.check=raise" if rank == 0 else ""):
            try:
                t.backward(mine_vals)
            except tp.VerificationError:
                pass
        key = breaker.group_key(t.engine, group)
        states = [breaker.state(key)]
        t.backward(mine_vals)  # open: straight to the reference rung, verified
        states.append(breaker.state(key))
        os.environ["SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S"] = "0"
        t.backward(mine_vals)  # the half-open probe passes: closed
        states.append(breaker.state(key))
        out["breaker"] = states
        out["rungs"] = [d["event"] for d in t.report()["degradations"]]

        # guard: a NaN in rank 0's values (backward), then in rank 1's block
        # (verified forward); a clean call after them
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                    dtype=np.float64, guard=True, verify=True)
        space = t.backward(mine_vals)
        bad_vals = [None if v is None else v.copy() for v in mine_vals]
        bad_space = [None if b is None else b.clone() for b in space]
        if rank == 0:
            bad_vals[min(mine)][0] = np.nan
        else:
            bad_space[min(mine)][0, 0, 0] = float("nan")
        out["guard"], out["guard_msg"] = [], []
        for call in (lambda: t.backward(bad_vals), lambda: t.forward(bad_space)):
            try:
                call()
                out["guard"].append(None)
                out["guard_msg"].append(None)
            except tp.GenericError as e:
                out["guard"].append(type(e).__name__)
                out["guard_msg"].append(str(e))
        out["guard_after"] = [r for r, b in enumerate(t.backward(mine_vals)) if b is not None]

        # the engine's own breaker entry, opened in rank 0 by a plan of its
        # own, and a verified call of the group plan
        os.environ["SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S"] = "3600"
        breaker.reset()
        if rank == 0:
            alone = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per,
                                            mesh=_port_mesh("pencil2x2"), dtype=np.float64,
                                            verify=True)
            with faults.inject("engine.execute=raise"):
                alone.backward(vals)
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, *DIMS, per, mesh=mesh,
                                    dtype=np.float64, verify=True)
        t.backward(mine_vals)
        out["split"] = [breaker.state(t.engine), breaker.state(breaker.group_key(t.engine, group)),
                        [d["event"] for d in t.report()["degradations"]]]
        queue.put((rank, out, None))
    except Exception as e:
        queue.put((rank, None, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target):
    """Run ``target`` in two spawned processes; {rank: result}."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(rank, port, queue)) for rank in range(2)]
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
    return {rank: out for rank, out, _ in got}


@pytest.fixture(scope="module")
def clean():
    return _spawn(_clean_worker)


@pytest.fixture(scope="module")
def faulted():
    return _spawn(_fault_worker)


def _stacked(mesh_name, r2c, mode):
    per, vals = _problem(mesh_name, r2c)
    return _port_case(_port_mesh(mesh_name), r2c, mode, per, vals)


def _jax_rows(mesh_name, r2c):
    P, layout = _layout(mesh_name)
    per, vals = _problem(mesh_name, r2c)
    mesh = spfft_tpu.make_fft_mesh(P) if layout is None else spfft_tpu.make_fft_mesh2(*layout)
    rows = []
    inner, wrapped = _recorded(jax_checks, rows)
    jax_checks.run_checks = wrapped
    try:
        _drive(spfft_tpu, mesh, r2c, per, vals, set(range(P)), verify=True)
    finally:
        jax_checks.run_checks = inner
    return rows


def _blocks(mesh_name, r2c, space):
    """A global ``(Z, Y, X)`` result cut into the shards' blocks."""
    P, _ = _layout(mesh_name)
    per, _ = _problem(mesh_name, r2c)
    plan = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *DIMS, per,
                                   mesh=_port_mesh(mesh_name), dtype=np.float64, engine="xla")
    return [space[plan.local_z_offset(r):plan.local_z_offset(r) + plan.local_z_length(r),
                  plan.local_y_offset(r):plan.local_y_offset(r) + plan.local_y_length(r)]
            for r in range(P)]


def _verdicts(rows):
    return [[(d, c, v) for d, c, v, *_ in call] for call in rows]


def _scalars_close(rows, want):
    for call, want_call in zip(rows, want):
        pairs = [(complex(a), complex(b)) for r, w in zip(call, want_call)
                 for a, b in ((r[3], w[3]), (r[4], w[4]))]
        scale = max([abs(b) for _, b in pairs] + [1e-300])
        for a, b in pairs:
            assert abs(a - b) <= SCALAR_TOL * scale, (a, b, scale)


@pytest.mark.parametrize("mesh_name,r2c,mode", CASES,
                         ids=[f"{m}-{'r2c' if r else 'c2c'}-{mode}" for m, r, mode in CASES])
def test_a_group_verifies_as_the_stacked_plan_and_the_jax_package(clean, mesh_name, r2c, mode):
    (stacked, _, want_rows) = _stacked(mesh_name, r2c, mode)
    jax_rows = _jax_rows(mesh_name, r2c)
    assert _verdicts(want_rows) == _verdicts(jax_rows)
    for rank, out in clean.items():
        got, plain, rows = out[mesh_name, r2c, mode]
        # the verified results are the unverified plan's, bitwise
        for a, b in zip(got, plain):
            for x, y in zip(a, b):
                assert (x is None and y is None) or np.array_equal(x, y)
        assert all(v == "pass" for call in rows for _, _, v, *_ in call)
        assert _verdicts(rows) == _verdicts(want_rows)
        _scalars_close(rows, want_rows)
        _scalars_close(rows, jax_rows)
        # this process's blocks and values are the stacked plan's
        for r, blk in enumerate(_blocks(mesh_name, r2c, stacked[0])):
            if got[0][r] is not None:
                assert np.abs(got[0][r] - blk).max() <= 1e-13 * np.abs(blk).max()
        for r, v in enumerate(stacked[1]):
            if got[1][r] is not None:
                assert np.abs(got[1][r] - v).max() <= 1e-13 * np.abs(v).max()


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_the_reference_rung_is_the_stacked_plans_bitwise(clean, mesh_name, r2c):
    per, vals = _problem(mesh_name, r2c)
    space, back, rungs = _reference_case(_port_mesh(mesh_name), r2c, per, vals)
    blocks = _blocks(mesh_name, r2c, space)
    for rank, out in clean.items():
        got_space, got_back, got_rungs = out[mesh_name, r2c, "reference"]
        assert got_rungs == rungs == ["verify_demoted"] * 2
        for r, blk in enumerate(blocks):
            if got_space[r] is not None:
                assert np.array_equal(got_space[r], blk)
        for r, v in enumerate(back):
            assert (got_back[r] is None) == (r not in range(2 * rank, 2 * rank + 2)
                                             if mesh_name == "pencil2x2" else r != rank)
            if got_back[r] is not None:
                assert np.array_equal(got_back[r], v)


def test_a_fault_in_one_process_raises_in_every_process(faulted):
    for rank, out in faulted.items():
        assert out["on"] == out["strict"] == "VerificationError", (rank, out)


def test_the_breakers_of_a_group_move_in_step(faulted):
    assert faulted[0]["breaker"] == faulted[1]["breaker"] == ["open", "open", "closed"]
    assert faulted[0]["rungs"] == faulted[1]["rungs"] == ["verify_breaker_open",
                                                          "verify_demoted"]


def test_a_non_finite_input_in_one_process_raises_in_every_process(faulted):
    for rank, out in faulted.items():
        assert out["guard"] == ["HostExecutionError"] * 2, (rank, out["guard"])
        # the process whose own input was finite raises for the other one:
        # rank 1 in the backward call, rank 0 in the forward call
        remote = out["guard_msg"][1 - rank]
        assert "input]: failed on 1 other process(es) of the group" in remote, (rank, remote)
        assert out["guard_after"] == [2 * rank, 2 * rank + 1]


def test_a_breaker_opened_by_one_process_alone_does_not_split_the_group(faulted):
    assert faulted[0]["split"] == ["open", "closed", []]
    assert faulted[1]["split"] == ["closed", "closed", []]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_a_whole_space_verifies_as_the_stacked_plan(clean, mesh_name, r2c):
    per, _ = _problem(mesh_name, r2c)
    want, _, want_rows, want_recovered = _whole_case(_port_mesh(mesh_name), r2c, per)
    for rank, out in clean.items():
        got, plain, rows, recovered = out[mesh_name, r2c, "whole"]
        assert all(v == "pass" for call in rows for _, _, v, *_ in call)
        assert _verdicts(rows) == _verdicts(want_rows)
        _scalars_close(rows, want_rows)
        for r, v in enumerate(want):
            assert (got[r] is None) == (plain[r] is None) == (recovered[r] is None)
            if got[r] is not None:
                assert np.array_equal(got[r], plain[r])
                assert np.abs(got[r] - v).max() <= 1e-13 * np.abs(v).max()
                assert np.array_equal(recovered[r], want_recovered[r])
