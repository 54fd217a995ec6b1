"""The port's repairs against the JAX package: the empty local plan on the
``torch.fft`` engine, and the mesh engines' legacy path.

* An empty plan (``num_local_elements=0``) on either engine returns the JAX
  package's zero ``(Z, Y, X)`` grid and ``(0,)`` forward values, C2C and
  R2C, float32 and float64 (the ``torch.fft`` engine skips a DFT stage whose
  batch is empty).
* With ``ir.lower=raise`` armed, a slab or 2 x 2 pencil plan on either
  engine runs its legacy path (``_lower_slab`` / ``_lower_pencil``'s nodes
  in order, no graph) and records ``ir_lower_failed``, as the JAX package
  does: its results are bitwise those of the plan without the fault, and
  within the dtype's bar (1e-5 float32, 1e-11 float64, relative to the
  largest value) of the JAX package's ``engine="xla"`` plan under the same
  fault, whose degradation record it matches. The same holds over a
  2-process gloo group (each process passing its own shards).
"""
import multiprocessing
import socket

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu_torch import faults, obs

DIM = 8
BAR = {np.float32: 1e-5, np.float64: 1e-11}
JOIN_SECONDS = 120


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SPFFT_TPU_FAULTS", "SPFFT_TPU_FUSE", "SPFFT_TPU_VERIFY", "SPFFT_TPU_GUARD"):
        monkeypatch.delenv(name, raising=False)
    for f in (faults, jfaults):
        f.disarm()
    obs.enable()
    obs.clear()
    yield
    for f in (faults, jfaults):
        f.disarm()


def _close(got, want, dtype):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= BAR[dtype] * max(float(np.abs(want).max()), 1.0)


# ---- the empty local plan (queue C fault 1) ------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_an_empty_plan_gives_the_jax_zero_grid(engine, r2c, dtype):
    none = np.zeros((0, 3), np.int32)
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), DIM, DIM, DIM, num_local_elements=0,
                        indices=none, engine=engine, dtype=dtype)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), DIM, DIM, DIM,
                              num_local_elements=0, indices=none, engine="xla", dtype=dtype)
    empty = np.zeros(0, np.complex128)
    space, want = port.backward(empty), np.asarray(ref.backward(empty))
    assert tuple(space.shape) == want.shape == (DIM,) * 3
    assert space.dtype == {(False, np.float32): torch.complex64,
                           (False, np.float64): torch.complex128,
                           (True, np.float32): torch.float32,
                           (True, np.float64): torch.float64}[r2c, dtype]
    assert not bool(space.abs().any()) and not np.abs(want).any()
    for scaling in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        back = port.forward(scaling=scaling)
        assert tuple(back.shape) == np.asarray(ref.forward(scaling=int(scaling))).shape == (0,)
    field = np.random.default_rng(1).standard_normal((DIM,) * 3)
    assert tuple(port.forward(field).shape) == (0,)
    assert port.report()["degradations"] == []


def test_the_z_stage_passes_an_empty_table_through():
    """A DFT over an empty (0, Z) stick table is skipped in both directions
    (MKL refuses an empty batch)."""
    t = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, num_local_elements=0,
                     indices=np.zeros((0, 3), np.int32), engine="xla")
    sticks = torch.zeros((0, DIM), dtype=torch.complex128)
    assert t._exec._st_z_backward(sticks) is sticks
    assert t._exec._st_z_forward(sticks) is sticks


# ---- the mesh engines' legacy path -----------------------------------------------------


def _problem(r2c, pencil, dtype):
    trip = np.asarray(tp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8,
                                                          hermitian_symmetry=r2c))
    rng = np.random.default_rng(5 + int(r2c))
    if pencil:
        per = [np.asarray(p) for p in tp.distribute_triplets(trip, 4, DIM, layout=(2, 2),
                                                             dim_x=DIM)]
    else:
        per = [np.asarray(p) for p in tp.distribute_triplets(trip, 4, DIM,
                                                             weights=(2, 1, 1, 1))]
    if r2c:
        spec = np.fft.fftn(rng.standard_normal((DIM,) * 3))
        vals = [spec[t[:, 2] % DIM, t[:, 1] % DIM, t[:, 0]] for t in per]
    else:
        vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals


def _port_plan(r2c, pencil, engine, dtype, per, group=None, **kw):
    mesh = (tp.make_fft_mesh2(2, 2, device="cpu", group=group) if pencil
            else tp.make_fft_mesh(4 // (1 if group is None else 2), device="cpu", group=group))
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), DIM, DIM, DIM, per,
                                   mesh=mesh, engine=engine, dtype=dtype, **kw)


def _jax_legacy(r2c, pencil, dtype, per, vals):
    mesh = spfft_tpu.make_fft_mesh2(2, 2) if pencil else spfft_tpu.make_fft_mesh(4)
    with jfaults.inject("ir.lower=raise"):
        jt = spfft_tpu.DistributedTransform(spfft_tpu.ProcessingUnit.HOST, int(r2c), DIM, DIM,
                                            DIM, per, mesh=mesh, engine="xla", dtype=dtype)
    space = np.asarray(jt.backward(vals))
    back = [np.asarray(b) for b in jt.forward(scaling=spfft_tpu.ScalingType.FULL)]
    return jt, space, back


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("pencil", [False, True], ids=["slab", "pencil2x2"])
def test_a_mesh_plan_runs_its_legacy_path(pencil, r2c, engine, dtype):
    per, vals = _problem(r2c, pencil, dtype)
    with faults.inject("ir.lower=raise"):
        leg = _port_plan(r2c, pencil, engine, dtype, per)
    plain = _port_plan(r2c, pencil, engine, dtype, per)
    card = leg.report()
    assert card["ir"]["path"] == "legacy" and card["ir"]["stages"] is None
    assert obs.validate_plan_card(card) == []
    jt, jspace, jback = _jax_legacy(r2c, pencil, dtype, per, vals)
    assert [d["event"] for d in card["degradations"]] == ["ir_lower_failed"] == [
        d["event"] for d in jt.report()["degradations"]]
    assert card["degradations"][0]["reason"] == jt.report()["degradations"][0]["reason"]
    space = leg.backward(vals)
    assert torch.equal(space, plain.backward(vals))
    _close(space, jspace, dtype)
    back = leg.forward(scaling=tp.ScalingType.FULL)
    for b, p, j in zip(back, plain.forward(scaling=tp.ScalingType.FULL), jback):
        assert torch.equal(b, p)
        _close(b, j, dtype)
    assert not leg.fused and leg.backward_batch([vals, vals])[1].shape == space.shape


def _worker(rank, port, queue):
    import torch.distributed as dist

    try:
        group = tp.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
        results = []
        for pencil in (False, True):
            for engine in ("xla", "mxu"):
                per, vals = _problem(False, pencil, np.float64)
                with faults.inject("ir.lower=raise"):
                    t = _port_plan(False, pencil, engine, np.float64, per, group=group)
                mine = set(t.mesh.local_shards)
                space = t.backward([v if r in mine else None for r, v in enumerate(vals)])
                back = t.forward(scaling=tp.ScalingType.FULL)
                results.append((
                    t.report()["ir"]["path"], [d["event"] for d in t.report()["degradations"]],
                    {r: space[r].numpy() for r in mine}, {r: back[r].numpy() for r in mine},
                    {r: (t.local_z_offset(r), t.local_z_length(r), t.local_y_offset(r),
                         t.local_y_length(r)) for r in mine}))
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


def test_the_legacy_path_over_a_process_group():
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(rank, port, queue)) for rank in range(2)]
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
    cases = [(pencil, engine) for pencil in (False, True) for engine in ("xla", "mxu")]
    for i, (pencil, engine) in enumerate(cases):
        per, vals = _problem(False, pencil, np.float64)
        _, jspace, jback = _jax_legacy(False, pencil, np.float64, per, vals)
        for _, results, _ in got:
            path, rungs, spaces, backs, blocks = results[i]
            assert path == "legacy" and rungs == ["ir_lower_failed"]
            for r, s in spaces.items():
                zo, lz, yo, ly = blocks[r]
                _close(s, jspace[zo:zo + lz, yo:yo + ly], np.float64)
                _close(backs[r], jback[r], np.float64)
