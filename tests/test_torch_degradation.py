"""The port's degradation ladder (spfft_tpu_torch.faults.ladder and the IR's
rungs in spfft_tpu_torch.ir.compile) against the JAX package's.

Rung 1 (``engine.compile`` on ``engine="mxu"``): the JAX MXU engine cannot
be built on this jax, so the port's entry is held against the dict that
``spfft_tpu.faults.engine_fallback("mxu", "xla", ...)`` returns and its
counter delta. The IR's rungs (``ir.lower``, ``ir.compile``, ``ir.batch``)
and ``exchange.build`` are held against a JAX ``engine="xla"`` plan of the
same triplets (16^3): the same path, results within the bar, the same
metric deltas, events and ``degradations`` entries. The kernels' typed
errors take no rung. Cards with a degradation and with verification pass
both packages' validators.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.obs import metrics as jmetrics
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu.obs import trace as jtrace
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.execution_mxu import MxuLocalExecution
from spfft_tpu_torch.ir import compile as pcompile
from spfft_tpu_torch.obs import metrics, trace
from spfft_tpu_torch.parallel.execution_mxu import MxuDistributedExecution

DIM = 16
ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("faults_injected_total", "degradations_total", "engine_fallbacks_total",
            "execution_failures_total", "transforms_total", "ir_dispatches_total")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("SPFFT_TPU_FAULTS", "SPFFT_TPU_GUARD", "SPFFT_TPU_VERIFY",
                 "SPFFT_TPU_FUSE", "SPFFT_TPU_BATCH_FUSE"):
        monkeypatch.delenv(name, raising=False)
    for f in (faults, jfaults):
        f.disarm()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    yield
    for f in (faults, jfaults):
        f.disarm()
    for o in (obs, jobs):
        o.clear()
        o.trace.disable()


def problem(r2c=False, seed=7):
    trip = np.asarray(tp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8,
                                                          hermitian_symmetry=r2c))
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    space = rng.standard_normal((DIM,) * 3)
    if not r2c:
        space = space + 1j * rng.standard_normal((DIM,) * 3)
    return trip, values, space


def plan(pkg, trip, r2c=False, engine="xla", dtype=np.float64, **kw):
    return pkg.Transform(pkg.ProcessingUnit.HOST, int(r2c), DIM, DIM, DIM, indices=trip,
                         dtype=dtype, engine=engine, **kw)


def mesh_plan(pkg, trip, shards=2, engine="xla", **kw):
    per = [np.array(p) for p in tp.distribute_triplets(trip, shards, DIM)]
    mesh = pkg.make_fft_mesh(shards) if pkg is spfft_tpu else pkg.make_fft_mesh(
        shards, device="cpu")
    return pkg.DistributedTransform(pkg.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per, mesh=mesh,
                                    dtype=np.float64, engine=engine, **kw)


def family(o) -> dict:
    return {k: v for k, v in o.snapshot()["counters"].items() if k.startswith(FAMILIES)}


def names(o) -> list:
    return [(e["name"], e["args"].get("what"), e["args"].get("choice"), e["args"].get("event"))
            for e in o.trace.snapshot()["events"]]


def entries(t) -> list:
    return [(d["event"], sorted(d)) for d in t.report()["degradations"]]


def close(got, want, bar=1e-12):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


# ---- rung 1: the engine fallback ---------------------------------------------------


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_local_engine_fallback_is_the_jax_record(r2c, dtype):
    trip, values, space = problem(r2c)
    want = plan(tp, trip, r2c, engine="xla", dtype=dtype)
    with faults.inject("engine.compile=raise"):
        t = plan(tp, trip, r2c, engine="mxu", dtype=dtype)
    assert t.engine == "xla" and isinstance(t._exec, tp.execution.LocalExecution)
    reason = "InjectedFault: injected fault at site 'engine.compile'"
    jobs.clear()
    with jfaults.collecting([]) as sink:
        jfaults.engine_fallback("mxu", "xla", reason)
    assert t.report()["degradations"] == sink
    jc = {k: v for k, v in jobs.snapshot()["counters"].items()}
    pc = family(obs)
    assert {k: pc[k] for k in jc} == jc
    assert pc['faults_injected_total{kind="raise",site="engine.compile"}'] == 1
    assert torch.equal(t.backward(values), want.backward(values))
    assert torch.equal(t.forward(space), want.forward(space))


@pytest.mark.parametrize("pencil", [False, True], ids=["slab", "pencil"])
def test_distributed_engine_fallback_keeps_mesh_and_discipline(pencil):
    trip, _, _ = problem()
    mesh = tp.make_fft_mesh2(2, 2, device="cpu") if pencil else tp.make_fft_mesh(2, device="cpu")
    per = tp.distribute_triplets(trip, mesh.num_shards, DIM,
                                 **({"layout": (2, 2), "dim_x": DIM} if pencil else {}))
    kw = dict(mesh=mesh, dtype=np.float64, exchange_type=tp.ExchangeType.UNBUFFERED)
    want = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per,
                                   engine="xla", **kw)
    with faults.inject("engine.compile=raise"):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per,
                                    engine="mxu", **kw)
    assert t.engine == want.engine == ("pencil2" if pencil else "xla")
    assert t.exchange_type == want.exchange_type
    (entry,) = t.report()["degradations"]
    assert (entry["event"], entry["from"], entry["to"]) == (
        "engine_fallback", "pencil2-mxu" if pencil else "mxu", t.engine)
    assert obs.validate_plan_card(t.report()) == [] == jplancard.validate_plan_card(t.report())


def test_a_torch_fft_engine_failure_has_no_rung_below(monkeypatch):
    trip, _, _ = problem()

    def broken(*args, **kwargs):
        raise RuntimeError("no fft today")

    monkeypatch.setattr(tp.execution.LocalExecution, "_init_ir", broken)
    with pytest.raises(tp.FFTWError, match="no fft today"):
        plan(tp, trip, engine="xla")
    with faults.inject("engine.compile=raise"), pytest.raises(tp.FFTWError):
        plan(tp, trip, engine="mxu")  # falls back, and the fallback fails too
    assert family(obs)['engine_fallbacks_total{from="mxu",to="xla"}'] == 1


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_exchange_build_outcome_is_the_jax_packages(engine):
    trip, _, _ = problem()
    with jfaults.inject("exchange.build=raise"), pytest.raises(spfft_tpu.MPIError) as want:
        mesh_plan(spfft_tpu, trip, engine="xla")
    jc = family(jobs)
    with faults.inject("exchange.build=raise"), pytest.raises(tp.MPIError) as got:
        mesh_plan(tp, trip, engine=engine)
    assert str(got.value) == str(want.value)
    pc = family(obs)
    if engine == "mxu":  # the fallback fires first, then the exchange fails again
        assert pc.pop('engine_fallbacks_total{from="mxu",to="xla"}') == 1
        assert pc.pop('degradations_total{event="engine_fallback"}') == 1
        assert pc['faults_injected_total{kind="raise",site="exchange.build"}'] == 2
        pc['faults_injected_total{kind="raise",site="exchange.build"}'] = 1
    assert pc == jc


@pytest.mark.parametrize("error", ["GPUSupportError", "GPULaunchError"])
@pytest.mark.parametrize("where", ["local", "mesh"])
def test_the_kernels_typed_errors_take_no_rung(monkeypatch, error, where):
    """A kernel that does not build or launch is an error, not a fallback:
    the mxu engine's typed failures pass through rung 1."""
    cls = getattr(tp, error)

    def fail(self, *args, **kwargs):
        raise cls(f"{error} inside construction")

    klass = MxuLocalExecution if where == "local" else MxuDistributedExecution
    monkeypatch.setattr(klass, "__init__", fail)
    trip, _, _ = problem()
    with pytest.raises(cls, match="inside construction"):
        plan(tp, trip, engine="mxu") if where == "local" else mesh_plan(tp, trip, engine="mxu")
    assert not any(k.startswith(("engine_fallbacks", "degradations")) for k in family(obs))


# ---- the IR's rungs ------------------------------------------------------------------


def drive_pair(pkg, t, values, space):
    return [t.backward(values), t.forward(scaling=pkg.ScalingType.FULL), t.forward(space)]


def both(spec, drive=drive_pair, r2c=False, **kw):
    trip, values, space = problem(r2c)
    got = []
    for pkg, o, f in ((spfft_tpu, jobs, jfaults), (tp, obs, faults)):
        o.clear()
        o.trace.enable()
        o.trace.clear()
        with f.inject(spec):
            t = plan(pkg, trip, r2c, **kw)
        outs = drive(pkg, t, values, space)
        got.append((outs, family(o), names(o), t))
        o.trace.disable()
    return got


@pytest.mark.parametrize("site,path,event", [
    ("ir.lower", "legacy", "ir_lower_failed"),
    ("ir.compile", "staged", "fuse_compile_failed"),
])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_ir_rungs_are_the_jax_packages(site, path, event, r2c):
    (jout, jc, jev, jt), (pout, pc, pev, pt) = both(f"{site}=raise", r2c=r2c)
    assert pt.report()["ir"]["path"] == jt.report()["ir"]["path"] == path
    assert not pt.fused
    for g, w in zip(pout, jout):
        close(g, w)
    assert pc == jc
    assert pev == jev
    assert entries(pt) == entries(jt) == [(event, ["event", "reason"])]
    card = pt.report()
    assert obs.validate_plan_card(card) == [] == jplancard.validate_plan_card(card)


@pytest.mark.parametrize("site", ["ir.lower", "ir.compile"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_ir_rungs_on_the_mxu_engine_keep_the_kernels(site, r2c):
    trip, values, space = problem(r2c)
    want = plan(tp, trip, r2c, engine="mxu")
    with faults.inject(f"{site}=raise"):
        t = plan(tp, trip, r2c, engine="mxu")
    assert t.engine == "mxu"
    assert t.describe()["ir"]["path"] == ("legacy" if site == "ir.lower" else "staged")
    # the same stage bodies, in the same order: bitwise the fused plan's results
    assert torch.equal(t.backward(values), want.backward(values))
    assert torch.equal(t.forward(space, tp.ScalingType.FULL),
                       want.forward(space, tp.ScalingType.FULL))
    for direction in ("backward", "forward"):
        key = f'ir_dispatches_total{{direction="{direction}",mode="{t.describe()["ir"]["path"]}"}}'
        assert obs.snapshot()["counters"][key] >= 1


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_the_batch_rung_is_the_jax_packages(direction):
    trip, values, space = problem()
    got = []
    for pkg, o, f in ((spfft_tpu, jobs, jfaults), (tp, obs, faults)):
        t = plan(pkg, trip)
        o.clear()
        with f.inject("ir.batch=raise"):
            out = (t.backward_batch([values, values]) if direction == "backward"
                   else t.forward_batch([space, space]))
        batch = t.report()["batch"]
        got.append((out, family(o), entries(t), batch["failed"], batch["enabled"]))
    (jout, jc, je, jf, jen), (pout, pc, pe, pf, pen) = got
    assert (pf, pen) == (jf, jen) == (True, False)
    for g, w in zip(pout, jout):
        close(g, w)
    assert pe == je == [("batch_fuse_failed", ["event", "reason"])]
    assert pc == jc


def test_a_first_dispatch_failure_takes_the_compile_rung(monkeypatch):
    """A fused program whose first call fails with a runtime error (on the
    card, a capture the CUDA runtime refuses) degrades to the staged path,
    recorded on the plan built earlier; the call is not lost."""
    trip, values, _ = problem()
    want = plan(tp, trip).backward(values)
    real = tp.execution.LocalExecution._st_y_backward
    calls = []

    def flaky(self, grid):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("operation not permitted when stream is capturing")
        return real(self, grid)

    monkeypatch.setattr(tp.execution.LocalExecution, "_st_y_backward", flaky)
    t = plan(tp, trip)
    assert t.fused and t.report()["degradations"] == []
    obs.clear()
    assert torch.equal(t.backward(values), want)
    assert t.describe()["ir"]["path"] == "staged" and not t.fused
    (entry,) = t.report()["degradations"]
    assert entry["event"] == "fuse_compile_failed" and "capturing" in entry["reason"]
    assert torch.equal(t.backward(values), want)  # staged from now on
    c = obs.snapshot()["counters"]
    assert c['degradations_total{event="fuse_compile_failed"}'] == 1
    assert 'ir_dispatches_total{direction="backward",mode="fused"}' not in c


def test_a_first_batched_dispatch_failure_turns_the_batch_axis_off(monkeypatch):
    trip, values, _ = problem()
    t = plan(tp, trip)
    monkeypatch.setattr(pcompile, "_batched", lambda graph, fn, batch: _raise_runtime)
    out = t.backward_batch([values, values])
    assert len(out) == 2 and torch.equal(out[0], plan(tp, trip).backward(values))
    assert t.report()["batch"] == {**t.report()["batch"], "failed": True, "enabled": False}
    assert [d["event"] for d in t.report()["degradations"]] == ["batch_fuse_failed"]
    assert t.fused  # the plan stays fused


def _raise_runtime(*args):
    raise RuntimeError("batched program failed")


def test_a_mesh_lowering_failure_raises_a_typed_error():
    """Once a typed refusal; now JAX's outcome: the mesh engine runs its
    legacy path, records ``ir_lower_failed`` and gives JAX's result."""
    trip, values, _ = problem()
    per = tp.distribute_triplets(trip, 2, DIM)
    lut = {tuple(x): v for x, v in zip(map(tuple, trip), values)}
    vals = [np.asarray([lut[tuple(x)] for x in p]) for p in per]
    with faults.inject("ir.lower=raise"), jfaults.inject("ir.lower=raise"):
        t, jt = mesh_plan(tp, trip), mesh_plan(spfft_tpu, trip)
    assert t.report()["ir"]["path"] == "legacy" == jt.report()["ir"]["path"]
    assert [d["event"] for d in t.report()["degradations"]] == ["ir_lower_failed"] == [
        d["event"] for d in jt.report()["degradations"]]
    np.testing.assert_allclose(t.backward(vals).numpy(), np.asarray(jt.backward(vals)),
                               rtol=0, atol=1e-11 * np.abs(values).sum())


def test_a_staged_fallback_on_a_mesh_matches_the_fused_plan():
    trip, values, space = problem()
    per = tp.distribute_triplets(trip, 2, DIM)
    lut = {tuple(x): v for x, v in zip(map(tuple, trip), values)}
    vals = [np.asarray([lut[tuple(x)] for x in p]) for p in per]
    want = mesh_plan(tp, trip, engine="mxu")
    with faults.inject("ir.compile=raise"):
        t = mesh_plan(tp, trip, engine="mxu")
    assert not t.fused and t.report()["degradations"][0]["event"] == "fuse_compile_failed"
    assert torch.equal(t.backward(vals), want.backward(vals))


# ---- cards, vocabularies, the package boundary ------------------------------------------


def test_degradations_section_is_always_present_and_live():
    trip, values, _ = problem()
    t = plan(tp, trip)
    assert t.report()["degradations"] == []
    t._exec._ir._record("fuse_compile_failed", RuntimeError("late"))
    assert [d["event"] for d in t.report()["degradations"]] == ["fuse_compile_failed"]


@pytest.mark.parametrize("kind", ["local", "mesh"])
def test_cards_with_a_rung_and_verification_pass_both_validators(kind):
    trip, _, _ = problem()
    with faults.inject("engine.compile=raise"):
        t = (plan(tp, trip, engine="mxu", verify="on") if kind == "local"
             else mesh_plan(tp, trip, engine="mxu", verify="on"))
    card = t.report()
    assert card["degradations"][0]["event"] == "engine_fallback"
    assert card["verification"]["mode"] == "on"
    assert obs.validate_plan_card(card) == [] == jplancard.validate_plan_card(dict(card))


def test_metric_rows_and_events_are_the_jax_packages():
    jrows = {row[0]: row for row in jmetrics.METRICS}
    mine = {row[0]: row for row in metrics.METRICS}
    for name in ("execution_failures_total", "engine_fallbacks_total", "degradations_total",
                 "guard_checks_total", "guard_failures_total", "faults_injected_total",
                 "verify_checks_total", "verify_retries_total", "verify_recoveries_total",
                 "verify_failures_total", "verify_breaker_state", "verify_breaker_trips_total"):
        assert mine[name] == jrows[name], name
    assert {"degradation", "guard", "fault.injected", "verify"} <= set(trace.EVENTS)
    assert set(trace.EVENTS) <= set(jtrace.EVENTS)


@pytest.mark.parametrize("package", ["faults", "verify"])
def test_the_new_packages_import_no_jax(package):
    for path in sorted((ROOT / "spfft_tpu_torch" / package).glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "spfft_tpu"), (path, mod)
        assert "import jax" not in path.read_text()


def test_async_synchronize_failure_is_typed_on_a_mesh():
    trip, _, _ = problem()
    t = mesh_plan(tp, trip)
    t.set_execution_mode(tp.ExecType.ASYNCHRONOUS)
    with faults.inject("sync.fence=raise"), pytest.raises(tp.HostExecutionError,
                                                          match="synchronize failed"):
        t.synchronize()
