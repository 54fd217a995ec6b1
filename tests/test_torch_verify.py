"""The port's self-verification (spfft_tpu_torch.verify) against the JAX
package's (spfft_tpu.verify).

Checks: the same numpy arrays, made from a seed, go through both
``run_checks``: equal verdict rows, ``rel`` within 1e-12, on the true
transform pair and on a corrupted result, for every direction and transform
type, and on a tensor whose strides are the mxu engine's native layout.
Plans: a port plan and a JAX ``engine="xla"`` plan of the same triplets
(16^3) with ``verify="on"`` give results within the dtype's bar, the same
metric deltas of the verify and fault families, the same ``verify`` events
and the same ``degradations`` entries, for each armed site; the breaker's
state sequence and ``backoff_s`` for one seed are the JAX package's.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import verify as jverify
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu_torch import faults, obs, verify
from spfft_tpu_torch.verify import checks

DIM = 16
BAR = {np.float32: 1e-5, np.float64: 1e-12}
FAMILIES = ("faults_injected_total", "verify_", "degradations_total", "guard_",
            "execution_failures_total", "transforms_total")
VERIFY_KNOBS = ("SPFFT_TPU_VERIFY", "SPFFT_TPU_VERIFY_RTOL", "SPFFT_TPU_VERIFY_SEED",
                "SPFFT_TPU_VERIFY_RETRIES", "SPFFT_TPU_VERIFY_BACKOFF_S",
                "SPFFT_TPU_VERIFY_JITTER_SEED", "SPFFT_TPU_VERIFY_BREAKER_K",
                "SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S", "SPFFT_TPU_GUARD", "SPFFT_TPU_FAULTS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in VERIFY_KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BACKOFF_S", "0.001")
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        f.reseed(0)
        v.breaker.reset()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    yield
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        v.breaker.reset()
    for o in (obs, jobs):
        o.clear()
        o.trace.disable()


def problem(r2c=False, seed=5):
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


def family(o) -> dict:
    return {k: v for k, v in o.snapshot()["counters"].items() if k.startswith(FAMILIES)}


def rows(o, names=("verify", "degradation", "fault.injected", "guard")):
    return [(e["name"], e["args"].get("what"), e["args"].get("check"),
             e["args"].get("verdict"), e["args"].get("event"))
            for e in o.trace.snapshot()["events"] if e["name"] in names]


def entries(t):
    return [(d["event"], sorted(d)) for d in t.report()["degradations"]]


def close(got, want, bar):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert np.abs(got - want).max() <= bar * max(1.0, np.abs(want).max())


def run_both(spec, drive, r2c=False, **kw):
    """The same calls on a JAX and a port xla plan under ``spec``, each with
    its registry and recorder fresh: ``((outs, counters, events, plan), ...)``
    for JAX, then the port."""
    trip, values, space = problem(r2c)
    got = []
    for pkg, o, f in ((spfft_tpu, jobs, jfaults), (tp, obs, faults)):
        o.clear()
        o.trace.enable()
        o.trace.clear()
        with f.inject(spec):
            t = plan(pkg, trip, r2c, **kw)
            outs = drive(pkg, t, values, space)
        got.append((outs, family(o), rows(o), t))
        o.trace.disable()
    return got


# ---- modes and tolerances ------------------------------------------------------


@pytest.mark.parametrize("explicit,env,want", [
    (None, None, "off"), (True, None, "on"), ("1", None, "on"), ("strict", None, "strict"),
    (False, "1", "off"), (None, "on", "on"), (None, "strict", "strict"), ("bogus", None, None),
])
def test_mode_resolution_is_the_jax_packages(monkeypatch, explicit, env, want):
    if env is not None:
        monkeypatch.setenv("SPFFT_TPU_VERIFY", env)
    if want is None:
        with pytest.raises(spfft_tpu.InvalidParameterError) as e1:
            jverify.resolve_mode(explicit)
        with pytest.raises(tp.InvalidParameterError) as e2:
            verify.resolve_mode(explicit)
        assert str(e1.value) == str(e2.value)
    else:
        assert verify.resolve_mode(explicit) == jverify.resolve_mode(explicit) == want


def test_rtol_follows_the_dtype_and_the_knob(monkeypatch):
    assert verify.resolve_rtol(np.float32) == 1e-4
    assert verify.resolve_rtol(np.float64) == 1e-9 == jverify.resolve_rtol(np.float64)
    monkeypatch.setenv("SPFFT_TPU_VERIFY_RTOL", "3e-7")
    assert verify.resolve_rtol(np.float64) == 3e-7 == jverify.resolve_rtol(np.float64)
    monkeypatch.setenv("SPFFT_TPU_VERIFY_RTOL", "-1")
    with pytest.raises(tp.InvalidParameterError, match="must be positive"):
        verify.resolve_rtol(np.float32)


def test_vocabulary_and_applicability_are_the_jax_packages():
    assert verify.CHECKS == jverify.CHECKS == tuple(verify.CHECK_FNS)
    for direction in ("backward", "forward"):
        for tt in (0, 1):
            assert verify.applicable_checks(direction, tt) == jverify.applicable_checks(
                direction, tt)
    assert (verify.DEFAULT_RETRIES, verify.DEFAULT_BACKOFF_S) == (
        jverify.DEFAULT_RETRIES, jverify.DEFAULT_BACKOFF_S)


# ---- the checks ------------------------------------------------------------------


def true_pair(r2c, seed=5):
    """The JAX package's own transform pair of a problem: (triplets, freq,
    space) for backward and forward."""
    trip, values, space = problem(r2c, seed)
    t = plan(spfft_tpu, trip, r2c)
    return trip, values, np.asarray(t.backward(values)), space, np.asarray(t.forward(space))


@pytest.mark.parametrize("direction", ["backward", "forward"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("corrupt", [False, True], ids=["true", "corrupt"])
def test_checks_give_the_jax_verdicts(direction, r2c, corrupt):
    trip, values, bspace, fspace, fvalues = true_pair(r2c)
    if direction == "backward":
        freq, space = values, bspace.copy()
    else:
        freq, space = fvalues.copy(), fspace
    if corrupt:
        if direction == "backward":
            space[1, 2, 3] += 5.0
        else:
            freq = -freq
    kw = dict(direction=direction, triplets=trip, transform_type=int(r2c), rtol=1e-9,
              scale=1.0)
    want = jverify.run_checks(freq=freq, space=space, **kw)
    got = checks.run_checks(freq=freq, space=space, **kw)
    # the same tensor in the mxu engine's native (Y, X, Z) memory order
    strided = torch.as_tensor(space).permute(1, 2, 0).contiguous().permute(2, 0, 1)
    got_strided = checks.run_checks(freq=torch.as_tensor(freq), space=strided, **kw)
    assert [r["check"] for r in got] == [r["check"] for r in want] == [
        r["check"] for r in got_strided]
    for g, s, w in zip(got, got_strided, want):
        assert g["verdict"] == s["verdict"] == w["verdict"]
        assert g["rtol"] == w["rtol"]
        assert abs(g["rel"] - w["rel"]) <= 1e-12 and abs(s["rel"] - w["rel"]) <= 1e-12
    if want:
        assert any(r["verdict"] == "fail" for r in want) == corrupt


def test_checks_with_scaling_and_without_the_origin():
    trip, values, _, fspace, _ = true_pair(False)
    t = plan(spfft_tpu, trip)
    fvalues = np.asarray(t.forward(fspace, spfft_tpu.ScalingType.FULL))
    keep = trip.any(axis=1)  # the origin's row dropped: the dc check skips
    for tr, fr in ((trip, fvalues), (trip[keep], fvalues[keep])):
        kw = dict(direction="forward", triplets=tr, transform_type=0, rtol=1e-9,
                  scale=1.0 / DIM ** 3)
        want = jverify.run_checks(freq=fr, space=fspace, **kw)
        got = checks.run_checks(freq=fr, space=fspace, **kw)
        assert [(r["check"], r["verdict"]) for r in got] == [
            (r["check"], r["verdict"]) for r in want]
        assert all(abs(g["rel"] - w["rel"]) <= 1e-12 for g, w in zip(got, want))
    assert [r["check"] for r in got] == ["probe"]


def test_checks_count_and_trace_as_the_jax_package():
    trip, values, bspace, _, _ = true_pair(False)
    for run, o in ((jverify.run_checks, jobs), (checks.run_checks, obs)):
        o.clear()
        o.trace.enable()
        o.trace.clear()
        run(direction="backward", freq=values, space=bspace, triplets=trip,
            transform_type=0, rtol=1e-9)
    assert family(obs) == family(jobs)
    assert rows(obs) == rows(jobs)


# ---- verified plans against the JAX package ------------------------------------------


def _pair(pkg, t, values, space):
    return t.backward(values), t.forward(scaling=pkg.ScalingType.FULL)


def _fwd(pkg, t, values, space):
    return (t.forward(space),)


@pytest.mark.parametrize("spec,drive,want", [
    ("engine.execute=corrupt", _pair, "recovered"),
    ("engine.execute=nan", _pair, "recovered"),
    ("engine.execute=corrupt", _fwd, "recovered"),
    ("verify.check=raise", _pair, "VerificationError"),
    ("sync.fence=raise", _pair, "VerificationError"),
    ("ir.compile=raise", _pair, "clean"),
    ("ir.lower=raise", _pair, "clean"),
], ids=["corrupt-pair", "nan-pair", "corrupt-forward", "check-site", "fence", "ir.compile",
        "ir.lower"])
def test_armed_site_under_verify_is_the_jax_packages(spec, drive, want):
    def drive_typed(pkg, t, values, space):
        try:
            return drive(pkg, t, values, space)
        except pkg.VerificationError as e:
            return type(e).__name__

    (jout, jc, jev, jt), (pout, pc, pev, pt) = run_both(spec, drive_typed, verify="on")
    if want == "VerificationError":
        assert pout == jout == want
    else:
        for g, w in zip(pout, jout):
            close(g, w, BAR[np.float64])
    assert pc == jc
    assert pev == jev
    assert entries(pt) == entries(jt)
    assert (any(e[0] == "verify_demoted" for e in entries(pt))) == (want == "recovered")


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_a_clean_verified_pair_equals_the_unverified_one(engine, dtype):
    trip, values, space = problem()
    want = plan(tp, trip, engine=engine, dtype=dtype)
    got = plan(tp, trip, engine=engine, dtype=dtype, verify="on", guard=True)
    assert torch.equal(got.backward(values), want.backward(values))
    assert torch.equal(got.forward(scaling=tp.ScalingType.FULL),
                       want.forward(scaling=tp.ScalingType.FULL))
    assert torch.equal(got.forward(space), want.forward(space))
    c = obs.snapshot()["counters"]
    assert c['verify_checks_total{check="probe",verdict="pass"}'] == 3
    assert not any("fail" in k or "recover" in k for k in c)
    assert got.report()["degradations"] == []


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_corruption_recovers_through_the_reference_rung(engine):
    trip, values, space = problem()
    want = plan(spfft_tpu, trip)
    wb, wf = want.backward(values), want.forward(space)
    t = plan(tp, trip, engine=engine, verify="on")
    with faults.inject("engine.execute=corrupt"):
        close(t.backward(values), wb, 1e-12)
    # the retained space is the verified recovery (the forward runs clean)
    close(t.forward(), want.forward(np.asarray(wb)), 1e-12)
    with faults.inject("engine.execute=corrupt"):
        close(t.forward(space), wf, 1e-12)
    assert isinstance(t._reference_exec, tp.execution.LocalExecution)
    assert t._reference_exec.device == t.device
    c = obs.snapshot()["counters"]
    assert c['verify_recoveries_total{direction="backward"}'] == 1
    assert c['verify_recoveries_total{direction="forward"}'] == 1
    assert [d["event"] for d in t.report()["degradations"]] == ["verify_demoted"] * 2


def test_a_transient_fault_heals_within_the_retry_budget(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_VERIFY_RETRIES", "4")
    trip, values, _ = problem()
    want = plan(tp, trip).backward(values)
    t = plan(tp, trip, verify="on")
    faults.reseed(7)
    with faults.inject("engine.execute=corrupt:0.5"):
        for _ in range(4):
            close(t.backward(values), want, 1e-12)
    assert obs.snapshot()["counters"].get('verify_retries_total{direction="backward"}', 0) > 0


def test_strict_raises_at_once_and_bypasses_an_open_breaker(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BREAKER_K", "1")
    trip, values, _ = problem()
    with faults.inject("engine.execute=corrupt"):
        plan(tp, trip, verify="on").backward(values)  # trips the xla breaker
        assert verify.breaker.describe("xla")["state"] == "open"
        with pytest.raises(tp.VerificationError, match="strict verification failed"):
            plan(tp, trip, verify="strict").backward(values)
    c = obs.snapshot()["counters"]
    assert c['verify_failures_total{direction="backward"}'] == 1
    assert int(tp.VerificationError("x").error_code) == 23


def test_breaker_trips_at_k_and_short_circuits(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BREAKER_K", "2")

    def drive(pkg, t, values, space):
        states = []
        for _ in range(3):
            t.backward(values)
            states.append(t.report()["verification"]["breaker"]["state"])
        return states

    (jstates, jc, jev, jt), (pstates, pc, pev, pt) = run_both(
        "engine.execute=corrupt", drive, verify="on")
    assert pstates == jstates == ["closed", "open", "open"]
    assert pc == jc and pev == jev and entries(pt) == entries(jt)
    assert [e[0] for e in entries(pt)] == ["verify_demoted"] * 2 + [
        "verify_breaker_open", "verify_demoted"]
    gauges = obs.snapshot()["gauges"]
    assert gauges['verify_breaker_state{engine="xla"}'] == 1
    verify.breaker.reset()
    assert obs.snapshot()["gauges"]['verify_breaker_state{engine="xla"}'] == 0


@pytest.mark.parametrize("heal", [True, False], ids=["heals", "reopens"])
def test_the_half_open_probe(monkeypatch, heal):
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BREAKER_K", "1")
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S", "0")
    seqs = []
    for v, f in ((jverify, jfaults), (verify, faults)):
        seq = []
        with f.inject("engine.execute=corrupt"):
            seq.append(v.breaker.allow("e"))
            v.breaker.record_failure("e")
            seq.append(v.breaker.describe("e")["state"])
            seq.append(v.breaker.allow("e"))  # cooldown 0: the probe
            seq.append(v.breaker.describe("e")["state"])
            seq.append(v.breaker.allow("e"))  # a second caller waits for the probe
            (v.breaker.record_success if heal else v.breaker.record_failure)("e")
            seq.append(v.breaker.describe("e"))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[1][:5] == [True, "open", True, "half_open", False]
    assert seqs[1][5]["state"] == ("closed" if heal else "open")


def test_backoff_and_jitter_streams_are_the_jax_packages(monkeypatch):
    import random

    for attempt in (1, 2, 5):
        assert faults.backoff_s(0.01, attempt) == jfaults.backoff_s(0.01, attempt)
    a, b = random.Random(4), random.Random(4)
    assert [faults.backoff_s(0.5, i, a) for i in range(1, 6)] == [
        jfaults.backoff_s(0.5, i, b) for i in range(1, 6)]
    monkeypatch.setenv("SPFFT_TPU_VERIFY_JITTER_SEED", "9")
    assert verify.jitter_rng().random() == jverify.jitter_rng().random()
    assert verify.resolve_retries() == 2 and verify.resolve_backoff_s() == 0.001


def test_verify_events_match_on_a_clean_pair():
    (_, jc, jev, _), (_, pc, pev, _) = run_both("", _pair, verify="on")
    assert pc == jc
    assert pev == jev and {e[1] for e in pev} == {"check"}


# ---- distributed plans, batches, cards, clones ----------------------------------------


def test_a_distributed_plan_recovers():
    trip, values, space = problem()
    per = tp.distribute_triplets(trip, 2, DIM)
    lut = {tuple(x): v for x, v in zip(map(tuple, trip), values)}
    vals = [np.asarray([lut[tuple(x)] for x in p]) for p in per]
    want = plan(spfft_tpu, trip).backward(values)
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                [np.array(p) for p in per], mesh=tp.make_fft_mesh(2, device="cpu"),
                                dtype=np.float64, verify="on")
    with faults.inject("engine.execute=corrupt"):
        close(t.backward(vals), want, 1e-12)
        back = t.forward(scaling=tp.ScalingType.FULL)
    for got, v in zip(back, vals):
        close(got, v, 1e-12)
    assert [d["event"] for d in t.report()["degradations"]] == ["verify_demoted"] * 2


def test_a_mesh_across_processes_rejects_verify(monkeypatch):
    import torch.distributed as dist

    from spfft_tpu_torch.parallel.mesh import ShardMesh

    trip, _, _ = problem()
    monkeypatch.setattr(dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group: 0)
    mesh = ShardMesh(torch.device("cpu"), 2, group=object())
    per = tp.distribute_triplets(trip, 4, DIM)
    with pytest.raises(tp.InvalidParameterError, match="every shard in this process"):
        tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per, mesh=mesh,
                                verify="on")


@pytest.mark.parametrize("mode", ["1", "on", "strict"])
def test_a_mesh_across_processes_rejects_the_verify_knob(monkeypatch, mode):
    """SPFFT_TPU_VERIFY set process-wide is refused as the argument is,
    naming the knob (it once reached the supervisor and an untyped
    TypeError at the first backward); set to off, the plan builds."""
    import torch.distributed as dist

    from spfft_tpu_torch.parallel.mesh import ShardMesh

    trip, _, _ = problem()
    monkeypatch.setattr(dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group: 0)
    mesh = ShardMesh(torch.device("cpu"), 2, group=object())
    per = tp.distribute_triplets(trip, 4, DIM)
    monkeypatch.setenv("SPFFT_TPU_VERIFY", mode)
    with pytest.raises(tp.InvalidParameterError,
                       match=f"SPFFT_TPU_VERIFY='{mode}' needs every shard in this process"):
        tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per, mesh=mesh)
    # an explicit verify="off" wins over the knob
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per, mesh=mesh,
                                verify="off")
    assert t._verifier is None


def test_verified_batches_run_each_request_under_the_supervisor():
    trip, values, space = problem()
    want = plan(tp, trip)
    t = plan(tp, trip, verify="on")
    with faults.inject("engine.execute=corrupt"):
        got = t.backward_batch([values, values])
        back = t.forward_batch([space, space])
    for g in got:
        close(g, want.backward(values), 1e-12)
    for g in back:
        close(g, want.forward(space), 1e-12)
    assert obs.snapshot()["counters"]['verify_recoveries_total{direction="backward"}'] == 2


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_the_card_passes_both_validators(r2c):
    trip, values, _ = problem(r2c)
    jt, pt = plan(spfft_tpu, trip, r2c, verify="on"), plan(tp, trip, r2c, verify="on")
    pcard = pt.report()
    assert obs.validate_plan_card(pcard) == [] == jplancard.validate_plan_card(pcard)
    assert pcard["verification"] == jt.report()["verification"]
    assert pcard["verification"]["checks"] == (["dc", "probe"] if r2c else
                                              ["dc", "parseval", "probe"])
    off = plan(tp, trip, r2c).report()["verification"]
    assert off == plan(spfft_tpu, trip, r2c).report()["verification"]


def test_clone_and_grid_keep_the_mode():
    trip, _, _ = problem()
    t = plan(tp, trip, verify="strict", guard=True)
    c = t.clone()
    assert c._verify_mode == "strict" and c._guard and c._verifier is not None
    grid = tp.Grid(DIM, DIM, DIM, DIM * DIM, tp.ProcessingUnit.HOST)
    g = grid.create_transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=trip,
                              verify="on", guard=True)
    assert g.report()["verification"]["mode"] == "on" and g._guard
