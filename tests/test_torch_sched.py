"""The port's task-graph scheduler (spfft_tpu_torch.sched) against the JAX
package's (spfft_tpu.sched).

The counterparts of the non-serving cases of ``tests/test_sched.py``: graph
semantics (the dependency kinds, cycles and dangling dependencies refused,
the retained-buffer edge), windows, placement with its provenance on the
plan card (model, tuned and reproducible from a warm store, pinned), and the
failure ladder under every kind of ``sched.place`` / ``sched.run`` fault. The
same graphs, built from a seed, run in both packages (plans on the CPU,
``engine="xla"`` in the JAX package); each task's result agrees with the JAX
package's solo result (1e-11, float64, relative to the largest value) and
its outcome is the JAX package's. Placement on the CPU names the CPU device
(``devices=[torch.device("cpu")]``); the default device list is every
visible CUDA device.
"""
import os

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import sched as jsched
from spfft_tpu import tuning as jtuning
from spfft_tpu import verify as jverify
from spfft_tpu_torch import errors, faults, obs, sched, tuning, verify

DIM = 8
BAR = 1e-11
CPU = [torch.device("cpu")]
FUZZ_SEED = int(os.environ.get("SPFFT_TPU_FUZZ_SEED", "0"))


@pytest.fixture(autouse=True)
def clean_sched(monkeypatch, tmp_path):
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        f.reseed(0)
        v.breaker.reset()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    for t in (tuning, jtuning):
        t.clear_memory()
    monkeypatch.setenv("SPFFT_TPU_WISDOM", str(tmp_path / "wisdom.json"))
    for knob in (sched.SCHED_INFLIGHT_ENV, "SPFFT_TPU_TUNE_CPU", "SPFFT_TPU_TUNE_REPEATS",
                 "SPFFT_TPU_TUNE_WARMUP", "SPFFT_TPU_POLICY", "SPFFT_TPU_FAULTS",
                 "SPFFT_TPU_GUARD", "SPFFT_TPU_VERIFY"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("SPFFT_TPU_VERIFY_BACKOFF_S", "0.001")
    monkeypatch.setenv("SPFFT_TPU_FAULTS_DELAY_S", "0.001")
    yield
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        v.breaker.reset()


def _triplets(dim=DIM, sparsity=0.9):
    return np.asarray(tp.create_spherical_cutoff_triplets(dim, dim, dim, sparsity))


def _plan(dim=DIM, trip=None, pkg=tp, **kw):
    trip = _triplets(dim) if trip is None else trip
    if pkg is spfft_tpu:
        kw.setdefault("engine", "xla")
    return pkg.Transform(pkg.ProcessingUnit.HOST, pkg.TransformType.C2C, dim, dim, dim,
                         indices=trip, **kw)


def _values(n, seed=0):
    rng = np.random.default_rng(FUZZ_SEED + seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _close(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= BAR * max(float(np.abs(want).max()), 1.0)


def _spec(trip, **kw):
    return {"transform_type": "C2C", "dims": (DIM,) * 3, "indices": trip, **kw}


def _both(build, run):
    """``build(pkg)`` -> a graph, ``run(pkg, graph)`` -> its report, in both
    packages: the two reports."""
    return [run(pkg, build(pkg)) for pkg in (tp, spfft_tpu)]


# ---- graph semantics --------------------------------------------------------------


def test_graph_rejects_cycles_and_dangling_deps():
    g = sched.TaskGraph()
    with pytest.raises(errors.InvalidParameterError):
        g.add("backward", after=["nope"], transform=_plan())
    t = _plan()
    a = g.add("backward", payload=_values(t.num_local_elements), transform=t)
    assert g.task(a).deps == ()
    with pytest.raises(errors.InvalidParameterError):
        g.add("sideways", transform=t)
    with pytest.raises(errors.InvalidParameterError):
        g.add("backward", id=a, transform=t)
    g2 = sched.TaskGraph()
    t2 = _plan()
    x = g2.add("backward", payload=_values(t2.num_local_elements), transform=t2)
    y = g2.add("forward", transform=t2)
    g2.task(x).deps = (y,)
    with pytest.raises(errors.InvalidParameterError, match="cycle"):
        g2.order()
    with pytest.raises(errors.InvalidParameterError, match="cycle"):
        sched.run_graph(g2)


def test_graph_requires_exactly_one_plan_source():
    g = sched.TaskGraph()
    with pytest.raises(errors.InvalidParameterError):
        g.add("backward")
    with pytest.raises(errors.InvalidParameterError):
        g.add("backward", transform=_plan(), spec=_spec(_triplets()))
    with pytest.raises(errors.InvalidParameterError, match="forward"):
        g.add("forward", spec=_spec(_triplets()))
    with pytest.raises(errors.InvalidParameterError, match="batch"):
        g.add("backward", spec=_spec(_triplets()), payload=[1], batch=True)
    with pytest.raises(errors.InvalidParameterError, match="list payload"):
        g.add("backward", transform=_plan(), payload=[], batch=True)


def test_retained_buffer_constraint_serializes_shared_plans():
    g = sched.TaskGraph()
    t = _plan()
    vals = _values(t.num_local_elements)
    b = g.add("backward", payload=vals, transform=t)
    f = g.add("forward", scaling=tp.ScalingType.FULL, transform=t)
    assert b in g.task(f).deps and g.depth() == 2
    _close(sched.run_graph(g).result(f), vals)


def test_flat_batch_matches_solo_results():
    trip = _triplets()
    plans = [_plan(trip=trip) for _ in range(5)]
    vals = [_values(p.num_local_elements, seed=i) for i, p in enumerate(plans)]
    outs = sched.run_tasks(plans, "backward", vals)
    for v, out in zip(vals, outs):
        _close(out, _plan(trip=trip, pkg=spfft_tpu).backward(v))
    assert obs.snapshot()["gauges"]["sched_graph_depth"] == 1


def test_cross_plan_dependency_chain():
    trip = _triplets()
    t1, t2 = _plan(trip=trip), _plan(trip=trip)
    vals = _values(t1.num_local_elements)
    g = sched.TaskGraph()
    b = g.add("backward", payload=vals, transform=t1)
    f = g.add("forward", scaling=tp.ScalingType.FULL, transform=t2, input_from=b)
    report = sched.run_graph(g)
    assert report.outcomes == {b: "completed", f: "completed"}
    _close(report.result(f), vals)


def test_run_tasks_validates_lengths():
    plans = [_plan()]
    with pytest.raises(errors.InvalidParameterError):
        sched.run_tasks(plans, "backward", [])
    with pytest.raises(errors.InvalidParameterError):
        sched.run_tasks(plans, ["backward", "forward"], [None])
    with pytest.raises(errors.InvalidParameterError):
        sched.run_tasks(plans, "backward", [None], scalings=[])


def test_inflight_env_knob_validation(monkeypatch):
    monkeypatch.setenv(sched.SCHED_INFLIGHT_ENV, "not-a-number")
    with pytest.raises(errors.InvalidParameterError):
        sched.resolve_inflight()
    monkeypatch.setenv(sched.SCHED_INFLIGHT_ENV, "3")
    assert sched.resolve_inflight() == 3 == jsched.resolve_inflight(3)
    assert sched.resolve_inflight(1) == 1 and sched.resolve_inflight(0) == 1
    monkeypatch.delenv(sched.SCHED_INFLIGHT_ENV)
    assert sched.resolve_inflight() == sched.DEFAULT_INFLIGHT == jsched.DEFAULT_INFLIGHT == 8
    assert sched.OUTCOMES == jsched.OUTCOMES


# ---- windows, mixed graphs ----------------------------------------------------------


@pytest.mark.parametrize("inflight", [1, 2, 7])
def test_window_sizes_preserve_results(inflight):
    trip = _triplets()
    plans = [_plan(trip=trip) for _ in range(5)]
    vals = [_values(p.num_local_elements, seed=i) for i, p in enumerate(plans)]
    want = [_plan(trip=trip, pkg=spfft_tpu).backward(v) for v in vals]
    for got, w in zip(sched.run_tasks(plans, "backward", vals, max_inflight=inflight), want):
        _close(got, w)


def _mixed_graph(pkg):
    """Three geometries, each a backward and its forward, and one forward of
    a given space (both packages, the same seeds)."""
    rng = np.random.default_rng(FUZZ_SEED + 11)
    g = pkg.sched.TaskGraph()
    for i, dim in enumerate((4, 8, 6)):
        t = _plan(dim, pkg=pkg)
        vals = _values(t.num_local_elements, seed=20 + i)
        g.add("backward", payload=vals, transform=t, id=f"b{dim}")
        g.add("forward", scaling=pkg.ScalingType.FULL, transform=t, id=f"f{dim}")
    space = rng.standard_normal((4, 4, 4)) + 1j * rng.standard_normal((4, 4, 4))
    g.add("forward", payload=space, transform=_plan(4, pkg=pkg), id="solo-fwd")
    return g


def test_mixed_direction_mixed_geometry_graph():
    """Each task's result is the JAX package's solo result of it."""
    port = sched.run_graph(_mixed_graph(tp), max_inflight=3)
    assert set(port.outcomes.values()) == {"completed"}
    rng = np.random.default_rng(FUZZ_SEED + 11)
    for i, dim in enumerate((4, 8, 6)):
        solo = _plan(dim, pkg=spfft_tpu)
        vals = _values(solo.num_local_elements, seed=20 + i)
        _close(port.result(f"b{dim}"), solo.backward(vals))
        _close(port.result(f"f{dim}"), solo.forward(scaling=spfft_tpu.ScalingType.FULL))
    space = rng.standard_normal((4, 4, 4)) + 1j * rng.standard_normal((4, 4, 4))
    _close(port.result("solo-fwd"), _plan(4, pkg=spfft_tpu).forward(space.copy()))
    jax = jsched.run_graph(_mixed_graph(spfft_tpu), max_inflight=3)
    assert port.outcomes == jax.outcomes
    assert port.describe()["outcomes"] == jax.describe()["outcomes"] == {"completed": 7}


def test_batch_tasks_run_one_batched_dispatch():
    from spfft_tpu_torch import ir

    trip = _triplets()
    t = _plan(trip=trip)
    vals = [_values(t.num_local_elements, seed=i) for i in range(3)]
    g = sched.TaskGraph()
    b = g.add("backward", payload=vals, transform=t, batch=True)
    ir.dispatches.clear()
    out = sched.run_graph(g).result(b)
    assert ir.dispatches[("batched", "backward")] == 1
    for got, v in zip(out, vals):
        _close(got, _plan(trip=trip, pkg=spfft_tpu).backward(v))


# ---- placement ------------------------------------------------------------------------


def test_model_placement_round_robins_and_stamps_cards():
    trip = _triplets()
    vals = _values(len(trip))
    g = sched.TaskGraph()
    ids = [g.add("backward", payload=vals, spec=_spec(trip), id=f"s{i}") for i in range(4)]
    pool = sched.PlanPool()
    report = sched.run_graph(g, pool=pool, devices=CPU)
    assert report.placement["provenance"] == "model"
    assert report.placement["reason"] == "policy='default': model placement (round-robin)"
    assert len(pool) == 1 and {id(g.task(t).plan) for t in ids} == {id(g.task(ids[0]).plan)}
    card = g.task(ids[0]).plan.report()
    assert obs.validate_plan_card(card) == []
    assert card["placement"]["provenance"] == "model" and card["placement"]["hit"] is False
    assert card["placement"]["device"] == "cpu" and card["placement"]["device_index"] == 0
    want = _plan(trip=trip, pkg=spfft_tpu).backward(vals)
    for tid in ids:
        _close(report.result(tid), want)


def test_placement_needs_a_device():
    g = sched.TaskGraph()
    g.add("backward", payload=_values(10), spec=_spec(_triplets()))
    if not torch.cuda.is_available():
        with pytest.raises(errors.InvalidParameterError, match="at least one device"):
            sched.run_graph(g)
    with pytest.raises(errors.InvalidParameterError, match="at least one device"):
        sched.run_graph(g, devices=[])


def test_tuned_placement_is_reproducible_from_warm_store(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_TUNE_CPU", "1")
    monkeypatch.setenv("SPFFT_TPU_TUNE_REPEATS", "1")
    trip = _triplets()
    vals = _values(len(trip))

    def make_graph():
        g = sched.TaskGraph()
        for i in range(4):
            g.add("backward", payload=vals, spec=_spec(trip), id=f"s{i}")
        return g

    pool = sched.PlanPool()
    r1 = sched.run_graph(make_graph(), pool=pool, policy="tuned", devices=CPU)
    assert r1.placement["provenance"] == "wisdom" and r1.placement["hit"] is False
    assert [row["label"] for row in r1.placement["trials"]] == ["rr1"]
    trials = sum(v for k, v in obs.snapshot()["counters"].items()
                 if k.startswith("tuning_trials_total"))
    g2 = make_graph()
    r2 = sched.run_graph(g2, pool=pool, policy="tuned", devices=CPU)
    assert r2.placement["hit"] is True and r2.placement["choice"] == r1.placement["choice"]
    assert trials == sum(v for k, v in obs.snapshot()["counters"].items()
                         if k.startswith("tuning_trials_total"))
    card = g2.task("s0").plan.report()
    assert obs.validate_plan_card(card) == []
    assert card["placement"]["provenance"] == "wisdom" and card["placement"]["hit"] is True


def test_a_kernel_error_in_a_placement_trial_raises(monkeypatch, tmp_path):
    """A K1 launch failure inside a placement trial raises out of
    run_graph, and the width is not persisted."""
    from spfft_tpu_torch.ops import fft as pfft

    monkeypatch.setenv("SPFFT_TPU_TUNE_CPU", "1")
    monkeypatch.setenv("SPFFT_TPU_TUNE_REPEATS", "1")

    def broken(*args, **kwargs):
        raise errors.GPULaunchError("synthetic kernel failure")

    monkeypatch.setattr(pfft, "complex_matmul", broken)
    trip = _triplets()
    g = sched.TaskGraph()
    g.add("backward", payload=_values(len(trip)), spec=_spec(trip, engine="mxu"))
    with pytest.raises(errors.GPULaunchError, match="synthetic kernel failure"):
        sched.run_graph(g, policy="tuned", devices=CPU)
    wisdom = tmp_path / "wisdom.json"
    assert not wisdom.exists() or tuning.WisdomStore(str(wisdom)).entries() == {}


def test_cpu_only_tuned_placement_falls_back_to_model():
    g = sched.TaskGraph()
    trip = _triplets()
    g.add("backward", payload=_values(len(trip)), spec=_spec(trip))
    report = sched.run_graph(g, policy="tuned", devices=CPU)
    assert report.placement["provenance"] == "model"
    assert "trials skipped" in report.placement["reason"]


def test_pinned_width_wins_outright():
    trip = _triplets()
    vals = _values(len(trip))
    g = sched.TaskGraph()
    ids = [g.add("backward", payload=vals, spec=_spec(trip), id=f"s{i}") for i in range(3)]
    report = sched.run_graph(g, width=4, devices=CPU)
    assert report.placement["provenance"] == "pinned"
    assert report.placement["choice"] == {"label": "rr1", "width": 1}
    assert report.placement["reason"] == "explicit width (clamped from 4)"
    assert {str(g.task(t).plan.device) for t in ids} == {"cpu"}


def test_workload_key_names_the_device_and_the_software():
    trip = _triplets()
    g = sched.TaskGraph()
    g.add("backward", payload=_values(len(trip)), spec=_spec(trip))
    g.add("backward", payload=_values(len(trip)), spec=_spec(trip))
    key = sched.workload_key(g, 1, torch.device("cpu"))
    assert key["kind"] == "sched" and key["tasks"] == 2 and key["pinned_tasks"] == 0
    assert len(key["workload"]) == 1 and key["workload"][0][1] == 2
    assert {k: key[k] for k in ("platform", "torch", "device_name")} == {
        "platform": "cpu", "torch": torch.__version__, "device_name": "cpu"}


# ---- the failure ladder, against the JAX package's outcomes --------------------------


def test_failed_task_demotes_without_stalling_graph():
    trip = _triplets()
    vals = _values(len(trip))

    def build(pkg):
        g = pkg.sched.TaskGraph()
        g.add("backward", payload=vals, transform=_plan(trip=trip, pkg=pkg), id="t")
        return g

    with faults.inject("sched.run=raise:1.0"), jfaults.inject("sched.run=raise:1.0"):
        port, jax = _both(build, lambda pkg, g: pkg.sched.run_graph(g))
    assert port.outcomes == jax.outcomes == {"t": "demoted"}
    _close(port.result("t"), jax.result("t"))
    assert obs.snapshot()["counters"]['sched_tasks_total{outcome="demoted"}'] == 1


def test_failed_task_without_demotion_resolves_typed_and_cascades():
    trip = _triplets()
    vals = _values(len(trip))

    def build(pkg):
        g = pkg.sched.TaskGraph()
        b = g.add("backward", payload=vals, transform=_plan(trip=trip, pkg=pkg), id="b")
        g.add("forward", scaling=pkg.ScalingType.FULL, transform=_plan(trip=trip, pkg=pkg),
              input_from=b, id="f")
        return g

    with faults.inject("sched.run=raise:1.0"), jfaults.inject("sched.run=raise:1.0"):
        port, jax = _both(build, lambda pkg, g: pkg.sched.run_graph(g, demote=False,
                                                                    retries=0))
    assert port.outcomes == jax.outcomes == {"b": "failed", "f": "upstream_failed"}
    assert isinstance(port.errors["b"], errors.HostExecutionError)
    assert type(port.errors["b"]).__name__ == type(jax.errors["b"]).__name__
    with pytest.raises(errors.HostExecutionError, match="upstream"):
        port.result("f")
    _close(sched.run_tasks([_plan(trip=trip)], "backward", [vals])[0],
           _plan(trip=trip, pkg=spfft_tpu).backward(vals))


def test_retry_rung_heals_transient_faults():
    trip = _triplets()
    vals = [_values(len(trip), seed=i) for i in range(6)]

    def build(pkg):
        g = pkg.sched.TaskGraph()
        for i, v in enumerate(vals):
            g.add("backward", payload=v, transform=_plan(trip=trip, pkg=pkg), id=f"t{i}")
        return g

    def run(pkg, g):
        (faults if pkg is tp else jfaults).reseed(FUZZ_SEED)
        with (faults if pkg is tp else jfaults).inject("sched.run=raise:0.5"):
            return pkg.sched.run_graph(g, retries=2)

    port, jax = _both(build, run)
    assert port.outcomes == jax.outcomes
    for i, v in enumerate(vals):
        assert port.outcomes[f"t{i}"] in ("completed", "demoted")
        _close(port.result(f"t{i}"), _plan(trip=trip, pkg=spfft_tpu).backward(v))


@pytest.mark.parametrize("site", ["sched.place", "sched.run"])
@pytest.mark.parametrize("kind", ["raise", "nan", "corrupt", "delay"])
def test_chaos_every_site_every_kind(site, kind):
    """Every site and kind at rate 1.0: each task completes with its JAX
    result through a recorded rung or resolves typed, with the JAX package's
    outcome; the graph always ends. nan and corrupt poison the in-flight
    result, which the guard (on in those plans) catches at finalize."""
    guard = kind in ("nan", "corrupt")
    trip = _triplets()
    vals = [_values(len(trip), seed=i) for i in range(3)]

    def build(pkg):
        g = pkg.sched.TaskGraph()
        for i, v in enumerate(vals):
            g.add("backward", payload=v, transform=_plan(trip=trip, pkg=pkg, guard=guard),
                  id=f"t{i}")
        g.add("backward", payload=vals[0], id="placed",
              spec=_spec(trip, guard=guard, **({} if pkg is tp else {"engine": "xla"})))
        return g

    def run(pkg, g):
        f = faults if pkg is tp else jfaults
        with f.inject(f"{site}={kind}:1.0"):
            kw = {"devices": CPU} if pkg is tp else {}
            return pkg.sched.run_graph(g, retries=1, **kw)

    port, jax = _both(build, run)
    assert port.outcomes == jax.outcomes
    for tid, v in zip(["t0", "t1", "t2", "placed"], vals + vals[:1]):
        if port.outcomes[tid] in ("completed", "demoted"):
            _close(port.result(tid), _plan(trip=trip, pkg=spfft_tpu).backward(v))
        else:
            assert isinstance(port.errors[tid], errors.GenericError)
            assert type(port.errors[tid]).__name__ == type(jax.errors[tid]).__name__
    if kind == "raise":
        assert any(k.startswith("faults_injected_total") for k in obs.snapshot()["counters"])


def test_auto_ids_never_collide_with_caller_ids():
    g = sched.TaskGraph()
    t = _plan()
    vals = _values(t.num_local_elements)
    a = g.add("backward", payload=vals, transform=t)
    g.add("backward", id="t2", payload=vals, transform=t)
    b = g.add("backward", payload=vals, transform=t)
    c = g.add("backward", payload=vals, transform=t)
    assert len({a, "t2", b, c}) == 4


def test_expired_task_resolves_typed_without_dispatch():
    import time as _time

    trip = _triplets()
    vals = _values(len(trip))
    g = sched.TaskGraph()
    ok = g.add("backward", payload=vals, transform=_plan(trip=trip))
    late = g.add("backward", payload=vals, transform=_plan(trip=trip),
                 deadline=_time.monotonic() - 0.001)
    report = sched.run_graph(g)
    assert report.outcomes[ok] == "completed" and report.outcomes[late] == "failed"
    assert isinstance(report.errors[late], errors.DeadlineExceededError)
    assert g.task(late).attempts == 0


def test_non_retryable_typed_failure_resolves_task_not_graph():
    trip = _triplets()
    vals = _values(len(trip))
    g = sched.TaskGraph()
    okid = g.add("backward", payload=vals, transform=_plan(trip=trip))
    badid = g.add("backward", payload=vals[:3], transform=_plan(trip=trip))
    report = sched.run_graph(g, retries=2)
    assert report.outcomes == {okid: "completed", badid: "failed"}
    assert isinstance(report.errors[badid], errors.InvalidParameterError)
    assert g.task(badid).attempts == 1
    _close(report.result(okid), _plan(trip=trip, pkg=spfft_tpu).backward(vals))


def test_place_fault_degrades_to_model_placement():
    trip = _triplets()
    vals = _values(len(trip))
    with faults.inject("sched.place=raise:1.0"):
        g = sched.TaskGraph()
        tid = g.add("backward", payload=vals, spec=_spec(trip))
        report = sched.run_graph(g, devices=CPU)
    assert report.placement["provenance"] == "model"
    assert "placement fault" in report.placement["reason"]
    _close(report.result(tid), _plan(trip=trip, pkg=spfft_tpu).backward(vals))
    assert obs.snapshot()["counters"]['degradations_total{event="sched_place_failed"}'] == 1


def test_supervised_plans_execute_under_their_supervisor():
    trip = _triplets()
    t = _plan(trip=trip, verify="on")
    vals = _values(t.num_local_elements)
    with faults.inject("engine.execute=corrupt:1.0"):
        outs = sched.run_tasks([t], "backward", [vals])
    _close(outs[0], _plan(trip=trip, pkg=spfft_tpu).backward(vals))
    assert sum(v for k, v in obs.snapshot()["counters"].items()
               if k.startswith("verify_recoveries_total")) > 0


class _Remote:
    """A plan with a ``rehost()`` hook whose host is lost ``lost`` times."""

    def __init__(self, plan, lost):
        self._plan, self.lost, self.moves = plan, lost, 0

    def __getattr__(self, name):
        return getattr(self._plan, name)

    def _dispatch_backward(self, values):
        if self.moves < self.lost:
            raise errors.HostLostError("host gone")
        return self._plan._dispatch_backward(values)

    def rehost(self, error):
        self.moves += 1


@pytest.mark.parametrize("lost, outcome", [(1, "completed"), (5, "host_lost")])
def test_the_rehost_rung_moves_a_task_or_resolves_host_lost(lost, outcome):
    trip = _triplets()
    vals = _values(len(trip))
    g = sched.TaskGraph()
    remote = _Remote(_plan(trip=trip), lost)
    tid = g.add("backward", payload=vals, transform=remote)
    dep = g.add("forward", payload=np.zeros((DIM,) * 3, complex), transform=_plan(trip=trip),
                after=[tid])
    report = sched.run_graph(g, host_retries=2, host_backoff_s=0.0)
    assert report.outcomes[tid] == outcome
    if outcome == "completed":
        assert remote.moves == 1 and report.outcomes[dep] == "completed"
        _close(report.result(tid), _plan(trip=trip, pkg=spfft_tpu).backward(vals))
    else:
        assert remote.moves == 2 and report.outcomes[dep] == "upstream_failed"
        assert isinstance(report.errors[tid], errors.HostLostError)


# ---- observability --------------------------------------------------------------------


def test_metrics_and_trace_exposure():
    obs.trace.enable()
    try:
        trip = _triplets()
        plans = [_plan(trip=trip) for _ in range(3)]
        vals = [_values(p.num_local_elements, seed=i) for i, p in enumerate(plans)]
        sched.run_tasks(plans, "backward", vals)
        snap = obs.snapshot()
        assert snap["counters"]['sched_tasks_total{outcome="completed"}'] == 3
        assert snap["gauges"]["sched_inflight"] == 0
        assert snap["gauges"]["sched_graph_depth"] == 1
        whats = {e["args"].get("what") for e in obs.trace.snapshot()["events"]
                 if e["name"] == "sched"}
        assert {"graph", "dispatch", "finalize"} <= whats
    finally:
        obs.trace.disable()
        obs.trace.clear()


def test_graph_report_describe_is_json_plain():
    import json

    t = _plan()
    g = sched.TaskGraph()
    g.add("backward", payload=_values(t.num_local_elements), transform=t)
    report = sched.run_graph(g)
    doc = report.describe()
    json.dumps(doc)
    assert doc["tasks"] == 1 and doc["depth"] == 1 and doc["outcomes"] == {"completed": 1}
    json.dumps(g.describe())


def test_the_gbench_program_runs_both_modes_bitwise():
    from spfft_tpu_torch.programs import gbench

    doc, serial, graph = gbench.main(["--cpu", "--dims", "6", "8", "--tasks", "2",
                                      "--repeats", "1"])
    assert [row["key"].rsplit(":", 1)[1] for row in doc["rows"]] == ["serial", "sched"]
    assert doc["rows"][1]["tasks"] == 8 and doc["platform"] == "cpu"
    for tid, result in serial.items():
        assert torch.equal(graph.task(tid).result, result)
