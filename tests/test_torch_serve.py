"""The port's serving layer (spfft_tpu_torch.serve) against the JAX package's.

Two halves. Parity: the same seeded triplets and values go through the JAX
``TransformService(engine="xla")`` and the port's service on
``ProcessingUnit.HOST`` with ``engine="xla"`` and ``engine="mxu"`` (the
kernels' plain versions); C2C and R2C, backward and forward, three requests
coalesced across value orders. Bars, relative to the largest value of the
JAX result: 1e-12 in float64, 1e-5 in float32.

The rest are the counterparts of the non-slow cases of ``tests/test_serve.py``
and the serve cases of ``tests/test_sched.py``: admission (backpressure,
quota, fair share, deadlines at admission and before dispatch), coalescing
with per-caller value orders, the plan cache, retry with jitter, the
breaker's shed-or-demote ladder, verified serving under corruption, the
chaos invariant on every ``serve.*`` site, lifecycle, the metrics and trace
exposure, ticket timelines, and the graph-scheduled mode. Results are
tensors on the plan's device (the CPU here); the serving modules import
neither ``jax`` nor ``spfft_tpu``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import spfft_tpu as jsp
import spfft_tpu_torch as sp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import verify as jverify
from spfft_tpu_torch import (
    ProcessingUnit,
    ScalingType,
    Transform,
    TransformType,
    errors,
    faults,
    obs,
    serve,
    verify,
)
from spfft_tpu_torch.parallel.ragged import value_order_map
from utils import assert_close

DIM = 8
DIMS = (DIM, DIM, DIM)
HOST = ProcessingUnit.HOST
BARS = {np.float64: 1e-12, np.float32: 1e-5}
ROOT = Path(__file__).resolve().parent.parent

SERVE_ENV_KNOBS = (
    serve.SERVE_QUEUE_CAP_ENV,
    serve.SERVE_BATCH_MAX_ENV,
    serve.SERVE_TENANT_QUOTA_ENV,
    serve.SERVE_TIMEOUT_ENV,
    serve.SERVE_RETRIES_ENV,
    serve.SERVE_BACKOFF_ENV,
    serve.SERVE_ON_BREAKER_ENV,
    serve.SERVE_PLANS_ENV,
    serve.SERVE_SCHED_ENV,
    "SPFFT_TPU_BATCH_FUSE",
)


@pytest.fixture(autouse=True)
def clean_serve(monkeypatch):
    """Serving state never leaks between tests: faults disarmed, breakers
    and metrics reset, the serve knobs scrubbed (both packages)."""
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        f.reseed(0)
        v.breaker.reset()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    for knob in SERVE_ENV_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    yield
    for f, v in ((faults, verify), (jfaults, jverify)):
        f.disarm()
        v.breaker.reset()


def _triplets(dim=DIM, frac=0.8):
    return sp.create_spherical_cutoff_triplets(dim, dim, dim, frac)


def _values(trip, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))


def _expect_backward(trip, values):
    return Transform(HOST, TransformType.C2C, DIM, DIM, DIM, indices=trip).backward(values)


def _service(**kw):
    kw.setdefault("start", False)
    kw.setdefault("queue_capacity", 16)
    kw.setdefault("batch_max", 4)
    return serve.TransformService(HOST, **kw)


def _counter_sum(snapshot_counters, prefix):
    return sum(v for k, v in snapshot_counters.items() if k.startswith(prefix))


# ---- parity with the JAX service -------------------------------------------------


def _problem(r2c, seed=11):
    """Triplets, values and a space of one geometry; R2C values are a real
    field's half spectrum, so both directions are exact transforms."""
    rng = np.random.default_rng(seed)
    trip = np.asarray(sp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8,
                                                          hermitian_symmetry=r2c))
    field = rng.standard_normal((DIM,) * 3)
    if r2c:
        spec = np.fft.fftn(field) / DIM ** 3
        values = spec[trip[:, 2] % DIM, trip[:, 1] % DIM, trip[:, 0] % DIM]
        space = field
    else:
        values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
        space = field + 1j * rng.standard_normal((DIM,) * 3)
    return trip, values, space


def _drive(svc, ttype, trip, values, space):
    """Three backward and three forward requests in three value orders;
    each direction coalesces into one batch. Returns the six results."""
    perms = [np.arange(len(trip))] + [np.random.default_rng(s).permutation(len(trip))
                                      for s in (1, 2)]
    tickets = [svc.submit(ttype, DIMS, trip[p], values[p]) for p in perms]
    tickets += [svc.submit(ttype, DIMS, trip[p], space, direction="forward",
                           scaling=ScalingType.FULL) for p in perms]
    assert svc.pump() == 2  # one coalesced batch per direction
    return [np.asarray(t.result(timeout=30)) for t in tickets]


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("ttype", [TransformType.C2C, TransformType.R2C], ids=["c2c", "r2c"])
def test_service_matches_the_jax_service(ttype, dtype, engine):
    trip, values, space = _problem(ttype == TransformType.R2C)
    with jsp.serve.TransformService(dtype=dtype, engine="xla", start=False,
                                    queue_capacity=16, batch_max=4) as jsvc:
        want = _drive(jsvc, jsp.TransformType(int(ttype)), trip, values, space)
    with _service(dtype=dtype, engine=engine) as svc:
        got = _drive(svc, ttype, trip, values, space)
        assert svc.describe()["plan_cache"][0]["engine"] == engine
    bar = BARS[dtype]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


def test_serving_modules_import_neither_jax_nor_the_jax_package():
    files = [*(ROOT / "spfft_tpu_torch" / "serve").glob("*.py"),
             ROOT / "spfft_tpu_torch" / "hostmesh.py",
             ROOT / "spfft_tpu_torch" / "obs" / "fleet.py",
             *(ROOT / "spfft_tpu_torch" / "programs" / f"{n}.py"
               for n in ("serve_worker", "loadgen", "fleetstat", "multihost_smoke"))]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|spfft_tpu)(\.|\s|$)", re.M)
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_service_defaults_to_the_card():
    """No CUDA device here: the default processing unit refuses typed, it
    never serves on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(errors.GPUNoDeviceError):
        serve.TransformService(start=False)


def test_dtype_none_is_float64_and_results_are_tensors():
    trip = _triplets()
    values = _values(trip)
    with _service() as svc:
        tk = svc.submit(TransformType.C2C, DIMS, trip, values)
        svc.pump()
        out = tk.result(timeout=10)
        assert torch.is_tensor(out) and out.dtype == torch.complex128
        assert out.device.type == "cpu"
        key = svc.plans.key(TransformType.C2C, DIMS, serve.canonical_triplets(trip, DIMS),
                            dtype=np.float64, precision="highest", engine="auto",
                            platform="cpu")[0]
        assert svc.plans.get(key) is not None


def test_as_typed_picks_the_platforms_error():
    assert isinstance(serve.as_typed(RuntimeError("x"), "gpu"), errors.GPUFFTError)
    assert isinstance(serve.as_typed(RuntimeError("x"), "cpu"), errors.HostExecutionError)
    e = errors.ServiceOverloadError("full")
    assert serve.as_typed(e, "gpu") is e
    assert serve.OUTCOMES == jsp.serve.OUTCOMES
    assert serve.SHED_REASONS == jsp.serve.SHED_REASONS


def test_tensor_payloads_are_served():
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    perm = np.random.default_rng(3).permutation(len(trip))
    with _service() as svc:
        tb = svc.submit(TransformType.C2C, DIMS, trip[perm], torch.as_tensor(values[perm]))
        tf = svc.submit(TransformType.C2C, DIMS, trip[perm], expect, direction="forward",
                        scaling=ScalingType.FULL)
        svc.pump()
        assert_close(tb.result(timeout=10), expect)
        assert_close(tf.result(timeout=10), values[perm])


# ---- coalescing and parity ---------------------------------------------------


def test_coalesced_backward_parity_across_value_orders():
    """Requests sharing a stick layout but packing values in different
    orders coalesce into ONE batch and each gets its own correct result."""
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    rng = np.random.default_rng(3)
    perm = rng.permutation(len(trip))
    svc = _service()
    t1 = svc.submit(TransformType.C2C, DIMS, trip, values, tenant="a")
    t2 = svc.submit(TransformType.C2C, DIMS, trip[perm], values[perm], tenant="b")
    t3 = svc.submit(TransformType.C2C, DIMS, trip, values, tenant="a")
    assert svc.pump() == 1  # one coalesced batch, not three
    for t in (t1, t2, t3):
        assert_close(t.result(timeout=10), expect)
    snap = obs.snapshot()
    occ = snap["histograms"]["serve_batch_occupancy"]
    assert occ["count"] == 1 and occ["sum"] == 3.0
    svc.close()


def test_forward_results_return_in_caller_order():
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    rng = np.random.default_rng(4)
    perm = rng.permutation(len(trip))
    svc = _service()
    tk = svc.submit(
        TransformType.C2C, DIMS, trip[perm], expect, direction="forward",
        scaling=ScalingType.FULL,
    )
    svc.pump()
    assert_close(tk.result(timeout=10), values[perm])
    svc.close()


def test_centered_and_wrapped_indexing_share_a_plan():
    trip = _triplets()
    wrapped = serve.wrap_triplets(trip, DIMS)
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = _service()
    t1 = svc.submit(TransformType.C2C, DIMS, trip, values)
    t2 = svc.submit(TransformType.C2C, DIMS, wrapped, values)
    assert svc.pump() == 1
    assert_close(t1.result(timeout=10), expect)
    assert_close(t2.result(timeout=10), expect)
    assert svc.stats()["plan_cache_entries"] == 1
    svc.close()


def test_plan_cache_hit_miss_and_eviction_counts():
    trip_a = _triplets(frac=0.8)
    trip_b = _triplets(frac=0.5)
    values_a, values_b = _values(trip_a), _values(trip_b)
    svc = _service(plan_cache_size=1)
    svc.submit(TransformType.C2C, DIMS, trip_a, values_a)
    svc.submit(TransformType.C2C, DIMS, trip_a, values_a)
    svc.submit(TransformType.C2C, DIMS, trip_b, values_b)  # evicts trip_a
    svc.pump()
    counters = obs.snapshot()["counters"]
    assert counters['serve_plan_cache_total{event="miss"}'] == 2
    assert counters['serve_plan_cache_total{event="hit"}'] == 1
    assert counters['serve_plan_cache_total{event="evict"}'] == 1
    assert svc.stats()["plan_cache_entries"] == 1
    svc.close()


def test_distinct_geometries_do_not_coalesce():
    trip_a = _triplets(frac=0.8)
    trip_b = _triplets(frac=0.5)
    svc = _service()
    ta = svc.submit(TransformType.C2C, DIMS, trip_a, _values(trip_a))
    tb = svc.submit(TransformType.C2C, DIMS, trip_b, _values(trip_b))
    assert svc.pump() == 2  # two batches: the geometries differ
    assert ta.outcome == "completed" and tb.outcome == "completed"
    svc.close()


def test_value_order_map_identity_permutation_and_mismatch():
    trip = np.asarray(_triplets(), dtype=np.int64).reshape(-1, 3) % DIM
    ident = value_order_map(trip, trip)
    assert np.array_equal(ident, np.arange(len(trip)))
    perm = np.random.default_rng(5).permutation(len(trip))
    src = value_order_map(trip, trip[perm])
    values = _values(trip)
    assert np.allclose(values[perm][src], values)
    assert value_order_map(trip, trip[: len(trip) - 1]) is None


# ---- admission: backpressure, quotas, deadlines ------------------------------


def test_bounded_queue_rejects_typed_when_full():
    trip = _triplets()
    values = _values(trip)
    svc = _service(queue_capacity=3, tenant_quota=1.0)
    for _ in range(3):
        svc.submit(TransformType.C2C, DIMS, trip, values, tenant="a")
    with pytest.raises(errors.ServiceOverloadError):
        svc.submit(TransformType.C2C, DIMS, trip, values, tenant="a")
    assert svc.queue.depth() == 3  # bounded: the refusal did not enqueue
    svc.close(drain=False)


def test_tenant_quota_rejects_before_queue_full():
    trip = _triplets()
    values = _values(trip)
    svc = _service(queue_capacity=10, tenant_quota=0.2)  # 2 slots/tenant
    svc.submit(TransformType.C2C, DIMS, trip, values, tenant="noisy")
    svc.submit(TransformType.C2C, DIMS, trip, values, tenant="noisy")
    with pytest.raises(errors.ServiceOverloadError):
        svc.submit(TransformType.C2C, DIMS, trip, values, tenant="noisy")
    svc.submit(TransformType.C2C, DIMS, trip, values, tenant="quiet")
    svc.close(drain=False)


def test_fair_share_shed_protects_quiet_tenant():
    trip = _triplets()
    values = _values(trip)
    svc = _service(queue_capacity=4, tenant_quota=1.0)
    noisy = [
        svc.submit(TransformType.C2C, DIMS, trip, values, tenant="noisy")
        for _ in range(4)
    ]
    quiet = svc.submit(TransformType.C2C, DIMS, trip, values, tenant="quiet")
    assert noisy[-1].done() and noisy[-1].outcome == "shed"
    with pytest.raises(errors.ServiceOverloadError):
        noisy[-1].result(timeout=0)
    assert svc.queue.depth() == 4  # still bounded
    svc.pump()
    assert quiet.outcome == "completed"
    counters = obs.snapshot()["counters"]
    assert counters['serve_sheds_total{reason="fair_share"}'] == 1
    svc.close()


def test_expired_deadline_refused_at_admission():
    trip = _triplets()
    svc = _service()
    with pytest.raises(errors.DeadlineExceededError):
        svc.submit(TransformType.C2C, DIMS, trip, _values(trip), timeout_s=1e-9)
    svc.close()


def test_deadline_shed_pre_dispatch():
    import time

    trip = _triplets()
    values = _values(trip)
    svc = _service()
    ok = svc.submit(TransformType.C2C, DIMS, trip, values)
    doomed = svc.submit(TransformType.C2C, DIMS, trip, values, timeout_s=0.005, tenant="late")
    time.sleep(0.02)
    svc.pump()
    assert ok.outcome == "completed"
    assert doomed.outcome == "deadline_miss"
    with pytest.raises(errors.DeadlineExceededError):
        doomed.result(timeout=0)
    counters = obs.snapshot()["counters"]
    assert counters['serve_deadline_misses_total{tenant="late"}'] == 1
    svc.close()


# ---- retries, breaker ladder, verification -----------------------------------


def test_transient_failure_retries_with_jitter_then_completes(monkeypatch):
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    from spfft_tpu_torch.serve import service as service_mod

    real_run_batch = service_mod.run_batch
    calls = {"n": 0}

    def flaky_run_batch(entry, requests, build_clone, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise errors.HostExecutionError("transient dispatch failure")
        return real_run_batch(entry, requests, build_clone, **kw)

    monkeypatch.setattr(service_mod, "run_batch", flaky_run_batch)
    svc = _service(retries=2, backoff_s=0.001)
    tk = svc.submit(TransformType.C2C, DIMS, trip, values)
    svc.pump()
    assert_close(tk.result(timeout=10), expect)
    assert calls["n"] == 2
    assert obs.snapshot()["counters"]["serve_retries_total"] == 1
    svc.close()


def test_retry_exhaustion_fails_typed():
    trip = _triplets()
    svc = _service(retries=1, backoff_s=0.001)
    with faults.inject("serve.dispatch=raise"):
        tk = svc.submit(TransformType.C2C, DIMS, trip, _values(trip))
        svc.pump()
    assert tk.outcome == "failed"
    with pytest.raises(errors.HostExecutionError):
        tk.result(timeout=0)
    assert obs.snapshot()["counters"]["serve_retries_total"] == 1
    svc.close()


def _trip_breaker(svc, trip, values, expect):
    warm = svc.submit(TransformType.C2C, DIMS, trip, values)
    svc.pump()
    assert_close(warm.result(timeout=10), expect)
    engine = svc.plans.describe()[0]["engine"]
    for _ in range(verify.breaker.threshold()):
        verify.breaker.record_failure(engine)
    return engine


def test_breaker_open_flips_service_to_demote():
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = _service(on_breaker="demote", engine="mxu")
    engine = _trip_breaker(svc, trip, values, expect)
    assert verify.breaker.describe(engine)["state"] == "open"
    tk = svc.submit(TransformType.C2C, DIMS, trip, values)
    svc.pump()
    assert_close(tk.result(timeout=10), expect)
    counters = obs.snapshot()["counters"]
    assert counters[f'serve_demotions_total{{engine="{engine}"}}'] == 1
    svc.close()


def test_breaker_open_shed_mode_fails_typed():
    trip = _triplets()
    values = _values(trip)
    svc = _service(on_breaker="shed")
    _trip_breaker(svc, trip, values, _expect_backward(trip, values))
    tk = svc.submit(TransformType.C2C, DIMS, trip, values)
    svc.pump()
    assert tk.outcome == "shed"
    with pytest.raises(errors.ServiceOverloadError):
        tk.result(timeout=0)
    counters = obs.snapshot()["counters"]
    assert counters['serve_sheds_total{reason="breaker_open"}'] == 1
    svc.close()


def test_breaker_heals_through_serve_traffic(monkeypatch):
    monkeypatch.setenv(verify.breaker.BREAKER_COOLDOWN_ENV, "0")
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = _service(on_breaker="demote")
    engine = _trip_breaker(svc, trip, values, expect)
    assert verify.breaker.describe(engine)["state"] == "open"
    tk = svc.submit(TransformType.C2C, DIMS, trip, values)
    svc.pump()
    assert_close(tk.result(timeout=10), expect)
    assert verify.breaker.describe(engine)["state"] == "closed"
    counters = obs.snapshot()["counters"]
    assert not any(k.startswith("serve_demotions_total") for k in counters)
    svc.close()


def test_out_of_range_indices_rejected_typed():
    trip = np.asarray(_triplets(), dtype=np.int64).reshape(-1, 3).copy()
    trip[0] = [DIM, 0, 0]  # == dim_x: out of both conventions' bounds
    svc = _service()
    with pytest.raises(errors.InvalidIndicesError):
        svc.submit(TransformType.C2C, DIMS, trip, np.zeros(len(trip)))
    svc.close()


def test_verified_service_recovers_under_corruption():
    import warnings

    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = _service(verify="on")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with faults.inject("engine.execute=corrupt:1.0"):
            tk = svc.submit(TransformType.C2C, DIMS, trip, values)
            svc.pump()
            result = tk.result(timeout=30)
    assert_close(result, expect)
    counters = obs.snapshot()["counters"]
    assert _counter_sum(counters, "verify_recoveries_total") >= 1
    svc.close()


# ---- the overload chaos invariant --------------------------------------------


@pytest.mark.parametrize("site_name", ["serve.admit", "serve.batch", "serve.dispatch"])
def test_chaos_invariant_serve_sites_at_overload(site_name):
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = _service(queue_capacity=4, batch_max=2, retries=1, backoff_s=0.001,
                   tenant_quota=1.0)
    accepted, rejected = [], 0
    with faults.inject(f"{site_name}=raise"):
        for i in range(16):  # 4x capacity
            try:
                accepted.append(
                    svc.submit(TransformType.C2C, DIMS, trip, values, tenant=f"t{i % 3}")
                )
            except errors.GenericError as e:
                assert isinstance(e, errors.ServiceOverloadError), type(e)
                rejected += 1
        assert svc.queue.high_water <= 4  # bounded under overload
        svc.pump()
    typed = 0
    for tk in accepted:
        assert tk.done(), "accepted ticket left unresolved"
        try:
            assert_close(tk.result(timeout=0), expect)
        except errors.GenericError:
            typed += 1
    if site_name == "serve.admit":
        assert rejected == 16 and not accepted
    else:
        assert rejected >= 12
        assert typed > 0
    svc.close()


# ---- lifecycle and exposure --------------------------------------------------


def test_close_fails_pending_tickets_typed():
    trip = _triplets()
    svc = _service()
    tickets = [svc.submit(TransformType.C2C, DIMS, trip, _values(trip)) for _ in range(3)]
    svc.close(drain=False)
    for tk in tickets:
        assert tk.outcome == "shed"
        with pytest.raises(errors.ServiceOverloadError):
            tk.result(timeout=0)
    with pytest.raises(errors.ServiceOverloadError):
        svc.submit(TransformType.C2C, DIMS, trip, _values(trip))


def test_drain_close_completes_queued_work_threaded():
    trip = _triplets()
    values = _values(trip)
    expect = _expect_backward(trip, values)
    svc = serve.TransformService(HOST, queue_capacity=16, batch_max=4)
    tickets = [svc.submit(TransformType.C2C, DIMS, trip, values) for _ in range(6)]
    svc.close(drain=True)
    for tk in tickets:
        assert_close(tk.result(timeout=10), expect)


def test_describe_joins_plan_cards_and_breakers():
    trip = _triplets()
    svc = _service()
    tk = svc.submit(TransformType.C2C, DIMS, trip, _values(trip))
    svc.pump()
    tk.result(timeout=10)
    desc = svc.describe()
    assert desc["config"]["queue_capacity"] == 16
    assert len(desc["plan_cache"]) == 1
    row = desc["plan_cache"][0]
    assert row["run_id"] and row["plans"] >= 1
    assert row["engine"] in desc["breakers"]
    assert desc["breakers"][row["engine"]]["state"] == "closed"
    assert desc["stats"]["counts"]["completed"] == 1
    svc.close()


def test_submit_rejects_malformed_requests_typed():
    trip = _triplets()
    svc = _service()
    with pytest.raises(errors.InvalidParameterError):
        svc.submit(TransformType.C2C, DIMS, trip, _values(trip)[:-1])
    with pytest.raises(errors.InvalidParameterError):
        svc.submit(TransformType.C2C, DIMS, trip, _values(trip), direction="sideways")
    with pytest.raises(errors.InvalidParameterError):
        svc.submit(TransformType.C2C, DIMS, trip, np.zeros(7), direction="forward")
    svc.close()


def test_serve_latency_histogram_and_trace_events():
    trip = _triplets()
    obs.trace.enable()
    try:
        svc = _service()
        tk = svc.submit(TransformType.C2C, DIMS, trip, _values(trip), tenant="t")
        svc.pump()
        tk.result(timeout=10)
        snap = obs.snapshot()
        hist = snap["histograms"]['serve_latency_seconds{tenant="t"}']
        assert hist["count"] == 1 and hist["sum"] > 0
        events = [e for e in obs.trace.snapshot()["events"] if e["name"] == "serve"]
        whats = {e["args"]["what"] for e in events}
        assert {"admit", "coalesce", "dispatch", "complete"} <= whats
        svc.close()
    finally:
        obs.trace.disable()
        obs.trace.clear()


# ---- end-to-end timelines ----------------------------------------------------


def test_ticket_stamps_first_wins_timeline_and_deltas():
    from spfft_tpu_torch.serve import queue as q

    tk = q.Ticket("t0", run="r1")
    tk.stamp("admitted")
    first = tk.stamps["admitted"]
    tk.stamp("admitted")  # first-wins: a retry keeps the original time
    assert tk.stamps["admitted"] == first
    with pytest.raises(errors.InvalidParameterError, match="phase"):
        tk.stamp("teleported")
    tk.stamp("dispatched")
    assert tk.resolve(object())
    tl = tk.timeline()
    assert [p["phase"] for p in tl] == ["admitted", "dispatched", "finalized"]
    ts = [p["t"] for p in tl]
    assert ts == sorted(ts) and ts[0] >= 0.0
    ps = tk.phase_seconds()
    assert set(ps) == {"dispatched", "finalized"}
    assert all(v >= 0.0 for v in ps.values())
    assert q.PHASES == jsp.serve.queue.PHASES


def test_service_tickets_feed_phase_histograms_in_process():
    svc = _service()
    trip = _triplets()
    vals = _values(trip)
    try:
        tickets = [svc.submit(TransformType.C2C, DIMS, trip, vals) for _ in range(3)]
        svc.pump()
        for tk in tickets:
            tk.result(timeout=30)
            tl = [p["phase"] for p in tk.timeline()]
            for phase in ("admitted", "coalesced", "dispatched", "finalized"):
                assert phase in tl, tl
            assert "wire" not in tl and "remote_execute" not in tl
    finally:
        svc.close()
    hists = obs.snapshot()["histograms"]
    for phase in ("coalesced", "dispatched", "finalized"):
        key = f'serve_phase_seconds{{phase="{phase}"}}'
        assert hists[key]["count"] >= 3, sorted(hists)
    assert 'serve_phase_seconds{phase="wire"}' not in hists


# ---- graph-scheduled mode (the serve cases of tests/test_sched.py) -----------


def test_serve_sched_mode_mixed_geometries_one_cycle():
    trip_a = _triplets(DIM, 0.9)
    trip_b = _triplets(DIM, 0.5)
    vals_a, vals_b = _values(trip_a, 1), _values(trip_b, 2)
    expect_a = _expect_backward(trip_a, vals_a)
    expect_b = _expect_backward(trip_b, vals_b)
    with _service(queue_capacity=32, sched=True) as svc:
        assert svc.stats()["sched"] is True
        ta = [svc.submit(TransformType.C2C, DIMS, trip_a, vals_a) for _ in range(3)]
        tb = [svc.submit(TransformType.C2C, DIMS, trip_b, vals_b) for _ in range(3)]
        assert svc.pump() == 2  # both geometry groups in ONE cycle
        for tk in ta:
            assert_close(tk.result(timeout=30), expect_a)
        for tk in tb:
            assert_close(tk.result(timeout=30), expect_b)


def test_serve_sched_chaos_tickets_always_resolve():
    trip = _triplets()
    vals = _values(trip)
    expect = _expect_backward(trip, vals)
    with faults.inject("sched.run=raise:1.0"):
        with _service(queue_capacity=32, sched=True) as svc:
            tickets = [svc.submit(TransformType.C2C, DIMS, trip, vals) for _ in range(3)]
            svc.pump()
            for tk in tickets:
                # demoted through the scheduler's reference rung: parity
                assert_close(tk.result(timeout=30), expect)
    counters = obs.snapshot()["counters"]
    assert _counter_sum(counters, "serve_demotions_total") > 0, counters


def test_serve_sched_pump_respects_max_batches():
    trip = _triplets()
    vals = _values(trip)
    with _service(queue_capacity=32, sched=True, sched_batches=8, batch_max=1) as svc:
        for _ in range(3):
            svc.submit(TransformType.C2C, DIMS, trip, vals)
        assert svc.pump(max_batches=2) == 2
        assert svc.queue.depth() == 1


@pytest.mark.parametrize("fuse", ["1", "0"], ids=["batch-fused", "split-phase"])
def test_batch_fuse_knob_paths_agree(monkeypatch, fuse):
    """The batch-fused arm (one batched program, bucket-padded) and the
    split-phase loop on leased clones give the same results."""
    monkeypatch.setenv("SPFFT_TPU_BATCH_FUSE", fuse)
    trip = _triplets()
    vals = [_values(trip, s) for s in range(3)]
    with _service(engine="mxu") as svc:
        tickets = [svc.submit(TransformType.C2C, DIMS, trip, v) for v in vals]
        assert svc.pump() == 1
        for tk, v in zip(tickets, vals):
            assert_close(tk.result(timeout=30), _expect_backward(trip, v))
        plans = svc.describe()["plan_cache"][0]["plans"]
    assert plans == (1 if fuse == "1" else 3)


def test_geometry_memo_is_keyed_by_content():
    """A repeat geometry is one memo entry; an index array mutated in place
    is a new geometry with its own plan, and serves right; the memo stays
    within its bound."""
    trip = np.asarray(_triplets()).copy()
    values = _values(trip)
    with _service(plan_cache_size=4) as svc:
        for _ in range(3):
            svc.submit(TransformType.C2C, DIMS, trip, values)
        assert len(svc.geometries) == 1
        trip[0] = [4, 4, 4]  # a corner outside the sphere: still a valid set
        tk = svc.submit(TransformType.C2C, DIMS, trip, values)
        svc.pump()
        assert len(svc.geometries) == 2
        assert_close(tk.result(timeout=10), _expect_backward(trip, values))
        for frac in (0.3, 0.4, 0.5, 0.6, 0.7, 0.9, 0.95, 1.0):
            t = _triplets(frac=frac)
            svc.geometries.resolve(t, DIMS)
        assert len(svc.geometries) == serve.batcher.GEOMETRY_CACHE
        w, c, sticks, order = svc.geometries.resolve(trip, DIMS)
        assert np.array_equal(c, serve.canonical_triplets(trip, DIMS))
        assert np.array_equal(w, serve.wrap_triplets(trip, DIMS))
