"""The port's autotuner and wisdom (spfft_tpu_torch.tuning) against the JAX
package's (spfft_tpu.tuning).

The counterparts of ``tests/test_tuning.py`` (wisdom round trip, corruption
and schema fallbacks, the CPU trial skip, the cache-hit guarantee, isolated
and all-failed trials, policy plumbing, trial deadlines, bundles), on
``make_fft_mesh(2, device="cpu")`` and 8^3 plans; then the two packages side
by side on the same triplets and values (made from a seed): each package's
own store holds an entry naming one local candidate or one exchange
discipline (slab, and a 2 x 2 pencil mesh), both build with
``policy="tuned"``, run no trial and agree on the results (1e-5 float32,
1e-11 float64, relative to the largest value); the model fallback picks what
``policy="default"`` picks; each armed ``tuning.*`` / ``wisdom.*`` site gives
the JAX package's outcome. The JAX MXU engine cannot be imported on this
jax, so a port plan on an ``mxu`` candidate is held against the JAX
``engine="xla"`` plan. What the port leaves out of the candidate lists
(the OVERLAPPED ``BUFFERED/ovC`` variants, and ``mxu/bf16-twiddle`` outside
float32 ``"highest"`` plans) is pinned here.
"""
import json

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import tuning as jtuning
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu_torch import faults, obs, tuning
from spfft_tpu_torch.errors import InvalidParameterError

DIM = 8
BAR = {np.float32: 1e-5, np.float64: 1e-11}
KNOBS = ("SPFFT_TPU_POLICY", "SPFFT_TPU_FAULTS", "SPFFT_TPU_FENCE_BUDGET_S",
         "SPFFT_TPU_TWIDDLE_BF16", "SPFFT_TPU_SPARSE_Y", "SPFFT_TPU_SPARSE_Y_BLOCKS",
         "SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC", "SPFFT_TPU_XPAD", "SPFFT_TPU_FUSE",
         "SPFFT_TPU_VERIFY", "SPFFT_TPU_GUARD")


@pytest.fixture(autouse=True)
def fresh_tuning(monkeypatch):
    """No ambient wisdom (file or memory) in either package, one timed
    repeat, clean metrics and faults."""
    for t in (tuning, jtuning):
        t.clear_memory()
    for name in (tuning.WISDOM_ENV, tuning.TUNE_CPU_ENV) + KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(tuning.TUNE_REPEATS_ENV, "1")
    monkeypatch.setenv(tuning.TUNE_WARMUP_ENV, "1")
    for f in (faults, jfaults):
        f.disarm()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    yield
    for t in (tuning, jtuning):
        t.clear_memory()
    for f in (faults, jfaults):
        f.disarm()


def _triplets(r2c=False):
    return np.asarray(tp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8,
                                                          hermitian_symmetry=r2c))


def _distributed(policy="tuned", **kwargs):
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, DIM, DIM, DIM,
                                   _triplets(), mesh=tp.make_fft_mesh(2, device="cpu"),
                                   policy=policy, **kwargs)


def _trial_count(o=obs) -> int:
    return sum(v for k, v in o.snapshot()["counters"].items()
               if k.startswith("tuning_trials_total"))


def _close(got, want, dtype=np.float64):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= BAR[dtype] * scale


def _per_shard(trip, values, per):
    lut = {tuple(x): v for x, v in zip(map(tuple, trip), values)}
    return [np.asarray([lut[tuple(x)] for x in np.asarray(s)]) for s in per]


# ---- the wisdom store ---------------------------------------------------------------


def test_wisdom_roundtrip(tmp_path):
    path = tmp_path / "wisdom.json"
    store = tuning.WisdomStore(str(path))
    key = {"kind": "exchange", "dims": [8, 8, 8], "platform": "cpu"}
    entry = tuning.make_entry(key, {"exchange_type": "BUFFERED"},
                              [{"label": "BUFFERED", "ms": 1.0}])
    store.record(key, entry)
    doc = json.loads(path.read_text())
    assert doc["schema"] == tuning.WISDOM_SCHEMA == "spfft_tpu_torch.tuning.wisdom/1"
    got = tuning.WisdomStore(str(path)).lookup(key)
    assert got["choice"] == {"exchange_type": "BUFFERED"}
    assert got["trials"] == entry["trials"] and got["key"] == key
    other = dict(key, dims=[16, 16, 16])
    assert store.lookup(other) is None
    store.record(other, tuning.make_entry(other, {"exchange_type": "UNBUFFERED"}, []))
    assert tuning.WisdomStore(str(path)).lookup(key)["choice"] == {"exchange_type": "BUFFERED"}
    # the digest is the JAX package's function of the key
    assert tuning.key_digest(key) == jtuning.key_digest(key)


def test_corrupted_file_falls_back(tmp_path, monkeypatch):
    path = tmp_path / "wisdom.json"
    path.write_text("{not json")
    monkeypatch.setenv(tuning.WISDOM_ENV, str(path))
    with pytest.warns(RuntimeWarning, match="quarantined"):
        t = _distributed()
    assert t._tuning["provenance"] == "model"
    assert "corrupt" in t._tuning["reason"]
    assert t._tuning["trials"] == []
    assert t.exchange_type == _distributed(policy="default").exchange_type
    assert (tmp_path / "wisdom.json.corrupt").exists()


def test_schema_version_mismatch_falls_back(tmp_path, monkeypatch):
    path = tmp_path / "wisdom.json"
    path.write_text(json.dumps({"schema": "spfft_tpu_torch.tuning.wisdom/999", "entries": {}}))
    monkeypatch.setenv(tuning.WISDOM_ENV, str(path))
    t = _distributed()
    assert t._tuning["provenance"] == "model"
    assert "schema mismatch" in t._tuning["reason"]
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t2 = _distributed()
    assert t2._tuning["provenance"] == "wisdom"
    assert json.loads(path.read_text())["schema"] == tuning.WISDOM_SCHEMA


def test_a_store_of_one_package_never_answers_for_the_other(tmp_path, monkeypatch):
    """Each package's file is a schema mismatch to the other, with each
    package's own outcome: the model, reason named."""
    port_file, jax_file = tmp_path / "port.json", tmp_path / "jax.json"
    key = {"kind": "x"}
    tuning.WisdomStore(str(port_file)).record(key, tuning.make_entry(key, {"w": 1}, []))
    jtuning.WisdomStore(str(jax_file)).record(key, jtuning.make_entry(key, {"w": 1}, []))
    assert tuning.WisdomStore(str(jax_file)).lookup(key) is None
    assert jtuning.WisdomStore(str(port_file)).lookup(key) is None
    monkeypatch.setenv(tuning.WISDOM_ENV, str(jax_file))
    t = _distributed()
    assert t._tuning["provenance"] == "model"
    assert f"!= {tuning.WISDOM_SCHEMA}" in t._tuning["reason"]
    assert json.loads(jax_file.read_text())["schema"] == jtuning.WISDOM_SCHEMA  # untouched


def test_cpu_only_trial_skip_model_fallback(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    t = _distributed()
    rec = t._tuning
    assert rec["policy"] == "tuned" and rec["provenance"] == "model"
    assert rec["hit"] is False and rec["trials"] == []
    assert rec["reason"] == "trials skipped on CPU-only host (set SPFFT_TPU_TUNE_CPU=1 to allow)"
    assert _trial_count() == 0
    assert t.exchange_type == _distributed(policy="default").exchange_type
    assert not (tmp_path / "wisdom.json").exists()
    assert t.report()["tuning"]["reason"] == rec["reason"]


# ---- the cache-hit guarantee ------------------------------------------------------------


def test_cache_hit_runs_zero_trials(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t1 = _distributed()
    rec1 = t1._tuning
    assert rec1["provenance"] == "wisdom" and rec1["hit"] is False
    n1 = _trial_count()
    assert n1 == 5  # one trial per discipline, and BUFFERED/ov2 and BUFFERED/ov4
    t2 = _distributed()
    rec2 = t2._tuning
    assert rec2["provenance"] == "wisdom" and rec2["hit"] is True
    assert _trial_count() == n1
    assert t2.exchange_type == t1.exchange_type and rec2["choice"] == rec1["choice"]
    assert rec2["trials"] and all("ms" in row for row in rec2["trials"])
    card = t2.report()
    assert card["policy"] == "tuned"
    assert card["tuning"]["provenance"] == "wisdom"
    assert card["tuning"]["trials"] == rec2["trials"]
    assert obs.validate_plan_card(card) == [] == jplancard.validate_plan_card(card)
    trip = _triplets()
    rng = np.random.default_rng(0)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    vps = _per_shard(trip, values, tp.distribute_triplets(trip, 2, DIM))
    local = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                indices=trip).backward(values)
    _close(t2.backward(vps), local)
    back = t2.forward(scaling=tp.ScalingType.FULL)
    for r, v in enumerate(vps):
        _close(back[r], v)


def test_local_tuned_cache_hit(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    trip = _triplets()
    make = lambda: tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=trip,
                                policy="tuned")
    t1 = make()
    rec1 = t1._tuning
    assert rec1["provenance"] == "wisdom" and rec1["hit"] is False
    assert t1.engine == rec1["choice"]["engine"]
    labels = [row["label"] for row in rec1["trials"]]
    assert {"xla", "mxu", "mxu/dense-y"} <= set(labels) and len(labels) == 5
    n1 = _trial_count()
    t2 = make()
    assert t2._tuning["hit"] is True and _trial_count() == n1
    assert t2.engine == t1.engine
    assert obs.validate_plan_card(t2.report()) == []
    rng = np.random.default_rng(1)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    oracle = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                 indices=trip).backward(values)
    _close(t2.backward(values), oracle)


def test_perf_knob_change_invalidates(tmp_path, monkeypatch):
    """Wisdom keyed under one ambient perf-knob state does not answer for
    another (PERF_ENV_KNOBS ride in every key)."""
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    assert _distributed()._tuning["hit"] is False
    monkeypatch.setenv("SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC", "0.7")
    assert _distributed()._tuning["hit"] is False
    monkeypatch.delenv("SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC")
    assert _distributed()._tuning["hit"] is True


def test_memory_store_when_env_unset(monkeypatch):
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t1 = _distributed()
    assert t1._tuning["wisdom_path"] is None
    n1 = _trial_count()
    assert _distributed()._tuning["hit"] is True
    assert _trial_count() == n1


def test_failed_candidate_is_isolated(tmp_path, monkeypatch):
    from spfft_tpu_torch.tuning import runner

    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    real = runner.measure_candidate

    def flaky(transform):
        if transform.exchange_type == tp.ExchangeType.BUFFERED:
            raise RuntimeError("synthetic trial failure")
        return real(transform)

    monkeypatch.setattr(runner, "measure_candidate", flaky)
    t = _distributed()
    rec = t._tuning
    assert rec["provenance"] == "wisdom" and rec["hit"] is False
    assert t.exchange_type != tp.ExchangeType.BUFFERED
    errors = [row for row in rec["trials"] if "error" in row]
    # the BUFFERED family holds BUFFERED/ov2 and /ov4 too, as the JAX package's
    assert {row["label"] for row in errors} == {"BUFFERED", "BUFFERED/ov2", "BUFFERED/ov4"}
    assert rec["trials"][-1]["error"] == "RuntimeError: synthetic trial failure"
    assert obs.validate_plan_card(t.report()) == []


def test_all_trials_failing_falls_back_to_model(monkeypatch):
    from spfft_tpu_torch.tuning import runner

    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    monkeypatch.setattr(runner, "measure_candidate",
                        lambda transform: (_ for _ in ()).throw(RuntimeError("synthetic")))
    t = _distributed()
    rec = t._tuning
    assert rec["provenance"] == "model" and rec["reason"] == "all trial candidates failed"
    assert rec["trials"] and all("error" in row for row in rec["trials"])
    assert t.exchange_type == _distributed(policy="default").exchange_type


@pytest.mark.parametrize("where", ["build", "launch"])
@pytest.mark.parametrize("plan", ["local", "slab"])
def test_a_kernel_error_in_a_trial_raises_and_persists_nothing(monkeypatch, tmp_path, where,
                                                               plan):
    """A K1 that does not build (GPUSupportError) or launch (GPULaunchError)
    in an mxu trial is no error row: the plan's construction raises it, and
    no wisdom is written, so that no later plan answers with the library
    path from the store."""
    from spfft_tpu_torch.errors import GPULaunchError, GPUSupportError
    from spfft_tpu_torch.execution_mxu import MxuLocalExecution
    from spfft_tpu_torch.ops import fft as pfft
    from spfft_tpu_torch.parallel.execution_mxu import MxuDistributedExecution

    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    wisdom = tmp_path / "wisdom.json"
    monkeypatch.setenv(tuning.WISDOM_ENV, str(wisdom))
    if where == "build":
        err, name = GPUSupportError, "__init__"
        owner = MxuDistributedExecution if plan == "slab" else MxuLocalExecution
    else:
        err, owner, name = GPULaunchError, pfft, "complex_matmul"

    def broken(*args, **kwargs):
        raise err("synthetic kernel failure")

    def make():
        if plan == "slab":
            return _distributed(engine="mxu")
        return tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets(),
                            policy="tuned")

    with monkeypatch.context() as m:
        m.setattr(owner, name, broken)
        with pytest.raises(err, match="synthetic kernel failure"):
            make()
    assert not wisdom.exists() or tuning.WisdomStore(str(wisdom)).entries() == {}
    rec = make()._tuning  # the kernels work again: nothing answers from the store
    assert rec["provenance"] == "wisdom" and rec["hit"] is False


def test_a_trial_that_takes_a_rung_is_an_error_row(monkeypatch):
    """engine.compile armed inside the trials: each mxu trial plan falls back
    to torch.fft, so it becomes a TrialDegradedError row and is not timed."""
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    with faults.inject("engine.compile=raise"):
        t = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets(),
                         policy="tuned")
    rows = {row["label"]: row for row in t._tuning["trials"]}
    for label in ("mxu", "mxu/dense-y", "mxu/staged"):
        assert rows[label]["error"].startswith("TrialDegradedError: trial plan took the "
                                               "engine_fallback rung")
    assert all("ms" in rows[label] for label in ("xla", "xla/staged"))
    assert t.engine == "xla" and t.report()["degradations"] == []


# ---- policy plumbing ------------------------------------------------------------------


def test_explicit_discipline_never_tuned(monkeypatch):
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t = _distributed(exchange_type=tp.ExchangeType.BUFFERED)
    assert t._tuning is None and t.exchange_type == tp.ExchangeType.BUFFERED
    assert _trial_count() == 0
    assert "tuning" not in t.report()
    local = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets(),
                         engine="mxu", policy="tuned")
    assert local._tuning is None and _trial_count() == 0


def test_invalid_policy_rejected(monkeypatch):
    with pytest.raises(InvalidParameterError):
        _distributed(policy="fastest")
    monkeypatch.setenv("SPFFT_TPU_POLICY", "fastest")
    with pytest.raises(InvalidParameterError):
        _distributed(policy=None)


def test_policy_env_knob(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_POLICY", "tuned")
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t = _distributed(policy=None)
    assert t._policy == "tuned" and t._tuning is not None
    assert _distributed(policy="default")._policy == "default"
    local = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets())
    assert local._policy == "tuned" and local._tuning["provenance"] == "wisdom"
    assert local.report()["policy"] == "tuned"


def test_wisdom_state_stamp(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    state = tuning.wisdom_state(_distributed())
    assert state == {"path": str(tmp_path / "wisdom.json"), "configured": True,
                     "policy": "tuned", "provenance": "wisdom", "hit": False}
    untuned = tuning.wisdom_state(_distributed(policy="default"))
    assert untuned["provenance"] == "model" and untuned["hit"] is None


def test_trial_deadline_turns_hung_candidate_into_error_row(monkeypatch):
    import time as _time

    from spfft_tpu_torch.tuning import runner

    monkeypatch.setenv("SPFFT_TPU_FENCE_BUDGET_S", "0.05")
    monkeypatch.setenv(tuning.TUNE_WARMUP_ENV, "0")
    monkeypatch.setenv(tuning.TUNE_REPEATS_ENV, "1")
    assert runner.trial_deadline_s() == pytest.approx(0.05 * 2)

    def build(cand):
        if cand["label"] == "hung":
            _time.sleep(5.0)
        raise ValueError("fast candidate fails honestly")

    t0 = _time.perf_counter()
    rows = runner.run_trials(build, [{"label": "hung"}, {"label": "fast"}])
    assert _time.perf_counter() - t0 < 2.0, "the deadline did not bound the hung trial"
    by_label = {r["label"]: r for r in rows}
    assert "TrialTimeout" in by_label["hung"]["error"]
    assert "ValueError" in by_label["fast"]["error"]


def test_trial_deadline_unset_means_no_deadline():
    from spfft_tpu_torch.tuning import runner

    assert runner.trial_deadline_s() == 0.0
    assert runner._run_deadlined(lambda: 42, 0.0, "x") == 42


# ---- bundles ------------------------------------------------------------------------------


def _entry(key, choice, ms_list):
    return tuning.make_entry(key, choice, [{"label": f"c{i}", "ms": ms}
                                           for i, ms in enumerate(ms_list)])


def test_bundle_export_merge_best_measured_wins(tmp_path):
    a = tuning.WisdomStore(str(tmp_path / "a.json"))
    b = tuning.WisdomStore(str(tmp_path / "b.json"))
    k1, k2 = {"kind": "x", "n": 1}, {"kind": "x", "n": 2}
    a.record(k1, _entry(k1, {"w": "slow"}, [5.0]))
    b.record(k1, _entry(k1, {"w": "fast"}, [3.0, 9.0]))
    b.record(k2, _entry(k2, {"w": "only"}, [1.0]))
    bundle = tmp_path / "fleet.json"
    assert b.export(str(bundle)) == 2
    assert a.merge(str(bundle)) == (1, 1)
    ent = a.entries()
    assert ent[tuning.key_digest(k1)]["choice"] == {"w": "fast"}
    assert ent[tuning.key_digest(k2)]["choice"] == {"w": "only"}
    assert a.merge(str(bundle)) == (0, 0)
    worse = tmp_path / "worse.json"
    assert a.export(str(worse)) == 2
    a.record(k1, _entry(k1, {"w": "fast"}, [2.0]))
    assert a.merge(str(worse)) == (0, 0)
    assert tuning.best_measured_ms(a.entries()[tuning.key_digest(k1)]) == 2.0


def test_bundle_measured_beats_unmeasured_and_malformed_skipped(tmp_path):
    a = tuning.WisdomStore(str(tmp_path / "a.json"))
    k = {"kind": "x", "n": 1}
    a.record(k, _entry(k, {"w": "model"}, []))
    bundle = tmp_path / "fleet.json"
    bundle.write_text(json.dumps({"schema": tuning.WISDOM_SCHEMA, "entries": {
        tuning.key_digest(k): _entry(k, {"w": "measured"}, [4.0]),
        "malformed": {"choice": "not-a-dict"}, "alsobad": ["nope"]}}))
    assert a.merge(str(bundle)) == (0, 1)
    assert a.entries()[tuning.key_digest(k)]["choice"] == {"w": "measured"}


def test_bundle_schema_mismatch_raises_typed(tmp_path):
    a = tuning.WisdomStore(str(tmp_path / "a.json"))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": jtuning.WISDOM_SCHEMA, "entries": {}}))
    with pytest.raises(InvalidParameterError, match="schema mismatch"):
        a.merge(str(bad))
    with pytest.raises(InvalidParameterError, match="unreadable"):
        a.merge(str(tmp_path / "missing.json"))


def test_bundle_corrupt_quarantine_parity(tmp_path):
    import warnings

    a = tuning.WisdomStore(str(tmp_path / "a.json"))
    k = {"kind": "x", "n": 1}
    a.record(k, _entry(k, {"w": "keep"}, [1.0]))
    corrupt = tmp_path / "fleet.json"
    corrupt.write_text("{ not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(InvalidParameterError, match="corrupt"):
            a.merge(str(corrupt))
    assert (tmp_path / "fleet.json.corrupt").exists() and not corrupt.exists()
    assert any("quarantined" in str(w.message) for w in caught)
    assert obs.snapshot()["counters"].get("wisdom_quarantined_total", 0) >= 1
    assert a.entries()[tuning.key_digest(k)]["choice"] == {"w": "keep"}


def test_bundle_memory_store_parity(tmp_path):
    m = tuning.MemoryStore()
    k1, k2 = {"kind": "x", "n": 1}, {"kind": "x", "n": 2}
    m.record(k1, _entry(k1, {"w": "mem"}, []))
    bundle = tmp_path / "fleet.json"
    bundle.write_text(json.dumps({"schema": tuning.WISDOM_SCHEMA, "entries": {
        tuning.key_digest(k1): _entry(k1, {"w": "fleet"}, [2.0]),
        tuning.key_digest(k2): _entry(k2, {"w": "new"}, [1.0])}}))
    assert m.merge(str(bundle)) == (1, 1)
    assert m.export(str(tmp_path / "out.json")) == 2
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["schema"] == tuning.WISDOM_SCHEMA and len(out["entries"]) == 2


# ---- candidates, keys and knobs against the JAX package ---------------------------------


@pytest.mark.parametrize("sticks", [(10, 10, 10, 10), (12, 9, 10, 10), (7, 7), (9, 4),
                                    (3, 3, 3)])
def test_exchange_candidates_are_jax_less_the_overlapped_variants(sticks, monkeypatch):
    """The candidates equal the JAX package's with its one-shot exchange,
    the OVERLAPPED ``BUFFERED/ovC`` variants included: labels, order, chunk
    counts and model costs (the JAX default round cost); a pinned count
    drops the variants in both."""
    monkeypatch.delenv("SPFFT_TPU_EXCH_ROUND_COST_KB", raising=False)
    lz = [2] * len(sticks)
    port = tuning.exchange_candidates(sticks, lz, wire_scalar_bytes=8)
    want = jtuning.exchange_candidates(sticks, lz, one_shot_supported=True,
                                       wire_scalar_bytes=8)
    assert port == want
    assert [c["label"] for c in port if "/ov" in c["label"]] == ["BUFFERED/ov2", "BUFFERED/ov4"]
    pinned = tuning.exchange_candidates(sticks, lz, wire_scalar_bytes=8, overlap=3)
    assert pinned == jtuning.exchange_candidates(sticks, lz, one_shot_supported=True,
                                                 wire_scalar_bytes=8, overlap=3)
    for pencil_overlap in (None, 1):
        assert tuning.exchange_candidates(pencil2=True, overlap=pencil_overlap) == \
            jtuning.exchange_candidates(pencil2=True, overlap=pencil_overlap)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("fuse", [None, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_local_candidates_are_jax(platform, fuse, dtype):
    """Labels, order and env of the JAX package's list at "highest"; at
    "high" and "default" the port drops ``mxu/bf16-twiddle``, where the knob
    would run the ``mxu`` kernels on rounded matrices."""
    want = jtuning.local_candidates(platform, dtype, fuse=fuse)
    assert tuning.local_candidates(platform, dtype, fuse=fuse) == want
    for precision in ("high", "default"):
        assert tuning.local_candidates(platform, dtype, fuse=fuse, precision=precision) == [
            c for c in want if c["label"] != "mxu/bf16-twiddle"]


def test_sched_and_batch_candidates_are_jax():
    for n in (1, 2, 6, 8):
        assert tuning.sched_candidates(n) == jtuning.sched_candidates(n)
    for cap in (None, 1, 4, 5, 0):
        assert tuning.batch_candidates(cap) == jtuning.batch_candidates(cap)


def test_perf_env_knobs_are_the_ported_ones(monkeypatch):
    assert tuning.PERF_ENV_KNOBS == ("SPFFT_TPU_SPARSE_Y", "SPFFT_TPU_SPARSE_Y_BLOCKS",
                                     "SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC", "SPFFT_TPU_XPAD")
    assert set(tuning.PERF_ENV_KNOBS) <= set(jtuning.PERF_ENV_KNOBS)
    monkeypatch.setenv("SPFFT_TPU_XPAD", "16")
    assert tuning.env_signature()["SPFFT_TPU_XPAD"] == "16"


def test_the_key_names_the_card_and_the_software():
    p = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets()).params
    key = tuning.local_key(p, torch.device("cpu"), np.float32, "highest")
    assert {k: key[k] for k in ("platform", "torch", "cuda", "device_name")} == {
        "platform": "cpu", "torch": torch.__version__, "cuda": torch.version.cuda,
        "device_name": "cpu"}
    assert "jax" not in key and key["kind"] == "local"
    assert key["sparsity_signature"] == jtuning.sparsity_signature(p.stick_x, p.stick_y,
                                                                   p.value_indices)


def test_env_overrides_restore_verbatim(monkeypatch):
    import os

    monkeypatch.setenv("SPFFT_TPU_SPARSE_Y", "1")
    with tuning.env_overrides({"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_FUSE": "0"}):
        assert os.environ["SPFFT_TPU_SPARSE_Y"] == "0" and os.environ["SPFFT_TPU_FUSE"] == "0"
    assert os.environ["SPFFT_TPU_SPARSE_Y"] == "1" and "SPFFT_TPU_FUSE" not in os.environ


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_twiddle_bf16_rounds_as_the_jax_package_does(monkeypatch, r2c):
    """SPFFT_TPU_TWIDDLE_BF16: the port's float32 matrices equal the JAX
    package's bfloat16 ones widened; float64 plans ignore the knob; the
    x-stage matrices (C2C and R2C) too."""
    from spfft_tpu.ops import fft as jfft

    from spfft_tpu_torch.ops import fft as pfft

    monkeypatch.setenv("SPFFT_TPU_TWIDDLE_BF16", "1")
    w = pfft.c2c_matrix(12, -1, scale=1 / 7.0)
    for got, want in zip(pfft.matrix_pair(w, np.float32), jfft.matrix_pair(w, np.float32)):
        assert np.array_equal(got, np.asarray(want).astype(np.float32))
    for got, want in zip(pfft.matrix_pair(w, np.float64), jfft.matrix_pair(w, np.float64)):
        assert np.array_equal(got, np.asarray(want))
    ux = np.arange(5)
    for got, want in zip(pfft.x_stage_matrices(12, ux, 8, r2c, np.float32),
                         jfft.x_stage_matrices(12, ux, 8, r2c, np.float32)):
        for g, x in zip(got, want):
            assert np.array_equal(g, np.asarray(x).astype(np.float32))
    monkeypatch.delenv("SPFFT_TPU_TWIDDLE_BF16")
    plain = pfft.matrix_pair(w, np.float32)[0]  # unset: no rounding
    assert plain.dtype == np.float32 and np.array_equal(plain, w.real.astype(np.float32))


def _bf16_backward(trip, values, dim, r2c):
    """The backward transform in float64 through the JAX package's own
    bfloat16-rounded stage matrices (``SPFFT_TPU_TWIDDLE_BF16`` set): the
    z, y and x stages over the dense grid, the x = 0 plane completed from
    its hermitian partners for R2C."""
    from spfft_tpu.ops import fft as jfft

    def wide(pair):
        return tuple(np.asarray(m).astype(np.float64) for m in pair)

    xf = dim // 2 + 1 if r2c else dim
    grid = np.zeros((dim, dim, xf), complex)  # (kz, ky, kx)
    z, y, x = trip[:, 2] % dim, trip[:, 1] % dim, trip[:, 0] % dim
    grid[z, y, x] = values
    if r2c:
        on = x == 0
        grid[-z[on] % dim, -y[on] % dim, 0] = np.conj(values[on])
    re, im = wide(jfft.matrix_pair(jfft.c2c_matrix(dim, +1), np.float32))
    wz = re + 1j * im
    g = np.einsum("kz,kyx->zyx", wz, grid)
    g = np.einsum("ly,zlx->zyx", wz, g)  # dim_y == dim_z: the same matrix
    (a, b), _ = jfft.x_stage_matrices(dim, np.arange(xf), xf, r2c, np.float32)
    a, b = wide((a, b))
    if r2c:
        return g.real @ a - g.imag @ b
    return g @ (a + 1j * b)


@pytest.mark.parametrize("plan,r2c", [(p, r) for p in ("dense", "blocked", "slab", "pencil2x2")
                                       for r in (False, True)] + [("per-slot", False)])
def test_a_bf16_twiddle_plan_runs_the_bf16_constant_form(monkeypatch, plan, r2c):
    """Under SPFFT_TPU_TWIDDLE_BF16 a float32 "highest" plan of every y plan
    and mesh builds its K1 constants in the "highest-bf16" form (each one
    exact in bfloat16), says so on its card, computes the float64 transform
    through the JAX package's own bfloat16 matrices to the float32 bar
    (1e-5), and stays within the JAX package's bar for the knob (3e-2,
    ``tests/test_ir.py``) of the JAX ``engine="xla"`` plan."""
    from spfft_tpu_torch.ops import complex_matmul as k1

    dim = 16
    radius = 0.3 if plan == "per-slot" else 0.8  # the per-slot y plan is C2C's
    trip = np.asarray(tp.create_spherical_cutoff_triplets(dim, dim, dim, radius,
                                                          hermitian_symmetry=r2c))
    if plan == "dense":
        monkeypatch.setenv("SPFFT_TPU_SPARSE_Y_BLOCKS", "0")
    monkeypatch.setenv("SPFFT_TPU_TWIDDLE_BF16", "1")
    rng = np.random.default_rng(9)
    spec = np.fft.fftn(rng.standard_normal((dim,) * 3))
    if r2c:
        values = spec[trip[:, 2] % dim, trip[:, 1] % dim, trip[:, 0]]
    else:
        values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    args = (int(r2c), dim, dim, dim)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, *args, indices=trip,
                              engine="xla").backward(values)
    if plan in ("slab", "pencil2x2"):
        mesh = (tp.make_fft_mesh(2, device="cpu") if plan == "slab"
                else tp.make_fft_mesh2(2, 2, device="cpu"))
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, *args, trip, mesh=mesh,
                                    engine="mxu", dtype=np.float32)
        per = tp.distribute_triplets(trip, t.num_shards, dim, **(
            {"layout": (2, 2), "dim_x": dim} if plan == "pencil2x2" else {}))
        got = t.backward(_per_shard(trip, values, per))
    else:
        t = tp.Transform(tp.ProcessingUnit.HOST, *args, indices=trip, engine="mxu",
                         dtype=np.float32)
        assert t._exec.y_plan == plan
        got = t.backward(values)
    assert t._exec.k1_precision == k1.BF16_CONSTANT and t.precision == "highest"
    card = t.report()["execution"]
    assert card["k1_form"] == k1.BF16_CONSTANT and card["twiddle_dtype"] == "bfloat16"
    got = got.numpy()
    want = _bf16_backward(trip, values, dim, r2c)
    assert np.abs(got - want).max() / np.abs(want).max() < BAR[np.float32], \
        np.abs(got - want).max() / np.abs(want).max()
    err = np.abs(got - np.asarray(ref)).max() / np.abs(ref).max()
    assert 1e-6 < err < 3e-2  # the rounding shows, within the knob's bar


# ---- the two packages side by side -----------------------------------------------------


def _values(trip, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))


def _seed_local(port_plan, jax_plan, label, engine, env):
    """Each package's store: an entry naming ``label`` at its own key."""
    pkey = tuning.local_key(port_plan.params, port_plan.device, port_plan.dtype, "highest")
    pkey["fuse"] = "tuned"
    choice = {"label": label, "engine": engine, "env": env}
    tuning.active_store().record(pkey, tuning.make_entry(pkey, choice,
                                                         [{"label": label, "ms": 1.0}]))
    jkey = jtuning.local_key(jax_plan._params, jax_plan._device, jax_plan.dtype, "highest")
    jkey["fuse"] = "tuned"
    jtuning.active_store().record(jkey, jtuning.make_entry(jkey, choice,
                                                           [{"label": label, "ms": 1.0}]))


@pytest.mark.parametrize("cand", tuning.local_candidates("cpu"), ids=lambda c: c["label"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_a_warm_store_answers_both_packages_with_no_trial(cand, r2c):
    trip = _triplets(r2c)
    values = _values(trip)
    if r2c:  # hermitian-consistent values: the spectrum of a real field
        field = np.random.default_rng(4).standard_normal((DIM,) * 3)
        spec = np.fft.fftn(field)
        values = spec[trip[:, 2] % DIM, trip[:, 1] % DIM, trip[:, 0] % DIM]
    args = (int(r2c), DIM, DIM, DIM)
    port0 = tp.Transform(tp.ProcessingUnit.HOST, *args, indices=trip)
    jax0 = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, *args, indices=trip)
    _seed_local(port0, jax0, cand["label"], cand["engine"], cand["env"])
    port = tp.Transform(tp.ProcessingUnit.HOST, *args, indices=trip, policy="tuned")
    assert port._tuning["hit"] is True and _trial_count() == 0
    assert port.engine == cand["engine"]
    assert port.fused == ("SPFFT_TPU_FUSE" not in cand["env"])
    # a float64 plan: K1's one form, or no K1 at all on torch.fft
    k1_form = None if cand["engine"] == "xla" else "highest"
    assert port._tuning["k1_form"] == port.report()["execution"].get("k1_form") == k1_form
    if cand["engine"] == "xla":
        ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, *args, indices=trip,
                                  policy="tuned")
        assert ref._tuning["hit"] is True and _trial_count(jobs) == 0
        assert ref._tuning["choice"] == port._tuning["choice"]
    else:  # the JAX MXU engine cannot be built on this jax
        ref = jax0
    _close(port.backward(values), ref.backward(values))
    space = port.space_domain_data()
    _close(port.forward(space, tp.ScalingType.FULL),
           ref.forward(space, spfft_tpu.ScalingType.FULL))


def test_a_tuned_bf16_twiddle_choice_names_its_k1_form():
    """A float32 "highest" plan that wisdom answers with ``mxu/bf16-twiddle``
    says what it runs: its record and card name the "highest-bf16" form and
    bfloat16 matrices, while the precision asked for stays "highest"."""
    trip = _triplets()
    args = (0, DIM, DIM, DIM)
    port0 = tp.Transform(tp.ProcessingUnit.HOST, *args, indices=trip, dtype=np.float32)
    jax0 = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, *args, indices=trip,
                               dtype=np.float32)
    _seed_local(port0, jax0, "mxu/bf16-twiddle", "mxu", {"SPFFT_TPU_TWIDDLE_BF16": "1"})
    t = tp.Transform(tp.ProcessingUnit.HOST, *args, indices=trip, dtype=np.float32,
                     policy="tuned")
    assert t._tuning["hit"] is True and t._tuning["k1_form"] == "highest-bf16"
    card = t.report()
    assert card["tuning"]["k1_form"] == card["execution"]["k1_form"] == "highest-bf16"
    assert card["execution"]["twiddle_dtype"] == "bfloat16" and card["precision"] == "highest"
    assert obs.validate_plan_card(card) == []


def _mesh_pair(pencil, trip):
    if pencil:
        per = [np.asarray(p) for p in tp.distribute_triplets(trip, 4, DIM, layout=(2, 2),
                                                             dim_x=DIM)]
        return per, tp.make_fft_mesh2(2, 2, device="cpu"), spfft_tpu.make_fft_mesh2(2, 2)
    per = [np.asarray(p) for p in tp.distribute_triplets(trip, 2, DIM)]
    return per, tp.make_fft_mesh(2, device="cpu"), spfft_tpu.make_fft_mesh(2)


@pytest.mark.parametrize("discipline", ["BUFFERED", "COMPACT_BUFFERED", "UNBUFFERED"])
@pytest.mark.parametrize("pencil", [False, True], ids=["slab", "pencil2x2"])
def test_a_warm_store_answers_both_mesh_packages_with_no_trial(discipline, pencil):
    trip = _triplets()
    values = _values(trip)
    per, pmesh, jmesh = _mesh_pair(pencil, trip)
    args = (0, DIM, DIM, DIM, per)
    port0 = tp.DistributedTransform(tp.ProcessingUnit.HOST, *args, mesh=pmesh)
    jax0 = spfft_tpu.DistributedTransform(spfft_tpu.ProcessingUnit.HOST, *args, mesh=jmesh,
                                          engine="xla")
    choice = {"exchange_type": discipline, "overlap": 1}
    pkey = tuning.exchange_key(port0.params, pmesh, port0.dtype, "auto", "highest", pencil)
    pkey["overlap"] = "tuned"
    tuning.active_store().record(pkey, tuning.make_entry(pkey, choice, [{"label": discipline,
                                                                         "ms": 1.0}]))
    jkey = jtuning.exchange_key(jax0._params, jmesh, jax0.dtype, "xla", "highest", pencil)
    jkey["overlap"] = "tuned"
    jtuning.active_store().record(jkey, jtuning.make_entry(jkey, choice,
                                                           [{"label": discipline, "ms": 1.0}]))
    port = tp.DistributedTransform(tp.ProcessingUnit.HOST, *args, mesh=pmesh, policy="tuned")
    ref = spfft_tpu.DistributedTransform(spfft_tpu.ProcessingUnit.HOST, *args, mesh=jmesh,
                                         engine="xla", policy="tuned")
    assert port._tuning["hit"] is True and ref._tuning["hit"] is True
    assert _trial_count() == 0 == _trial_count(jobs)
    assert port.exchange_type.name == discipline == ref.exchange_type.name
    vps = _per_shard(trip, values, per)
    _close(port.backward(vps), ref.backward(vps))
    for got, want in zip(port.forward(scaling=tp.ScalingType.FULL), ref.forward(
            scaling=spfft_tpu.ScalingType.FULL)):
        _close(got, want)


@pytest.mark.parametrize("kind", ["local", "slab", "pencil2x2"])
def test_the_model_fallback_is_policy_default(kind):
    """On the CPU without SPFFT_TPU_TUNE_CPU both packages take the model, for
    the same reason, and the port's pick is its policy="default" plan."""
    trip = _triplets()
    if kind == "local":
        make = lambda pkg, policy: pkg.Transform(pkg.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                                 indices=trip, policy=policy)
        pick = lambda t: t._engine
    else:
        per, pmesh, jmesh = _mesh_pair(kind == "pencil2x2", trip)
        meshes = {tp: pmesh, spfft_tpu: jmesh}
        make = lambda pkg, policy: pkg.DistributedTransform(
            pkg.ProcessingUnit.HOST, 0, DIM, DIM, DIM, per, mesh=meshes[pkg], policy=policy)
        pick = lambda t: t.exchange_type.name
    port, jax = make(tp, "tuned"), make(spfft_tpu, "tuned")
    assert port._tuning["provenance"] == "model" == jax._tuning["provenance"]
    assert port._tuning["reason"] == jax._tuning["reason"]
    assert pick(port) == pick(make(tp, "default"))
    if kind == "local":  # a mesh's DEFAULT rules differ by design (ROADMAP queue C)
        assert pick(port) == pick(jax) == "xla"


def test_a_mesh_across_processes_takes_the_model(monkeypatch):
    import torch.distributed as dist

    from spfft_tpu_torch.parallel.mesh import ShardMesh

    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    monkeypatch.setattr(dist, "get_world_size", lambda group: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group: 0)
    mesh = ShardMesh(torch.device("cpu"), 2, group=object())
    p = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, _triplets(),
                                mesh=tp.make_fft_mesh(2, device="cpu")).params
    choice, chunks, rec = tuning.tuned_exchange(p, mesh, np.float64, "auto", "highest", False,
                                                lambda cand: pytest.fail("a trial ran"))
    assert chunks == 1
    assert rec["provenance"] == "model" and rec["trials"] == []
    assert rec["reason"] == "multi-host mesh: tuning requires cross-process agreement"
    assert choice == tp.parallel.policy.resolve_default_for_plan(p)


def _armed_outcome(pkg, spec, tmp_path, monkeypatch, name):
    """One tuned slab plan (engine xla) under ``spec``: the tuning record's
    provenance and reason head, the degradation events, and whether the
    wisdom file exists afterwards."""
    f, o = (faults, obs) if pkg is tp else (jfaults, jobs)
    path = tmp_path / f"{name}.json"
    monkeypatch.setenv(tuning.WISDOM_ENV, str(path))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    monkeypatch.setenv("SPFFT_TPU_FAULTS_DELAY_S", "0.001")
    mesh = tp.make_fft_mesh(2, device="cpu") if pkg is tp else spfft_tpu.make_fft_mesh(2)
    make = lambda: pkg.DistributedTransform(pkg.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                            _triplets(), mesh=mesh, engine="xla",
                                            policy="tuned")
    if spec.startswith("wisdom.load"):
        make()  # a store to load
    o.clear()
    with f.inject(spec):
        t = make()
    rec = t._tuning
    return {"provenance": rec["provenance"], "hit": rec["hit"],
            "reason": rec["reason"].split(":")[0],
            "degradations": [d["event"] for d in t._degradations],
            "errors": sorted({row["error"].split(":")[0] for row in rec["trials"]
                              if "error" in row}),
            "file": path.exists(), "corrupt": (tmp_path / f"{name}.json.corrupt").exists(),
            "retries": o.snapshot()["counters"].get("wisdom_retries_total", 0)}


@pytest.mark.parametrize("spec", ["tuning.trial=raise", "tuning.trial=delay",
                                  "wisdom.load=raise", "wisdom.load=corrupt",
                                  "wisdom.save=raise", "wisdom.save=delay"])
def test_each_armed_site_gives_the_jax_outcome(spec, tmp_path, monkeypatch):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        port = _armed_outcome(tp, spec, tmp_path, monkeypatch, "port")
        jax = _armed_outcome(spfft_tpu, spec, tmp_path, monkeypatch, "jax")
    assert port == jax


def test_tuned_batch_measures_the_fused_batch_size(monkeypatch):
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    t = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets())
    choice, rec = tuning.tuned_batch(t, batch_max=4)
    assert rec["provenance"] == "wisdom" and choice["batch"] in (1, 4)
    assert [row["label"] for row in rec["trials"]] != [] and len(rec["trials"]) == 2
    again, rec2 = tuning.tuned_batch(t, batch_max=4)
    assert rec2["hit"] is True and again == choice
    staged = tp.Transform(tp.ProcessingUnit.HOST, 0, DIM, DIM, DIM, indices=_triplets(),
                          fuse=False)
    assert tuning.tuned_batch(staged)[1]["reason"] == "batch fusion unavailable on this plan"
    monkeypatch.delenv(tuning.TUNE_CPU_ENV)
    tuning.clear_memory()
    choice, rec = tuning.tuned_batch(t)
    assert choice == {"label": "fused/uncapped", "batch": None}
    assert rec["reason"].startswith("trials skipped on CPU-only host")


def test_grid_create_transform_tunes(monkeypatch):
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    grid = tp.Grid(DIM, DIM, DIM, DIM * DIM, tp.ProcessingUnit.HOST)
    t = grid.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, DIM, DIM, DIM,
                              indices=_triplets(), policy="tuned")
    assert t._tuning["provenance"] == "wisdom" and t.report()["policy"] == "tuned"


def test_the_tune_program_hits_on_its_second_run(tmp_path, capsys, monkeypatch):
    from spfft_tpu_torch.programs import tune

    # the program sets these knobs for its process: restored after the test
    for name in (tuning.WISDOM_ENV, tuning.TUNE_CPU_ENV, tuning.TUNE_REPEATS_ENV):
        monkeypatch.setenv(name, "")

    argv = ["-d", "8", "8", "8", "--mesh2", "2", "2", "--cpu", "--allow-cpu-trials",
            "--repeats", "1", "--wisdom", str(tmp_path / "w.json")]
    assert tune.main(argv + ["-o", str(tmp_path / "a.json")]) == 0
    assert tune.main(argv + ["-o", str(tmp_path / "b.json"),
                             "--export", str(tmp_path / "bundle.json")]) == 0
    a, b = (json.loads((tmp_path / n).read_text()) for n in ("a.json", "b.json"))
    assert a["tuning"]["hit"] is False and b["tuning"]["hit"] is True
    assert b["tuning"]["choice"] == a["tuning"]["choice"]
    assert b["wisdom"]["configured"] is True
    assert tune.main(["--merge", str(tmp_path / "bundle.json")]) == 0
    assert "merged bundle" in capsys.readouterr().out
