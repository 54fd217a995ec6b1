"""The port's fault-injection plane and guard mode (spfft_tpu_torch.faults)
against the JAX package's (spfft_tpu.faults).

The same specs, good and malformed, go through both parsers: equal tables,
equal error types and messages. The same armed sites on the same calls, on a
port plan and a JAX ``engine="xla"`` plan of the same triplets and values
(made from a seed with numpy, 16^3), give the same error types, the same
metric deltas of the fault and guard families and the same flight-recorder
event names. Guard's checks raise the JAX package's typed errors with its
messages; on a tensor the finite scan is a reduction where the tensor lives.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import faults as jfaults
from spfft_tpu import knobs as jknobs
from spfft_tpu import obs as jobs
from spfft_tpu_torch import faults, knobs, obs

DIM = 16
FAMILIES = ("faults_injected_total", "guard_checks_total", "guard_failures_total",
            "execution_failures_total", "degradations_total", "engine_fallbacks_total",
            "transforms_total")
KNOBS = ("SPFFT_TPU_FAULTS", "SPFFT_TPU_FAULTS_SEED", "SPFFT_TPU_FAULTS_DELAY_S",
         "SPFFT_TPU_GUARD", "SPFFT_TPU_VERIFY", "SPFFT_TPU_VERIFY_RTOL",
         "SPFFT_TPU_VERIFY_SEED", "SPFFT_TPU_VERIFY_RETRIES", "SPFFT_TPU_VERIFY_BACKOFF_S",
         "SPFFT_TPU_VERIFY_JITTER_SEED", "SPFFT_TPU_VERIFY_BREAKER_K",
         "SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    for f in (faults, jfaults):
        f.disarm()
        f.reseed(0)
    for o in (obs, jobs):
        o.enable()
        o.clear()
    yield
    for f in (faults, jfaults):
        f.disarm()
    for o in (obs, jobs):
        o.clear()
        o.trace.disable()


def test_hlo_stats_degrades_report():
    """The twin of the JAX package's test: ``hlo.stats=raise`` gives the
    card without its compiled section and with the degradation."""
    trip, _, _ = problem()
    t = plan(tp, trip)
    with faults.inject("hlo.stats=raise"):
        card = t.report(include_compiled=True)
    assert "compiled" not in card
    assert card["degradations"][0]["event"] == "hlo_stats_unavailable"
    assert obs.validate_plan_card(card) == []
    # fault-free report still carries the compiled section
    assert "compiled" in t.report(include_compiled=True)


def problem(seed=3):
    trip = np.asarray(tp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8))
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    space = rng.standard_normal((DIM,) * 3) + 1j * rng.standard_normal((DIM,) * 3)
    return trip, values, space


def plan(pkg, trip, engine="xla", **kw):
    return pkg.Transform(pkg.ProcessingUnit.HOST, pkg.TransformType.C2C, DIM, DIM, DIM,
                         indices=trip, dtype=np.float64, engine=engine, **kw)


def family_counters(o) -> dict:
    return {k: v for k, v in o.snapshot()["counters"].items() if k.startswith(FAMILIES)}


def outcome(pkg, o, f, spec, call, **plan_kw):
    """Plan and call under ``spec`` with the registry and recorder fresh:
    (the error's class name or None, the result, family counters, event
    names, the plan)."""
    trip, values, space = problem()
    o.clear()
    o.trace.enable()
    o.trace.clear()
    err, out, t = None, None, None
    with f.inject(spec):
        try:
            t = plan(pkg, trip, **plan_kw)
            out = call(t, values, space)
        except pkg.GenericError as e:
            err = type(e).__name__
    names = [e["name"] for e in o.trace.snapshot()["events"]]
    o.trace.disable()
    return err, out, family_counters(o), names, t


def as_numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---- the plane ---------------------------------------------------------------


def test_vocabularies_and_knobs_are_the_jax_packages():
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS
    assert (faults.FAULTS_ENV, faults.FAULTS_SEED_ENV, faults.FAULTS_DELAY_ENV,
            faults.GUARD_ENV) == (jfaults.FAULTS_ENV, jfaults.FAULTS_SEED_ENV,
                                  jfaults.FAULTS_DELAY_ENV, jfaults.GUARD_ENV)
    for name in KNOBS:
        mine, theirs = knobs.REGISTRY[name], jknobs.REGISTRY[name]
        assert (mine.kind, mine.default, mine.choices, mine.floor) == (
            theirs.kind, theirs.default, theirs.choices, theirs.floor), name


@pytest.mark.parametrize("spec", [
    "engine.compile=raise, wisdom.load=corrupt:0.5",
    "engine.execute=nan",
    "sync.fence=delay:0.25,ir.batch=raise:1,verify.check=corrupt:0",
    " , ir.lower=raise ,",
])
def test_good_specs_parse_the_same(spec):
    assert faults.parse_spec(spec) == jfaults.parse_spec(spec)


@pytest.mark.parametrize("spec", [
    "engine.compile", "engine.compile=", "engine.compile=explode",
    "bogus.site=raise",  # noqa: SA018 — an unregistered site, the refusal under test
    "engine.compile=raise:lots", "engine.compile=raise:1.5", "engine.compile=raise:-0.1",
    "engine.compile=raise,engine.compile=nan",
])
def test_malformed_specs_raise_the_same(spec):
    with pytest.raises(spfft_tpu.InvalidParameterError) as want:
        jfaults.parse_spec(spec)
    with pytest.raises(tp.InvalidParameterError) as got:
        faults.parse_spec(spec)
    assert str(got.value) == str(want.value)
    assert faults.armed() == {}  # a bad spec arms nothing


@pytest.mark.parametrize("table", [
    {"engine.compile": {"kind": "raise"}},
    {"nope": {"kind": "raise"}},
    {"engine.compile": {"kind": "boom"}},
    {"engine.compile": {"kind": "raise", "rate": 2}},
])
def test_dict_arming_matches(table):
    try:
        jfaults.arm(table)
        want = jfaults.armed()
    except spfft_tpu.InvalidParameterError as e:
        with pytest.raises(tp.InvalidParameterError) as got:
            faults.arm(table)
        assert str(got.value) == str(e)
        return
    faults.arm(table)
    assert faults.armed() == want == {"engine.compile": {"kind": "raise", "rate": 1.0}}


def test_poison_kind_on_a_payloadless_site_is_an_uncounted_noop():
    with faults.inject("sync.fence=nan"):
        assert faults.site("sync.fence") is None
    assert obs.snapshot()["counters"] == {}


def test_inject_restores_the_table_also_on_error():
    faults.arm("ir.lower=raise:0.5")
    with pytest.raises(faults.InjectedFault):
        with faults.inject("engine.execute=raise"):
            faults.site("engine.execute")
    assert faults.armed() == {"ir.lower": {"kind": "raise", "rate": 0.5}}
    faults.disarm("ir.lower")
    assert faults.armed() == {} and faults.site("ir.lower", 7) == 7


def test_fractional_rate_draws_the_jax_packages_sequence():
    def pattern(f):
        f.reseed(11)
        fired = []
        with f.inject("engine.execute=raise:0.5"):
            for _ in range(64):
                try:
                    f.site("engine.execute")
                    fired.append(False)
                except RuntimeError:
                    fired.append(True)
        return fired

    mine = pattern(faults)
    assert mine == pattern(jfaults) == pattern(faults)
    assert any(mine) and not all(mine)


def test_env_arming_at_import():
    code = ("from spfft_tpu_torch import faults;"
            "assert faults.armed() == {'engine.execute': {'kind': 'raise', 'rate': 0.25}},"
            " faults.armed(); print('armed ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "SPFFT_TPU_FAULTS": "engine.execute=raise:0.25",
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and "armed ok" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("kind,value", [("nan", float("nan")), ("corrupt", float("inf"))])
def test_poison_is_out_of_place_on_tensors_pairs_and_arrays(kind, value):
    re, im = torch.ones(4, dtype=torch.float64), torch.full((4,), 2.0, dtype=torch.float64)
    arr = np.ones(3)
    with faults.inject(f"engine.execute={kind}"):
        pair = faults.site("engine.execute", payload=(re, im))
        one = faults.site("engine.execute", payload=arr)
    assert isinstance(pair, tuple) and len(pair) == 2
    for got in (*pair, torch.as_tensor(one)):
        assert not torch.isfinite(got).any()
        if kind == "corrupt":
            assert torch.isinf(got).all()
    assert (re == 1).all() and (im == 2).all() and (arr == 1).all()  # the inputs untouched
    assert obs.snapshot()["counters"] == {
        f'faults_injected_total{{kind="{kind}",site="engine.execute"}}': 2}
    with faults.inject("wisdom.load=corrupt"):
        assert faults.site("wisdom.load", "abcdef") == jfaults.plane._corrupt("abcdef")


def test_delay_kind_keeps_results_right(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_FAULTS_DELAY_S", "0.01")
    trip, values, _ = problem()
    want = plan(tp, trip).backward(values)
    t0 = time.perf_counter()
    with faults.inject("engine.execute=delay,sync.fence=delay"):
        got = plan(tp, trip).backward(values)
    assert time.perf_counter() - t0 >= 0.02
    assert torch.equal(got, want)
    assert sum(family_counters(obs)[k] for k in family_counters(obs)
               if k.startswith("faults_injected")) == 2


# ---- armed sites on a plan, against the JAX package ---------------------------


def _backward(t, values, space):
    return t.backward(values)


def _forward(t, values, space):
    return t.forward(space)


CALLS = {"backward": _backward, "forward": _forward}
# (spec, call, plan kwargs): each armed site's outcome must be the JAX package's
SITE_CASES = [
    ("engine.execute=raise", "backward", {}),
    ("engine.execute=raise", "forward", {}),
    ("engine.execute=nan", "backward", {"guard": True}),
    ("engine.execute=corrupt", "forward", {"guard": True}),
    ("engine.execute=nan", "backward", {}),
    ("sync.fence=raise", "backward", {}),
    ("sync.fence=raise", "forward", {}),
    ("sync.fence=raise", "backward", {"guard": True}),
]


@pytest.mark.parametrize("spec,call,kw", SITE_CASES,
                         ids=[f"{s}-{c}-{'guard' if k else 'plain'}" for s, c, k in SITE_CASES])
def test_armed_site_outcome_is_the_jax_packages(spec, call, kw):
    jerr, jout, jc, jnames, _ = outcome(spfft_tpu, jobs, jfaults, spec, CALLS[call], **kw)
    perr, pout, pc, pnames, _ = outcome(tp, obs, faults, spec, CALLS[call], **kw)
    assert perr == jerr
    assert pc == jc
    assert pnames == jnames
    if jerr is None:  # no guard: a poisoned result flows, on both sides alike
        assert np.isnan(as_numpy(pout)).all() == np.isnan(as_numpy(jout)).all()


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_typed_execution_errors_on_each_engine(engine):
    trip, values, _ = problem()
    t = plan(tp, trip, engine=engine)
    with faults.inject("engine.execute=raise"):
        with pytest.raises(tp.HostExecutionError, match="backward dispatch failed"):
            t.backward(values)
    with faults.inject("sync.fence=raise"):
        with pytest.raises(tp.HostExecutionError, match="backward wait failed"):
            t.backward(values)
        t.set_execution_mode(tp.ExecType.ASYNCHRONOUS)
        t.backward(values)  # no fence in the call
        with pytest.raises(tp.HostExecutionError, match="synchronize failed"):
            t.synchronize()
    assert obs.snapshot()["counters"]['execution_failures_total{op="synchronize"}'] == 1


def test_the_error_surface_names_the_card_platform():
    assert faults.execution_error("cpu") is tp.HostExecutionError
    assert faults.execution_error("gpu") is tp.GPUFFTError
    with pytest.raises(tp.GPUFFTError, match="op failed: injected") as e:
        with faults.typed_execution("gpu", "op"):
            raise faults.InjectedFault("injected")
    assert isinstance(e.value.__cause__, faults.InjectedFault)
    with pytest.raises(tp.InvalidParameterError):  # typed errors pass untouched
        with faults.typed_execution("gpu", "op"):
            raise tp.InvalidParameterError("mine")
    with pytest.raises(TypeError):  # programming errors too
        with faults.typed_execution("gpu", "op"):
            raise TypeError("bug")


# ---- guard ----------------------------------------------------------------------


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_guard_rejects_a_nonfinite_input_with_the_jax_message(bad):
    trip, values, _ = problem()
    values = values.copy()
    values[3] = bad
    msgs = []
    for pkg, o in ((spfft_tpu, jobs), (tp, obs)):
        t = plan(pkg, trip, guard=True)
        o.clear()
        with pytest.raises(pkg.HostExecutionError) as e:
            t.backward(values)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "guard [backward input]: backward input: 1 non-finite value(s) of " \
        f"{len(trip)}"
    assert family_counters(obs) == family_counters(jobs)


def test_guard_scans_tensors_where_they_live_and_keeps_numerics():
    trip, values, space = problem()
    want = plan(tp, trip).backward(values)
    t = plan(tp, trip, guard=True)
    got = t.backward(torch.as_tensor(values))
    back = t.forward(space)
    assert torch.equal(got, want)
    assert back.shape == (len(trip),)
    c = obs.snapshot()["counters"]
    for check in ("backward input", "backward output", "forward input", "forward output"):
        assert c[f'guard_checks_total{{check="{check}"}}'] >= 1
    assert not any(k.startswith("guard_failures") for k in c)


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 3), None, "guard [x]: x shape (2, 2) != expected (2, 3)"),
    (None, np.complex64, "guard [x]: x dtype float64 != expected complex64"),
])
def test_guard_contract_messages_are_the_jax_packages(shape, dtype, want):
    arr = np.ones((2, 2))
    for f, err in ((jfaults, spfft_tpu.GPUFFTError), (faults, tp.GPUFFTError)):
        with pytest.raises(err) as e:
            f.check_array(arr, check="x", platform="gpu", shape=shape, dtype=dtype)
        assert str(e.value) == want
    t = torch.ones((2, 2), dtype=torch.float64)
    with pytest.raises(tp.GPUFFTError) as e:
        faults.check_array(t, check="x", platform="gpu", shape=shape, dtype=dtype)
    assert str(e.value) == want


def test_guard_counts_nonfinite_only_on_failure_and_skips_remote_shards():
    ok = [torch.ones(5), None, np.zeros(2)]
    assert faults.check_array(ok, check="c", platform="cpu") is ok
    bad = [torch.ones(5), torch.tensor([1.0, float("nan"), float("inf")])]
    with pytest.raises(tp.HostExecutionError, match=r"c\[1\]: 2 non-finite value\(s\) of 3"):
        faults.check_array(bad, check="c", platform="cpu")
    c = obs.snapshot()["counters"]
    assert c['guard_checks_total{check="c"}'] == 2 and c['guard_failures_total{check="c"}'] == 1


def test_guard_scans_permuted_views_in_place():
    """The mxu engine's results are permuted views: the scan reads them in
    memory order, without a copy, and finds a non-finite value anywhere."""
    base = torch.ones((4, 5, 6), dtype=torch.complex64)
    view = base.permute(2, 0, 1)
    assert faults.guard._memory_order(view).data_ptr() == base.data_ptr()
    assert faults.check_array([view, view[0]], check="v", platform="cpu")[0] is view
    base[3, 4, 5] = complex(float("nan"), 0.0)
    with pytest.raises(tp.HostExecutionError, match=r"v\[0\]: 1 non-finite value\(s\) of 120"):
        faults.check_array([view, base[0]], check="v", platform="cpu")


def test_guard_passes_finite_values_whose_sum_overflows():
    big = torch.full((8,), 3e38, dtype=torch.float32)  # the sum is inf in float32
    assert faults.check_array([big, torch.ones(3)], check="s", platform="cpu")[0] is big
    with pytest.raises(tp.HostExecutionError, match=r"s\[0\]: 1 non-finite value"):
        faults.check_array([torch.cat([big, torch.tensor([float("-inf")])]), None],
                           check="s", platform="cpu")


def test_guard_device_check():
    out = (torch.ones(2), torch.ones(2))
    assert faults.check_device(out, torch.device("cpu"), check="d", platform="cpu") is out
    with pytest.raises(tp.GPUFFTError, match="but the plan is bound to cuda:0"):
        faults.check_device(out, torch.device("cuda:0"), check="d", platform="gpu")


def test_guard_env_knob_and_explicit_argument(monkeypatch):
    trip, values, _ = problem()
    values = values.copy()
    values[0] = np.nan
    monkeypatch.setenv("SPFFT_TPU_GUARD", "1")
    assert faults.guard_enabled() and not faults.guard_enabled(False)
    with pytest.raises(tp.HostExecutionError):
        plan(tp, trip).backward(values)
    out = plan(tp, trip, guard=False).backward(values)  # the argument wins
    assert torch.isnan(out).any()
    monkeypatch.setenv("SPFFT_TPU_GUARD", "maybe")
    with pytest.raises(tp.InvalidParameterError):
        faults.guard_enabled()


def test_guard_on_a_distributed_plan_rejects_a_poisoned_shard():
    trip, _, _ = problem()
    per = tp.distribute_triplets(trip, 2, DIM)
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)) for p in per]
    vals[1][0] = np.inf
    results = []
    for pkg in (spfft_tpu, tp):
        mesh = pkg.make_fft_mesh(2) if pkg is spfft_tpu else pkg.make_fft_mesh(2, device="cpu")
        t = pkg.DistributedTransform(pkg.ProcessingUnit.HOST, 0, DIM, DIM, DIM,
                                     [np.array(p) for p in per], mesh=mesh, engine="xla",
                                     dtype=np.float64, guard=True)
        with pytest.raises(pkg.HostExecutionError) as e:
            t.backward(vals)
        results.append(str(e.value))
    assert results[0] == results[1] == "guard [backward input]: backward input[1]: 1 " \
        f"non-finite value(s) of {len(per[1])}"
