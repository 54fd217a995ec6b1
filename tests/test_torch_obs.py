"""The port's observability layer (spfft_tpu_torch.obs, .sync, the errors
hook, the knobs) against the JAX package's (spfft_tpu.obs).

The same sequence of calls, on the same triplets and values made from a seed
with numpy, goes through ``engine="xla"`` plans of both packages, local and
on a 4-shard CPU mesh, and must give the same registry counters (labels and
values) and the same sequence of flight-recorder events (names, phases,
phase labels, decisions). One divergence by design: the port's results stay
on the plan's device where the JAX package's are numpy, so
``staged_bytes_total{direction="device_to_host"}`` counts only the port's
real host fetches (``space_domain_data()``), which must equal the JAX
package's bytes for the same fetch. Plan cards pass the JAX package's
validator and equal its cards on the shared fields.
"""
import json

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import obs as jobs
from spfft_tpu.obs import metrics as jmetrics
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu.obs import trace as jtrace
from spfft_tpu_torch import knobs, obs, sync
from spfft_tpu_torch.obs import metrics, trace

DIMS = (8, 8, 9)
CASES = [(r2c, shards) for shards in (1, 4) for r2c in (False, True)]
D2H = 'staged_bytes_total{direction="device_to_host"}'


@pytest.fixture(autouse=True)
def _restore():
    yield
    for o in (jobs, obs):
        o.enable()
        o.clear()
        o.trace.disable()


def make_plan(pkg, r2c, shards, per, dtype=np.float64, exchange="BUFFERED"):
    if shards == 1:
        return pkg.Transform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS, indices=per[0],
                             dtype=dtype, engine="xla")
    mesh = pkg.make_fft_mesh(shards) if pkg is spfft_tpu else pkg.make_fft_mesh(shards,
                                                                                 device="cpu")
    return pkg.DistributedTransform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS,
                                    [np.array(t) for t in per], mesh=mesh, dtype=dtype,
                                    engine="xla", exchange_type=pkg.ExchangeType[exchange])


def problem(r2c, shards, seed=5):
    rng = np.random.default_rng(seed)
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8, hermitian_symmetry=r2c)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, shards, DIMS[1])]
    vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    space = rng.standard_normal(DIMS[::-1])
    if not r2c:
        space = space + 1j * rng.standard_normal(DIMS[::-1])
    return per, (vals[0] if shards == 1 else vals), space


def drive(pkg, t, vals, space):
    t.backward(vals)
    t.forward(scaling=pkg.ScalingType.FULL)
    t.forward(space, pkg.ScalingType.NONE)
    pkg.multi_transform_backward([t], [vals])
    pkg.multi_transform_forward([t], None, pkg.ScalingType.FULL)
    t.backward_batch([vals, vals])
    t.forward_batch([space, space])


def record(pkg, o, r2c, shards):
    """Plan and drive with the registry and recorder fresh and armed:
    (counters, events, plan)."""
    per, vals, space = problem(r2c, shards)
    o.enable()
    o.clear()
    o.trace.enable()
    o.trace.clear()
    t = make_plan(pkg, r2c, shards, per)
    drive(pkg, t, vals, space)
    events = [(e["name"], e["ph"], e["args"].get("label"), e["args"].get("what"),
               e["args"].get("choice"), e["args"].get("direction"))
              for e in o.trace.snapshot()["events"]]
    counters = o.snapshot()["counters"]
    o.trace.disable()
    return counters, events, t


@pytest.mark.parametrize("r2c,shards", CASES)
def test_same_calls_give_the_same_counters(r2c, shards):
    jc, _, jt = record(spfft_tpu, jobs, r2c, shards)
    pc, _, pt = record(tp, obs, r2c, shards)
    assert D2H not in pc  # the port's results stayed on the device
    jc.pop(D2H)
    assert pc == jc
    keys = set(pc)
    assert 'transforms_total{direction="backward",engine="xla"}' in keys
    assert ('exchange_wire_bytes_total{engine="xla"}' in keys) == (shards > 1)
    # a host fetch counts the same bytes in both packages
    for pkg, o, t in ((spfft_tpu, jobs, jt), (tp, obs, pt)):
        o.clear()
        t.space_domain_data()
    assert obs.snapshot()["counters"] == jobs.snapshot()["counters"]


@pytest.mark.parametrize("r2c,shards", CASES)
def test_same_calls_give_the_same_trace(r2c, shards):
    _, jev, _ = record(spfft_tpu, jobs, r2c, shards)
    _, pev, _ = record(tp, obs, r2c, shards)
    assert pev == jev
    assert {"plan", "execute", "phase", "fence", "decision"} <= {e[0] for e in pev}


def test_snapshots_pass_the_jax_validators():
    _, _, t = record(tp, obs, False, 4)
    obs.trace.enable()
    t.backward(problem(False, 4)[1])
    snap = obs.snapshot()
    assert jobs.validate_snapshot(snap) == [] == obs.validate_snapshot(snap)
    assert json.loads(json.dumps(snap)) == snap
    assert obs.prometheus_text(snap) == jobs.prometheus_text(snap)
    tsnap = trace.snapshot()
    assert jtrace.validate_trace(tsnap) == [] == trace.validate_trace(tsnap)
    assert tsnap["events"] and json.loads(json.dumps(tsnap)) == tsnap
    # the Chrome rendering is the JAX package's, under the port's process name
    chrome, want = trace.chrome_trace(tsnap), jtrace.chrome_trace(tsnap)
    want["traceEvents"][0]["args"]["name"] = "spfft_tpu_torch host"
    assert chrome == want
    runs = {e["run"] for e in tsnap["events"] if e["name"] == "execute"}
    assert runs == {t.report()["run_id"]}


@pytest.mark.parametrize("r2c,shards", CASES)
def test_plan_cards_pass_the_jax_validator_and_match(r2c, shards):
    per, _, _ = problem(r2c, shards)
    jcard = make_plan(spfft_tpu, r2c, shards, per).report()
    pcard = make_plan(tp, r2c, shards, per).report()
    assert jplancard.validate_plan_card(pcard) == [] == obs.validate_plan_card(pcard)
    assert set(jplancard.REQUIRED_KEYS) <= set(pcard)
    assert pcard["schema"] == "spfft_tpu.obs.plan_card/1"
    for key in ("kind", "engine", "transform_type", "dims", "num_elements", "num_sticks",
                "nnz_fraction", "dtype", "precision", "policy", "platform", "degradations",
                "verification"):
        assert pcard[key] == jcard[key], key
    assert pcard["ir"]["path"] == jcard["ir"]["path"] == "fused"
    if shards == 1:
        assert pcard["ir"]["stages"] == jcard["ir"]["stages"]
    else:  # on one device the port's exchange is one gather: no pack/unpack nodes
        for d in ("backward", "forward"):
            assert pcard["ir"]["stages"][d] == [s for s in jcard["ir"]["stages"][d]
                                                if s not in ("pack", "unpack")]
    assert set(pcard["batch"]) == set(jcard["batch"])
    if shards > 1:
        for key in ("num_shards", "mesh", "decomposition", "num_sticks_per_shard",
                    "local_z_lengths"):
            assert pcard[key] == jcard[key], key
        # "transport" names each package's own mechanism: the JAX package's
        # all_to_all, the port's gather on the one device
        for key in ("discipline", "wire_dtype", "wire_bytes", "rounds", "overlap_chunks"):
            assert pcard["exchange"][key] == jcard["exchange"][key], key
        assert pcard["exchange"]["transport"] == "device gather"
        assert pcard["exchange_policy"]["chosen"] == jcard["exchange_policy"]["chosen"]


@pytest.mark.parametrize("exchange", ["UNBUFFERED", "COMPACT_BUFFERED_FLOAT", "BUFFERED_BF16"])
def test_distributed_exchange_fields_match_per_discipline(exchange):
    per, _, _ = problem(False, 4)
    jcard = make_plan(spfft_tpu, False, 4, per, exchange=exchange).report()
    pcard = make_plan(tp, False, 4, per, exchange=exchange).report()
    for key in ("discipline", "wire_dtype", "wire_bytes", "overlap_chunks"):
        assert pcard["exchange"][key] == jcard["exchange"][key], key
    assert jplancard.validate_plan_card(pcard) == []
    chosen = [a["discipline"] for a in pcard["exchange_policy"]["alternatives"] if a["chosen"]]
    assert chosen == [jplancard.base_discipline(spfft_tpu.ExchangeType[exchange]).name]


def test_grid_report_matches():
    for mesh in (None, 4):
        kw = {} if mesh is None else {"max_local_z_length": 3}
        jg = spfft_tpu.Grid(8, 8, 9, 40, spfft_tpu.ProcessingUnit.HOST,
                            mesh=None if mesh is None else spfft_tpu.make_fft_mesh(4), **kw)
        pg = tp.Grid(8, 8, 9, 40, tp.ProcessingUnit.HOST,
                     mesh=None if mesh is None else tp.make_fft_mesh(4, device="cpu"), **kw)
        jcard, pcard = jg.report(), pg.report()
        assert set(pcard) == set(jcard)
        jcard.pop("device", None), pcard.pop("device", None)
        assert pcard == jcard


def test_local_plan_card_compiled_stats():
    """The twin of the JAX package's test: a local card with its compiled
    section, valid under both packages' rules and JSON-stable."""
    per, _, _ = problem(False, 1)
    card = make_plan(tp, False, 1, per).report(include_compiled=True)
    assert obs.validate_plan_card(card) == []
    assert jplancard.validate_plan_card(card) == []
    compiled = card["compiled"]
    assert compiled["compile_seconds"] > 0
    assert isinstance(compiled["hlo_op_classes"], dict) and compiled["hlo_op_classes"]
    assert isinstance(compiled["element_granular_ops"], int)
    assert json.loads(json.dumps(card)) == card


def test_vocabularies_are_the_jax_packages():
    assert obs.STAGES == jobs.STAGES
    jrows = {row[0]: row for row in jmetrics.METRICS}
    assert all(jrows[row[0]] == row for row in metrics.METRICS)
    assert metrics.KINDS == jmetrics.KINDS
    assert metrics.names() == tuple(r["name"] for r in metrics.describe())
    assert set(trace.EVENTS) <= set(jtrace.EVENTS)
    assert trace.TRACE_SCHEMA == jtrace.TRACE_SCHEMA
    assert obs.SNAPSHOT_SCHEMA == jobs.SNAPSHOT_SCHEMA


def test_disabled_layers_hand_out_one_shared_object():
    obs.disable()
    assert obs.counter("transforms_total", direction="a", engine="b") is obs.gauge("x")
    assert obs.histogram("x") is obs.counter("y")
    assert obs.phase_timer("wait_seconds", direction="a") is obs.phase_timer("x")
    obs.counter("transforms_total").inc()
    assert obs.snapshot()["counters"] == {}
    trace.disable()
    assert not trace.enabled()
    assert trace.span("fence") is trace.operation("execute") is trace.span("phase")
    trace.event("decision", what="x")
    assert trace.snapshot()["events"] == []


def test_recorder_ring_is_bounded():
    trace.enable(capacity=3)
    for i in range(5):
        trace.event("decision", i=i)
    snap = trace.snapshot()
    assert snap["capacity"] == 3 and snap["dropped"] == 2
    assert [e["args"]["i"] for e in snap["events"]] == [2, 3, 4]


def test_typed_error_notifies_the_recorder_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_TRACE_DUMP", str(tmp_path))
    trace.enable()
    with pytest.warns(RuntimeWarning, match="dumped"):
        err = tp.InvalidParameterError("bad input")
    events = trace.snapshot()["events"]
    assert events[-1]["name"] == "error"
    assert events[-1]["args"]["type"] == "InvalidParameterError"
    assert events[-1]["args"]["error_code"] == int(err.error_code)
    dumps = list(tmp_path.glob("trace-*.json"))
    assert len(dumps) == 1
    doc = json.loads(dumps[0].read_text())
    assert doc["reason"] == "InvalidParameterError" and jtrace.validate_trace(doc) == []


@pytest.mark.parametrize("name,value", [("SPFFT_TPU_METRICS", "maybe"),
                                        ("SPFFT_TPU_TRACE", "2"),
                                        ("SPFFT_TPU_TRACE_CAP", "many"),
                                        ("SPFFT_TPU_PERF_FLOP_PER_BYTE", "x"),
                                        ("SPFFT_TPU_FENCE_BUDGET_S", "soon")])
def test_malformed_knobs_raise_typed(monkeypatch, name, value):
    from spfft_tpu import knobs as jknobs

    monkeypatch.setenv(name, value)
    kind = knobs.REGISTRY[name].kind
    get = {"bool": knobs.get_bool, "int": knobs.get_int, "float": knobs.get_float}[kind]
    with pytest.raises(tp.InvalidParameterError):
        get(name)
    with pytest.raises(spfft_tpu.InvalidParameterError):
        jknobs.get(name)


def test_knob_defaults_and_floor_are_the_jax_packages(monkeypatch):
    from spfft_tpu import knobs as jknobs

    for name in ("SPFFT_TPU_METRICS", "SPFFT_TPU_TRACE", "SPFFT_TPU_TRACE_CAP",
                 "SPFFT_TPU_TRACE_DUMP", "SPFFT_TPU_PERF_FLOP_PER_BYTE",
                 "SPFFT_TPU_FENCE_BUDGET_S"):
        assert knobs.default(name) == jknobs.default(name), name
    monkeypatch.setenv("SPFFT_TPU_TRACE_CAP", "0")
    assert knobs.get_int("SPFFT_TPU_TRACE_CAP") == 1 == jknobs.get_int("SPFFT_TPU_TRACE_CAP")
    monkeypatch.setenv("SPFFT_TPU_TRACE", "On")
    assert knobs.get_bool("SPFFT_TPU_TRACE") is True
    assert knobs.get_str("SPFFT_TPU_TRACE_DUMP") is None


def test_fence_on_cpu_tensors_returns_the_tree_in_a_fence_span():
    trace.enable()
    tree = {"a": (torch.ones(3), [torch.zeros(2)]), "b": None}
    assert sync.fence(tree) is tree
    assert [(e["name"], e["ph"]) for e in trace.snapshot()["events"]] == [("fence", "B"),
                                                                            ("fence", "E")]
    assert sync.wait(tree) is tree
    assert issubclass(sync.FenceTimeout, RuntimeError)


@pytest.mark.parametrize("shards", [1, 4])
def test_synchronize_fences_a_plan_that_retains_nothing(shards):
    per, vals, _ = problem(False, shards)
    t = make_plan(tp, False, shards, per)
    t.set_execution_mode(tp.ExecType.ASYNCHRONOUS)
    trace.enable()
    t.synchronize()  # a fresh plan: the fence runs on the plan's device all the same
    assert [(e["name"], e["ph"]) for e in trace.snapshot()["events"]] == [("fence", "B"),
                                                                            ("fence", "E")]


def test_fence_budget_knob_is_read_and_validated(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_FENCE_BUDGET_S", "nope")
    with pytest.raises(tp.InvalidParameterError):
        sync.fence(torch.ones(1))
    monkeypatch.setenv("SPFFT_TPU_FENCE_BUDGET_S", "0.5")
    out = torch.ones(2)
    assert sync.fence(out) is out  # CPU work is complete: nothing to wait for
