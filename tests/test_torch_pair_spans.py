"""The scopes of the pair path (``Transform.backward_pair``/``forward_pair``)
and of the IR runtime's replay, in the three sinks of ``timing.scoped``: the
timing tree, the flight recorder's ``phase`` spans, and ``spfft:<label>``
ranges on a ``torch.profiler`` timeline.

On the CPU the plans run eagerly, so their "dispatch" holds no "copy in",
"replay" or "copy out"; the test of those three needs a CUDA device and skips
without one:

    python -m pytest --noconftest tests/test_torch_pair_spans.py -q   # on the card (no JAX there)
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import spfft_tpu_torch as tp
from spfft_tpu_torch import obs, timing
from spfft_tpu_torch.ir import compile as ir_compile
from spfft_tpu_torch.obs import trace

DIMS = (8, 8, 9)
RUNTIME = ("copy in", "replay", "copy out")


@pytest.fixture(autouse=True)
def _restore():
    yield
    timing.disable()
    timing.clear()
    trace.disable()


def plan(pu=tp.ProcessingUnit.HOST, engine="auto"):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8)
    return tp.Transform(pu, tp.TransformType.C2C, *DIMS, indices=trip, dtype=np.float32,
                        engine=engine)


def values(t, seed=5):
    rng = np.random.default_rng(seed)
    n = t.num_local_elements
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=t.device)
    return put(rng.standard_normal(n)), put(rng.standard_normal(n))


def pairs(t, n=1):
    re, im = values(t)
    for _ in range(n):
        t.backward_pair(re, im)
        re, im = t.forward_pair(tp.ScalingType.FULL)
    return re, im


def tree(result):
    """{label: (count, subtree)} below ``result``."""
    return {s.label: (s.count, tree(s)) for s in result.sub}


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_pair_calls_are_timed_per_call(engine):
    t = plan(engine=engine)
    timing.clear()
    timing.enable()
    pairs(t, 3)
    got = tree(timing.process())
    staged = {"input staging": (3, {}), "dispatch": (3, {})}
    # an eager CPU call has no copies and no replay
    assert got == {"backward": (3, staged), "forward": (3, staged)}


def test_pair_calls_count_as_transforms():
    t = plan()
    was = obs.is_enabled()
    obs.enable()
    obs.clear()
    try:
        pairs(t, 2)
        counters = obs.snapshot()["counters"]
    finally:
        obs.clear()
        if not was:
            obs.disable()
    assert counters['transforms_total{direction="backward",engine="xla"}'] == 2
    assert counters['transforms_total{direction="forward",engine="xla"}'] == 2


def test_pair_calls_are_execute_operations_with_phase_spans():
    t = plan()
    trace.enable()
    trace.clear()
    pairs(t, 1)
    events = trace.snapshot()["events"]
    ops = [e for e in events if e["name"] == "execute"]
    assert [(e["ph"], e["args"]["direction"]) for e in ops] == [
        ("B", "backward"), ("E", "backward"), ("B", "forward"), ("E", "forward")]
    run = t.report()["run_id"]
    assert {e["run"] for e in ops} == {run}
    phases = [(e["ph"], e["args"]["label"]) for e in events if e["name"] == "phase"]
    call = lambda d: [("B", d), ("B", "input staging"), ("E", "input staging"),
                      ("B", "dispatch"), ("E", "dispatch"), ("E", d)]
    assert phases == call("backward") + call("forward")
    assert {e["run"] for e in events if e["name"] == "phase"} == {run}


def test_pair_calls_draw_prefixed_profiler_ranges():
    t = plan()
    re, im = values(t)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t.backward_pair(re, im)
        t.forward_pair(tp.ScalingType.FULL)
    names = [e.name for e in prof.events() if e.name.startswith(timing.RANGE_PREFIX)]
    want = [timing.RANGE_PREFIX + label for label in
            ("backward", "input staging", "dispatch", "forward", "input staging", "dispatch")]
    assert sorted(names) == sorted(want)
    assert not any(s.startswith(timing.RANGE_PREFIX) for s in obs.STAGES)


def test_the_range_is_opened_with_the_other_sinks():
    timing.enable()
    trace.enable()
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.scoped("dispatch"):
            torch.ones(4).sum()
    assert timing.RANGE_PREFIX + "dispatch" in {e.name for e in prof.events()}
    assert [s.label for s in timing.process().sub] == ["dispatch"]
    assert [e["ph"] for e in trace.snapshot()["events"] if e["name"] == "phase"] == ["B", "E"]


def test_with_every_sink_off_a_scope_is_the_shared_no_op():
    timing.disable()
    trace.disable()
    assert not torch.autograd.profiler._is_profiler_enabled
    scope = timing.scoped("copy in")
    assert scope is timing.scoped("replay") is timing._NOOP
    with scope:
        pass
    assert timing.process().sub == []


def test_start_stop_keep_the_profiler_range_balanced_across_toggles():
    timing.start("outer")  # no profiler: no range opens
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timing.start("inner")
        torch.ones(2).sum()
        timing.stop("inner")
        timing.stop("outer")  # closes nothing it did not open
        timing.start("late")
    timing.stop("late")  # the profiler has stopped: its range still closes
    names = [e.name for e in prof.events() if e.name.startswith(timing.RANGE_PREFIX)]
    assert timing.RANGE_PREFIX + "inner" in names
    assert timing.RANGE_PREFIX + "outer" not in names
    assert timing._ranges == [] and timing._trace_spans == [] and timing._start_flags == []


def test_the_ir_s_counters_stay():
    t = plan(engine="mxu")
    before = dict(ir_compile.dispatches)
    pairs(t, 2)
    grown = {k: v - before.get(k, 0) for k, v in ir_compile.dispatches.items()}
    assert grown[("fused", "backward")] == 2 and grown[("fused", "forward")] == 2


@pytest.mark.card
def test_the_replay_s_scopes_nest_under_dispatch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = plan(tp.ProcessingUnit.GPU, engine="mxu")
    pairs(t, 1)  # the captures, outside the tree
    torch.cuda.synchronize()
    timing.clear()
    timing.enable()
    pairs(t, 2)
    torch.cuda.synchronize()
    runtime = {label: (2, {}) for label in RUNTIME}
    staged = {"input staging": (2, {}), "dispatch": (2, runtime)}
    assert tree(timing.process()) == {"backward": (2, staged), "forward": (2, staged)}
    timing.disable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pairs(t, 1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for label in RUNTIME:
        assert names.count(timing.RANGE_PREFIX + label) >= 2  # host (and device) ranges
