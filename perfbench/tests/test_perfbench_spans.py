"""The reductions of the program's own ranges (``perfbench/spans.py``) on a
recorded trace: four pairs of the fused ``c2c-256-s15`` plan, fenced every
two, as ``fixtures/record.py`` records them, by a program whose
``timing.scoped`` draws ``spfft:<label>`` ranges, on an NVIDIA H100 80GB HBM3
(700 W) with torch 2.11.0+cu128. The expected numbers are summed here from
the raw events. On the trace of a program that draws no such range (the
earlier fixture, ``trace_c2c-256-s15_4pairs.json``) every reduction reads
nothing, and every per-layer reader of the benchmark reads what it read
before these ranges existed."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import spans, spec, trace

HERE = Path(__file__).resolve().parent / "fixtures"
EVENTS = json.loads((HERE / "trace_c2c-256-s15_4pairs_spans.json").read_text())["traceEvents"]
OLD = json.loads((HERE / "trace_c2c-256-s15_4pairs.json").read_text())["traceEvents"]
PAIRS = 4
# each reduction, called with the stretch's Profile and the trace's events
NEW = {"copy in": lambda p, ev: spans.device_ms(p, ev, spans.COPY_IN),
       "copy out": lambda p, ev: spans.device_ms(p, ev, spans.COPY_OUT),
       "entry": spans.entry_ms,
       "copies": lambda p, ev: spans.host_ms(p, ev, spans.COPY_IN, spans.COPY_OUT),
       "replay": lambda p, ev: spans.host_ms(p, ev, spans.REPLAY),
       "idle in calls": spans.idle_in_calls_pct}
# what the readers read on the earlier fixture before the program drew its ranges
BEFORE = {"k1_ms_per_pair": 1.3538695, "k2_ms_per_pair": 0.0603625,
          "torch_ops_ms_per_pair": 0.10588499999999999, "graph_copy_ms_per_pair": 0.2219775,
          "device_idle_pct.ahead": 8.332364078841714, "device_idle_pct.sync": 8.332364078841714}


@pytest.fixture(scope="module")
def profile():
    return trace.Profile(EVENTS, PAIRS, spec.kernel_families())


def read(name, profile, window=None):
    return spec.reader(name)(SimpleNamespace(profile=profile, window=window or {}))


def new(name, profile, events=EVENTS):
    return NEW[name](profile, events)


def host(name):
    """The host ranges named ``name`` inside the stretch, as (start, end)."""
    s = next(e for e in EVENTS if e.get("name") == trace.STRETCH)
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in EVENTS
                  if e.get("cat") == "user_annotation" and e["name"] == name
                  and s["ts"] <= e["ts"] < s["ts"] + s["dur"])


def inside(span, spans_):
    return any(a <= span[0] and span[1] <= b for a, b in spans_)


def launched_in(label):
    """Device µs of the activities whose runtime call began in a range."""
    ranges = host("spfft:" + label)
    corr = {e["args"]["correlation"] for e in EVENTS if e.get("cat") == "cuda_runtime"
            and any(a <= e["ts"] < b for a, b in ranges)}
    return sum(e["dur"] for e in EVENTS if e.get("cat") in trace.DEVICE_CATS
               and e.get("args", {}).get("correlation") in corr)


def test_the_ranges_nest_as_the_pair_path_opens_them():
    calls = host("spfft:backward") + host("spfft:forward")
    harness = host("perfbench.backward_pair") + host("perfbench.forward_pair")
    assert len(host("spfft:backward")) == len(host("spfft:forward")) == PAIRS
    assert all(inside(c, harness) for c in calls)
    dispatch = host("spfft:dispatch")
    assert len(dispatch) == len(host("spfft:input staging")) == 2 * PAIRS
    assert all(inside(d, calls) for d in dispatch + host("spfft:input staging"))
    for label in spans.RUNTIME:
        found = host("spfft:" + label)
        assert len(found) == 2 * PAIRS and all(inside(r, dispatch) for r in found)


def test_the_copies_split_the_graph_copies(profile):
    copy_in, copy_out = new("copy in", profile), new("copy out", profile)
    assert copy_in == pytest.approx(launched_in("copy in") / 1e3 / PAIRS)
    assert copy_out == pytest.approx(launched_in("copy out") / 1e3 / PAIRS)
    # values in 2 x 10 MB and the space back in 2 x 64 MB; the space out and the values out
    assert 0.09 < copy_in < 0.13 and 0.09 < copy_out < 0.13
    graph = read("graph_copy_ms_per_pair", profile)
    assert abs(copy_in + copy_out - graph) <= 0.02 * graph
    assert launched_in("replay") > 0  # the graphs' kernels carry the launch's correlation


def test_the_host_s_time_in_the_calls(profile):
    per_pair = lambda spans_: sum(b - a for a, b in spans_) / 1e3 / PAIRS
    calls = host("spfft:backward") + host("spfft:forward")
    copies = host("spfft:copy in") + host("spfft:copy out")
    replay = host("spfft:replay")
    assert new("copies", profile) == pytest.approx(per_pair(copies))
    assert new("replay", profile) == pytest.approx(per_pair(replay))
    entry = new("entry", profile)
    assert entry == pytest.approx(per_pair(calls) - per_pair(copies) - per_pair(replay))
    harness = per_pair(host("perfbench.backward_pair") + host("perfbench.forward_pair"))
    parts = entry + new("copies", profile) + new("replay", profile)
    assert 0 < entry and parts <= harness


def test_the_device_idle_while_the_host_is_in_a_call(profile):
    calls = host("spfft:backward") + host("spfft:forward")
    idle = sum(max(0.0, min(b, d) - max(a, c)) for a, b in profile.idle_gaps() for c, d in calls)
    got = new("idle in calls", profile)
    assert got == pytest.approx(100 * idle / profile.window_us)
    assert 0 < got < read("device_idle_pct.sync", profile)


def test_the_earlier_readers_read_the_spans_trace_as_any(profile):
    assert read("k1_ms_per_pair", profile) > 1.2 and read("k2_ms_per_pair", profile) > 0.04
    assert profile.count("k1") == 12 * PAIRS and profile.count(trace.HARNESS) == 2 * PAIRS
    # the device timeline's spfft: ranges are no device activity
    assert all(not e["name"].startswith(spans.PREFIX) for e in profile.device_ops)


def test_a_trace_without_the_program_s_ranges():
    old = trace.Profile(OLD, PAIRS, spec.kernel_families())
    for name, value in BEFORE.items():
        assert read(name, old) == value, name
    assert read("host_call_ms.sync", old, {"host_call_s": [2e-4, 4e-4]}) == pytest.approx(0.3)
    for name in NEW:
        assert new(name, old, OLD) is None and new(name, None, OLD) is None


def test_interval_arithmetic():
    assert spans.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert spans.overlap([(0, 10)], [(2, 3), (2.5, 4), (9, 12)]) == 3
    assert spans.overlap([(0, 1), (4, 5)], [(1, 4)]) == 0
    assert spans.overlap([], [(0, 1)]) == 0
