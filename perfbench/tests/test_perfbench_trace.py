"""The trace's reduction and the per-layer readers on a recorded trace: four
pairs of the fused ``c2c-256-s15`` plan, fenced every two, ``V(r)`` applied
between the calls, exported by ``torch.profiler`` on an NVIDIA H100 80GB
HBM3 (700 W), with the harness's ranges (``fixtures/record.py``). The
expected numbers are summed here from the raw events."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import spec, trace

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "trace_c2c-256-s15_4pairs.json"
EVENTS = json.loads(FIXTURE.read_text())["traceEvents"]
PAIRS = 4


@pytest.fixture(scope="module")
def profile():
    return trace.Profile(EVENTS, PAIRS, spec.kernel_families())


def stretch():
    e = next(e for e in EVENTS if e.get("name") == "perfbench.stretch")
    return e["ts"], e["ts"] + e["dur"]


def device(cat=None, has=None):
    t0, t1 = stretch()
    return [e for e in EVENTS if e.get("ph") == "X" and t0 <= e["ts"] < t1
            and e.get("cat") in ((cat,) if cat else ("kernel", "gpu_memcpy", "gpu_memset"))
            and (has is None or has in e["name"])]


def harness_kernels():
    """The kernels whose launch the host made inside ``perfbench.potential``,
    found here by the launch's own timestamp and correlation id."""
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in EVENTS
              if e.get("name") == "perfbench.potential" and e.get("cat") == "user_annotation"]
    corr = {e["args"]["correlation"] for e in EVENTS if e.get("cat") == "cuda_runtime"
            and any(a <= e["ts"] < b for a, b in ranges)}
    return [e for e in device("kernel") if e["args"].get("correlation") in corr]


def ms_per_pair(events):
    return sum(e["dur"] for e in events) / 1e3 / PAIRS


def read(name, profile):
    return spec.reader(name)(SimpleNamespace(profile=profile, window={}))


def test_the_fixture_holds_the_plan_s_launches(profile):
    # the fused blocked C2C pair: 12 K1 and 2 K2 launches, 8 copies in and out
    assert profile.count("k1") == 12 * PAIRS == len(device("kernel", "tc_kernel"))
    assert profile.count("k2") == 2 * PAIRS == len(device("kernel", "row_gather_kernel"))
    assert len(device("gpu_memcpy")) == 8 * PAIRS
    assert len(profile.device_ops) == len(device())
    # the harness's multiply by V: one kernel a part (re, im) a pair
    assert profile.count(trace.HARNESS) == 2 * PAIRS == len(harness_kernels())


def test_per_pair_device_times(profile):
    k1 = ms_per_pair(device("kernel", "tc_kernel"))
    k2 = ms_per_pair(device("kernel", "row_gather_kernel"))
    copies = ms_per_pair(device("gpu_memcpy"))
    everything = ms_per_pair(device())
    harness = ms_per_pair(harness_kernels())
    assert read("k1_ms_per_pair", profile) == pytest.approx(k1)
    assert read("k2_ms_per_pair", profile) == pytest.approx(k2)
    assert read("graph_copy_ms_per_pair", profile) == pytest.approx(copies)
    assert read("torch_ops_ms_per_pair", profile) == pytest.approx(
        everything - k1 - k2 - copies - harness)
    assert 0.05 < harness < 0.5
    assert 1.2 < k1 < 1.5 and 0.04 < k2 < 0.08  # what the card read


def test_idle_share_and_busy(profile):
    t0, t1 = stretch()
    spans = sorted((e["ts"], min(e["ts"] + e["dur"], t1)) for e in device())
    busy, reach = 0.0, t0
    for a, b in spans:  # the union, by hand
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    assert profile.busy_us() == pytest.approx(busy)
    assert profile.window_us == pytest.approx(t1 - t0)
    idle = 100 * (1 - busy / (t1 - t0))
    assert read("device_idle_pct.ahead", profile) == pytest.approx(idle)
    assert read("device_idle_pct.sync", profile) == pytest.approx(idle)
    assert 0 < idle < 100
    gaps = profile.idle_gaps()
    assert sum(b - a for a, b in gaps) == pytest.approx((t1 - t0) - busy)


def test_breakdown(profile):
    ops = profile.device_ops_s()
    assert len(ops) <= 10 and ops[0][0].endswith("tc_kernel")
    assert ops[0][1] == pytest.approx(ms_per_pair(device("kernel", "tc_kernel")) * PAIRS / 1e3)
    idle = profile.idle_by_host_s()
    assert {name for name, _ in idle} <= {"fence", "backward_pair", "potential", "forward_pair",
                                          "between calls"}
    assert any(name.startswith("harness: ") for name, _ in ops)
    assert sum(s for _, s in idle) == pytest.approx(sum(b - a for a, b in profile.idle_gaps()) / 1e6)


def test_union_and_names():
    assert trace.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.union([]) == 0
    assert trace.short_name("void (anonymous namespace)::tc::tc_kernel<Tf32x3, 4>(Args)") \
        == "(anonymous namespace)::tc::tc_kernel"
    assert trace.short_name("(anonymous namespace)::row_gather_kernel(int, float*)") \
        == "(anonymous namespace)::row_gather_kernel"


def test_nothing_traced_reads_nothing():
    empty = trace.Profile([], PAIRS, spec.kernel_families())
    for name in ("k1_ms_per_pair", "k2_ms_per_pair", "torch_ops_ms_per_pair",
                 "graph_copy_ms_per_pair", "device_idle_pct.ahead"):
        assert read(name, empty) is None
