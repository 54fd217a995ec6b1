"""The port's fleet metrics aggregation (spfft_tpu_torch.obs.fleet) against
the JAX package's (spfft_tpu.obs.fleet).

The counterparts of ``tests/test_fleet.py``, and: a port fleet document
passes the JAX ``validate_fleet`` with no findings, both packages merge the
same snapshots into the same document (``scraped_unix`` aside), and both
render the same Prometheus text. Contract layers:

* series keys — ``parse_series_key`` inverts the registry's key builder
  (escaping included) and raises typed on malformed blocks;
  ``host_series_key`` merges the ``host`` label in registry label order;
* merge — counters/histograms re-keyed per host and summed fleet-wide
  under ``totals`` (buckets bound-by-bound), gauges per-host only, missing
  hosts recorded with their scrape state, never silently dropped;
* scrape — ``fleet_snapshot`` skips already-lost hosts typed without
  touching the wire, stamps ``unreachable``/``malformed`` per-host verdicts
  inside one bounded ``SPFFT_TPU_FLEET_SCRAPE_S`` deadline, and counts
  every outcome in ``fleet_scrapes_total``;
* schema pin / export — ``validate_fleet`` trips on doctored documents,
  ``fleet_prometheus_text`` renders host-labeled series and deliberately
  never re-exports ``totals`` (double-counting).
"""
import json

import pytest

from spfft_tpu.obs import fleet as jfleet
from spfft_tpu_torch import obs
from spfft_tpu_torch.errors import HostLostError, InvalidParameterError
from spfft_tpu_torch.obs import fleet, registry, trace


@pytest.fixture(autouse=True)
def clean_registry():
    obs.clear()
    yield
    obs.clear()
    trace.disable()


def _snap_with(counter=None, gauge=None, hist=None):
    """A real registry snapshot with one series of each asked-for kind."""
    obs.clear()
    if counter:
        registry.counter(counter[0], **counter[1]).inc(counter[2])
    if gauge:
        registry.gauge(gauge[0], **gauge[1]).set(gauge[2])
    if hist:
        for v in hist[2]:
            registry.histogram(hist[0], **hist[1]).observe(v)
    snap = obs.snapshot()
    obs.clear()
    return snap


# ---- series keys -------------------------------------------------------------


def test_parse_series_key_inverts_registry_escaping():
    key = 'requests_total{tenant="a\\"b\\\\c\\nd",verb="submit"}'
    name, labels = fleet.parse_series_key(key)
    assert name == "requests_total"
    assert dict(labels) == {"tenant": 'a"b\\c\nd', "verb": "submit"}
    assert fleet.parse_series_key("plain_total") == ("plain_total", ())


def test_parse_series_key_typed_on_malformed():
    with trace.suppressed_dumps():
        for bad in ("x{unterminated", 'x{k="v}', "x{noeq}", 'x{k=bare}'):
            with pytest.raises(InvalidParameterError):
                fleet.parse_series_key(bad)


def test_host_series_key_sorts_host_with_existing_labels():
    assert (
        fleet.host_series_key('x_total{tenant="t0"}', "host1")
        == 'x_total{host="host1",tenant="t0"}'
    )
    assert fleet.host_series_key("x_total", "h") == 'x_total{host="h"}'
    # round-trips through the registry's own parser
    name, labels = fleet.parse_series_key(
        fleet.host_series_key('x_total{z="1",a="2"}', "h")
    )
    assert name == "x_total" and dict(labels)["host"] == "h"


# ---- merge -------------------------------------------------------------------


def test_merge_snapshots_rekeys_and_sums():
    a = _snap_with(
        counter=("requests_total", {"tenant": "t"}, 3),
        gauge=("queue_depth", {}, 5.0),
        hist=("serve_seconds", {}, [0.1, 0.2]),
    )
    b = _snap_with(
        counter=("requests_total", {"tenant": "t"}, 4),
        gauge=("queue_depth", {}, 7.0),
        hist=("serve_seconds", {}, [0.4]),
    )
    doc = fleet.merge_snapshots({"host0": a, "host1": b})
    assert doc["schema"] == fleet.FLEET_SCHEMA
    assert fleet.validate_fleet(doc) == []
    key = 'requests_total{host="host0",tenant="t"}'
    assert doc["counters"][key] == 3
    assert doc["counters"]['requests_total{host="host1",tenant="t"}'] == 4
    # fleet-wide totals: counters summed under the ORIGINAL key
    assert doc["totals"]["counters"]['requests_total{tenant="t"}'] == 7
    # gauges stay per-host only — a last-value has no meaningful fleet sum
    assert 'queue_depth{host="host0"}' in doc["gauges"]
    assert "queue_depth" not in doc["totals"]["counters"]
    total_h = doc["totals"]["histograms"]["serve_seconds"]
    assert total_h["count"] == 3
    assert total_h["sum"] == pytest.approx(0.7)
    assert total_h["min"] == pytest.approx(0.1)
    assert total_h["max"] == pytest.approx(0.4)
    # buckets summed bound-by-bound equal the per-host cumulative counts
    ha = a["histograms"]["serve_seconds"]["buckets"]
    hb = b["histograms"]["serve_seconds"]["buckets"]
    for bound, cum in total_h["buckets"].items():
        assert cum == ha.get(bound, 0) + hb.get(bound, 0)
    # both hosts recorded live
    assert doc["hosts"]["host0"]["state"] == "live"
    json.dumps(doc)  # document is JSON-plain


def test_merge_records_missing_hosts():
    doc = fleet.merge_snapshots(
        {"host0": _snap_with(counter=("x_total", {}, 1))},
        {"host1": {"state": "lost", "error": "host_lost"}},
    )
    assert doc["hosts"]["host1"] == {"state": "lost", "error": "host_lost"}
    assert fleet.validate_fleet(doc) == []


# ---- scrape ------------------------------------------------------------------


class _Client:
    def __init__(self, reply=None, error=None):
        self.reply = reply
        self.error = error
        self.calls = []

    def call(self, msg, timeout_s=None):
        self.calls.append((msg, timeout_s))
        if self.error is not None:
            raise self.error
        return self.reply


class _Handle:
    def __init__(self, name, client, lost=False):
        self.name = name
        self.client = client
        self.lost = lost


def _counters(prefix):
    return {
        k: v
        for k, v in obs.snapshot()["counters"].items()
        if k.startswith(prefix)
    }


def test_fleet_snapshot_merges_live_hosts_with_bounded_deadline():
    snap = _snap_with(counter=("requests_total", {}, 2))
    h0 = _Handle("host0", _Client(reply={"metrics": snap}))
    h1 = _Handle("host1", _Client(reply={"metrics": snap}))
    doc = fleet.fleet_snapshot([h0, h1], timeout_s=0.25)
    assert fleet.validate_fleet(doc) == []
    assert doc["hosts"]["host0"]["state"] == "live"
    assert doc["totals"]["counters"]["requests_total"] == 4
    # ONE metrics call per host, carrying the per-host deadline
    (msg, timeout_s), = h0.client.calls
    assert msg == {"op": "metrics"} and timeout_s == 0.25
    c = _counters("fleet_scrapes_total")
    assert c['fleet_scrapes_total{host="host0",outcome="ok"}'] == 1


def test_fleet_snapshot_default_deadline_is_the_knob():
    h = _Handle("host0", _Client(reply={"metrics": _snap_with()}))
    fleet.fleet_snapshot([h])
    (_, timeout_s), = h.client.calls
    assert timeout_s == fleet.resolve_scrape_s() == 5.0


def test_fleet_snapshot_skips_lost_host_without_touching_wire():
    lost_client = _Client(error=AssertionError("wire touched"))
    h0 = _Handle("host0", lost_client, lost=True)
    h1 = _Handle("host1", _Client(reply={"metrics": _snap_with()}))
    doc = fleet.fleet_snapshot([h0, h1])
    assert lost_client.calls == []
    entry = doc["hosts"]["host0"]
    assert entry["state"] == "lost" and entry["error"] == "host_lost"
    assert "skipped_unix" in entry
    assert doc["hosts"]["host1"]["state"] == "live"
    assert fleet.validate_fleet(doc) == []
    c = _counters("fleet_scrapes_total")
    assert c['fleet_scrapes_total{host="host0",outcome="lost"}'] == 1


def test_fleet_snapshot_stamps_unreachable_and_malformed():
    h0 = _Handle("host0", _Client(error=HostLostError("host0 died")))
    h1 = _Handle("host1", _Client(reply={"metrics": {"bogus": True}}))
    h2 = _Handle("host2", _Client(reply="not-a-dict"))
    doc = fleet.fleet_snapshot([h0, h1, h2])
    assert doc["hosts"]["host0"]["state"] == "unreachable"
    assert doc["hosts"]["host0"]["error"] == "HostLostError"
    assert doc["hosts"]["host1"]["state"] == "malformed"
    assert doc["hosts"]["host2"]["state"] == "malformed"
    # the aggregation itself still returns a valid (empty-series) document
    assert fleet.validate_fleet(doc) == []
    c = _counters("fleet_scrapes_total")
    assert c['fleet_scrapes_total{host="host0",outcome="unreachable"}'] == 1
    assert c['fleet_scrapes_total{host="host1",outcome="malformed"}'] == 1


# ---- schema pin / export -----------------------------------------------------


def test_validate_fleet_trips_on_doctored_documents():
    doc = fleet.merge_snapshots({"host0": _snap_with(counter=("x_total", {}, 1))})
    assert fleet.validate_fleet(doc) == []
    assert fleet.validate_fleet("nope") == ["fleet (not a dict)"]
    bad = dict(doc, schema="spfft_tpu.obs.fleet/999")
    assert any("schema" in f for f in fleet.validate_fleet(bad))
    bad = {k: v for k, v in doc.items() if k != "totals"}
    assert any("totals" in f for f in fleet.validate_fleet(bad))
    bad = dict(doc, hosts={"host0": {"state": "zombie", "error": None}})
    assert any("state" in f for f in fleet.validate_fleet(bad))
    # a counter series without the host label is not a fleet series
    bad = dict(doc, counters={"x_total": 1})
    assert any("host label" in f for f in fleet.validate_fleet(bad))
    bad = dict(doc, counters={"x_total{oops": 1})
    assert any("malformed series key" in f for f in fleet.validate_fleet(bad))


def test_fleet_prometheus_text_excludes_totals():
    a = _snap_with(counter=("x_total", {}, 3), hist=("h_seconds", {}, [0.5]))
    doc = fleet.merge_snapshots({"host0": a, "host1": a})
    text = fleet.fleet_prometheus_text(doc)
    assert 'x_total{host="host0"} 3' in text
    assert 'x_total{host="host1"} 3' in text
    # totals are derivable by the scraper; re-exporting them double-counts
    assert "\nx_total 6" not in text and "x_total 6" not in text
    assert 'h_seconds_bucket' in text


# ---- parity with the JAX package ------------------------------------------------


def test_port_fleet_document_is_the_jax_packages():
    a = _snap_with(counter=("x_total", {"tenant": "t"}, 3), gauge=("g", {}, 2.0),
                   hist=("h_seconds", {}, [0.5, 0.01]))
    b = _snap_with(counter=("x_total", {"tenant": "t"}, 4))
    hosts = {"host2": {"state": "lost", "error": "host_lost"}}
    mine = fleet.merge_snapshots({"host0": a, "host1": b}, hosts)
    theirs = jfleet.merge_snapshots({"host0": a, "host1": b}, hosts)
    assert jfleet.validate_fleet(mine) == []
    assert mine["schema"] == jfleet.FLEET_SCHEMA
    mine.pop("scraped_unix")
    theirs.pop("scraped_unix")
    assert mine == theirs
    assert fleet.fleet_prometheus_text(mine) == jfleet.fleet_prometheus_text(theirs)
    key = 'x_total{tenant="a\\"b",verb="s"}'
    assert fleet.parse_series_key(key) == jfleet.parse_series_key(key)
    assert fleet.HOST_STATES == jfleet.HOST_STATES


# ---- cross-host trace segments (the counterparts of tests/test_trace.py's) ------


@pytest.fixture()
def armed():
    trace.enable(capacity=4096)
    yield
    trace.disable()
    trace.clear()


def test_segment_filters_by_run_and_bounds(armed):
    from spfft_tpu.obs import trace as jtrace

    with trace.with_run("r_a"):
        for i in range(10):
            trace.event("serve", what="admit", i=i)
    with trace.with_run("r_b"):
        trace.event("serve", what="admit")
    seg = trace.segment("r_a")
    assert seg["schema"] == trace.SEGMENT_SCHEMA == jtrace.SEGMENT_SCHEMA
    assert seg["run"] == "r_a"
    assert len(seg["events"]) == 10
    assert trace.validate_segment(seg) == [] == jtrace.validate_segment(seg)
    assert set(seg["events"][0]) == {"ts", "name", "ph", "args"}
    bounded = trace.segment("r_a", limit=3)
    assert [e["args"]["i"] for e in bounded["events"]] == [7, 8, 9]
    assert len(trace.segment("r_b")["events"]) == 1
    assert trace.segment("r_nope")["events"] == []


def test_segment_empty_while_disarmed():
    trace.disable()
    seg = trace.segment("r_x")
    assert seg["events"] == [] and trace.validate_segment(seg) == []


def test_validate_segment_rejects_malformed():
    assert trace.validate_segment("nope") == ["segment (not a dict)"]
    findings = trace.validate_segment({"schema": "bogus/0", "events": [42]})
    assert any("run" in f for f in findings)
    assert any("schema" in f for f in findings)
    assert any("events[0]" in f for f in findings)
    bad_ev = {
        "schema": trace.SEGMENT_SCHEMA, "run": "r",
        "events": [{"ts": 0.0, "name": "not_a_name", "ph": "Z", "args": {}}],
    }
    findings = trace.validate_segment(bad_ev)
    assert any(".ph" in f for f in findings)
    assert any(".name" in f for f in findings)


def test_splice_tags_host_and_skips_invalid_events(armed):
    with trace.with_run("r_remote"):
        trace.event("rpc", what="remote_execute")
        trace.event("serve", what="admit")
    seg = trace.segment("r_remote")
    seg["events"].append({"ts": 0.0, "name": "bogus", "ph": "i", "args": {}})
    trace.clear()
    assert trace.splice(seg, host="host7") == 2
    evs = [e for e in trace.snapshot()["events"] if e["run"] == "r_remote"]
    assert len(evs) == 2
    for ev in evs:
        assert ev["args"]["host"] == "host7"
        assert "remote_ts" in ev["args"]
    assert trace.splice({"schema": "bogus/0"}, host="h") == 0
    assert trace.splice("nope", host="h") == 0
    trace.disable()
    assert trace.splice(seg, host="h") == 0


def test_segments_cross_between_the_packages(armed):
    """A port segment splices into the JAX recorder and a JAX segment into
    the port's: the join works whichever side runs the worker."""
    from spfft_tpu.obs import trace as jtrace

    jtrace.enable(capacity=4096)
    try:
        with trace.with_run("r_port"):
            trace.event("serve", what="complete", tenant="t")
        with jtrace.with_run("r_jax"):
            jtrace.event("sched", what="dispatch", task="x")
        assert jtrace.splice(trace.segment("r_port"), host="host0") == 1
        assert trace.splice(jtrace.segment("r_jax"), host="host1") == 1
        ev = [e for e in trace.snapshot()["events"] if e["run"] == "r_jax"][0]
        assert ev["args"]["host"] == "host1" and ev["name"] == "sched"
        assert trace.validate_trace(trace.snapshot()) == []
    finally:
        jtrace.disable()
        jtrace.clear()
