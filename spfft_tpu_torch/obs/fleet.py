"""Fleet metrics aggregation: one merged view over every serving host.

The port of ``spfft_tpu/obs/fleet.py``, the sixth observability layer and
the first one that spans the fleet: every other layer — cards, metrics,
traces, perf reports — is process-local, so a
:class:`~spfft_tpu_torch.serve.cluster.ClusterFront` serving through N worker
hosts has N+1 metric islands. This module merges them under the JAX
package's schema name:

* :func:`fleet_snapshot` scrapes each live host's ``obs.snapshot()`` over
  the ``metrics`` RPC op (one bounded ``SPFFT_TPU_FLEET_SCRAPE_S`` deadline
  per host — a dead or blackholed host is stamped, never a hung scrape;
  hosts already declared lost are skipped typed without touching the wire),
* :func:`merge_snapshots` folds the per-host documents into one
  :data:`FLEET_SCHEMA` document: every series re-keyed with a ``host``
  label, counters additionally summed fleet-wide and histogram buckets
  summed bound-by-bound under ``totals`` (gauges stay per-host — a
  last-value has no meaningful fleet sum),
* :func:`validate_fleet` pins the schema (the ``validate_snapshot`` /
  ``validate_plan_card`` discipline) and :func:`fleet_prometheus_text`
  renders the host-labeled series in the exposition format, so one scrape
  endpoint can expose the whole fleet.

``ClusterFront.describe()`` joins a fleet document in, and
``python -m spfft_tpu_torch.programs.fleetstat`` is the operator CLI.
"""
from __future__ import annotations

import time

from .. import knobs
from ..errors import GenericError, InvalidParameterError
from . import registry, trace

FLEET_SCHEMA = "spfft_tpu.obs.fleet/1"
FLEET_SCRAPE_ENV = "SPFFT_TPU_FLEET_SCRAPE_S"

# Host scrape states: "live" (snapshot merged), "lost" (already declared
# lost — skipped typed, no wire touched), "unreachable" (scrape failed or
# timed out inside the per-host deadline), "malformed" (answered, but the
# snapshot failed its own schema pin — excluded from the merge).
HOST_STATES = ("live", "lost", "unreachable", "malformed")

_FLEET_KEYS = (
    "schema", "scraped_unix", "hosts", "counters", "gauges", "histograms",
    "totals",
)
_HOST_KEYS = ("state", "error")
_TOTALS_KEYS = ("counters", "histograms")


def resolve_scrape_s(value=None) -> float:
    """The per-host fleet scrape deadline (``SPFFT_TPU_FLEET_SCRAPE_S``)."""
    return knobs.get_float(FLEET_SCRAPE_ENV, value)


# ---- series keys ------------------------------------------------------------


def parse_series_key(key: str) -> tuple:
    """``name{k="v",...}`` -> ``(name, ((k, v), ...))`` — the inverse of the
    registry's key builder, honoring its escaping (backslash, quote,
    newline). Malformed label blocks raise typed
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` (callers treat the
    snapshot as malformed)."""
    name, brace, rest = key.partition("{")
    if not brace:
        return name, ()
    if not rest.endswith("}"):
        raise InvalidParameterError(
            f"unterminated label block in series key {key!r}"
        )
    body = rest[:-1]
    labels = []
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq < 0:
            raise InvalidParameterError(
                f"label without '=' in series key {key!r}"
            )
        k = body[i:eq]
        if not body[eq + 1 : eq + 2] == '"':
            raise InvalidParameterError(
                f"unquoted label value in series key {key!r}"
            )
        j = eq + 2
        out = []
        while True:
            if j >= len(body):
                raise InvalidParameterError(
                    f"unterminated label value in {key!r}"
                )
            c = body[j]
            if c == "\\":
                nxt = body[j + 1 : j + 2]
                out.append({"n": "\n"}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        labels.append((k, "".join(out)))
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return name, tuple(labels)


def host_series_key(key: str, host: str) -> str:
    """Re-key one series with a ``host`` label merged in (sorted with the
    existing labels, the registry's ordering rule)."""
    name, labels = parse_series_key(key)
    merged = tuple(
        sorted({**dict(labels), "host": str(host)}.items())
    )
    return name + registry._label_key(merged)


# ---- merge ------------------------------------------------------------------


def _merge_histogram(total: dict, h: dict) -> None:
    total["count"] += h.get("count", 0)
    total["sum"] += h.get("sum", 0.0)
    if h.get("count", 0):
        total["min"] = min(total["min"], h.get("min", 0.0))
        total["max"] = max(total["max"], h.get("max", 0.0))
    for bound, cum in h.get("buckets", {}).items():
        total["buckets"][bound] = total["buckets"].get(bound, 0) + cum


def merge_snapshots(host_snaps: dict, hosts: dict | None = None) -> dict:
    """Fold per-host registry snapshots into one :data:`FLEET_SCHEMA` doc.

    ``host_snaps`` maps host name -> its ``obs.snapshot()``; ``hosts``
    (optional) maps host name -> a scrape-status entry (``state``/
    ``error``) for hosts that did NOT answer, so the document records who
    is missing and why (a fleet view that silently dropped a host would
    read as a healthy fleet). Counters and histograms re-key with a
    ``host`` label; ``totals`` carries the fleet-wide sums (counters
    summed, histogram buckets summed bound-by-bound)."""
    doc = {
        "schema": FLEET_SCHEMA,
        "scraped_unix": time.time(),
        "hosts": {},
        "counters": {},
        "gauges": {},
        "histograms": {},
        "totals": {"counters": {}, "histograms": {}},
    }
    for host, entry in (hosts or {}).items():
        doc["hosts"][str(host)] = dict(entry)
    for host, snap in host_snaps.items():
        host = str(host)
        doc["hosts"].setdefault(host, {"state": "live", "error": None})
        for key, value in snap.get("counters", {}).items():
            doc["counters"][host_series_key(key, host)] = value
            totals = doc["totals"]["counters"]
            totals[key] = totals.get(key, 0) + value
        for key, value in snap.get("gauges", {}).items():
            doc["gauges"][host_series_key(key, host)] = value
        for key, h in snap.get("histograms", {}).items():
            doc["histograms"][host_series_key(key, host)] = dict(
                h, buckets=dict(h.get("buckets", {}))
            )
            total = doc["totals"]["histograms"].setdefault(
                key,
                {
                    "count": 0, "sum": 0.0, "min": float("inf"),
                    "max": float("-inf"), "buckets": {},
                },
            )
            _merge_histogram(total, h)
    for total in doc["totals"]["histograms"].values():
        if not total["count"]:
            total["min"] = 0.0
            total["max"] = 0.0
    return doc


# ---- scrape -----------------------------------------------------------------


def fleet_snapshot(hosts, timeout_s: float | None = None) -> dict:
    """Scrape every host and merge: the fleet's ``obs.snapshot()``.

    ``hosts`` is an iterable of host handles (duck-typed: ``name``,
    ``lost``, and a ``client`` whose ``call`` speaks the ``metrics`` RPC
    op — exactly the cluster front's ``HostHandle``). Each live host gets
    ONE bounded scrape (``timeout_s``, default
    ``SPFFT_TPU_FLEET_SCRAPE_S``); a host that cannot answer inside it is
    stamped ``unreachable`` and the aggregation moves on — a scrape must
    never hang behind one dead host. Hosts already declared lost are
    skipped typed (``state="lost"``, ``error="host_lost"``) WITHOUT
    touching the wire: the loss ladder already closed their clients."""
    budget = resolve_scrape_s(timeout_s)
    snaps: dict = {}
    status: dict = {}
    for handle in hosts:
        name = str(getattr(handle, "name", handle))
        if getattr(handle, "lost", False):
            status[name] = {
                "state": "lost", "error": "host_lost",
                "skipped_unix": time.time(),
            }
            registry.counter(
                "fleet_scrapes_total", host=name, outcome="lost"
            ).inc()
            trace.event("host", what="scrape_skipped", host=name)
            continue
        try:
            reply = handle.client.call({"op": "metrics"}, timeout_s=budget)
            snap = reply.get("metrics") if isinstance(reply, dict) else None
        except GenericError as e:
            # a scrape failure is a per-host verdict, never an aggregation
            # failure: the client raises typed (HostLostError on transport
            # death) and the host is stamped unreachable with the class name
            status[name] = {"state": "unreachable", "error": type(e).__name__}
            registry.counter(
                "fleet_scrapes_total", host=name, outcome="unreachable"
            ).inc()
            trace.event(
                "host", what="scrape_failed", host=name,
                error=type(e).__name__,
            )
            continue
        if not isinstance(snap, dict) or registry.validate_snapshot(snap):
            status[name] = {"state": "malformed", "error": "invalid_snapshot"}
            registry.counter(
                "fleet_scrapes_total", host=name, outcome="malformed"
            ).inc()
            continue
        snaps[name] = snap
        registry.counter("fleet_scrapes_total", host=name, outcome="ok").inc()
    return merge_snapshots(snaps, status)


# ---- schema pin / export ----------------------------------------------------


def validate_fleet(doc: dict) -> list:
    """Missing/malformed key paths of a fleet document ([] when valid) —
    the schema pin, same style as ``obs.validate_snapshot``."""
    if not isinstance(doc, dict):
        return ["fleet (not a dict)"]
    missing = [k for k in _FLEET_KEYS if k not in doc]
    if doc.get("schema") != FLEET_SCHEMA:
        missing.append(f"schema (unknown: {doc.get('schema')!r})")
    for host, entry in doc.get("hosts", {}).items():
        if not isinstance(entry, dict):
            missing.append(f"hosts[{host}] (not a dict)")
            continue
        missing.extend(
            f"hosts[{host}].{k}" for k in _HOST_KEYS if k not in entry
        )
        if entry.get("state") not in HOST_STATES:
            missing.append(
                f"hosts[{host}].state (unknown: {entry.get('state')!r})"
            )
    with trace.suppressed_dumps():
        # probing keys for malformedness constructs typed errors by design:
        # a validator run must not flood the dump directory
        for key in doc.get("counters", {}):
            try:
                _, labels = parse_series_key(key)
            except InvalidParameterError:
                missing.append(f"counters[{key}] (malformed series key)")
                continue
            if "host" not in dict(labels):
                missing.append(f"counters[{key}] (missing host label)")
    for key, h in doc.get("histograms", {}).items():
        if not isinstance(h, dict) or "buckets" not in h:
            missing.append(f"histograms[{key}].buckets")
    totals = doc.get("totals")
    if isinstance(totals, dict):
        missing.extend(
            f"totals.{k}" for k in _TOTALS_KEYS if k not in totals
        )
    return missing


def fleet_prometheus_text(doc: dict) -> str:
    """Prometheus exposition rendering of a fleet document: the host-labeled
    series through the registry's own renderer (one scrape endpoint for the
    whole fleet; ``totals`` are derivable by the scraper and deliberately
    not re-exported — double-counting a summed series is the classic
    aggregation bug)."""
    return registry.prometheus_text(
        {
            "counters": doc.get("counters", {}),
            "gauges": doc.get("gauges", {}),
            "histograms": doc.get("histograms", {}),
        }
    )
