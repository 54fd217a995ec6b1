"""Process-global run-metrics registry: counters, gauges, histograms.

The port of ``spfft_tpu/obs/registry.py``: what the host-facing transform
paths did (transforms per direction and engine, bytes staged across the host
boundary, dispatch and wait latency, exchange wire bytes). Host-side only:
nothing here runs inside a CUDA graph (scopes and counters sit outside the
captured region, :mod:`spfft_tpu_torch.ir.compile`), so recording costs a
dict lookup and an add; with metrics disabled the instrument factories return
one shared no-op object, so the hot path records and allocates nothing.

Gate: the ``SPFFT_TPU_METRICS`` knob (``0`` disables at import) plus runtime
:func:`enable`/:func:`disable`. Export: :func:`snapshot` (schema
``spfft_tpu.obs.snapshot/1``, checked by :func:`validate_snapshot`) and
:func:`prometheus_text` (``spfft_tpu_``-prefixed exposition format).
"""
from __future__ import annotations

import threading
import time

from .. import knobs

METRICS_ENV = "SPFFT_TPU_METRICS"
SNAPSHOT_SCHEMA = "spfft_tpu.obs.snapshot/1"

# Latency-oriented cumulative bucket bounds (seconds); +Inf is implicit.
HISTOGRAM_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def _escape_label(value) -> str:
    """Prometheus label-value escaping (backslash, double-quote, newline) —
    applied when keys are built, so snapshot keys and the exposition format
    agree on one quoting rule."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_key(labels: tuple) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels) + "}"


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        # registry lock: instruments are process-global and += is a
        # read-modify-write, so concurrent dispatch threads must not interleave
        with _lock:
            self.value += n


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        with _lock:
            self.value = float(v)


class Histogram:
    """Fixed-bucket cumulative histogram (count/sum/min/max + bucket counts)."""

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "bucket_counts")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.bucket_counts = [0] * (len(HISTOGRAM_BUCKETS) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        # under the registry lock so count/sum/buckets stay mutually
        # consistent (the cumulative-bucket contract prometheus_text emits)
        with _lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, bound in enumerate(HISTOGRAM_BUCKETS):
                if v <= bound:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    def to_dict(self) -> dict:
        buckets = {}
        cum = 0
        for bound, n in zip(HISTOGRAM_BUCKETS, self.bucket_counts):
            cum += n
            buckets[repr(bound)] = cum
        buckets["+Inf"] = self.count
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "buckets": buckets,
        }


class _NoopInstrument:
    """Shared do-nothing counter/gauge/histogram handed out while disabled —
    no registry entry, no per-call allocation on the hot path."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NOOP_INSTRUMENT = _NoopInstrument()


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SCOPE = _NoopScope()


class _PhaseTimer:
    """Context manager feeding one wall-clock duration into a histogram."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


_lock = threading.Lock()
_counters: dict = {}
_gauges: dict = {}
_histograms: dict = {}
_enabled = knobs.get_bool(METRICS_ENV)


def enable() -> None:
    """Turn metrics recording on (overrides ``SPFFT_TPU_METRICS=0``)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn metrics recording off: instrument factories return shared no-ops."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop every recorded instrument (tests / fresh measurement windows)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()


def _instrument(table: dict, cls, name: str, labels: dict):
    key = (name, tuple(sorted(labels.items())))
    inst = table.get(key)
    if inst is None:
        with _lock:
            inst = table.setdefault(key, cls(name, key[1]))
    return inst


def counter(name: str, **labels) -> Counter:
    if not _enabled:
        return _NOOP_INSTRUMENT
    return _instrument(_counters, Counter, name, labels)


def gauge(name: str, **labels) -> Gauge:
    if not _enabled:
        return _NOOP_INSTRUMENT
    return _instrument(_gauges, Gauge, name, labels)


def histogram(name: str, **labels) -> Histogram:
    if not _enabled:
        return _NOOP_INSTRUMENT
    return _instrument(_histograms, Histogram, name, labels)


def phase_timer(name: str, **labels):
    """Scoped wall-clock observation into ``histogram(name, **labels)``;
    the shared no-op scope when disabled (zero allocation)."""
    if not _enabled:
        return _NOOP_SCOPE
    return _PhaseTimer(_instrument(_histograms, Histogram, name, labels))


def snapshot() -> dict:
    """JSON-stable view of everything recorded so far.

    Schema (``SNAPSHOT_SCHEMA``): ``schema``/``enabled`` headers plus one map
    per instrument kind, keyed ``name{label="value",...}``. Round-trips
    through ``json.dumps``/``loads`` unchanged (plain str/int/float only).
    """
    with _lock:
        return {
            "schema": SNAPSHOT_SCHEMA,
            "enabled": _enabled,
            "counters": {
                c.name + _label_key(c.labels): c.value for c in _counters.values()
            },
            "gauges": {
                g.name + _label_key(g.labels): g.value for g in _gauges.values()
            },
            "histograms": {
                h.name + _label_key(h.labels): h.to_dict()
                for h in _histograms.values()
            },
        }


_SNAPSHOT_KEYS = ("schema", "enabled", "counters", "gauges", "histograms")
_HISTOGRAM_KEYS = ("count", "sum", "min", "max", "buckets")


def validate_snapshot(snap: dict) -> list:
    """Missing/malformed key paths of a snapshot dict ([] when valid)."""
    missing = [k for k in _SNAPSHOT_KEYS if k not in snap]
    if snap.get("schema") not in (None, SNAPSHOT_SCHEMA):
        missing.append(f"schema (unknown: {snap['schema']!r})")
    for key, h in snap.get("histograms", {}).items():
        missing.extend(
            f"histograms[{key}].{k}" for k in _HISTOGRAM_KEYS if k not in h
        )
    return missing


def prometheus_text(snap: dict | None = None) -> str:
    """Prometheus exposition rendering of a snapshot (``spfft_tpu_`` prefix).

    Gauges and counters render directly; histograms render the standard
    ``_bucket``/``_sum``/``_count`` series with cumulative ``le`` buckets.
    """
    snap = snapshot() if snap is None else snap
    lines: list = []
    typed: set = set()  # one "# TYPE" line per metric name

    def split(key: str):
        name, _, labels = key.partition("{")
        return "spfft_tpu_" + name, ("{" + labels if labels else "")

    def type_line(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for kind, table in (("counter", "counters"), ("gauge", "gauges")):
        for key, value in sorted(snap.get(table, {}).items()):
            name, labels = split(key)
            type_line(name, kind)
            lines.append(f"{name}{labels} {value}")
    for key, h in sorted(snap.get("histograms", {}).items()):
        name, labels = split(key)
        base = labels[1:-1] if labels else ""
        type_line(name, "histogram")
        for bound, cum in h["buckets"].items():
            sep = "," if base else ""
            lines.append(f'{name}_bucket{{{base}{sep}le="{bound}"}} {cum}')
        lines.append(f"{name}_sum{labels} {h['sum']}")
        lines.append(f"{name}_count{labels} {h['count']}")
    return "\n".join(lines) + "\n"
