"""Execution tracing: run IDs, a bounded flight recorder, Chrome-trace export.

The port of ``spfft_tpu/obs/trace.py``. Every host-facing operation (plan
construction, one ``backward``/``forward`` call) runs under a **run ID**, and
typed events (operation and phase spans, the fence, decisions, perf reports,
typed errors) land in a bounded ring buffer stamped with it. Plan cards carry
their construction run ID (``plan.report()["run_id"]``), so card, metrics and
trace join on one key.

**Arming**: ``SPFFT_TPU_TRACE=1`` at import (capacity ``SPFFT_TPU_TRACE_CAP``,
default :data:`DEFAULT_CAPACITY`) or :func:`enable`/:func:`disable` at
runtime. Disarmed (the default), the recorder is one shared falsy no-op and
every emit path is one falsy check; :func:`span`/:func:`operation` hand out
one shared no-op scope.

**Export**: :func:`snapshot` (schema ``spfft_tpu.obs.trace/1``, checked by
:func:`validate_trace`) and :func:`chrome_trace` (Chrome trace-event format,
one track per host phase, loadable in Perfetto).

**Dump-on-error**: with ``SPFFT_TPU_TRACE_DUMP`` naming a directory, every
typed :mod:`spfft_tpu_torch.errors` exception flushes the recorder there
(:func:`dump`).

**Cross-host segments**: a worker host answers a request that carried the
caller's run ID with :func:`segment`, the slice of its recorder stamped with
that run (schema :data:`SEGMENT_SCHEMA`, checked by :func:`validate_segment`),
and the cluster front re-emits it locally with :func:`splice`, tagged
``host=``. One front-side :func:`snapshot` then shows both sides.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
import warnings

from .. import knobs

TRACE_ENV = "SPFFT_TPU_TRACE"
TRACE_CAP_ENV = "SPFFT_TPU_TRACE_CAP"
TRACE_DUMP_ENV = "SPFFT_TPU_TRACE_DUMP"
TRACE_SCHEMA = "spfft_tpu.obs.trace/1"

DEFAULT_CAPACITY = knobs.default(TRACE_CAP_ENV)

# Canonical trace event-name vocabulary: the JAX package's names that the
# ported paths emit. Every ``trace.event/span/operation`` call in the package
# names one of these.
EVENTS = (
    # operation spans (each pushes/propagates the active run ID)
    "plan",            # Transform / DistributedTransform construction
    "execute",         # one host-facing backward/forward call
    "tune.trial",      # one autotuner candidate trial (child run of its plan)
    # nested host-phase spans (labels = the timing-tree phase vocabulary)
    "phase",
    # completion-fence span (sync.fence)
    "fence",
    # instants
    "decision",        # engine / exchange discipline resolution
    "degradation",     # ladder rung fired (faults.record_degradation)
    "guard",           # guard verdict, pass or fail (faults.guard)
    "fault.injected",  # armed fault site fired (faults.plane)
    "verify",          # ABFT check verdict / retry / demotion / breaker
    #                    transition (spfft_tpu_torch.verify)
    "perf",            # performance report built (obs.perf)
    "wisdom.load",     # wisdom store consulted (tuning.wisdom)
    "wisdom.save",     # wisdom store write attempt (tuning.wisdom)
    "serve",           # serving-layer transition (spfft_tpu_torch.serve): admit,
    #                    reject, shed, coalesce, dispatch, complete
    "sched",           # task-graph scheduler transition (spfft_tpu_torch.sched):
    #                    graph, place, dispatch, finalize, demote, fail, rehost
    "host",            # multi-host liveness transition (serve.cluster):
    #                    heartbeat verdicts, a worker host declared lost
    "rpc",             # cross-host RPC transition (serve.rpc): request served
    #                    or failed
    "error",           # typed spfft_tpu_torch.errors exception constructed
)

# Chrome phase codes used in recorded events: B/E duration pairs, i instants.
_PHASES = ("B", "E", "i")

_lock = threading.Lock()
_run_counter = itertools.count(1)
_dump_counter = itertools.count(1)
_tls = threading.local()


def _jsonable(value):
    """Coerce an event arg to a JSON-plain scalar (events must round-trip
    through ``json.dumps`` unchanged, like metrics snapshots)."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return str(value)


class TraceRecorder:
    """Bounded ring-buffer of typed events — the flight recorder.

    Capacity-bounded (:data:`SPFFT_TPU_TRACE_CAP`): a long-running process
    keeps the *last* N events, evicting the oldest (``dropped`` counts the
    evictions so a snapshot is honest about truncation). Thread-safe; ``seq``
    is a process-wide total order over emissions."""

    __slots__ = ("capacity", "_events", "_seq", "_dropped", "_epoch", "epoch_unix")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._events: collections.deque = collections.deque(maxlen=self.capacity)
        self._seq = 0
        self._dropped = 0
        self._epoch = time.perf_counter()
        self.epoch_unix = time.time()

    def emit(self, name: str, ph: str, run: str | None, args: dict) -> None:
        with _lock:
            # timestamp under the lock so ts agrees with the seq total order
            # (concurrent emitters must not interleave read and append)
            ts = time.perf_counter() - self._epoch
            self._seq += 1
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(
                {
                    "seq": self._seq,
                    "ts": ts,
                    "run": run,
                    "name": name,
                    "ph": ph,
                    "args": {k: _jsonable(v) for k, v in args.items()},
                }
            )

    def events(self) -> list:
        with _lock:
            return [dict(e, args=dict(e["args"])) for e in self._events]

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with _lock:
            self._events.clear()
            self._dropped = 0


class _NoopRecorder:
    """Shared falsy stand-in while tracing is disarmed: the emit paths gate
    on ``if not _recorder`` — one falsy check, no allocation (the
    no-op-instrument discipline)."""

    __slots__ = ()
    capacity = 0
    dropped = 0
    epoch_unix = 0.0

    def __bool__(self) -> bool:
        return False

    def emit(self, name, ph, run, args) -> None:
        pass

    def events(self) -> list:
        return []

    def clear(self) -> None:
        pass


_NOOP_RECORDER = _NoopRecorder()


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


def _default_capacity() -> int:
    return knobs.get_int(TRACE_CAP_ENV)


_recorder = (
    TraceRecorder(_default_capacity())
    if knobs.get_bool(TRACE_ENV)
    else _NOOP_RECORDER
)


def enable(capacity: int | None = None) -> None:
    """Arm the flight recorder (overriding ``SPFFT_TPU_TRACE``). A fresh
    recorder is installed when tracing was off or ``capacity`` is given;
    an armed recorder with no capacity change is kept (events retained)."""
    global _recorder
    if not _recorder or capacity is not None:
        _recorder = TraceRecorder(
            _default_capacity() if capacity is None else capacity
        )


def disable() -> None:
    """Disarm: swap in the shared no-op recorder (recorded events are
    dropped; emit paths return to the single falsy check)."""
    global _recorder
    _recorder = _NOOP_RECORDER


def enabled() -> bool:
    return bool(_recorder)


def clear() -> None:
    """Drop recorded events (tests / fresh measurement windows)."""
    _recorder.clear()


def new_run_id() -> str:
    """Fresh process-unique run ID (``r``-prefixed, monotonic). Minted even
    while tracing is disarmed — plan cards always carry one, so arming the
    recorder later still joins against cards built before."""
    return f"r{next(_run_counter):06d}"


def current_run_id() -> str | None:
    """The innermost active run ID (None outside any operation scope)."""
    stack = getattr(_tls, "runs", None)
    return stack[-1] if stack else None


def event(name: str, **args) -> None:
    """Record one instant event stamped with the active run ID; a falsy
    check when disarmed. ``name`` must come from :data:`EVENTS`."""
    if not _recorder:
        return
    _recorder.emit(name, "i", current_run_id(), args)


class _Span:
    """Begin/end duration event pair stamped with the active run ID."""

    __slots__ = ("_name", "_args")

    def __init__(self, name: str, args: dict):
        self._name = name
        self._args = args

    def __enter__(self):
        _recorder.emit(self._name, "B", current_run_id(), self._args)
        return self

    def __exit__(self, exc_type, exc, tb):
        args = self._args
        if exc_type is not None:
            args = dict(args, error=exc_type.__name__)
        _recorder.emit(self._name, "E", current_run_id(), args)
        return False


class _Operation:
    """A :class:`_Span` that also pushes a run ID for its scope, so every
    nested event (phases, the fence, decisions) is stamped with it. A nested
    operation gets its own run ID and records its parent's."""

    __slots__ = ("_span", "_run")

    def __init__(self, name: str, run_id: str | None, args: dict):
        parent = current_run_id()
        if parent is not None:
            args = dict(args, parent=parent)
        self._run = run_id or new_run_id()
        self._span = _Span(name, args)

    def __enter__(self):
        stack = getattr(_tls, "runs", None)
        if stack is None:
            stack = _tls.runs = []
        stack.append(self._run)
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            return self._span.__exit__(exc_type, exc, tb)
        finally:
            _tls.runs.pop()


@contextlib.contextmanager
def with_run(run_id: str | None):
    """Make ``run_id`` the active run for the scope WITHOUT emitting events:
    a perf report built after its plan's operations stamps its ``perf``
    event with the plan's run ID this way. ``None`` is a no-op scope."""
    if run_id is None:
        yield
        return
    stack = getattr(_tls, "runs", None)
    if stack is None:
        stack = _tls.runs = []
    stack.append(run_id)
    try:
        yield
    finally:
        stack.pop()


def span(name: str, **args):
    """Scoped duration event (begin/end pair); the shared no-op scope when
    disarmed (zero allocation)."""
    if not _recorder:
        return _NOOP_SPAN
    return _Span(name, args)


def operation(name: str, run_id: str | None = None, **args):
    """Scoped host-facing operation: a duration span that also makes
    ``run_id`` (fresh when None) the active run for everything nested under
    it. The no-op scope when disarmed."""
    if not _recorder:
        return _NOOP_SPAN
    return _Operation(name, run_id, args)


# ---- export -------------------------------------------------------------------

_SNAPSHOT_KEYS = ("schema", "enabled", "capacity", "dropped", "epoch_unix", "events")
_EVENT_KEYS = ("seq", "ts", "run", "name", "ph", "args")


def snapshot() -> dict:
    """JSON-stable view of the flight recorder (schema
    :data:`TRACE_SCHEMA`); round-trips through ``json.dumps``/``loads``
    unchanged. ``dropped`` counts ring evictions, so consumers know when the
    window truncated."""
    return {
        "schema": TRACE_SCHEMA,
        "enabled": enabled(),
        "capacity": _recorder.capacity,
        "dropped": _recorder.dropped,
        "epoch_unix": _recorder.epoch_unix,
        "events": _recorder.events(),
    }


def validate_trace(snap: dict) -> list:
    """Missing/malformed key paths of a trace snapshot ([] when valid) —
    the schema pin, same style as ``obs.validate_snapshot`` /
    ``obs.validate_plan_card``."""
    missing = [k for k in _SNAPSHOT_KEYS if k not in snap]
    if snap.get("schema") not in (None, TRACE_SCHEMA):
        missing.append(f"schema (unknown: {snap['schema']!r})")
    for i, ev in enumerate(snap.get("events", ())):
        missing.extend(f"events[{i}].{k}" for k in _EVENT_KEYS if k not in ev)
        if ev.get("ph") not in _PHASES:
            missing.append(f"events[{i}].ph (unknown: {ev.get('ph')!r})")
        if ev.get("name") not in EVENTS:
            missing.append(f"events[{i}].name (unknown: {ev.get('name')!r})")
    return missing


# ---- cross-host segments ----------------------------------------------------

# The wire format of the cross-host trace join, the JAX package's: the events
# of one run, stripped to the wire keys (``seq`` is recorder-local and the run
# is hoisted to the envelope).
SEGMENT_SCHEMA = "spfft_tpu.obs.trace.segment/1"
_SEGMENT_KEYS = ("schema", "run", "events")
_SEGMENT_EVENT_KEYS = ("ts", "name", "ph", "args")


def segment(run_id: str, limit: int | None = None) -> dict:
    """Every recorded event stamped with ``run_id`` as a schema-pinned
    segment; ``limit`` keeps the newest. Empty while disarmed."""
    events = [
        {"ts": e["ts"], "name": e["name"], "ph": e["ph"], "args": e["args"]}
        for e in _recorder.events()
        if e["run"] == run_id
    ]
    if limit is not None and len(events) > int(limit):
        events = events[-int(limit):]
    return {"schema": SEGMENT_SCHEMA, "run": run_id, "events": events}


def validate_segment(seg: dict) -> list:
    """Missing or malformed key paths of a segment ([] when valid)."""
    if not isinstance(seg, dict):
        return ["segment (not a dict)"]
    missing = [k for k in _SEGMENT_KEYS if k not in seg]
    if seg.get("schema") != SEGMENT_SCHEMA:
        missing.append(f"schema (unknown: {seg.get('schema')!r})")
    for i, ev in enumerate(seg.get("events", ())):
        if not isinstance(ev, dict):
            missing.append(f"events[{i}] (not a dict)")
            continue
        missing.extend(f"events[{i}].{k}" for k in _SEGMENT_EVENT_KEYS if k not in ev)
        if ev.get("ph") not in _PHASES:
            missing.append(f"events[{i}].ph (unknown: {ev.get('ph')!r})")
        if ev.get("name") not in EVENTS:
            missing.append(f"events[{i}].name (unknown: {ev.get('name')!r})")
    return missing


def splice(seg: dict, host: str | None = None) -> int:
    """Re-emit a remote segment's events into the local recorder under the
    segment's run, each tagged ``host=`` and carrying the remote timestamp
    as ``remote_ts`` (local ``ts``/``seq`` are assigned here). Events that
    fail the schema are skipped, never spliced; returns how many were (0
    while disarmed or for a malformed envelope)."""
    if not _recorder or not isinstance(seg, dict):
        return 0
    if seg.get("schema") != SEGMENT_SCHEMA:
        return 0
    run = seg.get("run")
    spliced = 0
    for ev in seg.get("events", ()):
        if not isinstance(ev, dict) or any(k not in ev for k in _SEGMENT_EVENT_KEYS):
            continue
        if ev["ph"] not in _PHASES or ev["name"] not in EVENTS:
            continue
        args = dict(ev["args"] if isinstance(ev["args"], dict) else {})
        if host is not None:
            args["host"] = str(host)
        args["remote_ts"] = ev["ts"]
        _recorder.emit(ev["name"], ev["ph"], run, args)
        spliced += 1
    return spliced


def _track_of(ev: dict) -> str:
    """Chrome track key: host phases get one track per phase label (the
    timing vocabulary becomes rows), every other event name is its own
    track."""
    if ev["name"] == "phase":
        return str(ev["args"].get("label", "phase"))
    return ev["name"]


def chrome_trace(snap: dict | None = None) -> dict:
    """Chrome trace-event rendering of a snapshot — loadable in Perfetto /
    ``chrome://tracing``. One process ("spfft_tpu_torch host"), one named track
    per host phase / event name; B/E spans render as slices, instants as
    thread-scoped ``i`` events; every event's args carry its run ID.

    Ring eviction can orphan a ``B`` or ``E`` at the window edge; viewers
    tolerate the unmatched end, and ``dropped`` in the source snapshot says
    whether the window truncated.
    """
    snap = snapshot() if snap is None else snap
    pid = 1
    out = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "spfft_tpu_torch host"},
        }
    ]
    tids: dict = {}
    for ev in snap.get("events", ()):
        track = _track_of(ev)
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        entry = {
            "name": track,
            "cat": ev["name"],
            "ph": ev["ph"],
            "ts": round(ev["ts"] * 1e6, 3),  # Chrome wants microseconds
            "pid": pid,
            "tid": tid,
            "args": {**ev["args"], "run": ev["run"], "seq": ev["seq"]},
        }
        if ev["ph"] == "i":
            entry["s"] = "t"  # thread-scoped instant
        out.append(entry)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ---- dump-on-error ------------------------------------------------------------

# Dump files rotate like the event ring: at most DUMP_KEEP files per process,
# the oldest overwritten — a long-running service with recovered typed errors
# keeps bounded disk AND the dump that matters (the final crash) is always
# among the newest files, never dropped for a cap.
DUMP_KEEP = 64

_dump_warned = False


@contextlib.contextmanager
def suppressed_dumps():
    """A scope in which :func:`dump` is a no-op (events still record): for
    code that expects and recovers from typed errors, such as a tuning
    trial's isolation, so that ``SPFFT_TPU_TRACE_DUMP`` is not flooded with
    dumps of errors that were handled."""
    prev = getattr(_tls, "no_dump", 0)
    _tls.no_dump = prev + 1
    try:
        yield
    finally:
        _tls.no_dump = prev


def dump(reason: str = "error") -> str | None:
    """Flush the flight recorder to a JSON file in the
    ``SPFFT_TPU_TRACE_DUMP`` directory; returns the path (None when the knob
    is unset, tracing is disarmed, a :func:`suppressed_dumps` scope is
    active, or the write failed — a dump must never
    add a second failure to the one being dumped). At most :data:`DUMP_KEEP` files per process, the
    oldest rotated over. Warns once per process on the first dump so crash
    logs point at the artifact.

    Called automatically when a typed :mod:`spfft_tpu_torch.errors`
    exception is constructed, and callable directly from debugging
    sessions."""
    global _dump_warned
    directory = knobs.get_str(TRACE_DUMP_ENV)
    if not directory or not _recorder or getattr(_tls, "no_dump", 0):
        return None
    doc = dict(snapshot(), reason=str(reason))
    path = os.path.join(
        directory,
        f"trace-{os.getpid()}-{next(_dump_counter) % DUMP_KEEP:04d}.json",
    )
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
    except OSError:
        return None
    with _lock:
        first = not _dump_warned
        _dump_warned = True
    if first:
        warnings.warn(
            f"spfft_tpu_torch flight recorder dumped to {path!r} ({reason})",
            RuntimeWarning,
            stacklevel=3,
        )
    return path
