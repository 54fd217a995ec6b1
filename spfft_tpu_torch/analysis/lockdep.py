"""Runtime lockdep validator: observe the REAL lock-acquisition graph.

The port of ``spfft_tpu/analysis/lockdep.py``, recording the port's locks.

The static lock-order checker (:mod:`.locks`, SA011) models acquisition
order from the AST — conservatively, name-based. What it cannot see:
dynamic dispatch (a callback acquiring a lock the caller never names),
dict-held latches (``serve.batcher``'s per-digest build locks), and
cross-thread handoffs. This module is the second layer: armed via the
``SPFFT_TPU_LOCKDEP`` knob (read in ``spfft_tpu_torch/__init__`` *before*
any submodule creates its threading primitives), :func:`install` replaces
the ``threading.Lock/RLock/Condition/Event`` factories with recording
wrappers for every primitive the PACKAGE creates — a creation site under
``spfft_tpu_torch/``, outside the harness folders (``programs/``,
``examples/``, ``native/``) and this analysis package. Foreign creations
(stdlib internals, torch, the JAX package, tests) pass through untouched,
so overhead and noise stay confined to the locks under study. The wrappers
are Python objects: a lock taken around a CUDA-graph capture is recorded at
its acquisition and is never part of the captured graph.

What gets recorded, per process:

* **Locks** — every package-created primitive, identified by its creation
  site ``file::line`` (the join key against the static model; a
  per-instance ``self.<attr>`` lock yields many primitives sharing one
  site id, aggregated exactly like the static model's one-name-per-site
  view).
* **Edges** — ``A -> B`` whenever a thread acquires ``B`` while holding
  ``A`` (recorded at the *attempt*, so a real deadlock still leaves its
  edge in the report). Re-entry of the SAME primitive instance (RLock) is
  not an edge, but nesting two same-site instances IS — it appears as a
  site-level self-edge, the shape of an unordered two-instance (ABBA)
  hazard.
* **Blocking** — a ``Condition.wait`` / ``Event.wait`` entered while some
  *other* recorded lock is still held (``Condition.wait`` releases only its
  own lock; anything else stays held across the unbounded wait).
* **Cycles** — SCCs of the observed edge graph (:func:`.locks.find_cycles`,
  the same detector the static pass uses).

:func:`report` exports the ``spfft_tpu_torch.analysis.lockdep/1`` JSON document
(``SPFFT_TPU_LOCKDEP_REPORT`` dumps it at process exit); :func:`crosscheck`
validates it against :func:`.locks.static_graph`: a runtime edge between
two statically-known locks that the static graph does not contain means
THE STATIC MODEL IS STALE — itself a finding, exactly like a runtime cycle
or a blocking wait. Edges touching a lock the static pass cannot track
(dynamic creation sites) are reported as ``dynamic`` — listed, explained,
not findings.

Import discipline: stdlib-only, loadable without ``spfft_tpu_torch`` (the
same contract as every module in this package). The wrappers implement the full
public lock API (``acquire(blocking, timeout)``, context-manager protocol,
``locked``, ``notify``/``wait_for``) so armed suites run unchanged.
"""
from __future__ import annotations

import atexit
import json
import sys
import threading

from .locks import find_cycles

SCHEMA = "spfft_tpu_torch.analysis.lockdep/1"

_REAL: dict = {}       # saved threading factories (install/uninstall)
_installed = False
_report_path = None
_dump_registered = False  # atexit hook registered once per process

# recorder state — guarded by a REAL (unwrapped) lock created at install;
# the recorder lock is leaf-only: nothing else is ever acquired under it
_reclock = None
_locks: dict = {}      # lock_id -> {"kind", "file", "line", "created"}
_edges: dict = {}      # (from, to) -> {"file", "line", "count"}
_blocking: dict = {}   # (lock_id, held_tuple) -> {"file", "line", "count"}

_tls = threading.local()

_SELF_FILE = __file__
_THREADING_FILE = threading.__file__

# creation sites under this path component are "package" locks (recorded),
# except those in the folders below; everything else passes through unwrapped
_PACKAGE_MARKER = "spfft_tpu_torch"
_UNRECORDED_SUBDIRS = ("analysis", "programs", "examples", "native")


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _rel_path(filename: str) -> str:
    """Repository-relative path when the marker is present (the static
    model's file keys are repo-relative), else the filename unchanged."""
    norm = filename.replace("\\", "/")
    marker = f"/{_PACKAGE_MARKER}/"
    idx = norm.rfind(marker)
    if idx >= 0:
        return norm[idx + 1:]
    return norm


def _caller_site() -> tuple:
    """(file, line) of the nearest frame outside this module and the
    threading module — where the user code created/acquired the primitive."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _SELF_FILE and fn != _THREADING_FILE:
            return _rel_path(fn), f.f_lineno
        f = f.f_back
    return "?", 0


def _in_package(rel: str) -> bool:
    parts = rel.split("/")
    return (
        len(parts) > 1
        and parts[0] == _PACKAGE_MARKER
        and not (len(parts) > 2 and parts[1] in _UNRECORDED_SUBDIRS)
    )


def _register_lock(kind: str, site: tuple) -> str:
    lock_id = f"{site[0]}::{site[1]}"
    with _reclock:
        info = _locks.get(lock_id)
        if info is None:
            _locks[lock_id] = {
                "kind": kind, "file": site[0], "line": site[1], "created": 1,
            }
        else:
            info["created"] += 1
    return lock_id


def _note_attempt(wrapper) -> None:
    """Record held -> wrapper edges at the acquisition ATTEMPT (before the
    real acquire blocks), so a genuine deadlock still leaves its edge.

    The held stack carries wrapper INSTANCES: re-entry of the same
    instance (RLock) is exempt by identity, while nesting two different
    instances created at the same site records a site-level self-edge —
    the unordered two-instance hazard a shared-id comparison would hide."""
    held = _held()
    if not held:
        return
    lock_id = wrapper.lock_id
    site = _caller_site()
    with _reclock:
        for h in held:
            if h is wrapper:
                continue  # same-instance re-entry (RLock): not an edge
            e = _edges.get((h.lock_id, lock_id))
            if e is None:
                _edges[(h.lock_id, lock_id)] = {
                    "file": site[0], "line": site[1], "count": 1,
                }
            else:
                e["count"] += 1


def _note_blocking(lock_id: str, others: list) -> None:
    site = _caller_site()
    key = (lock_id, tuple(sorted(set(others))))
    with _reclock:
        b = _blocking.get(key)
        if b is None:
            _blocking[key] = {"file": site[0], "line": site[1], "count": 1}
        else:
            b["count"] += 1


def _push(wrapper) -> None:
    _held().append(wrapper)


def _pop(wrapper) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] is wrapper:
            del held[i]
            return


class _LockWrapper:
    """Recording proxy over a real ``threading.Lock``/``RLock``."""

    __slots__ = ("_real", "lock_id", "kind")

    def __init__(self, real, kind: str, lock_id: str):
        self._real = real
        self.kind = kind
        self.lock_id = lock_id

    def acquire(self, blocking=True, timeout=-1):
        _note_attempt(self)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            _push(self)
        return ok

    def release(self):
        self._real.release()
        _pop(self)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _ConditionWrapper:
    """Recording proxy over a real ``threading.Condition``.

    Constructed without a lock, the wrapper owns a real RLock (created from
    the saved original so the inner lock is never itself recorded) and does
    its own held bookkeeping. Constructed WITH a caller lock, that lock's
    own wrapper (if any) already does the bookkeeping — this wrapper then
    only adds the wait-while-holding detection."""

    __slots__ = ("_real", "lock_id", "kind", "_tracks", "_inner")

    def __init__(self, kind: str, lock_id: str, lock=None):
        self.kind = kind
        self.lock_id = lock_id
        if lock is None:
            self._real = _REAL["Condition"](_REAL["RLock"]())
            self._tracks = True
            self._inner = self
        else:
            self._real = _REAL["Condition"](lock)
            self._tracks = False
            self._inner = lock  # the caller's (possibly wrapped) lock

    def acquire(self, *args, **kwargs):
        if self._tracks:
            _note_attempt(self)
        ok = self._real.acquire(*args, **kwargs)
        if self._tracks and ok:
            _push(self)
        return ok

    def release(self):
        self._real.release()
        if self._tracks:
            _pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _waiting_blocked(self):
        others = [h.lock_id for h in _held() if h is not self._inner]
        if others:
            _note_blocking(
                getattr(self._inner, "lock_id", self.lock_id), others
            )

    def wait(self, timeout=None):
        self._waiting_blocked()
        if self._tracks:
            _pop(self)  # the wait releases the condition's own lock
        try:
            return self._real.wait(timeout)
        finally:
            if self._tracks:
                _push(self)  # implicit re-acquire on wakeup

    def wait_for(self, predicate, timeout=None):
        self._waiting_blocked()
        if self._tracks:
            _pop(self)
        try:
            return self._real.wait_for(predicate, timeout)
        finally:
            if self._tracks:
                _push(self)

    def notify(self, n=1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()


class _EventWrapper:
    """Recording proxy over a real ``threading.Event`` — only ``wait`` is
    instrumented (an Event wait entered with a lock held blocks every other
    path through that lock, exactly like a foreign ``.wait()`` in SA011)."""

    __slots__ = ("_real", "lock_id")

    def __init__(self, lock_id: str):
        self._real = _REAL["Event"]()
        self.lock_id = lock_id

    def wait(self, timeout=None):
        others = [h.lock_id for h in _held()]
        if others:
            _note_blocking(self.lock_id, others)
        return self._real.wait(timeout)

    def set(self):
        self._real.set()

    def clear(self):
        self._real.clear()

    def is_set(self):
        return self._real.is_set()


def _lock_factory():
    site = _caller_site()
    if not _in_package(site[0]):
        return _REAL["Lock"]()
    return _LockWrapper(_REAL["Lock"](), "lock", _register_lock("lock", site))


def _rlock_factory():
    site = _caller_site()
    if not _in_package(site[0]):
        return _REAL["RLock"]()
    return _LockWrapper(
        _REAL["RLock"](), "rlock", _register_lock("rlock", site)
    )


def _condition_factory(lock=None):
    site = _caller_site()
    if not _in_package(site[0]):
        return _REAL["Condition"](lock)
    return _ConditionWrapper(
        "condition", _register_lock("condition", site), lock
    )


def _event_factory():
    site = _caller_site()
    if not _in_package(site[0]):
        return _REAL["Event"]()
    return _EventWrapper(_register_lock("event", site))


def install(report_path=None) -> None:
    """Arm the validator: replace the ``threading`` factories with the
    recording wrappers (package-created primitives only). Idempotent. With
    ``report_path``, the ``spfft_tpu_torch.analysis.lockdep/1`` report is written
    there at process exit."""
    global _installed, _reclock, _report_path, _dump_registered
    if not _installed:
        _REAL.update(
            Lock=threading.Lock,
            RLock=threading.RLock,
            Condition=threading.Condition,
            Event=threading.Event,
        )
        _reclock = _REAL["Lock"]()
        threading.Lock = _lock_factory
        threading.RLock = _rlock_factory
        threading.Condition = _condition_factory
        threading.Event = _event_factory
        _installed = True
    if report_path:
        _report_path = str(report_path)
        if not _dump_registered:
            _dump_registered = True
            atexit.register(_dump)


def uninstall() -> None:
    """Restore the real ``threading`` factories (recorded data is kept —
    :func:`reset` clears it). Already-created wrappers keep working."""
    global _installed
    if not _installed:
        return
    threading.Lock = _REAL["Lock"]
    threading.RLock = _REAL["RLock"]
    threading.Condition = _REAL["Condition"]
    threading.Event = _REAL["Event"]
    _installed = False


def reset() -> None:
    """Drop every recorded lock/edge/blocking entry (tests)."""
    with (_reclock if _reclock is not None else threading.Lock()):
        _locks.clear()
        _edges.clear()
        _blocking.clear()


def installed() -> bool:
    return _installed


def report() -> dict:
    """The ``spfft_tpu_torch.analysis.lockdep/1`` JSON document of everything
    observed so far (JSON-plain; cycles via the shared SCC detector)."""
    guard = _reclock if _reclock is not None else threading.Lock()
    with guard:
        locks = [
            {"id": lock_id, **info} for lock_id, info in sorted(_locks.items())
        ]
        edges = [
            {"from": a, "to": b, **info}
            for (a, b), info in sorted(_edges.items())
        ]
        blocking = [
            {"lock": lock_id, "held": list(held), **info}
            for (lock_id, held), info in sorted(_blocking.items())
        ]
    graph: dict = {}
    for e in edges:
        graph.setdefault(e["from"], set()).add(e["to"])
    return {
        "schema": SCHEMA,
        "installed": _installed,
        "locks": locks,
        "edges": edges,
        "blocking": blocking,
        "cycles": find_cycles(graph),
        "counts": {
            "locks": len(locks),
            "edges": len(edges),
            "blocking": len(blocking),
        },
    }


REPORT_KEYS = (
    "schema", "installed", "locks", "edges", "blocking", "cycles", "counts",
)


def merge_reports(docs: list) -> dict:
    """Union N per-process lockdep reports into one (the multi-host merge:
    every spawned worker writes its own ``SPFFT_TPU_LOCKDEP_REPORT`` and
    ``spfft_tpu_torch/programs/analyze.py --lockdep-check`` cross-checks the fleet as one
    graph). Locks are keyed by creation site (``created`` summed), edges by
    (from, to) with ``count`` summed, blocking rows by (lock, held) with
    ``count`` summed; cycles are recomputed over the merged edge graph.
    Site-keyed edges from different processes compose meaningfully: a
    cycle assembled from one host's ``a -> b`` and another's ``b -> a`` is
    a real latent ABBA hazard — both orders exist in the code that ran,
    and nothing stops one process's threads from interleaving them."""
    locks: dict = {}
    edges: dict = {}
    blocking: dict = {}
    installed = False
    for doc in docs:
        installed = installed or bool(doc.get("installed"))
        for row in doc.get("locks", []):
            info = locks.get(row["id"])
            if info is None:
                locks[row["id"]] = {
                    k: v for k, v in row.items() if k != "id"
                }
            else:
                info["created"] = info.get("created", 0) + row.get(
                    "created", 0
                )
        for row in doc.get("edges", []):
            key = (row["from"], row["to"])
            info = edges.get(key)
            if info is None:
                edges[key] = {
                    k: v for k, v in row.items() if k not in ("from", "to")
                }
            else:
                info["count"] = info.get("count", 0) + row.get("count", 0)
        for row in doc.get("blocking", []):
            key = (row["lock"], tuple(row.get("held", ())))
            info = blocking.get(key)
            if info is None:
                blocking[key] = {
                    k: v for k, v in row.items() if k not in ("lock", "held")
                }
            else:
                info["count"] = info.get("count", 0) + row.get("count", 0)
    lock_rows = [{"id": i, **info} for i, info in sorted(locks.items())]
    edge_rows = [
        {"from": a, "to": b, **info} for (a, b), info in sorted(edges.items())
    ]
    blocking_rows = [
        {"lock": lock_id, "held": list(held), **info}
        for (lock_id, held), info in sorted(blocking.items())
    ]
    graph: dict = {}
    for e in edge_rows:
        graph.setdefault(e["from"], set()).add(e["to"])
    return {
        "schema": SCHEMA,
        "installed": installed,
        "locks": lock_rows,
        "edges": edge_rows,
        "blocking": blocking_rows,
        "cycles": find_cycles(graph),
        "counts": {
            "locks": len(lock_rows),
            "edges": len(edge_rows),
            "blocking": len(blocking_rows),
        },
    }


def validate_report(doc: dict) -> list:
    """Missing-key list for a lockdep report (schema floor; empty = valid),
    the same shape as the analysis report validator."""
    missing = [k for k in REPORT_KEYS if k not in doc]
    if doc.get("schema") != SCHEMA:
        missing.append(f"schema=={SCHEMA}")
    for i, row in enumerate(doc.get("locks", [])):
        for k in ("id", "kind", "file", "line"):
            if k not in row:
                missing.append(f"locks[{i}].{k}")
    for i, row in enumerate(doc.get("edges", [])):
        for k in ("from", "to", "file", "line", "count"):
            if k not in row:
                missing.append(f"edges[{i}].{k}")
    return missing


def _dump() -> None:
    if not _report_path:
        return
    try:
        with open(_report_path, "w") as fh:
            json.dump(report(), fh, indent=2)
            fh.write("\n")
    except OSError:  # a vanished tmpdir at exit must not mask the real exit
        pass


def crosscheck(doc: dict, static: dict) -> dict:
    """Validate a runtime report against the static model
    (:func:`.locks.static_graph`).

    Returns ``findings`` (each a dict with ``kind``/``message``/``where``)
    plus the explanation tables. Findings:

    * ``stale-static`` — a runtime edge between two statically-known locks
      that the static graph lacks: the SA011 model no longer matches the
      code that actually ran.
    * ``same-site-nesting`` — a site-level self-edge: two DISTINCT
      primitive instances created at one site nested inside each other
      (the per-instance ``self.<attr>`` pattern acquired pairwise). The
      static model cannot order instances, and pairwise acquisition
      without a documented instance order is the ABBA deadlock shape.
    * ``cycle`` — an observed acquisition-order cycle.
    * ``blocking`` — a wait entered while another recorded lock was held.

    Runtime locks with no static counterpart (creation sites the static
    pass cannot track) are ``dynamic``; their edges are explained, listed,
    and not findings."""
    by_site = {
        (info["file"], info["line"]): lock_id
        for lock_id, info in static.get("locks", {}).items()
    }
    static_edges = {tuple(e) for e in static.get("edges", [])}
    mapping = {}
    for row in doc.get("locks", []):
        mapping[row["id"]] = by_site.get((row["file"], row["line"]))
    findings: list = []
    explained = {"static": [], "dynamic": []}
    for e in doc.get("edges", []):
        if e["from"] == e["to"]:
            # wrapper identity already exempts same-instance re-entry, so a
            # surviving self-edge means two instances from one site nested
            findings.append(
                {
                    "kind": "same-site-nesting",
                    "where": f"{e['file']}:{e['line']}",
                    "message": (
                        f"two distinct instances of {e['from']} were "
                        "nested inside each other — pairwise acquisition "
                        "of same-site locks without a documented instance "
                        "order is the ABBA deadlock shape"
                    ),
                }
            )
            continue
        a = mapping.get(e["from"])
        b = mapping.get(e["to"])
        if a is None or b is None:
            explained["dynamic"].append(e)
            continue
        if (a, b) in static_edges:
            explained["static"].append(e)
            continue
        findings.append(
            {
                "kind": "stale-static",
                "where": f"{e['file']}:{e['line']}",
                "message": (
                    f"runtime acquisition edge {a} -> {b} is missing from "
                    "the SA011 static graph — the static model is stale "
                    "(dynamic dispatch or a callback the AST walk cannot "
                    "resolve); teach spfft_tpu_torch/analysis/locks.py the path "
                    "or restructure the acquisition"
                ),
            }
        )
    for comp in doc.get("cycles", []):
        findings.append(
            {
                "kind": "cycle",
                "where": comp[0],
                "message": (
                    "observed lock-order cycle (potential deadlock): "
                    + " <-> ".join(comp)
                ),
            }
        )
    for b in doc.get("blocking", []):
        findings.append(
            {
                "kind": "blocking",
                "where": f"{b['file']}:{b['line']}",
                "message": (
                    f"wait on {b['lock']} entered while still holding "
                    f"{', '.join(b['held'])} — the held lock blocks every "
                    "other path for the whole wait"
                ),
            }
        )
    return {"findings": findings, "explained": explained, "mapping": mapping}
