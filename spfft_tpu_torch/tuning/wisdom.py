"""Persistent plan wisdom: the measured choice of each tuned plan decision.

The port of ``spfft_tpu/tuning/wisdom.py``. A store maps a *tuning key* (the
plan properties that decide which candidate wins: dims, sparsity signature,
mesh, dtype, requested engine, platform, the card's name, the torch and CUDA
versions) to the winning choice and its trial table. Two stores share one
interface:

- :class:`WisdomStore`: JSON at the path of ``SPFFT_TPU_WISDOM``, under the
  port's own schema (:data:`WISDOM_SCHEMA`), so that a file written by one
  package never answers for the other: a JAX-written file is a schema
  mismatch. A corrupt file or a schema mismatch degrades to an empty store
  (every lookup misses and ``fallback_reason`` says why); a corrupt file is
  also *quarantined* (renamed ``*.corrupt``, warned about once per process,
  ``wisdom_quarantined_total``). Writes are atomic (tempfile and
  ``os.replace``) under a module lock and an advisory ``flock`` on a sidecar
  file, retried with exponential backoff (``wisdom_retries_total``); retries
  that run out degrade to a recorded ``wisdom_save_failed`` rung. The fault
  sites ``wisdom.load`` and ``wisdom.save`` sit on both paths.
- :class:`MemoryStore`: the process-global store when ``SPFFT_TPU_WISDOM`` is
  unset: constructions in one process reuse trials; nothing persists.

A key that changes lands in a different entry, so stale wisdom is bypassed,
never applied.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import threading
import time
import warnings

from .. import faults, knobs, obs

WISDOM_ENV = "SPFFT_TPU_WISDOM"
WISDOM_SCHEMA = "spfft_tpu_torch.tuning.wisdom/1"

# Bounded retry of a failing wisdom write: attempts, and the base of the
# exponential backoff between them (0.01 s, 0.02 s).
WISDOM_SAVE_ATTEMPTS = 3
WISDOM_SAVE_BACKOFF_S = 0.01

# The port's engine knobs that change what a trial measures; their ambient
# values ride in every key (:func:`env_signature`). The JAX package's list
# less the knobs that have no counterpart here (the TPU's GAUSS_MM,
# PAIR_COPY, COPY_DENSE_FRAC, F64_STAGE_MB, PHASE_*, ONESHOT_TRANSPORT) and
# SPARSE_Y_MATRIX_MB, which the port does not read (``knobs.py``).
PERF_ENV_KNOBS = (
    "SPFFT_TPU_SPARSE_Y",
    "SPFFT_TPU_SPARSE_Y_BLOCKS",
    "SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC",
    "SPFFT_TPU_XPAD",
)

_lock = threading.Lock()
_warn_lock = threading.Lock()  # guards _quarantine_warned (the quarantine
# runs inside _load, which record() calls under _lock)
_quarantine_warned: set = set()  # paths warned about, once a process


def env_signature() -> dict:
    """The ambient values of :data:`PERF_ENV_KNOBS` (None when unset)."""
    return {k: knobs.raw(k) for k in PERF_ENV_KNOBS}


def sparsity_signature(*arrays) -> str:
    """A stable 16-hex digest of the stick and value layout arrays."""
    import numpy as np

    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a, dtype=np.int64))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory exclusive lock on a sidecar file, for read-modify-write
    across processes; no lock where ``fcntl`` is missing (the module lock
    still covers threads)."""
    try:
        import fcntl
    except ImportError:
        yield
        return
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # closing drops the flock


def key_digest(key: dict) -> str:
    """The entry id of a tuning key (sorted-JSON sha256, 24 hex)."""
    return hashlib.sha256(
        json.dumps(key, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()[:24]


def make_entry(key: dict, choice: dict, trials: list) -> dict:
    """A store entry: the full key, the winning candidate and the trial
    table that picked it."""
    return {"key": key, "choice": choice, "trials": trials, "created_unix": time.time()}


def best_measured_ms(entry: dict) -> float | None:
    """The fastest measured trial of an entry (None without measured rows):
    the tie-breaker of :func:`merge_entries`."""
    times = []
    for row in entry.get("trials", ()):
        if not (isinstance(row, dict) and "ms" in row):
            continue
        try:
            times.append(float(row["ms"]))
        except (TypeError, ValueError):
            continue  # a malformed row is not a measurement
    return min(times) if times else None


def merge_entries(existing: dict, incoming: dict) -> tuple:
    """Merge bundle entries into ``existing`` in place, the better measured
    entry winning a key; returns ``(added, replaced)``. Ties keep the
    existing entry, so merging one bundle twice changes nothing."""
    added = replaced = 0
    for digest, entry in incoming.items():
        if not isinstance(entry, dict) or not isinstance(entry.get("choice"), dict):
            continue  # malformed rows never displace measured wisdom
        current = existing.get(digest)
        if current is None:
            existing[digest] = entry
            added += 1
            continue
        new_ms, cur_ms = best_measured_ms(entry), best_measured_ms(current)
        if new_ms is not None and (cur_ms is None or new_ms < cur_ms):
            existing[digest] = entry
            replaced += 1
    return added, replaced


def quarantine_file(path: str, why: str) -> None:
    """Rename a corrupt wisdom file or bundle to ``<path>.corrupt``, warn
    once a process and count ``wisdom_quarantined_total``; a rename that
    fails leaves the caller's degrade-to-empty behaviour alone."""
    path = str(path)
    target = path + ".corrupt"
    try:
        os.replace(path, target)
    except OSError:
        return
    obs.counter("wisdom_quarantined_total").inc()
    faults.record_degradation("wisdom_quarantined", why, path=path, quarantined_to=target)
    with _warn_lock:
        first = path not in _quarantine_warned
        _quarantine_warned.add(path)
    if first:
        warnings.warn(f"corrupt wisdom store {path!r} quarantined to {target!r}: {why}",
                      RuntimeWarning, stacklevel=4)


def _write_bundle(path: str, entries: dict, *, dir: str) -> None:
    """Atomic write of a ``{schema, entries}`` document."""
    doc = {"schema": WISDOM_SCHEMA, "entries": entries}
    fd, tmp = tempfile.mkstemp(prefix=".wisdom.", dir=dir)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, str(path))
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _load_bundle(path: str) -> dict:
    """A bundle's entries, for a merge. A merge is an operator's action, so
    a bad bundle raises typed: unreadable, schema mismatch, or corrupt (the
    last also quarantined first)."""
    from ..errors import InvalidParameterError

    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise InvalidParameterError(f"wisdom bundle {str(path)!r} is unreadable: {e}") from e
    try:
        doc = json.loads(text)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        quarantine_file(path, faults.summarize(e))
        raise InvalidParameterError(
            f"wisdom bundle {str(path)!r} is corrupt (quarantined to "
            f"{str(path) + '.corrupt'!r}): {faults.summarize(e)}") from e
    if not isinstance(doc, dict) or doc.get("schema") != WISDOM_SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else type(doc).__name__
        raise InvalidParameterError(
            f"wisdom bundle {str(path)!r} schema mismatch: {got!r} != {WISDOM_SCHEMA!r}")
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def _export(entries: dict, path) -> int:
    d = os.path.dirname(os.path.abspath(str(path))) or "."
    os.makedirs(d, exist_ok=True)
    _write_bundle(path, entries, dir=d)
    obs.trace.event("wisdom.save", path=str(path), outcome="ok", attempt=1)
    return len(entries)


class WisdomStore:
    """The JSON-file store (module docstring)."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fallback_reason: str | None = None

    def _load(self) -> dict:
        """``{digest: entry}``; empty when the file is absent, corrupt (and
        quarantined) or of another schema (``fallback_reason`` says which)."""
        self.fallback_reason = None
        try:
            with open(self.path) as f:
                text = f.read()
            # wisdom.load: `corrupt` mangles the text, `raise` is an unreadable store
            text = faults.site("wisdom.load", payload=text)
            doc = json.loads(text)
        except FileNotFoundError:
            return {}
        except faults.InjectedFault as e:
            self.fallback_reason = f"wisdom load fault: {e}"
            faults.record_degradation("wisdom_load_failed", str(e), path=self.path)
            return {}
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self.fallback_reason = f"corrupt wisdom file: {faults.summarize(e)}"
            quarantine_file(self.path, faults.summarize(e))
            return {}
        except OSError as e:
            self.fallback_reason = f"corrupt wisdom file: {faults.summarize(e)}"
            return {}
        if not isinstance(doc, dict) or doc.get("schema") != WISDOM_SCHEMA:
            got = doc.get("schema") if isinstance(doc, dict) else type(doc).__name__
            self.fallback_reason = f"wisdom schema mismatch: {got!s} != {WISDOM_SCHEMA}"
            return {}
        entries = doc.get("entries")
        return entries if isinstance(entries, dict) else {}

    def lookup(self, key: dict) -> dict | None:
        entry = self._load().get(key_digest(key))
        if entry is not None and not isinstance(entry.get("choice"), dict):
            entry = None  # an entry must at least carry a choice
        obs.trace.event("wisdom.load", path=self.path,
                        outcome=self.fallback_reason or "ok", hit=entry is not None)
        return entry

    def record(self, key: dict, entry: dict) -> None:
        """Add one entry: read, modify and write under both locks, with the
        bounded retries; a corrupt file is overwritten with a fresh store;
        retries that run out record ``wisdom_save_failed`` and return."""
        self._update(lambda entries: entries.__setitem__(key_digest(key), entry))

    def _update(self, mutate) -> bool:
        """One atomic read-modify-write (``mutate`` edits the table in
        place), retried; the backoff sleeps outside the locks. Returns
        whether the write landed."""
        last: Exception | None = None
        for attempt in range(WISDOM_SAVE_ATTEMPTS):
            try:
                faults.site("wisdom.save")
                with _lock:
                    d = os.path.dirname(os.path.abspath(self.path)) or "."
                    os.makedirs(d, exist_ok=True)
                    with _file_lock(self.path + ".lock"):
                        entries = self._load()
                        mutate(entries)
                        _write_bundle(self.path, entries, dir=d)
                obs.trace.event("wisdom.save", path=self.path, outcome="ok",
                                attempt=attempt + 1)
                return True
            except (OSError, faults.InjectedFault) as e:
                last = e
                obs.counter("wisdom_retries_total").inc()
                if attempt < WISDOM_SAVE_ATTEMPTS - 1:
                    time.sleep(WISDOM_SAVE_BACKOFF_S * (2 ** attempt))
        obs.counter("wisdom_save_failures_total").inc()
        obs.trace.event("wisdom.save", path=self.path, outcome="failed", reason=str(last))
        faults.record_degradation("wisdom_save_failed", str(last), path=self.path)
        return False

    def entries(self) -> dict:
        """A copy of the store's ``{digest: entry}`` table."""
        with _lock:
            return dict(self._load())

    def export(self, path: str) -> int:
        """Write the entries as a bundle at ``path`` (a wisdom file of the
        same schema); returns how many."""
        return _export(self.entries(), path)

    def merge(self, bundle_path: str) -> tuple:
        """Merge a bundle (:func:`merge_entries`); returns ``(added,
        replaced)``. A bundle of another schema, or a corrupt one
        (quarantined), raises :class:`InvalidParameterError`."""
        incoming = _load_bundle(bundle_path)
        if not incoming:
            return (0, 0)
        counts = []

        def mutate(entries):
            counts[:] = [merge_entries(entries, incoming)]

        return counts[0] if self._update(mutate) else (0, 0)


class MemoryStore:
    """The process-global store (``SPFFT_TPU_WISDOM`` unset)."""

    path = None
    fallback_reason = None
    _entries: dict = {}

    def lookup(self, key: dict) -> dict | None:
        entry = MemoryStore._entries.get(key_digest(key))
        obs.trace.event("wisdom.load", path=None, outcome="ok", hit=entry is not None)
        return entry

    def record(self, key: dict, entry: dict) -> None:
        with _lock:
            MemoryStore._entries[key_digest(key)] = entry
        obs.trace.event("wisdom.save", path=None, outcome="ok", attempt=1)

    def entries(self) -> dict:
        with _lock:
            return dict(MemoryStore._entries)

    def export(self, path: str) -> int:
        """Write the memory store as a bundle (:meth:`WisdomStore.export`)."""
        return _export(self.entries(), path)

    def merge(self, bundle_path: str) -> tuple:
        """Merge a bundle into memory (the rules of :meth:`WisdomStore.merge`)."""
        incoming = _load_bundle(bundle_path)
        if not incoming:
            return (0, 0)
        with _lock:
            return merge_entries(MemoryStore._entries, incoming)


def active_store():
    """The file store at ``SPFFT_TPU_WISDOM`` when set, else the memory store."""
    path = knobs.get_str(WISDOM_ENV)
    return WisdomStore(path) if path else MemoryStore()


def clear_memory() -> None:
    """Empty the process-global memory store."""
    with _lock:
        MemoryStore._entries.clear()
