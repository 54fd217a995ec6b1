"""Process-global engine circuit breaker for verified execution.

The port of ``spfft_tpu/verify/breaker.py``, the same state machine. After
``SPFFT_TPU_VERIFY_BREAKER_K`` consecutive verified-failure episodes on one
engine, the engine is **open** for the whole process: verified transforms
skip it and go straight to the ``torch.fft`` reference rung. After
``SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S`` the breaker turns **half-open** and
admits one probe: a verified success closes it, a failure opens it again.

State is per engine name (``mxu``, ``xla``, ``pencil2-mxu``, ...) and
process-global, as the fault plane and the metrics registry are; a plan over
a process group has an entry of its engine and group (:func:`group_key`). Exposure:
the ``verify_breaker_state{engine}`` gauge (0 closed / 1 open / 2
half-open), ``verify_breaker_trips_total{engine}``, a ``verify`` event at
every transition, and :func:`describe` for the plan card's
``verification.breaker`` section.
"""
from __future__ import annotations

import threading
import time

from .. import knobs, obs

BREAKER_K_ENV = "SPFFT_TPU_VERIFY_BREAKER_K"
BREAKER_COOLDOWN_ENV = "SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S"

DEFAULT_K = knobs.default(BREAKER_K_ENV)
DEFAULT_COOLDOWN_S = knobs.default(BREAKER_COOLDOWN_ENV)

_STATE_CODES = {"closed": 0, "open": 1, "half_open": 2}

_lock = threading.Lock()
_states: dict = {}  # engine -> {"state", "consecutive_failures", "opened_at", "trips"}


def threshold() -> int:
    """Consecutive verified failures that trip the breaker (floor 1)."""
    return knobs.get_int(BREAKER_K_ENV)


def cooldown_s() -> float:
    """Open -> half-open probe delay in seconds (0 probes immediately)."""
    return knobs.get_float(BREAKER_COOLDOWN_ENV)


def group_key(engine: str, group) -> str:
    """The breaker entry of a plan over a process group: the engine and the
    group's global ranks (``"pencil2@ranks0,1"``). Only the group's verified
    calls move it, and they give every process the same verdicts, so it is
    in the same state on every process of the group, whatever the process's
    other plans do to the engine's own entry."""
    import torch.distributed as dist

    ranks = ",".join(str(r) for r in dist.get_process_group_ranks(group))
    return f"{engine}@ranks{ranks}"


def _entry(engine: str) -> dict:
    entry = _states.get(engine)
    if entry is None:
        entry = _states[engine] = {
            "state": "closed",
            "consecutive_failures": 0,
            "opened_at": 0.0,
            "trips": 0,
            # half-open admits exactly ONE in-flight probe: concurrent
            # verified callers racing the cooldown must not all hammer a
            # possibly-still-bad engine at once — losers fail fast to the
            # reference rung while the winner's verdict settles the state
            "probing": False,
            "probe_at": 0.0,
        }
    return entry


def _probe_takeover_s() -> float:
    """How long an in-flight half-open probe may go verdict-less before
    another caller may take over the slot. A probe whose carrier died
    without reporting (a non-retryable escape, a killed thread) must not
    wedge the breaker in half-open forever — the slot self-heals after the
    cooldown (floored at 1 s so a zero cooldown still admits exactly one
    probe per instant under a thread race)."""
    return max(1.0, cooldown_s())


def _transition(engine: str, entry: dict, state: str) -> None:
    entry["state"] = state
    obs.gauge("verify_breaker_state", engine=engine).set(_STATE_CODES[state])
    obs.trace.event("verify", what="breaker", engine=engine, state=state)


def _admits(entry: dict, now: float) -> bool:
    """Whether ``entry``'s breaker admits a caller at ``now`` (see :func:`allow`)."""
    if entry["state"] == "open":
        return now - entry["opened_at"] >= cooldown_s()
    if entry["state"] == "half_open":
        # a verdict-less probe (carrier escaped without record_*) frees
        # its slot after the takeover interval — see _probe_takeover_s
        return not (entry["probing"] and now - entry["probe_at"] < _probe_takeover_s())
    return True


def allow(engine: str) -> bool:
    """Whether a verified transform may attempt the primary engine now.

    Closed -> yes. Open -> no until the cooldown elapses, then the breaker
    moves to half-open and THIS caller carries the probe. Half-open -> yes
    for exactly ONE caller at a time: while a probe is in flight every other
    caller is refused (straight to the reference rung) — N threads racing an
    elapsed cooldown must not multiply the probe load on an engine the
    breaker just declared unhealthy. The probe's verdict
    (:func:`record_success` / :func:`record_failure`) settles the state and
    releases the probe slot."""
    with _lock:
        entry = _entry(engine)
        now = time.monotonic()
        if entry["state"] == "closed":
            return True
        if not _admits(entry, now):
            return False
        if entry["state"] == "open":
            _transition(engine, entry, "half_open")
        entry["probing"] = True
        entry["probe_at"] = now
        return True


def state(engine: str) -> str:
    """``"closed"``, ``"open"`` or ``"half_open"``."""
    with _lock:
        return _entry(engine)["state"]


def would_allow(engine: str) -> bool:
    """What :func:`allow` would answer now, with no transition and no probe
    taken (a group of processes agrees on the answer before any of them
    takes it)."""
    with _lock:
        return _admits(_entry(engine), time.monotonic())


def release_probe(engine: str) -> None:
    """Release a held half-open probe slot WITHOUT a verdict — the probe
    never actually executed (e.g. the serving layer's probe batch was fully
    deadline-shed before dispatch). The state stays half-open and the next
    :func:`allow` grants a fresh probe immediately instead of waiting out
    the takeover interval. No-op when no probe is held."""
    with _lock:
        _entry(engine)["probing"] = False


def record_success(engine: str) -> None:
    """A verified execution on ``engine`` passed its checks: reset the
    consecutive-failure count and close the breaker (half-open probe healed)."""
    with _lock:
        entry = _entry(engine)
        entry["consecutive_failures"] = 0
        entry["probing"] = False
        if entry["state"] != "closed":
            _transition(engine, entry, "closed")


def record_failure(engine: str) -> None:
    """One verified-failure episode (retries exhausted or a half-open probe
    failed): trips the breaker at :func:`threshold` consecutive failures —
    immediately when half-open, since the probe just proved the engine is
    still bad."""
    with _lock:
        entry = _entry(engine)
        entry["consecutive_failures"] += 1
        entry["probing"] = False
        tripped = (
            entry["state"] == "half_open"
            or entry["consecutive_failures"] >= threshold()
        )
        if tripped and entry["state"] != "open":
            entry["opened_at"] = time.monotonic()
            entry["trips"] += 1
            obs.counter("verify_breaker_trips_total", engine=engine).inc()
            _transition(engine, entry, "open")


def describe(engine: str) -> dict:
    """JSON-plain state of one engine's breaker (the plan card's
    ``verification.breaker`` section)."""
    with _lock:
        entry = _entry(engine)
        return {
            "engine": engine,
            "state": entry["state"],
            "consecutive_failures": int(entry["consecutive_failures"]),
            "trips": int(entry["trips"]),
            "threshold": threshold(),
        }


def snapshot() -> dict:
    """JSON-plain state of every engine the process has verified."""
    with _lock:
        return {engine: dict(entry) for engine, entry in _states.items()}


def reset() -> None:
    """Close every breaker and drop all counts (tests / fresh processes).
    The ``verify_breaker_state`` gauges are zeroed too, so a metrics
    snapshot never shows a tripped breaker that no longer exists."""
    with _lock:
        for engine in _states:
            obs.gauge("verify_breaker_state", engine=engine).set(
                _STATE_CODES["closed"]
            )
        _states.clear()
