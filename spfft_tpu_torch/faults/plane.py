"""Process-global fault-injection plane: named sites, armed kinds, rates.

The port of ``spfft_tpu/faults/plane.py``. Failure paths are code that a
test can reach: every fallback the runtime claims ("an MXU engine that fails
to build falls back to ``torch.fft``", "a capture failure runs the staged
path") is shown by arming the site that triggers it and checking the
ladder's response.

**Sites** (:data:`SITES`): the JAX package's whole vocabulary, so that one
``SPFFT_TPU_FAULTS`` spec parses the same in both packages. The port threads
``engine.compile``, ``engine.execute``, ``exchange.build``, ``ir.lower``,
``ir.compile``, ``ir.batch``, ``sync.fence``, ``verify.check``,
``tuning.trial``, ``wisdom.load``, ``wisdom.save``, ``sched.place``,
``sched.run``, and the serving sites ``serve.admit``, ``serve.batch``,
``serve.dispatch``, ``host.heartbeat``, ``rpc.submit`` and ``hlo.stats``
(the compiled-program statistics of ``report(include_compiled=True)``).

**Kinds** (:data:`KINDS`): ``raise`` raises :class:`InjectedFault`;
``nan`` / ``corrupt`` poison the site's payload (tensors multiplied by NaN /
Inf, out of place on the tensor's own device; text truncated and mangled);
``delay`` sleeps ``SPFFT_TPU_FAULTS_DELAY_S`` seconds.

**Arming**: the ``SPFFT_TPU_FAULTS`` knob (``"site=kind[:rate],..."``,
parsed at import), or :func:`inject` / :func:`arm`. Rates below 1 draw from
one process-global ``random.Random`` seeded by ``SPFFT_TPU_FAULTS_SEED``
(:func:`reseed`). Disarmed, :func:`site` is one falsy-dict check. Every
injection that fires counts in ``faults_injected_total{site,kind}`` and
lands as a ``fault.injected`` flight-recorder event.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time

from .. import knobs, obs
from ..errors import InvalidParameterError

FAULTS_ENV = "SPFFT_TPU_FAULTS"
FAULTS_SEED_ENV = "SPFFT_TPU_FAULTS_SEED"
FAULTS_DELAY_ENV = "SPFFT_TPU_FAULTS_DELAY_S"

# The JAX package's site vocabulary (spfft_tpu/faults/plane.py SITES), the
# same literal.
SITES = (
    "tuning.trial",
    "wisdom.load",
    "wisdom.save",
    "engine.compile",
    "engine.execute",
    "ir.lower",
    "ir.compile",
    "ir.batch",
    "exchange.build",
    "hlo.stats",
    "sync.fence",
    "verify.check",
    "serve.admit",
    "serve.batch",
    "serve.dispatch",
    "sched.place",
    "sched.run",
    "host.heartbeat",
    "rpc.submit",
)

KINDS = ("raise", "nan", "corrupt", "delay")


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` fault site. A ``RuntimeError``, as the
    CUDA runtime's and PyTorch's failures are, so that the handlers that
    catch real faults catch injected ones."""


_lock = threading.Lock()
_armed: dict = {}  # site -> {"kind": str, "rate": float}
_rng = random.Random(knobs.get_int(FAULTS_SEED_ENV))


def parse_spec(spec: str) -> dict:
    """Parse a ``"site=kind[:rate],..."`` spec into ``{site: {"kind",
    "rate"}}``. Every malformed token raises :class:`InvalidParameterError`
    naming the token, and so does a site armed twice in one spec."""
    table: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, action = part.partition("=")
        name = name.strip()
        if not sep or not action.strip():
            raise InvalidParameterError(
                f"malformed fault spec token {part!r}: expected site=kind[:rate]"
            )
        kind, _, rate_s = action.strip().partition(":")
        if name not in SITES:
            raise InvalidParameterError(
                f"unknown fault site {name!r} in token {part!r}: expected one "
                f"of {SITES}"
            )
        if kind not in KINDS:
            raise InvalidParameterError(
                f"unknown fault kind {kind!r} in token {part!r}: expected one "
                f"of {KINDS}"
            )
        try:
            rate = float(rate_s) if rate_s else 1.0
        except ValueError as e:
            raise InvalidParameterError(
                f"malformed fault rate {rate_s!r} in token {part!r}"
            ) from e
        if not 0.0 <= rate <= 1.0:
            raise InvalidParameterError(
                f"fault rate must be in [0, 1] in token {part!r}, got {rate}"
            )
        if name in table:
            raise InvalidParameterError(
                f"duplicate fault site {name!r} in token {part!r}: an earlier "
                "token in the same spec already armed it"
            )
        table[name] = {"kind": kind, "rate": rate}
    return table


def arm(spec) -> None:
    """Arm sites from a spec string or a ``{site: {"kind", "rate"}}`` table
    (``rate`` defaults to 1.0), over what is already armed."""
    table = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    normalized = {}
    for name, fault in table.items():
        if name not in SITES:
            raise InvalidParameterError(
                f"unknown fault site {name!r}: expected one of {SITES}"
            )
        if fault.get("kind") not in KINDS:
            raise InvalidParameterError(
                f"unknown fault kind {fault.get('kind')!r}: expected one of {KINDS}"
            )
        rate = float(fault.get("rate", 1.0))
        if not 0.0 <= rate <= 1.0:
            raise InvalidParameterError(
                f"fault rate must be in [0, 1], got {rate}"
            )
        normalized[name] = {"kind": fault["kind"], "rate": rate}
    with _lock:
        _armed.update(normalized)


def disarm(site_name: str | None = None) -> None:
    """Disarm one site, or every site when ``site_name`` is None."""
    with _lock:
        if site_name is None:
            _armed.clear()
        else:
            _armed.pop(site_name, None)


def armed() -> dict:
    """A copy of the armed table."""
    with _lock:
        return {k: dict(v) for k, v in _armed.items()}


def reseed(seed: int | None = None) -> None:
    """Reseed the rate draws (default: ``SPFFT_TPU_FAULTS_SEED``)."""
    if seed is None:
        seed = knobs.get_int(FAULTS_SEED_ENV)
    with _lock:
        _rng.seed(int(seed))


@contextlib.contextmanager
def inject(spec):
    """Arm ``spec`` over the current table for the scope, and restore the
    table on exit, exception or not."""
    with _lock:
        saved = {k: dict(v) for k, v in _armed.items()}
    arm(spec)
    try:
        yield
    finally:
        with _lock:
            _armed.clear()
            _armed.update(saved)


def _poison(payload, value: float):
    """Every array leaf of ``payload`` (tensors and numpy arrays, in tuples,
    lists and dicts) multiplied by ``value``: a new array on the leaf's own
    device, so that no buffer that another holder reads (a CUDA graph's
    static output) is written. Other leaves pass through."""
    if isinstance(payload, (tuple, list)):
        return type(payload)(_poison(leaf, value) for leaf in payload)
    if isinstance(payload, dict):
        return {k: _poison(v, value) for k, v in payload.items()}
    if hasattr(payload, "dtype") and hasattr(payload, "shape"):
        return payload * value
    return payload


def _corrupt(payload):
    """Text and bytes truncated with garbage appended; arrays Inf-poisoned;
    anything else unchanged."""
    if isinstance(payload, str):
        return payload[: len(payload) // 2] + "\x00<injected corruption>"
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload[: len(payload) // 2]) + b"\x00<injected corruption>"
    return _poison(payload, float("inf"))


def site(name: str, payload=None):
    """Fault checkpoint ``name``; returns ``payload``, poisoned if a ``nan``
    or ``corrupt`` fault fired. Disarmed, one falsy-dict check. A poison kind
    at a site with no payload is a no-op and is not counted."""
    if not _armed:
        return payload
    fault = _armed.get(name)
    if fault is None:
        return payload
    rate = fault["rate"]
    if rate <= 0.0:
        return payload
    if rate < 1.0:
        with _lock:
            draw = _rng.random()
        if draw >= rate:
            return payload
    kind = fault["kind"]
    if payload is None and kind in ("nan", "corrupt"):
        return payload
    obs.counter("faults_injected_total", site=name, kind=kind).inc()
    obs.trace.event("fault.injected", site=name, kind=kind)
    if kind == "raise":
        raise InjectedFault(f"injected fault at site {name!r}")
    if kind == "delay":
        time.sleep(knobs.get_float(FAULTS_DELAY_ENV))
        return payload
    if kind == "nan":
        return _poison(payload, float("nan"))
    return _corrupt(payload)


# Arming from the environment at import: a whole test suite or program runs
# under injection with no change to its code.
_env_spec = knobs.get_str(FAULTS_ENV)
if _env_spec:
    arm(_env_spec)
del _env_spec
