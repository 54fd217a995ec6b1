"""The degradation ladder: record fallbacks, turn failures into typed errors.

The port of ``spfft_tpu/faults/ladder.py``. The rungs the port takes:

1. **Engine fallback**: an ``mxu`` engine that fails to build (fault site
   ``engine.compile``) falls back to the ``torch.fft`` engine
   (:func:`engine_fallback`, ``engine_fallbacks_total``). The kernels' own
   failures (:class:`~spfft_tpu_torch.errors.GPUSupportError`,
   :class:`~spfft_tpu_torch.errors.GPULaunchError`) are typed and pass
   through it: a kernel that does not build is an error, not a rung.
2. **The IR's rungs** (:mod:`spfft_tpu_torch.ir.compile`):
   ``ir_lower_failed``, ``fuse_compile_failed``, ``batch_fuse_failed``.
3. **Typed execution errors**: dispatch and fence failures raise
   :class:`~spfft_tpu_torch.errors.HostExecutionError` or
   :class:`~spfft_tpu_torch.errors.GPUFFTError` (:func:`typed_execution`).

4. **Tuning and scheduling**: ``wisdom_load_failed``,
   ``wisdom_save_failed``, ``wisdom_quarantined``
   (:mod:`spfft_tpu_torch.tuning.wisdom`), ``sched_place_failed`` and
   ``host_lost`` (:mod:`spfft_tpu_torch.sched`).

5. **Compiled-program statistics**: ``hlo_stats_unavailable``
   (:mod:`spfft_tpu_torch.obs.plancard`, fault site ``hlo.stats``): the card
   without its ``compiled`` section.

Every rung lands in the plan's ``degradations`` list (the plan card; the
card's own copy for ``hlo_stats_unavailable``) and counts
``degradations_total{event}``.
"""
from __future__ import annotations

import contextlib
import threading

from .. import obs
from ..errors import GenericError
from .guard import execution_error
from .plane import InjectedFault

# What the ladder may degrade: injected faults, runtime failures (CUDA's and
# PyTorch's are RuntimeErrors) and unimplemented paths. Not the typed
# spfft_tpu_torch.errors (they surface), not programming errors.
ENGINE_BUILD_ERRORS = (InjectedFault, RuntimeError, NotImplementedError)

_tls = threading.local()


def backoff_s(base: float, attempt: int, rng=None) -> float:
    """Backoff before re-attempt ``attempt`` (1-based): ``base *
    2**(attempt-1)``, times a uniform draw in [0.5, 1.5) when ``rng`` (a
    ``random.Random``) is given, so that callers that failed together do not
    retry together."""
    delay = float(base) * (2.0 ** (max(1, int(attempt)) - 1))
    if rng is not None:
        delay *= 0.5 + rng.random()
    return delay


def summarize(exc: BaseException, limit: int = 200) -> str:
    """``"Type: first message line"`` of an exception."""
    first = str(exc).splitlines()[0] if str(exc) else ""
    return f"{type(exc).__name__}: {first}"[:limit]


@contextlib.contextmanager
def collecting(sink: list):
    """Route :func:`record_degradation` entries into ``sink`` for the scope
    (a plan's ``degradations`` list while it is built)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.pop()


def current_sink():
    """The innermost :func:`collecting` sink, or None: a component built in
    a plan's scope keeps it, to record a rung it takes later (the IR's
    first-dispatch ``fuse_compile_failed``)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def record_degradation(event: str, reason: str, **extra) -> dict:
    """Count ``degradations_total{event}``, emit a ``degradation`` event and
    append ``{"event", "reason", **extra}`` to the innermost sink; returns
    the entry."""
    entry = {"event": str(event), "reason": str(reason), **extra}
    obs.counter("degradations_total", event=str(event)).inc()
    obs.trace.event("degradation", event=str(event), reason=str(reason))
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].append(entry)
    return entry


def engine_fallback(from_engine: str, to_engine: str, reason: str) -> dict:
    """Rung 1: ``from_engine`` failed to build and ``to_engine`` runs
    (``engine_fallbacks_total`` and a ``degradations`` entry)."""
    obs.counter(
        "engine_fallbacks_total",
        **{"from": str(from_engine), "to": str(to_engine)},
    ).inc()
    return record_degradation(
        "engine_fallback",
        reason,
        **{"from": str(from_engine), "to": str(to_engine)},
    )


@contextlib.contextmanager
def typed_execution(platform: str, op: str):
    """Turn a runtime failure in the scope into the platform's typed error
    (:func:`~.guard.execution_error`), the original as ``__cause__``, and
    count ``execution_failures_total{op}``. Typed errors pass untouched."""
    try:
        yield
    except GenericError:
        raise
    except ENGINE_BUILD_ERRORS + (FloatingPointError,) as e:
        obs.counter("execution_failures_total", op=str(op)).inc()
        raise execution_error(platform)(f"{op} failed: {e}") from e
