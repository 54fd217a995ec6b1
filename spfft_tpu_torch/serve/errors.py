"""Typed serving-layer failure surface: vocabularies and conversion helpers.

The port of ``spfft_tpu/serve/errors.py``. Every admission refusal, shed,
deadline miss and execution failure of the serving layer resolves as a member
of the :mod:`spfft_tpu_torch.errors` taxonomy, tagged with a reason from the
vocabularies below, counted in the metrics and stamped into the flight
recorder: *every accepted request either completes or fails typed*.
"""
from __future__ import annotations

from ..errors import (  # noqa: F401  (the serving layer's error surface)
    DeadlineExceededError,
    GenericError,
    ServiceOverloadError,
)
from ..faults import execution_error, summarize

# Terminal outcomes of a submitted request (the ``outcome`` label of
# ``serve_requests_total{tenant,outcome}``). ``rejected`` happens at admission
# (the caller's submit raises); the others resolve admitted tickets.
OUTCOMES = ("completed", "rejected", "shed", "deadline_miss", "failed")

# Why a request was refused or shed (the ``reason`` label of
# ``serve_sheds_total{reason}``):
#   queue_full    the bounded queue is at capacity, no sheddable peer
#   tenant_quota  the tenant is over its per-tenant queue quota
#   fair_share    a queued request of an over-share tenant was evicted to
#                 admit an under-share tenant
#   deadline      the request expired while queued
#   breaker_open  the engine's circuit breaker is open and the service sheds
#   plan_evicted  the request's plan-cache entry was evicted while it queued
#   closing       the service is shutting down
SHED_REASONS = (
    "queue_full",
    "tenant_quota",
    "fair_share",
    "deadline",
    "breaker_open",
    "plan_evicted",
    "closing",
)


def as_typed(exc: BaseException, platform: str) -> GenericError:
    """Any execution failure as the typed surface: taxonomy members pass
    through, anything else becomes the platform's execution error
    (``HostExecutionError`` for ``"cpu"``, ``GPUFFTError`` on the card) with
    the original as ``__cause__``: the rule of
    :func:`spfft_tpu_torch.faults.typed_execution`, for failures held as
    values (ticket resolution)."""
    if isinstance(exc, GenericError):
        return exc
    err = execution_error(platform)(f"serving execution failed: {summarize(exc)}")
    err.__cause__ = exc
    return err
