"""Recovery supervisor: detection turned into bounded, observable recovery.

The port of ``spfft_tpu/verify/supervisor.py``, the same ladder around a
plan's host-facing ``backward``/``forward`` (the whole attempt: dispatch,
fence, output staging, guard checks), each rung recorded in the plan's
``degradations``, the metrics and the flight recorder:

1. **Verify**: the checks (:mod:`.checks`) on the attempt's result; all
   pass -> return it (and close the engine's breaker).
2. **Retry**: on a failed check, a detector fault or a typed execution
   error, up to ``SPFFT_TPU_VERIFY_RETRIES`` more attempts with jittered
   exponential backoff (``SPFFT_TPU_VERIFY_BACKOFF_S``).
3. **Demote**: recompute through the reference rung, a freshly built
   ``torch.fft`` engine (:class:`~spfft_tpu_torch.execution.LocalExecution`,
   cuFFT on the card) on the plan's own device, and verify that; a verified
   result returns (``verify_recoveries_total``, a ``verify_demoted`` rung).
4. **Raise**: :class:`~spfft_tpu_torch.errors.VerificationError`.

``strict`` mode raises at the first failed check, with no retry, demotion
or breaker short-circuit (it still feeds the breaker). The breaker
(:mod:`.breaker`) sits above rung 2: an open engine skips the attempt (a
``verify_breaker_open`` rung).

Unlike the JAX package, :meth:`Supervisor.forward` does not fetch the space
grid to the host: it keeps it on the plan's device for the checks, the
retries and the reference rung.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import faults, knobs, obs
from ..errors import (
    FFTWError,
    GPUFFTError,
    HostExecutionError,
    MPIError,
    VerificationError,
)
from . import breaker, checks

VERIFY_RETRIES_ENV = "SPFFT_TPU_VERIFY_RETRIES"
VERIFY_BACKOFF_ENV = "SPFFT_TPU_VERIFY_BACKOFF_S"
VERIFY_JITTER_SEED_ENV = "SPFFT_TPU_VERIFY_JITTER_SEED"

DEFAULT_RETRIES = knobs.default(VERIFY_RETRIES_ENV)
DEFAULT_BACKOFF_S = knobs.default(VERIFY_BACKOFF_ENV)

# Typed execution failures the retry rung absorbs; parameter errors surface.
RETRYABLE_ERRORS = (HostExecutionError, GPUFFTError, MPIError, FFTWError)

# Failures of the detector itself (the verify.check site raises
# InjectedFault, a RuntimeError): an unverifiable result is a failed episode.
CHECKER_ERRORS = (RuntimeError,)


def resolve_retries() -> int:
    """Re-executions after the first attempt (``SPFFT_TPU_VERIFY_RETRIES``)."""
    return knobs.get_int(VERIFY_RETRIES_ENV)


def resolve_backoff_s() -> float:
    """Base of the retry backoff (``SPFFT_TPU_VERIFY_BACKOFF_S``)."""
    return knobs.get_float(VERIFY_BACKOFF_ENV)


def jitter_rng() -> random.Random:
    """The backoff's jitter stream: seeded by ``SPFFT_TPU_VERIFY_JITTER_SEED``
    when set, else from system entropy."""
    seed = knobs.get_int(VERIFY_JITTER_SEED_ENV)
    return random.Random(seed) if seed is not None else random.Random()


def flat_values(values):
    """The packed values as one vector in triplet order: a per-shard list
    concatenates in shard order (on the card if one of them is there)."""
    if isinstance(values, (list, tuple)):
        parts = [v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)) for v in values]
        device = next((p.device for p in parts if p.is_cuda), parts[0].device)
        return torch.cat([p.reshape(-1).to(device) for p in parts])
    return values if torch.is_tensor(values) else torch.as_tensor(np.asarray(values))


class Supervisor:
    """Per-plan recovery supervisor, made only when verification is armed.

    The plan provides ``_backward_attempt`` / ``_forward_attempt`` (its whole
    path, fault sites included), ``_reference_backward`` /
    ``_reference_forward`` (the ``torch.fft`` rung), ``_verify_triplets``,
    ``_device_space`` and ``_retain_space``; the supervisor owns the policy."""

    def __init__(self, transform, mode: str):
        self._t = transform
        self.mode = mode
        self.rtol = checks.resolve_rtol(transform.dtype)
        self.retries = resolve_retries()
        self._jitter = jitter_rng()
        self._geometry = None  # lazy: the plan-constant check geometry

    # ---- plan-facing entry points ------------------------------------------

    def backward(self, values):
        """Supervised backward: ``values`` (packed, or a per-shard list) ->
        the verified ``(Z, Y, X)`` space tensor."""
        freq = flat_values(values)
        return self._supervise(
            direction="backward",
            attempt=lambda: self._t._backward_attempt(values),
            reference=lambda: self._t._reference_backward(values),
            check=lambda result: self._run_checks(
                "backward", freq=freq, space=result, scale=1.0
            ),
        )

    def forward(self, space, scaling):
        """Supervised forward: a space (or None, the retained one) -> the
        verified packed values (a per-shard list on a distributed plan). The
        space stays on the plan's device for the checks and the rungs."""
        from ..types import ScalingType

        t = self._t
        space_dev = t._device_space(space)
        scale = (
            1.0 / float(t.global_size)
            if ScalingType(scaling) == ScalingType.FULL
            else 1.0
        )
        return self._supervise(
            direction="forward",
            attempt=lambda: t._forward_attempt(space if space is None else space_dev, scaling),
            reference=lambda: t._reference_forward(space_dev, scaling),
            check=lambda result: self._run_checks(
                "forward",
                freq=flat_values(result),
                space=space_dev,
                scale=scale,
            ),
        )

    # ---- the ladder ---------------------------------------------------------

    def _supervise(self, *, direction, attempt, reference, check):
        t = self._t
        engine = t._engine
        strict = self.mode == "strict"
        failures: list = []
        # strict attempts the primary engine whatever the breaker says (and
        # still feeds it)
        if strict or breaker.allow(engine):
            budget = 1 if strict else 1 + self.retries
            backoff = resolve_backoff_s()
            for i in range(budget):
                if i:
                    obs.counter("verify_retries_total", direction=direction).inc()
                    obs.trace.event(
                        "verify", what="retry", direction=direction, attempt=i
                    )
                    time.sleep(faults.backoff_s(backoff, i, self._jitter))
                bad = None
                try:
                    result = attempt()
                except RETRYABLE_ERRORS as e:
                    bad = f"execution: {faults.summarize(e)}"
                if bad is None:
                    try:
                        verdicts = check(result)
                    except CHECKER_ERRORS as e:
                        bad = f"checker: {faults.summarize(e)}"
                    else:
                        failed = [v for v in verdicts if v["verdict"] != "pass"]
                        if not failed:
                            breaker.record_success(engine)
                            return result
                        bad = "; ".join(
                            f"{v['check']} rel={v['rel']:.3g} > rtol={v['rtol']:.3g}"
                            for v in failed
                        )
                failures.append(bad)
                if strict:
                    obs.counter("verify_failures_total", direction=direction).inc()
                    breaker.record_failure(engine)
                    raise VerificationError(
                        f"strict verification failed on {direction}: {bad}"
                    )
            breaker.record_failure(engine)
            reason = failures[-1]
        else:
            reason = f"engine {engine!r} circuit breaker open"
            with faults.collecting(t._degradations):
                faults.record_degradation(
                    "verify_breaker_open",
                    reason,
                    engine=engine,
                    direction=direction,
                )
        # rung 3: the torch.fft reference engine, itself verified
        obs.trace.event("verify", what="demote", direction=direction, engine=engine)
        try:
            result = reference()
            verdicts = check(result)
        except CHECKER_ERRORS + RETRYABLE_ERRORS as e:
            obs.counter("verify_failures_total", direction=direction).inc()
            raise VerificationError(
                f"{direction} failed verification and the reference rung could "
                f"not verify either ({faults.summarize(e)}); attempts: "
                f"{failures or [reason]}"
            ) from e
        failed = [v for v in verdicts if v["verdict"] != "pass"]
        if failed:
            obs.counter("verify_failures_total", direction=direction).inc()
            raise VerificationError(
                f"{direction} failed verification on engine {engine!r} AND on "
                f"the torch.fft reference: "
                + "; ".join(f"{v['check']} rel={v['rel']:.3g}" for v in failed)
            )
        obs.counter("verify_recoveries_total", direction=direction).inc()
        with faults.collecting(t._degradations):
            faults.record_degradation(
                "verify_demoted",
                f"recovered via torch.fft reference after: {reason}",
                engine=engine,
                direction=direction,
            )
        if direction == "backward":
            # the retained space holds the primary engine's failed result: a
            # later forward(space=None) reads the verified recovery instead
            t._retain_space(result)
        return result

    # ---- helpers ------------------------------------------------------------

    def _run_checks(self, direction, *, freq, space, scale):
        return checks.run_checks(
            direction=direction,
            freq=freq,
            space=space,
            triplets=self.geometry(),
            transform_type=self._t.transform_type,
            scale=scale,
            rtol=self.rtol,
        )

    def geometry(self) -> checks.Geometry:
        """The plan's check geometry (storage-order rows aligned with the
        packed order, concatenated over the shards); plan-constant, cached."""
        if self._geometry is None:
            self._geometry = checks.Geometry(self._t._verify_triplets())
        return self._geometry

    def describe(self) -> dict:
        """The plan card's ``verification`` section."""
        return {
            "mode": self.mode,
            "checks": sorted(
                set(
                    checks.applicable_checks("backward", self._t.transform_type)
                )
                | set(checks.applicable_checks("forward", self._t.transform_type))
            ),
            "rtol": float(self.rtol),
            "retries": int(self.retries),
            "breaker": breaker.describe(self._t._engine),
        }
