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

A mesh plan over a process group runs the ladder on every process in step.
Each attempt's checks hold one all-reduce (:func:`.checks.run_checks` with
:class:`~.checks.Shards`), which every process reaches whatever its own
attempt did, and which carries a flag for a failed attempt or detector: so
every process sees the same verdicts and takes the same next rung. The
plan's breaker entry is its engine's and its group's
(:func:`.breaker.group_key`), which only such verdicts move, so it is in the
same state on every process; one that is not closed asks the group once
more, before the attempt, whether every process admits it (their cooldowns'
clocks differ).
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

# Failures of the detector itself (checks.CHECKER_ERRORS): an unverifiable
# result is a failed episode.
CHECKER_ERRORS = checks.CHECKER_ERRORS


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
        # a mesh plan over a process group: this process's part (checks.Shards)
        shards = getattr(transform, "_check_shards", None)
        self._shards = shards() if shards is not None else None

    # ---- plan-facing entry points ------------------------------------------

    def backward(self, values):
        """Supervised backward: ``values`` (packed, or a per-shard list) ->
        the verified ``(Z, Y, X)`` space tensor (across processes, this
        process's blocks)."""
        t = self._t
        freq = flat_values(values) if self._shards is None else t._local_values(values)
        return self._supervise(
            direction="backward",
            attempt=lambda: t._backward_attempt(values),
            reference=lambda: t._reference_backward(values),
            check=lambda result, failure: self._run_checks(
                "backward", freq=freq, space=result, scale=1.0, failure=failure
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
        local = self._shards is not None
        return self._supervise(
            direction="forward",
            attempt=lambda: t._forward_attempt(space if space is None else space_dev, scaling),
            reference=lambda: t._reference_forward(space_dev, scaling),
            check=lambda result, failure: self._run_checks(
                "forward",
                freq=(None if result is None else
                      t._local_values(result) if local else flat_values(result)),
                space=space_dev,
                scale=scale,
                failure=failure,
            ),
        )

    # ---- the ladder ---------------------------------------------------------

    def _verified(self, produce, check, errors=RETRYABLE_ERRORS):
        """One rung: ``produce`` a result (a failure among ``errors`` is
        the rung's) and check it; returns ``(result, None)`` on a pass,
        else ``(None, reason)``. Over a process group every process reaches
        the checks' all-reduce, its own failure carried in it, so all of
        them return a pass or all a reason."""
        result, failure = None, None
        try:
            result = produce()
        except errors as e:
            failure = ("execution", faults.summarize(e))
            if self._shards is None:
                return None, f"execution: {failure[1]}"
        try:
            verdicts = check(result, failure)
        except CHECKER_ERRORS as e:
            return None, f"checker: {faults.summarize(e)}"
        failed = [v for v in verdicts if v["verdict"] != "pass"]
        if not failed:
            return result, None
        return None, "; ".join(
            f"{v['check']} rel={v['rel']:.3g} > rtol={v['rtol']:.3g}" for v in failed)

    def _breaker_key(self) -> str:
        """The plan's breaker entry: its engine's, over a process group its
        engine's and group's."""
        engine = self._t._engine
        if self._shards is None:
            return engine
        return breaker.group_key(engine, self._shards.group)

    def _admitted(self, key: str) -> bool:
        """The breaker's admission (:func:`.breaker.allow`) of entry
        ``key``. Over a process group the entry is in the same state on
        every process, but an open one's cooldown may end at different
        times, so the group admits the engine only if every process would,
        in one all-reduce, and then every process takes the admission."""
        if self._shards is None or breaker.state(key) == "closed":
            return breaker.allow(key)
        import torch.distributed as dist

        if checks.group_scalar(breaker.would_allow(key), self._shards.group,
                               self._shards.device, dist.ReduceOp.MIN) < 1:
            return False
        breaker.allow(key)
        return True

    def _supervise(self, *, direction, attempt, reference, check):
        t = self._t
        engine = t._engine
        key = self._breaker_key()
        strict = self.mode == "strict"
        failures: list = []
        # strict attempts the primary engine whatever the breaker says (and
        # still feeds it)
        if strict or self._admitted(key):
            budget = 1 if strict else 1 + self.retries
            backoff = resolve_backoff_s()
            for i in range(budget):
                if i:
                    obs.counter("verify_retries_total", direction=direction).inc()
                    obs.trace.event(
                        "verify", what="retry", direction=direction, attempt=i
                    )
                    time.sleep(faults.backoff_s(backoff, i, self._jitter))
                result, bad = self._verified(attempt, check)
                if bad is None:
                    breaker.record_success(key)
                    return result
                failures.append(bad)
                if strict:
                    obs.counter("verify_failures_total", direction=direction).inc()
                    breaker.record_failure(key)
                    raise VerificationError(
                        f"strict verification failed on {direction}: {bad}"
                    )
            breaker.record_failure(key)
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
        result, bad = self._verified(reference, check,
                                     RETRYABLE_ERRORS + CHECKER_ERRORS)
        if bad is not None:
            obs.counter("verify_failures_total", direction=direction).inc()
            raise VerificationError(
                f"{direction} failed verification on engine {engine!r} and the "
                f"torch.fft reference rung could not verify either ({bad}); "
                f"attempts: {failures or [reason]}"
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

    def _run_checks(self, direction, *, freq, space, scale, failure):
        if self._shards is not None and space is not None:
            space = self._t._local_blocks(space)
        return checks.run_checks(
            direction=direction,
            freq=freq,
            space=space,
            triplets=self.geometry(),
            transform_type=self._t.transform_type,
            scale=scale,
            rtol=self.rtol,
            shards=self._shards,
            failure=failure,
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
            "breaker": breaker.describe(self._breaker_key()),
        }
