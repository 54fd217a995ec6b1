"""Trials: each candidate built as the real plan and timed on its device.

The port of ``spfft_tpu/tuning/runner.py``. A trial builds a whole transform
for one candidate (the caller's geometry, mesh, dtype and precision, with
the model policy, so tuning cannot recurse), stages random inputs of the
plan's exact shape on the plan's device, runs ``SPFFT_TPU_TUNE_WARMUP``
untimed round trips (the first captures a fused plan's CUDA graphs), then
``SPFFT_TPU_TUNE_REPEATS`` timed backward + forward(FULL) round trips, each
ended by the completion fence (:func:`spfft_tpu_torch.sync.fence`); the best
counts. A CPU plan runs no trials unless ``SPFFT_TPU_TUNE_CPU=1``: CPU
timings must never answer for the card, so the tuned policy takes the model
there.

A candidate that fails (the classes of :data:`TRIAL_ERRORS`, a deadline, or
a build or first call that took a degradation rung) becomes an ``error`` row
and sorts last. The kernels' own failures (:data:`KERNEL_ERRORS`: a K1 or K2
that does not build, load or launch) are no trial result: they raise out of
the trials, and nothing is persisted, as they raise out of any plan; ``tuning_trials_total`` / ``tuning_trial_failures_total``
count per candidate and ``tuning_trial_seconds`` times each timed repeat.
Each trial is a ``tune.trial`` operation of the flight recorder, its round
trips under the ``tune warmup`` / ``tune trial`` profiler ranges.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import faults, knobs, obs, timing
from ..errors import GenericError, GPULaunchError, GPUSupportError
from ..sync import FENCE_BUDGET_ENV, fence

TUNE_REPEATS_ENV = "SPFFT_TPU_TUNE_REPEATS"
TUNE_WARMUP_ENV = "SPFFT_TPU_TUNE_WARMUP"
TUNE_CPU_ENV = "SPFFT_TPU_TUNE_CPU"

# What a trial may swallow into an error row: the typed errors, runtime
# failures (CUDA's and PyTorch's, the injected ones, a CUDA out-of-memory),
# missing paths, host memory and I/O. A programming error propagates.
TRIAL_ERRORS = (GenericError, RuntimeError, NotImplementedError, ValueError, MemoryError,
                OSError)
# What a trial never swallows: a kernel that did not build, load or launch.
# As an error row it would leave the library path to win, and the wisdom
# would keep that choice for every later plan.
KERNEL_ERRORS = (GPUSupportError, GPULaunchError)


class TrialTimeout(RuntimeError):
    """A trial ran past its deadline (:func:`trial_deadline_s`): a member of
    :data:`TRIAL_ERRORS`, so a hung candidate becomes an error row."""


class TrialDegradedError(RuntimeError):
    """A trial plan took a degradation rung (an engine fallback, a staged
    fallback of its fused program, ...): its time would measure the rung,
    not the candidate, so the candidate becomes an error row instead."""


def trial_budget() -> tuple:
    """``(warmup, repeats)`` per candidate (floors 0 and 1)."""
    return knobs.get_int(TUNE_WARMUP_ENV), knobs.get_int(TUNE_REPEATS_ENV)


def trial_deadline_s() -> float:
    """The wall-clock budget of one whole trial: ``SPFFT_TPU_FENCE_BUDGET_S
    x (warmup + repeats + 1)``; 0 (the budget unset) is no deadline."""
    budget = knobs.get_float(FENCE_BUDGET_ENV)
    if budget <= 0:
        return 0.0
    warmup, repeats = trial_budget()
    return budget * (warmup + repeats + 1)


def _run_deadlined(fn, budget_s: float, label: str):
    """``fn()`` under a wall-clock deadline, in a worker thread that keeps
    the caller's run ID and dump suppression; past the deadline
    :class:`TrialTimeout` raises and the worker stays parked (a daemon)."""
    if budget_s <= 0:
        return fn()
    done = threading.Event()
    result, err = [], []
    run = obs.trace.current_run_id()

    def work():
        try:
            with obs.trace.with_run(run), obs.trace.suppressed_dumps():
                result.append(fn())
        except BaseException as e:  # re-raised in the caller's thread
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=work, daemon=True).start()
    if not done.wait(budget_s):
        raise TrialTimeout(
            f"tuning trial {label!r} exceeded its {budget_s:.3g}s deadline "
            f"({FENCE_BUDGET_ENV} x (warmup + repeats + 1)); candidate recorded as "
            "an error row, planning falls back")
    if err:
        raise err[0]
    return result[0]


def trials_allowed(platform: str) -> bool:
    """Whether trials may run for a plan on ``platform`` (``"gpu"`` or
    ``"cpu"``): always on the card, on the CPU only with ``SPFFT_TPU_TUNE_CPU=1``."""
    return platform != "cpu" or knobs.get_bool(TUNE_CPU_ENV)


def _stage_inputs(transform):
    """Random values of the plan's exact shape (seeded), staged on the plan's
    device: the ``(re, im)`` pair that ``backward_pair`` takes (stacked per
    shard on a mesh). Trials time the device pipeline, not host staging."""
    from ..execution import as_pair

    rng = np.random.default_rng(0)
    if getattr(transform, "_mesh", None) is not None:
        vps = [rng.standard_normal(transform.num_local_elements(r))
               + 1j * rng.standard_normal(transform.num_local_elements(r))
               for r in range(transform.num_shards)]
        return transform._exec.pad_values(vps)
    n = transform.num_local_elements
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return transform._exec.put_pair(as_pair(values, transform.dtype))


def _stage_batch_inputs(transform, batch: int):
    """The plan's exact-shape trial inputs stacked ``batch`` times along the
    batch axis, staged on the plan's device (local plans: the batch axis the
    serving layer tunes is a local-plan surface)."""
    re, im = _stage_inputs(transform)
    batch = max(1, int(batch))
    return torch.stack([re] * batch), torch.stack([im] * batch)


def _roundtrip(transform, staged):
    """One backward + forward(FULL) over staged inputs, fenced."""
    from ..types import ScalingType

    transform.backward_pair(*staged)
    out = transform.forward_pair(ScalingType.FULL)
    fence(out, transform.device)
    return out


def _check_rungs(transform) -> None:
    """:class:`TrialDegradedError` if the trial plan took a rung."""
    rungs = [d["event"] for d in getattr(transform, "_degradations", ())]
    if rungs:
        raise TrialDegradedError(
            f"trial plan took the {rungs[0]} rung: its time would not measure the candidate")


def _best_of(roundtrip) -> float:
    """``SPFFT_TPU_TUNE_WARMUP`` untimed calls, then the least of
    ``SPFFT_TPU_TUNE_REPEATS`` timed ones, in seconds."""
    warmup, repeats = trial_budget()
    with timing.trace_annotation("tune warmup"):
        for _ in range(warmup):
            roundtrip()
    best = float("inf")
    for _ in range(repeats):
        with timing.trace_annotation("tune trial"), obs.phase_timer("tuning_trial_seconds"):
            t0 = time.perf_counter()
            roundtrip()
            best = min(best, time.perf_counter() - t0)
    return best


def measure_candidate(transform) -> float:
    """The best seconds per backward + forward pair of a built trial plan."""
    staged = _stage_inputs(transform)
    best = _best_of(lambda: _roundtrip(transform, staged))
    _check_rungs(transform)  # a fused program's first call may have degraded
    return best


def _trials(candidates: list, trial) -> list:
    """``trial(candidate)`` seconds for each candidate, isolated: the rows,
    measured ones fastest first, then the error rows. The fault site
    ``tuning.trial`` fires inside each trial's scope."""
    rows, failed = [], []
    for cand in candidates:
        try:
            with obs.trace.operation("tune.trial", label=cand["label"]), \
                    obs.trace.suppressed_dumps():
                def run(cand=cand):
                    faults.site("tuning.trial")
                    return trial(cand)

                seconds = _run_deadlined(run, trial_deadline_s(), cand["label"])
        except KERNEL_ERRORS:
            raise
        except TRIAL_ERRORS as e:
            obs.counter("tuning_trial_failures_total", candidate=cand["label"]).inc()
            failed.append(dict(cand, error=faults.summarize(e)))
            continue
        obs.counter("tuning_trials_total", candidate=cand["label"]).inc()
        rows.append(dict(cand, ms=round(seconds * 1e3, 4)))
    return sorted(rows, key=lambda r: r["ms"]) + failed


def run_trials(build, candidates: list) -> list:
    """Measure every candidate: ``build(candidate)`` makes the trial plan
    (the caller's constructor, with the model policy). A plan whose build
    took a rung raises :class:`TrialDegradedError` before it is timed."""
    def trial(cand):
        plan = build(cand)
        _check_rungs(plan)
        return measure_candidate(plan)

    return _trials(candidates, trial)


def measure_batch_seconds(transform, batch: int) -> float:
    """The best seconds per TRANSFORM (wall / B) through the batched
    programs: one stacked backward + forward(FULL) a round trip. A batch
    path that is unavailable, or takes its rung, raises
    :class:`TrialDegradedError` (the loop must not time as ``fused/bN``)."""
    from ..types import ScalingType

    batch = max(1, int(batch))
    re, im = _stage_batch_inputs(transform, batch)
    ex = transform._exec

    def roundtrip():
        out = ex.backward_pair_batch(re, im)
        if out is None:
            raise TrialDegradedError("batch-fused path unavailable: timing would measure "
                                     "the per-request loop, not the fused/bN candidate")
        space_re, space_im = (out, None) if transform._is_r2c else out
        pair = ex.forward_pair_batch(space_re, space_im, ScalingType.FULL)
        if pair is None:
            raise TrialDegradedError("batch-fused forward unavailable mid-trial")
        fence(pair, transform.device)

    return _best_of(roundtrip) / batch


def run_batch_trials(transform, candidates: list) -> list:
    """Measure the ``fused/bN`` candidates on the plan's own batched
    programs (the plan is the trial vehicle), isolated as :func:`run_trials`."""
    return _trials(candidates, lambda cand: measure_batch_seconds(transform, cand["batch"]))
