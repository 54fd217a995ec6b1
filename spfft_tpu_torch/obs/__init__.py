"""spfft_tpu_torch.obs: run metrics, plan cards, execution tracing and
performance reports, the port of ``spfft_tpu/obs/``.

The layers, coarse to fine, as in the JAX package:

1. **Host timing tree** (:mod:`spfft_tpu_torch.timing`): rt_graph statistics
   of the host-visible phases (init, staging, dispatch, wait).
2. **Plan cards** (:func:`plan_card`, ``plan.report()``): the JSON record of
   every plan-time decision, schema ``spfft_tpu.obs.plan_card/1``; and **run
   metrics**: a process-global counter/gauge/histogram registry
   (:func:`counter`/:func:`gauge`/:func:`histogram`/:func:`phase_timer`),
   exported by :func:`snapshot` and :func:`prometheus_text`.
   ``SPFFT_TPU_METRICS=0`` turns the registry into one shared no-op.
3. **Execution trace** (:mod:`.trace`): run-ID-stamped spans and events in a
   bounded flight recorder (``SPFFT_TPU_TRACE``).
4. **Device traces**: ``torch.profiler`` over the staged path, whose nodes
   run under the :data:`STAGES` names (``timing.trace_annotation``).
5. **Performance reports** (:mod:`.perf`): fenced seconds per pair
   attributed to :data:`STAGES` by an analytic flop/byte model.

6. **Fleet aggregation** (:mod:`.fleet`): every serving host's snapshot
   merged into one host-labeled document (``spfft_tpu.obs.fleet/1``).

7. **Compiled-program statistics** (:mod:`.hlo`, ``report(include_compiled=True)``):
   the backward program's op classes from a dispatch record, its
   element-granular gathers and scatters, and on the card a fresh capture
   of its CUDA graph with the graph's nodes by kind and kernel.
"""
from . import fleet, hlo, perf, trace  # noqa: F401
from .registry import (  # noqa: F401
    HISTOGRAM_BUCKETS,
    METRICS_ENV,
    SNAPSHOT_SCHEMA,
    clear,
    counter,
    disable,
    enable,
    gauge,
    histogram,
    is_enabled,
    phase_timer,
    prometheus_text,
    snapshot,
    validate_snapshot,
)
from .stages import STAGES  # noqa: F401


def plan_card(transform, *, include_compiled: bool = False) -> dict:
    """Structured record of a plan's decisions (see :mod:`.plancard`)."""
    from .plancard import plan_card as _plan_card

    return _plan_card(transform, include_compiled=include_compiled)


def validate_plan_card(card: dict) -> list:
    """Missing-key paths of a plan card ([] when schema-complete)."""
    from .plancard import validate_plan_card as _validate

    return _validate(card)


def validate_report(report: dict) -> list:
    """Validate a ``programs/report.py`` JSON document: a ``plan`` card plus
    a ``metrics`` snapshot. Returns the combined missing-key paths."""
    missing = []
    if "plan" not in report:
        missing.append("plan")
    else:
        missing.extend(f"plan.{m}" for m in validate_plan_card(report["plan"]))
    if "metrics" not in report:
        missing.append("metrics")
    else:
        missing.extend(f"metrics.{m}" for m in validate_snapshot(report["metrics"]))
    return missing
