"""Nested host-side timing tree: the reference's embedded ``rt_graph``
profiler (reference: src/timing/rt_graph.hpp:44-95) and its ``HOST_TIMING_*``
macros (reference: src/timing/timing.hpp:34-62), as the JAX package's
``spfft_tpu/timing.py`` has them.

The tree times the host-visible phases of a plan ("Execution init",
"backward", "forward", and under them "input staging", "dispatch", "wait",
"output staging"; "multi backward"/"multi forward" with "dispatch all" and
"finalize all"). A fused direction is one CUDA-graph replay, so its stages are
invisible to host timers: per-stage device time comes from ``torch.profiler``,
under the :func:`trace_annotation` ranges that the staged path opens around
each node. Every scope sits outside any captured CUDA graph, so its counts
are per call.

The pair path (``backward_pair``/``forward_pair``) has the same
"backward"/"forward", "input staging" and "dispatch" scopes, and on the card
the IR runtime's "copy in" (the caller's tensors into the CUDA graph's static
inputs), "replay" (``graph.replay()``) and "copy out" (the clone of the
static outputs) inside its "dispatch".

One scope feeds three sinks, each with its own run-time gate: the timing
tree (:func:`enable`/:func:`disable`), the flight recorder's ``phase`` spans
(:mod:`spfft_tpu_torch.obs.trace`, when armed) and, while a
``torch.profiler`` runs, a ``record_function`` range named
``RANGE_PREFIX + label`` (``spfft:dispatch``) on the profiler's timeline,
on the same clock as the device's activities. With all three off (the
default), :func:`scoped` hands out one shared no-op context manager.

The processed tree reports rt_graph's statistics: count, total, mean, median,
quartiles, min, max, percentage of the top-level total and of the parent
(reference: src/timing/rt_graph.hpp:44-56), printable or as the JSON that the
benchmark program embeds (reference: tests/programs/benchmark.cpp:283-289).
"""
from __future__ import annotations

import json as _json
import time

from .errors import InvalidParameterError
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from .obs import trace

# the prefix of the profiler ranges that :func:`scoped`, :func:`start` and
# :func:`stop` open: it tells them apart from the staged path's stage ranges
# (:data:`~spfft_tpu_torch.obs.STAGES`, :func:`trace_annotation`) and from a
# caller's own ranges
RANGE_PREFIX = "spfft:"


class _Node:
    __slots__ = ("label", "timings", "children", "order")

    def __init__(self, label: str):
        self.label = label
        self.timings: list[float] = []
        self.children: dict[str, "_Node"] = {}
        self.order: list[str] = []

    def child(self, label: str) -> "_Node":
        node = self.children.get(label)
        if node is None:
            node = _Node(label)
            self.children[label] = node
            self.order.append(label)
        return node


def _quantile(sorted_vals, q: float) -> float:
    return float(np.quantile(sorted_vals, q))


@dataclass
class TimingResult:
    """Processed statistics for one timing node (reference: rt_graph.hpp:44-56)."""

    label: str
    count: int
    total: float
    mean: float
    median: float
    min: float
    max: float
    lower_quartile: float
    upper_quartile: float
    percentage: float
    parent_percentage: float
    sub: list["TimingResult"] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "count": self.count,
            "total": self.total,
            "mean": self.mean,
            "median": self.median,
            "min": self.min,
            "max": self.max,
            "lower_quartile": self.lower_quartile,
            "upper_quartile": self.upper_quartile,
            "percentage": self.percentage,
            "parent_percentage": self.parent_percentage,
            "sub": [s.to_dict() for s in self.sub],
        }

    def json(self, indent: int | None = 2) -> str:
        return _json.dumps(self.to_dict(), indent=indent)

    def flat(self) -> list["TimingResult"]:
        out = [self]
        for s in self.sub:
            out.extend(s.flat())
        return out

    def find(self, label: str) -> "TimingResult | None":
        for node in self.flat():
            if node.label == label:
                return node
        return None

    def _format_lines(self, depth: int, lines: list[str]) -> None:
        indent = "  " * depth
        lines.append(
            f"{indent}{self.label:<{max(1, 34 - 2 * depth)}} "
            f"n={self.count:<5d} total={_fmt_s(self.total):>10} "
            f"mean={_fmt_s(self.mean):>10} median={_fmt_s(self.median):>10} "
            f"min={_fmt_s(self.min):>10} max={_fmt_s(self.max):>10} "
            f"{self.percentage:6.2f}% (parent {self.parent_percentage:6.2f}%)"
        )
        for s in self.sub:
            s._format_lines(depth + 1, lines)

    def __str__(self) -> str:
        lines: list[str] = []
        for s in self.sub if self.label == "" else [self]:
            s._format_lines(0, lines)
        return "\n".join(lines)


def _fmt_s(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:.3f} s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.3f} ms"
    return f"{seconds * 1e6:.3f} us"


class Timer:
    """Collects nested scoped timings into a tree.

    Unlike rt_graph — which logs raw start/stop events and reconstructs the nesting in
    ``process()`` (reference: rt_graph.hpp:60-95) — the tree is built live via an
    explicit scope stack; ``process()`` only computes statistics. Same output, no
    event-log replay, and mismatched stop labels are detected immediately.
    """

    def __init__(self):
        self._root = _Node("")
        self._stack: list[_Node] = [self._root]
        self._starts: list[float] = []

    def start(self, label: str) -> None:
        node = self._stack[-1].child(label)
        self._stack.append(node)
        self._starts.append(time.perf_counter())

    def stop(self, label: str) -> None:
        stop_time = time.perf_counter()
        if len(self._stack) <= 1:
            raise InvalidParameterError(
                f"Timer.stop({label!r}) without matching start"
            )
        node = self._stack[-1]
        if node.label != label:
            raise InvalidParameterError(
                f"Timer.stop({label!r}) does not match open scope {node.label!r}"
            )
        self._stack.pop()
        node.timings.append(stop_time - self._starts.pop())

    @contextmanager
    def scoped(self, label: str):
        self.start(label)
        try:
            yield
        finally:
            self.stop(label)

    def clear(self) -> None:
        self._root = _Node("")
        self._stack = [self._root]
        self._starts = []

    def process(self) -> TimingResult:
        """Compute the statistics tree over everything recorded so far."""
        top_total = sum(sum(c.timings) for c in self._root.children.values())

        def build(node: _Node, parent_total: float) -> TimingResult:
            vals = sorted(node.timings) or [0.0]
            total = sum(node.timings)
            res = TimingResult(
                label=node.label,
                count=len(node.timings),
                total=total,
                mean=total / max(1, len(node.timings)),
                median=_quantile(vals, 0.5),
                min=vals[0],
                max=vals[-1],
                lower_quartile=_quantile(vals, 0.25),
                upper_quartile=_quantile(vals, 0.75),
                percentage=100.0 * total / top_total if top_total else 0.0,
                parent_percentage=100.0 * total / parent_total if parent_total else 0.0,
                sub=[],
            )
            for label in node.order:
                res.sub.append(build(node.children[label], total))
            return res

        root = TimingResult(
            label="",
            count=0,
            total=top_total,
            mean=0.0,
            median=0.0,
            min=0.0,
            max=0.0,
            lower_quartile=0.0,
            upper_quartile=0.0,
            percentage=100.0,
            parent_percentage=100.0,
            sub=[build(self._root.children[l], top_total) for l in self._root.order],
        )
        return root


class _NoopScope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopScope()

# Process-global timer, the analogue of rt_graph's GlobalTimer
# (reference: src/timing/timing.cpp:34-36). Disabled by default like the
# SPFFT_TIMING=OFF build.
global_timer = Timer()
_enabled = False


def enable() -> None:
    """Turn on timing collection (the SPFFT_TIMING=ON build of the reference)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


class _JoinedScope:
    """Compose the scopes of the armed sinks, so one :func:`scoped` call
    feeds the timing tree, the flight recorder and the profiler's timeline
    without the call sites knowing which are armed."""

    __slots__ = ("_scopes",)

    def __init__(self, *scopes):
        self._scopes = scopes

    def __enter__(self):
        for s in self._scopes:
            s.__enter__()
        return self

    def __exit__(self, *exc):
        for s in reversed(self._scopes):
            s.__exit__(*exc)
        return False


def _profiler_range(label: str):
    """The ``torch.profiler`` range of a scope, or None with no profiler
    running (the check :func:`trace_annotation` makes)."""
    if not _profiler._is_profiler_enabled:
        return None
    return torch.profiler.record_function(RANGE_PREFIX + label)


def scoped(label: str):
    """Scoped timing region (the HOST_TIMING_SCOPED macro,
    reference: src/timing/timing.hpp:34-62). It feeds every armed sink: the
    timing tree when enabled; a run-ID-stamped ``phase`` begin/end span when
    the flight recorder (:mod:`spfft_tpu_torch.obs.trace`) is armed; a
    ``spfft:<label>`` range while a ``torch.profiler`` runs. With none armed
    it is the shared no-op scope."""
    if not (_enabled or _profiler._is_profiler_enabled or trace.enabled()):
        return _NOOP
    scopes = [s for s in (global_timer.scoped(label) if _enabled else None,
                          trace.span("phase", label=label) if trace.enabled() else None,
                          _profiler_range(label)) if s is not None]
    return scopes[0] if len(scopes) == 1 else _JoinedScope(*scopes)


# Each start() records whether it actually opened a scope, so a stop() after an
# enable/disable toggle stays balanced instead of corrupting the global tree.
# The parallel _trace_spans and _ranges stacks keep the flight-recorder phase
# spans and the profiler ranges balanced across toggles the same way.
_start_flags: list[bool] = []
_trace_spans: list = []
_ranges: list = []


def start(label: str) -> None:
    _start_flags.append(_enabled)
    if _enabled:
        global_timer.start(label)
    if trace.enabled():
        tspan = trace.span("phase", label=label)
        tspan.__enter__()
        _trace_spans.append(tspan)
    else:
        _trace_spans.append(None)
    prange = _profiler_range(label)
    if prange is not None:
        prange.__enter__()
    _ranges.append(prange)


def stop(label: str) -> None:
    prange = _ranges.pop() if _ranges else None
    if prange is not None:
        prange.__exit__(None, None, None)
    tspan = _trace_spans.pop() if _trace_spans else None
    if tspan is not None:
        tspan.__exit__(None, None, None)
    if _start_flags.pop() if _start_flags else False:
        global_timer.stop(label)


def clear() -> None:
    global_timer.clear()
    _start_flags.clear()


def process() -> TimingResult:
    return global_timer.process()


def trace_annotation(label: str):
    """Named range for ``torch.profiler`` traces (``record_function``): the
    staged path runs each stage-graph node under its :data:`obs.STAGES`
    label, so a profiler trace attributes device time per stage, as the JAX
    package's ``jax.profiler.TraceAnnotation`` does. With no profiler
    running it hands out the shared no-op scope: ``record_function`` itself
    costs microseconds a call, once per node of every staged call."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return torch.profiler.record_function(label)
