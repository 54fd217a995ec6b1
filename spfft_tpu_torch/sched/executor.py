"""The task-graph executor: transforms kept in flight, finalized as they finish.

The port of ``spfft_tpu/sched/executor.py``:

- **Windowed dispatch**: up to ``max_inflight`` tasks
  (``SPFFT_TPU_SCHED_INFLIGHT``) are dispatched at once, in topological
  order, so that the card's queue does not drain while the host stages the
  next task's input or fetches another's result.
- **Completion-order finalize**: in-flight tasks are polled and finalized as
  they complete, not in submission order. Where JAX polls
  ``jax.Array.is_ready``, a task here records a ``torch.cuda.Event`` on its
  device's current stream right after its dispatch (the stream that a fused
  plan's CUDA graph replays on and its results are copied out on) and is
  ready when the event's ``query()`` is; a CPU result is ready at once.
- **A failure ladder per task**: a task that fails is retried, then demoted
  through its plan's ``torch.fft`` reference rung, then resolved with a
  typed error; its dependents resolve ``upstream_failed``. A plan with a
  ``rehost()`` hook (a remote plan) moves on ``HostLostError`` before it
  resolves ``host_lost``. A failure never stalls the graph.

Observability: ``sched_tasks_total{outcome}``, ``sched_inflight``,
``sched_graph_depth``, ``sched_retries_total`` and ``sched`` trace events
(graph, place, dispatch, finalize, demote, fail, rehost). The fault site
``sched.run`` sits on each dispatch's result.
"""
from __future__ import annotations

import time
from collections import Counter

import torch

from .. import faults, knobs, obs
from ..errors import (DeadlineExceededError, FFTWError, GenericError, GPUFFTError,
                      HostExecutionError, HostLostError, InvalidParameterError, MPIError)
from ..types import ScalingType
from .graph import TaskGraph
from .placement import PlanPool, assign, default_devices, place

SCHED_INFLIGHT_ENV = "SPFFT_TPU_SCHED_INFLIGHT"
DEFAULT_INFLIGHT = knobs.default(SCHED_INFLIGHT_ENV)

# Between polls the executor sleeps _POLL_S; after _POLL_PATIENCE_S with no
# completion it finalizes the oldest in-flight task blocking, so progress
# never depends on a readiness probe.
_POLL_S = 0.0002
_POLL_PATIENCE_S = 0.05

# The outcomes (``sched_tasks_total{outcome}``); the failed ones cascade.
OUTCOMES = ("completed", "demoted", "failed", "upstream_failed", "host_lost")
_FAILED_OUTCOMES = ("failed", "upstream_failed", "host_lost")

# The host-loss requeue rung's budget: moves and the backoff between them.
HOST_RETRIES_ENV = "SPFFT_TPU_HOSTS_RETRIES"
HOST_BACKOFF_ENV = "SPFFT_TPU_HOSTS_BACKOFF_S"

# Typed execution failures the ladder retries and demotes; parameter errors
# fail fast.
LADDER_ERRORS = (HostExecutionError, GPUFFTError, MPIError, FFTWError)


def resolve_inflight(value=None) -> int:
    """The in-flight window: ``value``, else ``SPFFT_TPU_SCHED_INFLIGHT`` (floor 1)."""
    if value is not None:
        return max(1, int(value))
    return knobs.get_int(SCHED_INFLIGHT_ENV)


class GraphReport:
    """The outcome of one :func:`run_graph` call."""

    __slots__ = ("results", "outcomes", "errors", "depth", "tasks", "placement",
                 "wall_seconds")

    def __init__(self, graph: TaskGraph, placement, wall_seconds, depth=None):
        self.results = {t.id: t.result for t in graph if t.outcome in ("completed", "demoted")}
        self.outcomes = {t.id: t.outcome for t in graph}
        self.errors = {t.id: t.error for t in graph if t.error is not None}
        self.depth = graph.depth() if depth is None else int(depth)
        self.tasks = len(graph)
        self.placement = placement
        self.wall_seconds = wall_seconds

    def result(self, task_id: str):
        """The task's result; its typed error if it did not complete."""
        tid = str(task_id)
        if tid in self.errors:
            raise self.errors[tid]
        if tid not in self.results:
            raise InvalidParameterError(f"unknown task id {task_id!r}")
        return self.results[tid]

    def describe(self) -> dict:
        return {"tasks": self.tasks, "depth": self.depth,
                "outcomes": dict(Counter(self.outcomes.values())),
                "wall_seconds": self.wall_seconds, "placement": self.placement}


def _record_ready(task) -> None:
    """The readiness probe of a dispatched task: a remote call's own handle
    (it answers ``query()``), else an event on its device's current stream
    (None on the CPU, or for a task already resolved)."""
    device = getattr(task.plan, "device", None)
    task.ready = None
    if task.result is None and hasattr(task.pending, "query"):
        task.ready = task.pending
    elif task.result is None and device is not None and device.type == "cuda":
        task.ready = torch.cuda.Event()
        task.ready.record(torch.cuda.current_stream(device))


def _pending_ready(task) -> bool:
    return task.ready is None or task.ready.query()


def _leaves(result) -> list:
    items = result if isinstance(result, (list, tuple)) else [result]
    return [x for x in items if x is not None]


class _Run:
    """One graph execution: the dispatch and finalize loop's shared state."""

    def __init__(self, graph, *, retries, demote, on_error, poll_patience_s, backoff_s=0.0,
                 backoff_rng=None, host_retries=None, host_backoff_s=None):
        self.graph = graph
        self.retries = max(0, int(retries))
        self.demote = bool(demote)
        self.host_retries = knobs.get_int(HOST_RETRIES_ENV, host_retries)
        self.host_backoff_s = knobs.get_float(HOST_BACKOFF_ENV, host_backoff_s)
        if on_error not in ("resolve", "raise"):
            raise InvalidParameterError(f"on_error must be 'resolve' or 'raise', got {on_error!r}")
        self.on_error = on_error
        self.poll_patience_s = float(poll_patience_s)
        # jittered exponential backoff between a task's attempts (0: none)
        self.backoff_s = max(0.0, float(backoff_s))
        self.backoff_rng = backoff_rng

    # ---- one task ----------------------------------------------------------------

    def _payload(self, task):
        if task.input_from is not None:
            return self.graph.task(task.input_from).result
        return task.payload

    def _dispatch(self, task) -> None:
        """Stage and enqueue one task without waiting. A verified plan runs
        whole under its supervisor (which owns the retry and demote ladder)
        and completes here."""
        plan = task.plan
        task.attempts += 1
        task.dispatched_at = time.monotonic()
        payload = self._payload(task)
        obs.trace.event("sched", what="dispatch", task=task.id, direction=task.direction,
                        attempt=task.attempts)
        with faults.typed_execution(plan._platform, "sched dispatch"):
            if plan._verifier is not None:
                if task.batch:  # each request under its supervisor
                    task.result = ([plan.backward(v) for v in payload]
                                   if task.direction == "backward"
                                   else [plan.forward(v, task.scaling) for v in payload])
                elif task.direction == "backward":
                    task.result = plan.backward(payload)
                else:
                    task.result = plan.forward(payload, task.scaling)
                task.pending = ()
                return
            if task.batch:  # one batched program for the request list
                pending = (plan._dispatch_backward_batch(payload)
                           if task.direction == "backward"
                           else plan._dispatch_forward_batch(payload, task.scaling))
            elif task.direction == "backward":
                pending = plan._dispatch_backward(payload)
            else:
                pending = plan._dispatch_forward(payload, task.scaling)
            # `raise` surfaces here (typed by the scope); nan and corrupt
            # poison the in-flight result, which guard must catch at finalize
            task.pending = faults.site("sched.run", payload=pending)
        _record_ready(task)

    def _finalize(self, task) -> None:
        """Fetch one dispatched task's result; a guarded plan's result is
        scanned, so a poisoned one raises typed into the ladder."""
        plan = task.plan
        if task.result is not None or plan._verifier is not None:
            return  # supervised: done at dispatch
        with faults.typed_execution(plan._platform, "sched finalize"):
            if task.batch:
                result = (plan._finalize_backward_batch(task.pending)
                          if task.direction == "backward"
                          else plan._finalize_forward_batch(task.pending))
            elif task.direction == "backward":
                result = plan._finalize_backward(task.pending)
            else:
                result = plan._finalize_forward(task.pending)
            if plan._guard:
                faults.check_array(_leaves(result), check="sched output",
                                   platform=plan._platform)
        task.result = result

    def _reference(self, task):
        """The demotion rung: the plan's ``torch.fft`` reference engine, on
        no path that the primary dispatch shares (no ``sched.run`` site)."""
        plan = task.plan
        payload = self._payload(task)
        with faults.typed_execution(plan._platform, "sched demote"):
            if task.direction == "backward":
                if task.batch:
                    return [plan._reference_backward(v) for v in payload]
                return plan._reference_backward(payload)
            if task.batch:
                return [plan._reference_forward(plan._device_space(v), task.scaling)
                        for v in payload]
            return plan._reference_forward(plan._device_space(payload), task.scaling)

    def _expired(self, task) -> bool:
        """The deadline gate before every dispatch, first or retry: an
        expired task resolves typed without using the card."""
        if task.deadline is None or time.monotonic() < task.deadline:
            return False
        self._fail(task, DeadlineExceededError(
            f"sched task {task.id!r} deadline expired before "
            f"{'retry' if task.attempts else 'dispatch'}"))
        return True

    def _retry_pause(self, task) -> None:
        obs.counter("sched_retries_total").inc()
        if self.backoff_s > 0.0:
            time.sleep(faults.backoff_s(self.backoff_s, task.attempts, self.backoff_rng))

    def _attempt(self, task) -> bool:
        """One dispatch with the ladder; True when the task is in flight
        (or done)."""
        while True:
            if self._expired(task):
                return False
            try:
                self._dispatch(task)
                return True
            except HostLostError as e:  # before the ladder: HostLost is an MPIError
                if not self._rehost(task, e):
                    return False
            except LADDER_ERRORS as e:
                if task.attempts <= self.retries:
                    self._retry_pause(task)
                    continue
                self._demote_or_fail(task, e)
                return False
            except GenericError as e:
                # not retryable (a parameter error, an exhausted supervisor):
                # the task resolves typed, the graph runs on
                self._fail(task, e)
                return False

    def _finalize_ladder(self, task) -> None:
        """Finalize with the ladder: a failed finalize re-runs the attempt
        (the in-flight result is spent), then demotes, then resolves typed."""
        while True:
            try:
                self._finalize(task)
            except HostLostError as e:
                task.pending = None
                if not self._rehost(task, e) or not self._attempt(task):
                    return
                continue
            except LADDER_ERRORS as e:
                task.pending = None
                if task.attempts <= self.retries:
                    self._retry_pause(task)
                    if self._attempt(task):
                        continue
                    return
                self._demote_or_fail(task, e)
                return
            except GenericError as e:
                task.pending = None
                self._fail(task, e)
                return
            self._resolve(task, "completed")
            return

    def _rehost(self, task, error) -> bool:
        """The host-loss rung: move the task through its plan's ``rehost()``
        hook, at most ``host_retries`` times; False when it resolved
        ``host_lost`` instead (no hook, budget spent, no host left)."""
        rehost = getattr(task.plan, "rehost", None)
        if rehost is None or task.host_moves >= self.host_retries:
            self._host_lost(task, error)
            return False
        task.host_moves += 1
        obs.counter("host_requeues_total").inc()
        obs.trace.event("sched", what="rehost", task=task.id, move=task.host_moves)
        if self.host_backoff_s > 0.0:
            time.sleep(faults.backoff_s(self.host_backoff_s, task.host_moves, self.backoff_rng))
        try:
            rehost(error)
        except GenericError as e:
            self._host_lost(task, e)
            return False
        return True

    def _host_lost(self, task, error) -> None:
        faults.record_degradation("host_lost", faults.summarize(error), task=task.id)
        task.error = error
        obs.trace.event("sched", what="fail", task=task.id, error=type(error).__name__,
                        outcome="host_lost")
        self._resolve(task, "host_lost")
        if self.on_error == "raise":
            raise error

    def _demote_or_fail(self, task, error) -> None:
        if not self.demote:
            self._fail(task, error)
            return
        obs.trace.event("sched", what="demote", task=task.id)
        try:
            task.result = self._reference(task)
        except GenericError as demote_err:
            self._fail(task, demote_err)
            return
        task.error = None
        self._resolve(task, "demoted")

    def _fail(self, task, error) -> None:
        task.error = error
        obs.trace.event("sched", what="fail", task=task.id, error=type(error).__name__)
        self._resolve(task, "failed")
        if self.on_error == "raise":
            raise error

    def _resolve(self, task, outcome: str) -> None:
        task.outcome = outcome
        task.finished_at = time.monotonic()
        obs.counter("sched_tasks_total", outcome=outcome).inc()
        if outcome in ("completed", "demoted"):
            obs.trace.event("sched", what="finalize", task=task.id)

    def _cascade(self, task) -> None:
        """A task whose dependency failed resolves typed, never stalls."""
        causes = [d for d in task.deps if self.graph.task(d).outcome in _FAILED_OUTCOMES]
        err = HostExecutionError(
            f"sched task {task.id!r} not run: upstream task "
            f"{causes[0] if causes else '?'!r} failed")
        err.__cause__ = self.graph.task(causes[0]).error if causes else None
        task.error = err
        self._resolve(task, "upstream_failed")

    # ---- the loop ----------------------------------------------------------------

    def execute(self, order: list, max_inflight: int) -> None:
        gauge = obs.gauge("sched_inflight")
        try:
            self._execute(order, max_inflight, gauge)
        finally:
            gauge.set(0)  # drained or aborted (on_error="raise")

    def _execute(self, order: list, max_inflight: int, gauge) -> None:
        waiting = list(order)
        inflight: list = []
        last_progress = time.monotonic()
        while waiting or inflight:
            progressed = False
            while waiting and len(inflight) < max_inflight:
                task = self._next_ready(waiting)
                if task is None:
                    break
                waiting.remove(task)
                progressed = True
                if any(self.graph.task(d).outcome in _FAILED_OUTCOMES for d in task.deps):
                    self._cascade(task)
                    continue
                if self._attempt(task):
                    if task.result is not None:  # supervised: done already
                        self._resolve(task, "completed")
                    else:
                        inflight.append(task)
                        gauge.set(len(inflight))
            if inflight:
                ready = next((t for t in inflight if _pending_ready(t)), None)
                if ready is None and (time.monotonic() - last_progress > self.poll_patience_s
                                      or (not waiting and len(inflight) == 1)):
                    ready = inflight[0]
                if ready is not None:
                    inflight.remove(ready)
                    gauge.set(len(inflight))
                    self._finalize_ladder(ready)
                    progressed = True
                elif not progressed:
                    time.sleep(_POLL_S)
            if progressed:
                last_progress = time.monotonic()

    def _next_ready(self, waiting: list):
        """The first waiting task (topological order) whose deps resolved."""
        for task in waiting:
            if all(self.graph.task(d).outcome is not None for d in task.deps):
                return task
        return None


def run_graph(graph: TaskGraph, *, devices=None, pool: PlanPool | None = None,
              policy: str | None = None, width: int | None = None, max_inflight=None,
              retries: int = 1, demote: bool = True, on_error: str = "resolve",
              backoff_s: float = 0.0, backoff_rng=None, host_retries: int | None = None,
              host_backoff_s: float | None = None,
              _poll_patience_s: float = _POLL_PATIENCE_S) -> GraphReport:
    """Execute a :class:`TaskGraph`; returns a :class:`GraphReport`.

    ``devices`` (``torch.device``s; default every visible CUDA device) and
    ``policy`` feed the placement pass of spec'd tasks (``"tuned"``: the
    width from wisdom or trials; ``width=`` pins it). ``pool`` reuses plans
    across calls. ``retries`` / ``demote`` set the ladder;
    ``on_error="raise"`` aborts at the first failed task instead of
    resolving it. ``host_retries`` / ``host_backoff_s`` bound the host-loss
    rung of plans with a ``rehost()`` hook."""
    from ..parallel.policy import resolve_policy

    order = graph.order()  # validates (cycles) before anything runs
    if not order:
        return GraphReport(graph, None, 0.0)
    devices = default_devices() if devices is None else [torch.device(d) for d in devices]
    pool = pool if pool is not None else PlanPool()
    policy = resolve_policy(policy)
    t0 = time.monotonic()
    depth = graph.depth()
    obs.gauge("sched_graph_depth").set(depth)
    obs.trace.event("sched", what="graph", tasks=len(order), depth=depth, policy=str(policy))
    if width is not None:
        # the effective width: a pin wider than the device list is clamped
        w = max(1, min(int(width), len(devices) or 1))
        placement = {
            "provenance": "pinned", "hit": None, "wisdom_path": None, "key_digest": None,
            "choice": {"label": f"rr{w}", "width": w}, "trials": [],
            "reason": "explicit width" + (f" (clamped from {int(width)})" if w != int(width)
                                          else ""),
        }
        specd = [t for t in graph if t.spec is not None]
        if specd and not devices:
            raise InvalidParameterError("placement needs at least one device")
        assign(specd, devices, pool, placement, w)
    else:
        placement = place(graph, devices, pool, policy, measure=lambda cand: _measure_width(
            graph, devices, pool, cand["width"], max_inflight))
    run = _Run(graph, retries=retries, demote=demote, on_error=on_error,
               poll_patience_s=_poll_patience_s, backoff_s=backoff_s, backoff_rng=backoff_rng,
               host_retries=host_retries, host_backoff_s=host_backoff_s)
    run.execute(order, resolve_inflight(max_inflight))
    return GraphReport(graph, placement, time.monotonic() - t0, depth=depth)


def _measure_width(graph, devices, pool, width, max_inflight):
    """One placement trial: a fresh copy of the workload at the candidate
    width, with no retry or demotion (``on_error="raise"``), so that a width
    whose tasks fail becomes an error row, never a fast-looking winner."""
    run_graph(_copy_graph(graph), devices=devices, pool=pool, width=int(width),
              max_inflight=max_inflight, retries=0, demote=False, on_error="raise")


def _copy_graph(graph: TaskGraph) -> TaskGraph:
    """Fresh execution state over the same tasks (payloads and pinned plans
    shared; a trial re-executes them)."""
    copy = TaskGraph()
    for task in graph:
        copy.add(task.direction, id=task.id, payload=task.payload, scaling=task.scaling,
                 after=task.deps, input_from=task.input_from, transform=task.transform,
                 spec=task.spec, deadline=task.deadline, batch=task.batch)
    return copy


def run_tasks(plans: list, directions, payloads: list, scalings=None, *, max_inflight=None,
              retries: int = 0, demote: bool = False, on_error: str = "raise") -> list:
    """``plans[i]`` on ``payloads[i]`` as one graph with no edges (windowed
    dispatch, completion-order finalize); the results in batch order.
    ``directions`` is one direction or one per task. By default no retry or
    demotion (the caller owns recovery) and the first failure raises."""
    plans, payloads = list(plans), list(payloads)
    if len(plans) != len(payloads):
        raise InvalidParameterError(
            f"run_tasks: got {len(plans)} plans but {len(payloads)} payloads")
    directions = [directions] * len(plans) if isinstance(directions, str) else list(directions)
    if len(directions) != len(plans):
        raise InvalidParameterError(
            f"run_tasks: got {len(plans)} plans but {len(directions)} directions")
    scalings = [ScalingType.NONE] * len(plans) if scalings is None else list(scalings)
    if len(scalings) != len(plans):
        raise InvalidParameterError(
            f"run_tasks: got {len(plans)} plans but {len(scalings)} scalings")
    graph = TaskGraph()
    ids = [graph.add(d, payload=v, scaling=s, transform=p)
           for p, d, v, s in zip(plans, directions, payloads, scalings)]
    report = run_graph(graph, max_inflight=max_inflight, retries=retries, demote=demote,
                       on_error=on_error)
    return [report.result(tid) for tid in ids]
