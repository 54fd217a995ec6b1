"""`TransformService`: a multi-tenant, overload-safe transform service.

The port of ``spfft_tpu/serve/service.py``. Callers submit sparse
transforms (triplets + payload) from any thread and get back a
:class:`~spfft_tpu_torch.serve.queue.Ticket`; a single dispatcher (a background
thread, or the caller via :meth:`TransformService.pump`) pops same-geometry
coalesced batches from the bounded admission queue and executes them through
the plan cache. Robustness is the headline — the service's behavior *under
overload* is its contract:

- **Backpressure, not latency**: the bounded queue refuses admission with
  typed :class:`ServiceOverloadError` (queue full / tenant quota) — offered
  load beyond capacity is rejected in O(1), never absorbed as unbounded
  queueing delay.
- **Deadlines, twice**: an expired deadline is refused at admission and shed
  pre-dispatch — including between retry attempts — so device time is never
  burned on an answer nobody is waiting for
  (:class:`DeadlineExceededError`, ``deadline_miss``).
- **Fair-share shedding**: one noisy tenant cannot starve the rest (see
  :mod:`spfft_tpu_torch.serve.queue`).
- **Retry with jittered backoff**: transient typed execution failures
  (``RETRYABLE_ERRORS``) re-dispatch up to ``SPFFT_TPU_SERVE_RETRIES`` times
  with :func:`spfft_tpu_torch.faults.backoff_s` jitter — concurrent batches
  retrying one flaky engine spread out instead of herding.
- **Breaker ladder**: a tripped verify circuit breaker
  (:mod:`spfft_tpu_torch.verify.breaker`) on the batch's engine flips the
  service to shed-or-demote (``SPFFT_TPU_SERVE_ON_BREAKER``): ``demote``
  reroutes requests through the plan's ``torch.fft`` reference rung,
  ``shed`` fails them typed — never queue-and-die behind a dead engine.
- **No silent exits**: every admitted request's ticket resolves — completed,
  or failed with a typed :mod:`spfft_tpu_torch.errors` member — on every
  path, chaos included (``tests/test_torch_serve.py`` arms every
  ``serve.*`` fault site at overload and asserts it).

Two rules of the port differ from the JAX service. The processing unit
defaults to the card (``ProcessingUnit.GPU``; with no CUDA device the
constructor raises :class:`~spfft_tpu_torch.errors.GPUNoDeviceError`, it
never serves on the CPU unasked), and ``dtype=None`` means float64. A ticket
resolves to a tensor on the plan's device, as the port's plans return.

Observability rides the existing registries: per-tenant counters and latency
histograms, queue-depth gauges, batch-occupancy histograms
(``serve_*`` metrics in ``obs.snapshot()``), and ``serve`` flight-recorder
events for admit/shed/dispatch/complete transitions.
"""
from __future__ import annotations

import collections
import random
import threading
import time

import numpy as np
import torch

from .. import faults, knobs, obs, sched
from ..errors import (
    FFTWError,
    GPUFFTError,
    HostExecutionError,
    InvalidParameterError,
    MPIError,
)
from ..grid import device_for_processing_unit
from ..types import ProcessingUnit, ScalingType, TransformType
from ..ir.compile import resolve_batch_fuse
from ..verify import breaker
from .batcher import (
    GeometryMemo,
    PlanCache,
    _to_request_order,
    run_batch,
    run_reference,
)
from .errors import DeadlineExceededError, ServiceOverloadError, as_typed
from .queue import AdmissionQueue, Request

SERVE_QUEUE_CAP_ENV = "SPFFT_TPU_SERVE_QUEUE_CAP"
SERVE_BATCH_MAX_ENV = "SPFFT_TPU_SERVE_BATCH_MAX"
SERVE_TENANT_QUOTA_ENV = "SPFFT_TPU_SERVE_TENANT_QUOTA"
SERVE_TIMEOUT_ENV = "SPFFT_TPU_SERVE_TIMEOUT_S"
SERVE_RETRIES_ENV = "SPFFT_TPU_SERVE_RETRIES"
SERVE_BACKOFF_ENV = "SPFFT_TPU_SERVE_BACKOFF_S"
SERVE_ON_BREAKER_ENV = "SPFFT_TPU_SERVE_ON_BREAKER"
SERVE_PLANS_ENV = "SPFFT_TPU_SERVE_PLANS"
SERVE_SCHED_ENV = "SPFFT_TPU_SERVE_SCHED"
SERVE_SCHED_BATCHES_ENV = "SPFFT_TPU_SERVE_SCHED_BATCHES"

# defaults live in the spfft_tpu_torch.knobs registry (the single holder); these
# aliases keep the module's public surface stable
DEFAULT_QUEUE_CAP = knobs.default(SERVE_QUEUE_CAP_ENV)
DEFAULT_BATCH_MAX = knobs.default(SERVE_BATCH_MAX_ENV)
DEFAULT_TENANT_QUOTA = knobs.default(SERVE_TENANT_QUOTA_ENV)
DEFAULT_RETRIES = knobs.default(SERVE_RETRIES_ENV)
DEFAULT_BACKOFF_S = knobs.default(SERVE_BACKOFF_ENV)
DEFAULT_PLANS = knobs.default(SERVE_PLANS_ENV)
DEFAULT_SCHED_BATCHES = knobs.default(SERVE_SCHED_BATCHES_ENV)

# Typed execution failures one re-dispatch may heal (the verify supervisor's
# retry rule): the dual error surface's dispatch/fence conversions plus the
# collective layer. Parameter/index errors and overload/deadline refusals
# are NOT retryable — they would fail identically.
RETRYABLE_ERRORS = (HostExecutionError, GPUFFTError, MPIError, FFTWError)


def resolve_on_breaker(value: str | None = None) -> str:
    """``demote`` (reroute through the torch.fft reference rung) or ``shed``
    (typed refusal) — what the service does with a batch whose engine's
    circuit breaker is open (``SPFFT_TPU_SERVE_ON_BREAKER``)."""
    mode = value if value is not None else knobs.get_str(SERVE_ON_BREAKER_ENV)
    if mode not in ("demote", "shed"):
        raise InvalidParameterError(
            f"invalid breaker response {mode!r}: expected 'demote' or 'shed'"
        )
    return mode


class TransformService:
    """Multi-tenant transform service over a bounded admission queue.

    One service instance owns one plan cache, one admission queue and one
    dispatcher. ``start=True`` (default) runs the dispatcher as a daemon
    thread; ``start=False`` leaves dispatch to explicit :meth:`pump` calls
    (deterministic tests, caller-owned event loops). Close with
    :meth:`close` or a ``with`` block — pending tickets are drained or
    failed typed, never leaked.

    Plan-construction keyword arguments (``engine``, ``precision``,
    ``policy``, ``guard``, ``verify``, ``dtype``, ``device``) pass through
    to every cached :class:`~spfft_tpu_torch.transform.Transform`, so a verified
    service (``verify="on"``) runs every request under the ABFT recovery
    supervisor and a tuned one (``policy="tuned"``) resolves engines through
    wisdom."""

    def __init__(
        self,
        processing_unit=ProcessingUnit.GPU,
        *,
        dtype=None,
        engine: str = "auto",
        precision: str = "highest",
        policy: str | None = None,
        guard: bool | None = None,
        verify=None,
        device=None,
        queue_capacity: int | None = None,
        batch_max: int | None = None,
        tenant_quota: float | None = None,
        default_timeout_s: float | None = None,
        retries: int | None = None,
        backoff_s: float | None = None,
        on_breaker: str | None = None,
        plan_cache_size: int | None = None,
        sched: bool | None = None,
        sched_batches: int | None = None,
        start: bool = True,
    ):
        self._pu = ProcessingUnit(processing_unit)
        # the card unless the caller asks for the CPU: GPUNoDeviceError here,
        # before any thread starts, where there is no CUDA device
        self._device = device_for_processing_unit(self._pu, device)
        self._plan_kwargs = dict(
            dtype=np.float64 if dtype is None else np.dtype(dtype), engine=engine,
            precision=precision, policy=policy, guard=guard, verify=verify,
            device=self._device,
        )
        self.queue_capacity = (
            int(queue_capacity) if queue_capacity is not None
            else knobs.get_int(SERVE_QUEUE_CAP_ENV)
        )
        self.batch_max = (
            max(1, int(batch_max)) if batch_max is not None
            else knobs.get_int(SERVE_BATCH_MAX_ENV)
        )
        quota = (
            float(tenant_quota) if tenant_quota is not None
            else knobs.get_float(SERVE_TENANT_QUOTA_ENV)
        )
        self.default_timeout_s = (
            float(default_timeout_s) if default_timeout_s is not None
            else knobs.get_float(SERVE_TIMEOUT_ENV)
        )
        self.retries = (
            max(0, int(retries)) if retries is not None
            else knobs.get_int(SERVE_RETRIES_ENV)
        )
        self.backoff_s = (
            max(0.0, float(backoff_s)) if backoff_s is not None
            else knobs.get_float(SERVE_BACKOFF_ENV)
        )
        self.on_breaker = resolve_on_breaker(on_breaker)
        # graph-scheduled dispatch (spfft_tpu_torch.sched): one dispatch cycle pops
        # up to sched_batches coalesced batches — mixed geometries included —
        # and runs them as ONE task graph, so a flood across many plan-cache
        # entries stops serializing per entry (SPFFT_TPU_SERVE_SCHED;
        # spfft_tpu_torch.programs.loadgen --sched A/Bs it)
        self.sched = (
            bool(sched) if sched is not None
            else knobs.get_bool(SERVE_SCHED_ENV)
        )
        self.sched_batches = (
            max(1, int(sched_batches)) if sched_batches is not None
            else knobs.get_int(SERVE_SCHED_BATCHES_ENV)
        )
        cache_cap = (
            int(plan_cache_size) if plan_cache_size is not None
            else knobs.get_int(SERVE_PLANS_ENV)
        )
        self.queue = AdmissionQueue(self.queue_capacity, quota)
        self.queue.on_shed = lambda tenant: self._count("shed", tenant)
        self.plans = PlanCache(self._build_plan, cache_cap)
        self.geometries = GeometryMemo()
        self._retry_rng = random.Random()
        self._counts: collections.Counter = collections.Counter()
        self._counts_lock = threading.Lock()
        self._closing = False
        self._worker = None
        if start:
            self._worker = threading.Thread(
                target=self._dispatch_loop, name="spfft-serve-dispatch",
                daemon=True,
            )
            self._worker.start()

    # ---- plan construction ---------------------------------------------------

    def _build_plan(self, canonical, key):
        """Build the canonical plan of one cache entry (runs under the
        cache lock — one build per geometry key, ever)."""
        from ..transform import Transform

        return Transform(
            self._pu,
            TransformType[key["type"]],
            key["dims"][0], key["dims"][1], key["dims"][2],
            indices=canonical,
            **self._plan_kwargs,
        )

    def _clone_plan(self, plan):
        return plan.clone()

    def _platform(self) -> str:
        """``"gpu"`` on the card, ``"cpu"`` on the CPU: picks the typed
        execution error of a failure held as a value."""
        return "gpu" if self._device.type == "cuda" else "cpu"

    # ---- submission ----------------------------------------------------------

    def submit(
        self,
        transform_type,
        dims,
        indices,
        payload,
        *,
        direction: str = "backward",
        tenant: str = "default",
        timeout_s: float | None = None,
        scaling: ScalingType = ScalingType.NONE,
        run_id: str | None = None,
    ):
        """Admit one request; returns its ticket without waiting.

        ``indices`` are the caller's (V, 3) index triplets in the caller's
        packing order; ``payload`` is the packed frequency values
        (``direction="backward"``) or the ``(Z, Y, X)`` space slab
        (``direction="forward"``). Raises typed
        :class:`ServiceOverloadError` / :class:`DeadlineExceededError` on
        refusal — admission is the backpressure surface.

        ``run_id`` is the request's trace run ID (the card <-> metrics <->
        trace join key): a fresh one is minted when None, and an RPC front
        passes its CALLER's through so everything this service records joins
        under the caller's key (docs/details.md "Observability", fleet
        layer). The ID rides the request's ticket (``Ticket.run``)."""
        tenant = str(tenant)
        run = run_id if run_id is not None else obs.trace.new_run_id()
        try:
            if self._closing:
                obs.counter("serve_sheds_total", reason="closing").inc()
                raise ServiceOverloadError("service is closing")
            if direction not in ("backward", "forward"):
                raise InvalidParameterError(
                    f"unknown direction {direction!r}: expected backward/forward"
                )
            # cheap refusals BEFORE plan resolution: a request destined for
            # a typed rejection must not pay a plan build or thrash the LRU
            # cache on its way out — the
            # O(1)-backpressure half of the admission contract. The queue
            # re-checks both authoritatively under its own lock.
            deadline = self._resolve_deadline(timeout_s)
            if deadline is not None and deadline <= time.monotonic():
                raise DeadlineExceededError(
                    "request deadline expired before admission"
                )
            if self.queue.tenant_depth(tenant) >= self.queue.quota:
                obs.counter("serve_sheds_total", reason="tenant_quota").inc()
                raise ServiceOverloadError(
                    f"tenant {tenant!r} is over its queue quota "
                    f"({self.queue.quota} of {self.queue.capacity} slots)"
                )
            ttype = TransformType(transform_type)
            dims = tuple(int(d) for d in dims)
            if len(dims) != 3:
                raise InvalidParameterError("dims must be (dim_x, dim_y, dim_z)")
            request_triplets, canonical, sticks, order_sig = self.geometries.resolve(
                indices, dims)
            plan = self._plan_kwargs
            digest, key = self.plans.key(
                ttype, dims, canonical, dtype=plan["dtype"],
                precision=plan["precision"], engine=plan["engine"],
                platform=self._platform(), sticks=sticks,
            )
            entry, src = self.plans.ensure(digest, key, canonical, request_triplets, order_sig)
            payload = self._stage_payload(
                entry.plan, direction, payload, src, len(request_triplets)
            )
            request = Request(
                tenant=tenant, direction=direction,
                scaling=ScalingType(scaling), plan_key=digest,
                payload=payload,
                order_map=src if direction == "forward" else None,
                deadline=deadline, run=run,
            )
            try:
                self.queue.admit(request)
            except faults.InjectedFault as e:
                # the serve.admit chaos site: admission machinery death is
                # an overload-class refusal, typed like every other one
                raise ServiceOverloadError(
                    f"admission machinery failed: {faults.summarize(e)}"
                ) from e
        except Exception:
            self._count("rejected", tenant)
            with obs.trace.with_run(run):
                obs.trace.event("serve", what="reject", tenant=tenant)
            raise
        with obs.trace.with_run(run):
            obs.trace.event(
                "serve", what="admit", tenant=tenant, direction=direction
            )
        self._count("admitted", tenant)
        return request.ticket

    def backward(self, transform_type, dims, indices, values, **kw):
        """Submit one backward request and wait for its result."""
        return self.submit(
            transform_type, dims, indices, values, direction="backward", **kw
        ).result()

    def forward(self, transform_type, dims, indices, space,
                scaling: ScalingType = ScalingType.NONE, **kw):
        """Submit one forward request and wait for its packed result (in the
        caller's index order)."""
        return self.submit(
            transform_type, dims, indices, space, direction="forward",
            scaling=scaling, **kw
        ).result()

    def _resolve_deadline(self, timeout_s):
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        timeout_s = float(timeout_s)
        if timeout_s <= 0:
            return None
        return time.monotonic() + timeout_s

    def _stage_payload(self, plan, direction, payload, src, num_values):
        """Validate + reorder the caller's payload into plan order (backward
        values gather through the value-order map; forward slabs pass
        through shape-checked). A numpy payload stays on the host until its
        dispatch stages it; a tensor is gathered where it lies."""
        tensor = torch.is_tensor(payload)
        if direction == "backward":
            values = payload.reshape(-1) if tensor else np.asarray(payload).reshape(-1)
            size = values.numel() if tensor else values.size
            if size != num_values:
                raise InvalidParameterError(
                    f"expected {num_values} frequency values, got {size}"
                )
            if tensor:
                return values[torch.as_tensor(src, device=values.device)]
            return values[src]
        space = payload if tensor else np.asarray(payload)
        size = space.numel() if tensor else space.size
        expect = plan.dim_z * plan.dim_y * plan.dim_x
        if size != expect:
            raise InvalidParameterError(
                f"expected a {plan.dim_z}x{plan.dim_y}x{plan.dim_x} space "
                f"slab ({expect} elements), got {size}"
            )
        return space.reshape(plan.dim_z, plan.dim_y, plan.dim_x)

    # ---- dispatch ------------------------------------------------------------

    def pump(self, max_batches: int | None = None) -> int:
        """Drain coalesced batches synchronously (``start=False`` services);
        returns the number of batches processed. Single consumer only — a
        service with a live dispatcher thread refuses."""
        if self._worker is not None and self._worker.is_alive():
            raise InvalidParameterError(
                "pump() on a threaded service: the dispatcher owns the queue"
            )
        processed = 0
        while max_batches is None or processed < max_batches:
            if self.sched:
                limit = self.sched_batches
                if max_batches is not None:
                    limit = min(limit, max_batches - processed)
                batches = self._pop_batches(limit, timeout=0.0)
                if not batches:
                    break
                self._process_graph(batches)
                processed += len(batches)
                continue
            batch = self.queue.pop_batch(self.batch_max, timeout=0.0)
            if not batch:
                break
            self._process_batch(batch)
            processed += 1
        return processed

    def _dispatch_loop(self) -> None:
        while True:
            if self.sched:
                batches = self._pop_batches(self.sched_batches, timeout=0.05)
                if not batches:
                    if self._closing:
                        return
                    continue
                self._process_graph(batches)
                continue
            batch = self.queue.pop_batch(self.batch_max, timeout=0.05)
            if not batch:
                if self._closing:
                    return
                continue
            self._process_batch(batch)

    def _pop_batches(self, limit: int, timeout: float) -> list:
        """Up to ``limit`` coalesced batches for one graph-scheduled dispatch
        cycle: block up to ``timeout`` for the first, then drain whatever
        other groups are immediately available (mixed geometries included —
        that is the point: they stop serializing per plan-cache entry)."""
        batch = self.queue.pop_batch(self.batch_max, timeout=timeout)
        if not batch:
            return []
        batches = [batch]
        while len(batches) < max(1, int(limit)):
            more = self.queue.pop_batch(self.batch_max, timeout=0.0)
            if not more:
                break
            batches.append(more)
        return batches

    def _process_batch(self, batch: list) -> None:
        """Execute one coalesced batch end-to-end, resolving every ticket.

        The catch-all is deliberate and narrow in effect: a dispatcher that
        dies mid-batch would leave tickets pending forever (the queue-and-
        die failure mode this layer exists to remove), so ANY failure here
        resolves the whole batch's tickets with the typed conversion of the
        cause and the loop survives — the no-deadlock half of the chaos
        invariant."""
        try:
            self._process_batch_inner(batch)
        except Exception as e:  # noqa: BLE001 — see docstring
            err = as_typed(e, self._platform())
            for req in batch:
                # count only tickets THIS failure resolved: requests the
                # inner path already shed/resolved keep their first outcome
                if req.ticket.fail(err):
                    self._count("failed", req.tenant)

    def _process_batch_inner(self, batch: list) -> None:
        obs.counter("serve_batches_total").inc()
        platform = self._platform()
        entry = self.plans.get(batch[0].plan_key)
        survivors = self._shed_expired(batch)
        if not survivors:
            return
        if entry is None:  # evicted between admit and dispatch: rebuild-free shed
            err = ServiceOverloadError("plan cache entry evicted while queued")
            for req in survivors:
                obs.counter("serve_sheds_total", reason="plan_evicted").inc()
                if req.ticket.fail(err, outcome="shed"):
                    self._count("shed", req.tenant)
            return
        engine = entry.plan._engine
        supervised = entry.plan._verifier is not None
        # breaker ladder: an open breaker on this batch's engine means the
        # primary path is known-bad — shed or demote instead of queueing
        # into a dead engine. Supervised plans skip this: their recovery
        # supervisor owns the whole ladder, half-open probes included.
        # Unsupervised batches consult allow() — which performs the
        # open→half-open cooldown transition and grants THIS dispatcher the
        # probe slot — and report the execution verdict back below, so serve
        # traffic alone can heal (or re-open) a tripped breaker instead of
        # demoting forever.
        if not supervised and not breaker.allow(engine):
            self._breaker_response(survivors, engine, entry)
            return
        # From here an unsupervised dispatcher MAY hold the breaker's single
        # half-open probe slot (allow() just granted it). Every exit path
        # must settle it: success/exhaustion report verdicts inline; the
        # finally releases a verdict-carrying or verdict-less probe on the
        # remaining exits (batch fully deadline-shed mid-retry, a
        # non-retryable escape to the catch-all) so the breaker can never
        # wedge in half-open behind a lost probe.
        settled = supervised
        observed_failure = False
        try:
            attempt = 0
            while True:
                survivors = self._shed_expired(survivors)
                if not survivors:
                    return
                obs.trace.event(
                    "serve", what="dispatch", engine=engine,
                    occupancy=len(survivors), attempt=attempt,
                )
                for req in survivors:
                    req.ticket.stamp("dispatched")
                try:
                    with faults.typed_execution(platform, "serve dispatch"):
                        faults.site("serve.dispatch")
                        results = run_batch(
                            entry, survivors, self._clone_plan,
                            batch_cap=self._batch_cap(entry),
                        )
                except RETRYABLE_ERRORS as e:
                    observed_failure = True
                    attempt += 1
                    if attempt > self.retries:
                        if not supervised:
                            # an exhausted-retries episode is an engine-
                            # health signal: feed the breaker's consecutive-
                            # failure count (and settle a held probe)
                            breaker.record_failure(engine)
                            settled = True
                        err = as_typed(e, platform)
                        for req in survivors:
                            if req.ticket.fail(err):
                                self._count("failed", req.tenant)
                        return
                    obs.counter("serve_retries_total").inc()
                    self._count_only("retries")
                    # jittered exponential backoff (faults.backoff_s):
                    # concurrent batches retrying one flaky engine spread
                    # out, not herd
                    time.sleep(
                        faults.backoff_s(self.backoff_s, attempt, self._retry_rng)
                    )
                    continue
                if not supervised:
                    # execution succeeded: settle a half-open probe / reset
                    # the consecutive-failure count (supervised plans'
                    # supervisors already reported their verified verdicts)
                    breaker.record_success(engine)
                    settled = True
                for req, result in zip(survivors, results):
                    if req.ticket.resolve(result):
                        self._observe_completion(req)
                return
        finally:
            if not settled:
                if observed_failure:
                    breaker.record_failure(engine)
                else:
                    breaker.release_probe(engine)

    def _process_graph(self, batches: list) -> None:
        """Execute one graph-scheduled dispatch cycle end-to-end, resolving
        every ticket of every batch (the same catch-all no-deadlock contract
        as :meth:`_process_batch`, over the whole cycle)."""
        try:
            self._process_graph_inner(batches)
        except Exception as e:  # noqa: BLE001 — see _process_batch docstring
            err = as_typed(e, self._platform())
            for batch in batches:
                for req in batch:
                    if req.ticket.fail(err):
                        self._count("failed", req.tenant)

    def _process_graph_inner(self, batches: list) -> None:
        """Admit each batch through the same gates as the per-batch path
        (deadline shed, evicted-entry shed, breaker ladder), then run every
        surviving request of every geometry as ONE task graph
        (:func:`spfft_tpu_torch.sched.run_graph`): mixed-geometry dispatches
        overlap instead of serializing per plan-cache entry, finalize runs
        in completion order, and a failed task demotes through the
        scheduler's reference rung without stalling the rest of the cycle.
        The scheduler owns per-task retries here (``retries=self.retries``);
        engine breakers settle from the cycle's per-engine verdicts."""
        platform = self._platform()
        graph = sched.TaskGraph()
        jobs = []  # (task_id, request, engine, supervised)
        engines: dict = {}  # engine -> {"supervised", "failed"}
        settled = False
        # From the first allow() below this cycle MAY hold an engine
        # breaker's single half-open probe slot. Every exit — the normal
        # verdict loop included — must settle each engine's probe, so the
        # finally releases verdict-less probes on the exceptional exits (a
        # serve.batch fault on a later batch, a graph-build error): the
        # breaker must never wedge in half-open behind a lost probe (the
        # same contract as _process_batch_inner's finally).
        try:
            for batch in batches:
                obs.counter("serve_batches_total").inc()
                entry = self.plans.get(batch[0].plan_key)
                survivors = self._shed_expired(batch)
                if not survivors:
                    continue
                if entry is None:  # evicted between admit and dispatch
                    err = ServiceOverloadError(
                        "plan cache entry evicted while queued"
                    )
                    for req in survivors:
                        obs.counter(
                            "serve_sheds_total", reason="plan_evicted"
                        ).inc()
                        if req.ticket.fail(err, outcome="shed"):
                            self._count("shed", req.tenant)
                    continue
                engine = entry.plan._engine
                supervised = entry.plan._verifier is not None
                if not supervised and not breaker.allow(engine):
                    self._breaker_response(survivors, engine, entry)
                    continue
                state = engines.setdefault(
                    engine, {"supervised": supervised, "failed": False}
                )
                state["supervised"] = state["supervised"] and supervised
                faults.site("serve.batch")
                obs.histogram("serve_batch_occupancy").observe(len(survivors))
                obs.trace.event(
                    "serve", what="coalesce",
                    direction=survivors[0].direction,
                    occupancy=len(survivors),
                )
                if not supervised and entry.plan._exec._ir.batch_available():
                    # batch-fused entry: the scheduler sees the whole batch
                    # as ONE task (one stacked dispatch, one finalize, one
                    # ladder) — no plan clones leased. Forward groups by
                    # scaling (the batched program is scaling-specialized);
                    # the tuner-owned cap chunks oversized batches.
                    for chunk in _batch_chunks(
                        survivors, self._batch_cap(entry)
                    ):
                        deadlines = [r.deadline for r in chunk]
                        # no bucket padding here (unlike run_batch's fused
                        # arm): the scheduler's demote rung and split-phase
                        # fallback iterate the payload per request, so pad
                        # rows would be recomputed on the already-degraded
                        # path — sched mode accepts per-size specialization
                        tid = graph.add(
                            chunk[0].direction,
                            payload=[r.payload for r in chunk],
                            scaling=chunk[0].scaling, transform=entry.plan,
                            # the TASK deadline is the latest in the chunk (a
                            # batch must not shed early for its most urgent
                            # member); each member's OWN deadline is
                            # re-checked at resolution below, so coalescing
                            # never weakens the per-request contract
                            deadline=None
                            if any(d is None for d in deadlines)
                            else max(deadlines),
                            batch=True,
                        )
                        jobs.append((tid, chunk, engine, supervised, True))
                    continue
                plans = entry.lease(len(survivors), self._clone_plan)
                for plan, req in zip(plans, survivors):
                    tid = graph.add(
                        req.direction, payload=req.payload,
                        scaling=req.scaling, transform=plan,
                        deadline=req.deadline,
                    )
                    jobs.append((tid, [req], engine, supervised, False))
            if not jobs:
                return  # the finally releases any held probes verdict-less
            obs.trace.event(
                "serve", what="dispatch", engine="sched",
                occupancy=len(jobs), attempt=0,
            )
            for _tid, reqs, _engine, _supervised, _is_batch in jobs:
                for req in reqs:
                    req.ticket.stamp("dispatched")
            with faults.typed_execution(platform, "serve dispatch"):
                faults.site("serve.dispatch")
                report = sched.run_graph(
                    graph, retries=self.retries, demote=True,
                    on_error="resolve", backoff_s=self.backoff_s,
                    backoff_rng=self._retry_rng,
                )
            for tid, reqs, engine, supervised, is_batch in jobs:
                outcome = report.outcomes[tid]
                err = report.errors.get(tid)
                if outcome in ("completed", "demoted"):
                    result = report.results[tid]
                    # batch tasks resolve a request-aligned result list;
                    # per-request tasks wrap their single result
                    results = result if is_batch else [result]
                    if outcome == "demoted":
                        # the scheduler's reference rung answered: correct
                        # data over a failed primary — an engine-health signal
                        if not supervised:
                            engines[engine]["failed"] = True
                    now = time.monotonic()
                    for req, res in zip(reqs, results):
                        if is_batch and req.expired(now):
                            # the batch task ran under its LATEST member's
                            # deadline; a member whose own deadline expired
                            # meanwhile keeps the per-request contract —
                            # deadline_miss, exactly as if it had been shed
                            # pre-dispatch (per-request tasks enforce this
                            # inside the executor instead)
                            obs.counter(
                                "serve_deadline_misses_total",
                                tenant=req.tenant,
                            ).inc()
                            obs.counter(
                                "serve_sheds_total", reason="deadline"
                            ).inc()
                            obs.trace.event(
                                "serve", what="shed", reason="deadline",
                                tenant=req.tenant,
                            )
                            if req.ticket.fail(
                                DeadlineExceededError(
                                    "request deadline expired inside a "
                                    "batched dispatch"
                                ),
                                outcome="deadline_miss",
                            ):
                                self._count("deadline_miss", req.tenant)
                            continue
                        if req.direction == "forward":
                            res = _to_request_order(req, res)
                        if outcome == "demoted":
                            self._count_only("demoted")
                            obs.counter(
                                "serve_demotions_total", engine=engine
                            ).inc()
                            obs.trace.event(
                                "serve", what="demote", engine=engine,
                                tenant=req.tenant,
                            )
                        if req.ticket.resolve(res):
                            self._observe_completion(req)
                elif isinstance(err, DeadlineExceededError):
                    # expired between retry attempts inside the executor:
                    # the same accounting as a pre-dispatch shed — and NOT
                    # an engine-health failure
                    for req in reqs:
                        obs.counter(
                            "serve_deadline_misses_total", tenant=req.tenant
                        ).inc()
                        obs.counter(
                            "serve_sheds_total", reason="deadline"
                        ).inc()
                        obs.trace.event(
                            "serve", what="shed", reason="deadline",
                            tenant=req.tenant,
                        )
                        if req.ticket.fail(err, outcome="deadline_miss"):
                            self._count("deadline_miss", req.tenant)
                else:
                    if not supervised:
                        engines[engine]["failed"] = True
                    err = (
                        as_typed(err, platform) if err is not None
                        else ServiceOverloadError("scheduled task unresolved")
                    )
                    for req in reqs:
                        if req.ticket.fail(err):
                            self._count("failed", req.tenant)
            # settle the breakers with this cycle's verdicts (supervised
            # plans' supervisors already reported theirs)
            settled = True
            for engine, state in engines.items():
                if state["supervised"]:
                    continue
                if state["failed"]:
                    breaker.record_failure(engine)
                else:
                    breaker.record_success(engine)
        finally:
            if not settled:
                for engine, state in engines.items():
                    if not state["supervised"]:
                        breaker.release_probe(engine)

    def _batch_cap(self, entry):
        """The tuner-owned fused batch size of one cache entry (``None`` =
        uncapped), resolved lazily on the entry's first dispatch through the
        ``fused/bN`` wisdom axis (:func:`spfft_tpu_torch.tuning.tuned_batch`) —
        zero trials on a warm store, model fallback (uncapped) where trials
        are skipped. Entries outside the tuned policy, or without a live
        batch-fused path, stay uncapped for free."""
        from .batcher import _UNSET

        if entry.batch_cap is not _UNSET:
            return entry.batch_cap
        plan = entry.plan
        cap, record = None, None
        if (
            getattr(plan, "_policy", "default") == "tuned"
            and plan._verifier is None
            and plan._exec._ir.batch_available()
        ):
            from .. import tuning

            choice, record = tuning.tuned_batch(
                plan, batch_max=self.batch_max
            )
            cap = choice.get("batch")
        entry.batch_cap = cap
        entry.batch_record = record
        return cap

    def _shed_expired(self, batch: list) -> list:
        now = time.monotonic()
        survivors = []
        for req in batch:
            if req.expired(now):
                obs.counter(
                    "serve_deadline_misses_total", tenant=req.tenant
                ).inc()
                obs.counter("serve_sheds_total", reason="deadline").inc()
                obs.trace.event("serve", what="shed", reason="deadline",
                                tenant=req.tenant)
                if req.ticket.fail(
                    DeadlineExceededError(
                        "request expired while queued; shed pre-dispatch"
                    ),
                    outcome="deadline_miss",
                ):
                    self._count("deadline_miss", req.tenant)
            else:
                survivors.append(req)
        return survivors

    def _breaker_response(self, batch: list, engine: str, entry) -> None:
        if self.on_breaker == "shed":
            obs.counter("serve_sheds_total", reason="breaker_open").inc()
            err = ServiceOverloadError(
                f"engine {engine!r} circuit breaker open; shedding"
            )
            for req in batch:
                obs.trace.event("serve", what="shed", reason="breaker_open",
                                tenant=req.tenant)
                if req.ticket.fail(err, outcome="shed"):
                    self._count("shed", req.tenant)
            return
        # demote: the torch.fft reference rung, per request (correctness over
        # batching on the degraded path), mirroring the verify supervisor
        platform = self._platform()
        for req in batch:
            obs.trace.event("serve", what="demote", engine=engine,
                            tenant=req.tenant)
            self._count_only("demoted")
            obs.counter("serve_demotions_total", engine=engine).inc()
            req.ticket.stamp("dispatched")
            try:
                with faults.typed_execution(platform, "serve demote"):
                    result = run_reference(entry.plan, req)
            except Exception as e:  # noqa: BLE001 — ticket must resolve
                if req.ticket.fail(as_typed(e, platform)):
                    self._count("failed", req.tenant)
                continue
            if req.ticket.resolve(result):
                self._observe_completion(req)

    def _observe_completion(self, req) -> None:
        self._count("completed", req.tenant)
        obs.counter(
            "serve_requests_total", tenant=req.tenant, outcome="completed"
        ).inc()
        latency = req.ticket.latency_s()
        if latency is not None:
            obs.histogram("serve_latency_seconds", tenant=req.tenant).observe(
                latency
            )
        # under the request's run ID: the dispatcher thread's completion
        # event joins the caller's trace (and rides the RPC reply segment
        # when the caller sits on another host)
        with obs.trace.with_run(req.run):
            obs.trace.event("serve", what="complete", tenant=req.tenant)

    # ---- bookkeeping ---------------------------------------------------------

    def _count(self, outcome: str, tenant: str) -> None:
        with self._counts_lock:
            self._counts[outcome] += 1
        if outcome != "admitted":
            obs.counter(
                "serve_requests_total", tenant=tenant, outcome=outcome
            ).inc()

    def _count_only(self, key: str) -> None:
        with self._counts_lock:
            self._counts[key] += 1

    def stats(self) -> dict:
        """JSON-plain service counters + queue state (the loadgen/CI
        surface; the obs registry carries the per-tenant breakdown)."""
        with self._counts_lock:
            counts = dict(self._counts)
        return {
            "counts": counts,
            "queue_depth": self.queue.depth(),
            "queue_high_water": self.queue.high_water,
            "queue_capacity": self.queue.capacity,
            "tenant_quota_slots": self.queue.quota,
            "batch_max": self.batch_max,
            "plan_cache_entries": len(self.plans),
            "on_breaker": self.on_breaker,
            "sched": self.sched,
            "sched_batches": self.sched_batches,
        }

    def describe(self) -> dict:
        """Service configuration + plan-cache inventory (each entry carries
        its plan's card run ID — the join key into metrics and traces) +
        the breaker state of every cached engine."""
        cache = self.plans.describe()
        engines = sorted({row["engine"] for row in cache})
        return {
            "config": {
                "queue_capacity": self.queue_capacity,
                "batch_max": self.batch_max,
                "tenant_quota_slots": self.queue.quota,
                "default_timeout_s": self.default_timeout_s,
                "retries": self.retries,
                "backoff_s": self.backoff_s,
                "on_breaker": self.on_breaker,
                "verify": str(self._plan_kwargs.get("verify")),
                "threaded": self._worker is not None,
                "sched": self.sched,
                "sched_batches": self.sched_batches,
                # the serving batch-fuse A/B flag (read at call time, so it
                # reflects the knob the NEXT dispatch cycle will honor)
                "batch_fuse": resolve_batch_fuse()[0],
            },
            "plan_cache": cache,
            "breakers": {e: breaker.describe(e) for e in engines},
            "stats": self.stats(),
        }

    # ---- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the service. ``drain=True`` lets the dispatcher finish the
        queue first; ``drain=False`` fails every pending ticket typed
        (``ServiceOverloadError``, reason ``closing``). Idempotent; pending
        tickets are never leaked either way."""
        self._closing = True
        # refuse further admissions under the queue's own lock FIRST: a
        # submit racing this close either enqueued before the flag (drained
        # below or finished by the worker) or fails typed — no ticket leaks
        self.queue.shut()
        if not drain:
            self._shed_closing()
        if self._worker is not None:
            self.queue.wake()
            self._worker.join(timeout)
            self._worker = None
        elif drain:
            self.pump()
        # whatever survived a non-draining close or a wedged worker fails
        # typed — the no-leaked-ticket contract
        self._shed_closing()

    def _shed_closing(self) -> None:
        for req in self.queue.drain():
            obs.counter("serve_sheds_total", reason="closing").inc()
            if req.ticket.fail(
                ServiceOverloadError("service closed before dispatch"),
                outcome="shed",
            ):
                self._count("shed", req.tenant)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _batch_chunks(requests: list, cap) -> list:
    """Split one coalesced batch into batch-task chunks: grouped by scaling
    (the batched forward program is scaling-specialized; backward groups
    are trivially uniform), then cut to the tuner-owned cap."""
    groups: dict = {}
    for r in requests:
        groups.setdefault((r.direction, r.scaling), []).append(r)
    chunks = []
    for reqs in groups.values():
        step = len(reqs) if not cap else max(1, int(cap))
        for i in range(0, len(reqs), step):
            chunks.append(reqs[i : i + step])
    return chunks

