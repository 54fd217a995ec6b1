"""Bounded admission queue: backpressure, deadlines, quotas, fair-share shed.

The port of ``spfft_tpu/serve/queue.py``, pure host code: the front door of
the serving layer (:mod:`spfft_tpu_torch.serve`). Its defining
property is that it is *bounded*: under overload the queue converts excess
offered load into immediate typed :class:`ServiceOverloadError` rejections —
explicit backpressure the caller can act on — instead of unbounded queueing
latency (the queue-and-die failure mode the DaggerFFT/AccFFT serving framing
warns about). Four admission rules, in order:

1. **Deadline** — a request whose deadline already passed is refused with
   :class:`DeadlineExceededError` (it would only be shed later anyway).
2. **Tenant quota** — one tenant may hold at most ``quota`` queued slots
   (``SPFFT_TPU_SERVE_TENANT_QUOTA`` x capacity): a single runaway caller
   cannot fill the queue however fast it submits.
3. **Fair-share shed** — when the queue is full but the submitting tenant
   holds less than its fair share (capacity / active tenants), the *newest*
   queued request of the most-loaded tenant is shed (its ticket fails typed
   with reason ``fair_share``) to make room: a noisy tenant cannot starve a
   quiet one. Newest-first eviction preserves the victim tenant's oldest
   (closest-to-dispatch) work.
4. **Capacity** — otherwise a full queue refuses with reason ``queue_full``.

The ``serve.admit`` fault site fires inside :meth:`AdmissionQueue.admit`
(payload: the request's mapped values), so chaos runs prove an admission
machinery failure surfaces as a typed rejection, never a hang or a silently
dropped request.
"""
from __future__ import annotations

import collections
import threading
import time

from .. import faults, obs
from ..errors import InvalidParameterError
from .errors import DeadlineExceededError, ServiceOverloadError

# End-to-end request phases, in stamp order. Each ticket records the
# monotonic time it REACHED a phase (first stamp wins); the deltas between
# adjacent present stamps feed ``serve_phase_seconds{phase}`` at resolution
# so overload p99 attributes to WHERE latency lives — queue wait
# (``coalesced``), batch formation (``dispatched``), the cross-host round
# trip (``wire``/``remote_execute``), or resolution (``finalized``). The
# in-process path simply never stamps the wire phases; the histogram family
# and :meth:`Ticket.timeline` skip absent stamps.
PHASES = (
    "admitted", "coalesced", "dispatched", "wire", "remote_execute",
    "finalized",
)


class Ticket:
    """Completion handle of one admitted request.

    Resolved exactly once — with a value (:meth:`resolve`) or a typed error
    (:meth:`fail`); :meth:`result` blocks until then. The serving layer's
    no-deadlock contract is that every admitted request's ticket is resolved
    on every path (completion, shed, deadline, execution failure, service
    close).

    Carries the request's trace run ID (``run``) and monotonic phase stamps
    (:data:`PHASES`): :meth:`stamp` is called by the admission queue, the
    coalescer, the dispatcher and the RPC plane as the request moves, and
    resolution observes the per-phase deltas into
    ``serve_phase_seconds{phase}`` and freezes :meth:`timeline`."""

    __slots__ = (
        "tenant", "submitted_at", "finished_at", "outcome", "run", "stamps",
        "_event", "_value", "_error", "_lock",
    )

    def __init__(self, tenant: str, run: str | None = None):
        self.tenant = tenant
        self.submitted_at = time.monotonic()
        self.finished_at = None
        self.outcome = None  # one of serve.errors.OUTCOMES once resolved
        self.run = run  # trace run ID (card <-> metrics <-> trace join key)
        self.stamps = {}  # phase name -> monotonic ts (PHASES subset)
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._lock = threading.Lock()

    def stamp(self, phase: str) -> None:
        """Record the monotonic time this ticket reached ``phase``. First
        stamp per phase wins (a retry re-crossing the wire keeps the
        original transition time — stamps stay monotonic in PHASES order);
        unknown phases are refused typed so the vocabulary stays closed."""
        if phase not in PHASES:
            raise InvalidParameterError(
                f"unknown ticket phase {phase!r} (one of {PHASES})"
            )
        self.stamps.setdefault(phase, time.monotonic())

    def timeline(self) -> list:
        """The request's phase timeline: ``[{"phase", "t"}]`` rows in
        :data:`PHASES` order, ``t`` = seconds since submission. Absent
        phases (e.g. the wire stamps of an in-process request) are
        omitted; complete once the ticket resolved."""
        return [
            {"phase": phase, "t": self.stamps[phase] - self.submitted_at}
            for phase in PHASES
            if phase in self.stamps
        ]

    def phase_seconds(self) -> dict:
        """Seconds between adjacent present stamps, keyed by the phase
        REACHED (the ``serve_phase_seconds`` labeling: ``coalesced`` is
        queue wait, ``remote_execute`` is the cross-host round trip)."""
        out = {}
        prev = None
        for phase in PHASES:
            ts = self.stamps.get(phase)
            if ts is None:
                continue
            if prev is not None:
                out[phase] = max(0.0, ts - prev)
            prev = ts
        return out

    def resolve(self, value) -> bool:
        """First-resolution-wins; returns whether THIS call resolved the
        ticket (resolution can race between the dispatcher and queue-side
        shedding, and outcome accounting must count each request once)."""
        return self._finish("completed", value=value)

    def fail(self, error: BaseException, outcome: str = "failed") -> bool:
        """Typed-failure counterpart of :meth:`resolve` (same contract)."""
        return self._finish(outcome, error=error)

    def _finish(self, outcome: str, value=None, error=None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._error = error
            self.finished_at = time.monotonic()
            self.stamps.setdefault("finalized", self.finished_at)
            self.outcome = outcome
            self._event.set()
        # phase observation OUTSIDE the ticket lock (registry locks must
        # never nest under resolution — same rule as waiter callbacks)
        for phase, seconds in self.phase_seconds().items():
            obs.histogram("serve_phase_seconds", phase=phase).observe(seconds)
        return True

    def done(self) -> bool:
        return self._event.is_set()

    def latency_s(self) -> float | None:
        """Submit-to-resolution wall seconds (None while pending)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def result(self, timeout: float | None = None):
        """Block until resolved; returns the value or raises the typed
        error. ``timeout`` raises builtin ``TimeoutError`` (the ticket stays
        pending — the request is still owned by the service)."""
        if not self._event.wait(timeout):
            # documented builtin contract: callers polling a ticket catch
            # concurrent.futures-style TimeoutError, and the request stays
            # owned by the service (not a failure of it)
            raise TimeoutError("serving request still pending")  # noqa: SA010
        if self._error is not None:
            raise self._error
        return self._value


class Request:
    """One admitted unit of work, carrying everything the batcher needs."""

    __slots__ = (
        "tenant", "direction", "scaling", "plan_key", "payload", "order_map",
        "deadline", "run", "ticket",
    )

    def __init__(
        self, *, tenant, direction, scaling, plan_key, payload, order_map,
        deadline, run=None,
    ):
        self.tenant = str(tenant)
        self.direction = direction          # "backward" | "forward"
        self.scaling = scaling              # ScalingType (forward only)
        self.plan_key = plan_key            # plan-cache digest (coalesce key)
        self.payload = payload              # mapped values / space slab
        self.order_map = order_map          # plan order -> request order, or None
        self.deadline = deadline            # absolute monotonic, or None
        self.run = run                      # trace run ID (join key), or None
        self.ticket = Ticket(self.tenant, run=run)

    def expired(self, now: float | None = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    def group(self) -> tuple:
        """Coalescing identity: requests in one batched execution share a
        plan-cache entry and a direction (scaling rides per-request)."""
        return (self.plan_key, self.direction)


class AdmissionQueue:
    """Bounded FIFO with per-tenant accounting and same-geometry batch pop."""

    def __init__(self, capacity: int, tenant_quota: float):
        if capacity < 1:
            raise InvalidParameterError("admission queue capacity must be >= 1")
        if not 0.0 < tenant_quota <= 1.0:
            raise InvalidParameterError(
                f"tenant quota must be in (0, 1], got {tenant_quota}"
            )
        self.capacity = int(capacity)
        self.quota = max(1, int(round(self.capacity * float(tenant_quota))))
        self._cond = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._per_tenant: collections.Counter = collections.Counter()
        self.high_water = 0  # max depth ever observed (boundedness evidence)
        self.on_shed = None  # optional (tenant) callback for queue-side sheds
        self.closed = False  # set under the lock by shut(); admit() refuses

    # ---- depth accounting ---------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def tenant_depth(self, tenant: str) -> int:
        with self._cond:
            return self._per_tenant.get(str(tenant), 0)

    def _gauge(self) -> None:
        depth = len(self._pending)
        if depth > self.high_water:
            self.high_water = depth
        obs.gauge("serve_queue_depth").set(depth)

    # ---- admission ----------------------------------------------------------

    def admit(self, request: Request) -> None:
        """Apply the admission rules (module docstring); raises typed on
        refusal, otherwise enqueues and wakes the dispatcher. A fair-share
        eviction resolves the victim's ticket *outside* the queue lock."""
        # the admission machinery's own fault site, OUTSIDE the queue lock
        # (a delay-kind injection must stall only this submitter, never the
        # dispatcher or other tenants): an injected failure surfaces as a
        # typed rejection (the service converts InjectedFault), and nan/
        # corrupt kinds poison the payload so guard/verify layers downstream
        # prove they catch a poisoned admission
        request.payload = faults.site("serve.admit", payload=request.payload)
        shed_victim = None
        try:
            with self._cond:
                if self.closed:
                    # checked under the SAME lock shut() takes: a submit
                    # racing close() either lands before the flag (and is
                    # drained/dispatched by close) or is refused typed here
                    # — an admitted-but-never-resolved ticket is impossible
                    obs.counter("serve_sheds_total", reason="closing").inc()
                    raise ServiceOverloadError("service is closing")
                now = time.monotonic()
                if request.expired(now):
                    raise DeadlineExceededError(
                        "request deadline expired before admission"
                    )
                tenant = request.tenant
                if self._per_tenant[tenant] >= self.quota:
                    obs.counter("serve_sheds_total", reason="tenant_quota").inc()
                    raise ServiceOverloadError(
                        f"tenant {tenant!r} is over its queue quota "
                        f"({self.quota} of {self.capacity} slots)"
                    )
                if len(self._pending) >= self.capacity:
                    shed_victim = self._fair_share_victim(tenant)
                    if shed_victim is None:
                        obs.counter("serve_sheds_total", reason="queue_full").inc()
                        raise ServiceOverloadError(
                            f"admission queue full ({self.capacity} requests)"
                        )
                    self._pending.remove(shed_victim)
                    self._per_tenant[shed_victim.tenant] -= 1
                    obs.counter("serve_sheds_total", reason="fair_share").inc()
                self._pending.append(request)
                self._per_tenant[tenant] += 1
                request.ticket.stamp("admitted")
                self._gauge()
                self._cond.notify_all()
        finally:
            if shed_victim is not None:
                # ticket resolution can run arbitrary waiter code: never
                # under the queue lock
                obs.trace.event(
                    "serve", what="shed", reason="fair_share",
                    tenant=shed_victim.tenant,
                )
                if shed_victim.ticket.fail(
                    ServiceOverloadError(
                        f"shed under overload: tenant {shed_victim.tenant!r} "
                        "over fair share"
                    ),
                    outcome="shed",
                ) and self.on_shed is not None:
                    self.on_shed(shed_victim.tenant)

    def _fair_share_victim(self, newcomer_tenant: str):
        """The newest queued request of the most-loaded tenant, IF that
        tenant is over the current fair share and the newcomer is under it;
        None when the newcomer has no shedding claim (it is the hog, or load
        is balanced)."""
        counts = {t: c for t, c in self._per_tenant.items() if c > 0}
        if not counts:
            return None
        # the newcomer is an active claimant even while holding zero slots —
        # that is exactly the starvation case fair-share shedding exists for
        active = len(counts) + (0 if counts.get(newcomer_tenant) else 1)
        fair = max(1, self.capacity // max(active, 1))
        hog, hog_count = max(counts.items(), key=lambda kv: kv[1])
        if hog == newcomer_tenant or hog_count <= fair:
            return None
        if self._per_tenant[newcomer_tenant] >= fair:
            return None
        for req in reversed(self._pending):
            if req.tenant == hog:
                return req
        return None

    # ---- dispatch side ------------------------------------------------------

    def pop_batch(self, batch_max: int, timeout: float | None = None) -> list:
        """Pop the oldest request plus up to ``batch_max - 1`` younger
        requests sharing its coalescing group (same plan-cache key and
        direction), preserving FIFO order within the group. Blocks up to
        ``timeout`` for work; returns [] on timeout/empty wake."""
        with self._cond:
            if not self._pending:
                self._cond.wait(timeout)
            if not self._pending:
                return []
            head = self._pending[0]
            group = head.group()
            batch = []
            for req in list(self._pending):
                if len(batch) >= max(1, int(batch_max)):
                    break
                if req.group() == group:
                    batch.append(req)
            for req in batch:
                self._pending.remove(req)
                self._per_tenant[req.tenant] -= 1
                req.ticket.stamp("coalesced")
            self._gauge()
            return batch

    def drain(self) -> list:
        """Remove and return every pending request (service shutdown)."""
        with self._cond:
            batch = list(self._pending)
            self._pending.clear()
            self._per_tenant.clear()
            self._gauge()
            return batch

    def shut(self) -> None:
        """Refuse all further admissions (typed) and wake the dispatcher —
        the first step of service close, taken under the queue lock so no
        submit can slip in after the final drain."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def wake(self) -> None:
        """Wake any dispatcher blocked in :meth:`pop_batch` (shutdown)."""
        with self._cond:
            self._cond.notify_all()
