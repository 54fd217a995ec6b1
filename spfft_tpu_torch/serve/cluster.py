"""Multi-host serving that survives host loss: heartbeats, requeue, typing.

The port of ``spfft_tpu/serve/cluster.py``. The cross-host front of the
serving layer (the DaggerFFT distributed task-scheduling shape, arxiv
2601.12209): a
:class:`ClusterFront` owns one bounded admission queue — so admission,
per-tenant quotas, deadlines and fair-share shedding span the whole fleet —
and dispatches coalesced same-geometry chunks to worker hosts (each one a
:class:`~spfft_tpu_torch.serve.service.TransformService` behind a
:class:`~spfft_tpu_torch.serve.rpc.RpcServer`) through the task-graph scheduler.
Three pieces make host death a *typed, recoverable* event instead of an
untyped hang:

1. **Liveness** (:class:`HeartbeatMonitor`): one daemon thread pings every
   live host each ``SPFFT_TPU_HOSTS_HEARTBEAT_S`` interval (inter-sweep
   sleeps jittered ×[0.5, 1.5) so fleet heartbeats never synchronize);
   ``SPFFT_TPU_HOSTS_HEARTBEAT_MISSES`` consecutive failures declare the
   host lost (``hosts_lost_total{host}``). A dead transport on a live
   dispatch declares it immediately — the monitor is the *slow-path*
   detector for hosts that die while idle.
2. **Requeue** (:class:`RemotePlan` + the scheduler's ``host_lost`` rung):
   dispatches cross the wire as scheduler tasks whose plan is a
   :class:`RemotePlan`; a transport death surfaces as typed
   :class:`~spfft_tpu_torch.errors.HostLostError`, and
   :mod:`spfft_tpu_torch.sched.executor` requeues the in-flight task onto a
   surviving host (``rehost()``, bounded by ``SPFFT_TPU_HOSTS_RETRIES``
   with jittered ``SPFFT_TPU_HOSTS_BACKOFF_S`` backoff) before resolving
   it typed with the ``host_lost`` outcome — dependents cascade
   ``upstream_failed`` exactly like any other failed dependency.
3. **Accounting**: every admitted request's ticket resolves on every path
   (the serving layer's no-deadlock contract, now spanning processes);
   ``offered == completed + refused + failed`` holds exactly through a
   SIGKILLed worker (``tests/test_torch_cluster.py`` proves it), every
   ``host_lost``
   rung lands on the geometry entry's card and in the degradation
   counters.

The ``rpc.submit`` fault site fires in the dispatch path and
``host.heartbeat`` in the monitor's probe path, so worker-kill chaos is a
first-class armed scenario.

**Cross-host observability**: the front mints one trace run ID per admitted request and ships it on the
wire (``runs`` in the ``submit_batch`` frame); the worker records its spans
under that key and the reply carries back a compact trace *segment* per
request, which :meth:`RemotePlan._finalize` splices into the front's own
flight recorder tagged ``host=`` — one ``trace.snapshot()`` on the front
shows both sides of every dispatch under the submitting request's run ID.
Tickets carry monotonic phase stamps (``admitted -> coalesced ->
dispatched -> wire -> remote_execute -> finalized``) feeding the
``serve_phase_seconds{phase}`` histograms, and :meth:`ClusterFront.describe`
joins a fleet metrics document (:func:`spfft_tpu_torch.obs.fleet.fleet_snapshot`
over the ``metrics`` RPC op, lost hosts skipped typed).

The front converts its own failures (a dead RPC call's untyped escape, its
dispatcher's catch-all) with its ``platform``, the workers' platform, where
the JAX front says ``"cpu"``: an execution failure of a fleet on the card is
``GPUFFTError``. Results arrive as host numpy arrays.
"""
from __future__ import annotations

import collections
import hashlib
import random
import threading
import time

import numpy as np
import torch

from .. import faults, knobs, obs, sched
from ..errors import (
    GenericError,
    HostLostError,
    InvalidParameterError,
)
from ..types import ScalingType, TransformType
from .errors import DeadlineExceededError, ServiceOverloadError, as_typed
from .queue import AdmissionQueue, Request
from .rpc import RpcClient
from .service import (
    SERVE_BACKOFF_ENV,
    SERVE_BATCH_MAX_ENV,
    SERVE_QUEUE_CAP_ENV,
    SERVE_RETRIES_ENV,
    SERVE_TENANT_QUOTA_ENV,
    SERVE_TIMEOUT_ENV,
    _batch_chunks,
)

HEARTBEAT_ENV = "SPFFT_TPU_HOSTS_HEARTBEAT_S"
HEARTBEAT_MISSES_ENV = "SPFFT_TPU_HOSTS_HEARTBEAT_MISSES"
HOST_RETRIES_ENV = "SPFFT_TPU_HOSTS_RETRIES"
HOST_BACKOFF_ENV = "SPFFT_TPU_HOSTS_BACKOFF_S"


class HostHandle:
    """One worker host: its RPC client plus liveness state."""

    def __init__(self, name: str, address: str, *, timeout_s=None):
        self.name = str(name)
        self.address = str(address)
        self.client = RpcClient(address, timeout_s=timeout_s)
        self._lock = threading.Lock()
        self.lost = False
        self.lost_reason = None
        self.misses = 0

    def beat_ok(self) -> None:
        with self._lock:
            self.misses = 0

    def beat_missed(self) -> int:
        with self._lock:
            self.misses += 1
            return self.misses

    def mark_lost(self, reason: str) -> bool:
        """Idempotent; True when THIS call transitioned the host to lost."""
        with self._lock:
            if self.lost:
                return False
            self.lost = True
            self.lost_reason = str(reason)
            return True

    def describe(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "address": self.address,
                "lost": self.lost,
                "lost_reason": self.lost_reason,
                "heartbeat_misses": self.misses,
            }


class HeartbeatMonitor:
    """Jittered liveness sweeps over a :class:`ClusterFront`'s hosts.

    One daemon thread; each sweep pings every not-yet-lost host with the
    sweep interval as the probe's wall deadline (bounded waits everywhere),
    counts ``host_heartbeats_total{verdict}``, and declares a host lost
    after the configured consecutive misses. The ``host.heartbeat`` fault
    site fires before each probe, so chaos runs exercise the miss ladder
    without a real dead host."""

    def __init__(self, front, *, interval_s=None, misses=None):
        self.front = front
        self.interval_s = knobs.get_float(HEARTBEAT_ENV, interval_s)
        self.misses = knobs.get_int(HEARTBEAT_MISSES_ENV, misses)
        self._stop = threading.Event()
        self._rng = random.Random()
        self._started = False
        self._thread = threading.Thread(
            target=self._loop, name="spfft-host-heartbeat", daemon=True
        )

    def start(self) -> None:
        self._started = True
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(2.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            for handle in self.front.hosts:
                if handle.lost or self._stop.is_set():
                    continue
                try:
                    faults.site("host.heartbeat")
                    handle.client.call(
                        {"op": "ping"}, timeout_s=self.interval_s
                    )
                except (GenericError, faults.InjectedFault) as e:
                    n = handle.beat_missed()
                    obs.counter(
                        "host_heartbeats_total", verdict="missed"
                    ).inc()
                    obs.trace.event(
                        "host", what="missed", host=handle.name, misses=n
                    )
                    if n >= self.misses:
                        self.front._mark_lost(
                            handle,
                            f"missed {n} consecutive heartbeats: "
                            f"{faults.summarize(e)}",
                        )
                else:
                    handle.beat_ok()
                    obs.counter("host_heartbeats_total", verdict="ok").inc()
            # jittered inter-sweep sleep: a fleet of fronts never herds its
            # probes (the backoff_s jitter rule, applied to liveness)
            self._stop.wait(self.interval_s * (0.5 + self._rng.random()))


class _RpcPending:
    """In-flight RPC dispatch: the scheduler's pending handle.

    Runs the blocking client call on its own daemon thread so the
    executor's dispatch returns immediately; ``is_ready()`` feeds the
    completion-order finalize poll, ``result()`` re-raises transport
    failures as :class:`HostLostError` and application failures as their
    own taxonomy members."""

    def __init__(self, client: RpcClient, msg: dict, timeout_s: float,
                 platform: str = "cpu"):
        self._client = client
        self._msg = msg
        self._timeout_s = float(timeout_s)
        self._platform = str(platform)
        self._event = threading.Event()
        self._reply = None
        self._error = None
        self.expected = 0  # payload count; _finalize validates the reply
        self._thread = threading.Thread(
            target=self._run, name="spfft-rpc-call", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            self._reply = self._client.call(self._msg)
        except GenericError as e:
            self._error = e
        except Exception as e:  # noqa: BLE001 — count + convert: the
            # pending handle must NEVER swallow a failure (an unresolved
            # handle would wedge finalize), so anything unexpected becomes
            # the typed execution surface
            obs.counter("execution_failures_total", op="rpc pending").inc()
            self._error = as_typed(e, self._platform)
        finally:
            self._event.set()

    def is_ready(self) -> bool:
        return self._event.is_set()

    # the executor's readiness probe (a CUDA event's method name)
    query = is_ready

    def result(self) -> dict:
        if not self._event.wait(self._timeout_s + 1.0):
            raise HostLostError(
                f"host {self._client.address} RPC call outlived its "
                f"{self._timeout_s:.1f}s deadline"
            )
        if self._error is not None:
            raise self._error
        return self._reply


class RemotePlan:
    """Scheduler-compatible plan adapter executing on a remote host.

    Implements exactly the split-phase surface
    :mod:`spfft_tpu_torch.sched.executor` drives (``_dispatch_* / _finalize_*``,
    batch and single forms) by shipping the geometry entry's requests as
    one ``submit_batch`` RPC per dispatch, plus the ``rehost()`` hook the
    executor's ``host_lost`` rung calls to requeue in-flight work onto a
    surviving host. Unsupervised and unguarded by construction — the worker
    host's own service applies its ladder remotely."""

    _verifier = None
    _guard = False
    device = None

    @property
    def _platform(self) -> str:
        return self.front.platform

    def __init__(self, front, entry, handle: HostHandle, requests=None):
        self.front = front
        self.entry = entry
        self.handle = handle
        # the chunk's admitted requests, payload-aligned: their run IDs ride
        # the wire frame and their tickets take the wire/remote_execute
        # phase stamps (None for ad-hoc plans built without requests)
        self.requests = list(requests) if requests is not None else []

    # ---- host-loss requeue hook ---------------------------------------------

    def rehost(self, error) -> None:
        """Move this plan to a surviving host (the scheduler's requeue
        rung): marks the current host lost, picks a live one (typed
        :class:`HostLostError` when none remain), and records the
        ``host_lost`` rung on the geometry entry's card."""
        lost = self.handle
        self.front._mark_lost(lost, faults.summarize(error))
        self.handle = self.front._pick_host()
        self.entry.record_degradation(
            "host_lost",
            faults.summarize(error),
            host=lost.name,
            rehomed_to=self.handle.name,
        )

    # ---- dispatch/finalize surface ------------------------------------------

    def _msg(self, direction: str, payloads: list, scaling) -> dict:
        e = self.entry
        msg = {
            "op": "submit_batch",
            "transform_type": int(e.transform_type.value),
            "dims": list(e.dims),
            "indices": e.indices,
            "direction": direction,
            "scaling": int(ScalingType(scaling).value),
            "tenant": "cluster",
            "timeout_s": None,
            "payloads": [np.asarray(p) for p in payloads],
        }
        if len(self.requests) == len(payloads):
            # trace propagation: the worker records its spans under the
            # caller's run IDs and the reply carries them back as segments
            msg["runs"] = [r.run for r in self.requests]
        return msg

    def _dispatch(self, direction: str, payloads: list, scaling):
        # the RPC transport's fault checkpoint: an injected failure here
        # models the submit machinery dying and must degrade through the
        # scheduler's typed ladder (retry -> requeue -> host_lost)
        faults.site("rpc.submit")
        for req in self.requests:
            req.ticket.stamp("wire")  # first-wins: a rehosted re-dispatch
            # keeps the ORIGINAL time the request hit the wire
        pending = _RpcPending(
            self.handle.client,
            self._msg(direction, payloads, scaling),
            self.handle.client.timeout_s,
            self.front.platform,
        )
        pending.expected = len(payloads)
        return pending

    def _finalize(self, pending: _RpcPending) -> list:
        """The worker's per-entry reply, request-aligned: each member is a
        result array OR the member's own taxonomy error (held as a value —
        the front resolves tickets per member, so one refused request never
        discards or re-executes its completed peers). A malformed or
        short reply is a TRANSPORT failure (typed :class:`HostLostError`,
        feeding the requeue ladder): a results list shorter than the
        payloads sent would otherwise leave tail tickets unresolved
        forever."""
        from .rpc import raise_error_payload

        reply = pending.result()
        for req in self.requests:
            req.ticket.stamp("remote_execute")
        self._splice_spans(reply.get("spans"))
        results = reply.get("results")
        if not isinstance(results, list) or len(results) != pending.expected:
            got = len(results) if isinstance(results, list) else "no"
            raise HostLostError(
                f"host {pending._client.address} returned a malformed "
                f"submit_batch reply ({got} results for "
                f"{pending.expected} payloads)"
            )
        out = []
        for row in results:
            err = row.get("error")
            if err is not None:
                try:
                    raise_error_payload(err)
                except GenericError as e:
                    out.append(e)
                continue
            out.append(np.asarray(row["result"]))
        return out

    def _splice_spans(self, spans) -> None:
        """Splice the reply's remote trace segments into the front's flight
        recorder, tagged with the worker's host name (the cross-host run-ID
        join). Segments are advisory: a missing or malformed one never
        fails the request — splice() skips invalid events itself."""
        if not isinstance(spans, list):
            return
        n = 0
        for seg in spans:
            if seg:
                n += obs.trace.splice(seg, host=self.handle.name)
        if n:
            obs.counter(
                "remote_spans_spliced_total", host=self.handle.name
            ).inc(n)

    def _dispatch_backward_batch(self, payloads):
        return self._dispatch("backward", payloads, ScalingType.NONE)

    def _dispatch_forward_batch(self, payloads, scaling):
        return self._dispatch("forward", payloads, scaling)

    def _finalize_backward_batch(self, pending):
        return self._finalize(pending)

    def _finalize_forward_batch(self, pending):
        return self._finalize(pending)

    def _dispatch_backward(self, payload):
        return self._dispatch("backward", [payload], ScalingType.NONE)

    def _dispatch_forward(self, payload, scaling):
        return self._dispatch("forward", [payload], scaling)

    def _single(self, pending):
        value = self._finalize(pending)[0]
        if isinstance(value, GenericError):
            raise value
        return value

    def _finalize_backward(self, pending):
        return self._single(pending)

    def _finalize_forward(self, pending):
        return self._single(pending)


class _GeomEntry:
    """One coalescing geometry of the front: identity + card."""

    def __init__(self, digest, transform_type, dims, indices):
        self.digest = digest
        self.transform_type = transform_type
        self.dims = tuple(int(d) for d in dims)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self._lock = threading.Lock()
        self.card = {
            "digest": digest,
            "transform_type": transform_type.name,
            "dims": list(self.dims),
            "num_values": int(len(self.indices)),
            "degradations": [],
        }

    def record_degradation(self, event: str, reason: str, **extra) -> None:
        entry = faults.record_degradation(event, reason, **extra)
        with self._lock:
            self.card["degradations"].append(entry)

    def append_degradation(self, entry: dict) -> None:
        """Attach an already-recorded (counted/traced) degradation entry —
        a fleet-level event like a host loss lands on every geometry card
        without double-counting ``degradations_total``."""
        with self._lock:
            self.card["degradations"].append(dict(entry))

    def describe(self) -> dict:
        with self._lock:
            return {
                **{k: v for k, v in self.card.items() if k != "degradations"},
                "degradations": list(self.card["degradations"]),
            }


class ClusterFront:
    """Fleet-spanning admission + dispatch over RPC worker hosts.

    One bounded :class:`AdmissionQueue` (quotas, deadlines, fair-share
    shedding — the single backpressure surface of the whole fleet), one
    dispatcher (daemon thread, or caller-driven :meth:`pump`), one
    :class:`HeartbeatMonitor`. Coalesced same-geometry chunks execute as
    scheduler batch tasks on :class:`RemotePlan`\\ s spread round-robin over
    the live hosts; the scheduler owns per-task retries and the host-loss
    requeue ladder. Every ticket resolves typed on every path — a SIGKILLed
    worker mid-flight degrades through ``host_lost``, never an untyped
    hang."""

    def __init__(
        self,
        addresses,
        *,
        queue_capacity: int | None = None,
        tenant_quota: float | None = None,
        default_timeout_s: float | None = None,
        batch_max: int | None = None,
        retries: int | None = None,
        backoff_s: float | None = None,
        host_retries: int | None = None,
        host_backoff_s: float | None = None,
        heartbeat_s: float | None = None,
        heartbeat_misses: int | None = None,
        rpc_timeout_s: float | None = None,
        platform: str | None = None,
        start: bool = True,
    ):
        addresses = list(addresses)
        # where the workers run ("gpu" / "cpu"): None is the card where this
        # process sees one, else the CPU
        self.platform = (
            ("gpu" if torch.cuda.is_available() else "cpu")
            if platform is None else str(platform)
        )
        if not addresses:
            raise InvalidParameterError(
                "ClusterFront needs at least one worker host address"
            )
        self.hosts = [
            HostHandle(f"host{i}", addr, timeout_s=rpc_timeout_s)
            for i, addr in enumerate(addresses)
        ]
        self.queue_capacity = knobs.get_int(SERVE_QUEUE_CAP_ENV, queue_capacity)
        quota = knobs.get_float(SERVE_TENANT_QUOTA_ENV, tenant_quota)
        self.default_timeout_s = knobs.get_float(
            SERVE_TIMEOUT_ENV, default_timeout_s
        )
        self.batch_max = knobs.get_int(SERVE_BATCH_MAX_ENV, batch_max)
        self.retries = knobs.get_int(SERVE_RETRIES_ENV, retries)
        self.backoff_s = knobs.get_float(SERVE_BACKOFF_ENV, backoff_s)
        self.host_retries = knobs.get_int(HOST_RETRIES_ENV, host_retries)
        self.host_backoff_s = knobs.get_float(HOST_BACKOFF_ENV, host_backoff_s)
        self.queue = AdmissionQueue(self.queue_capacity, quota)
        self.queue.on_shed = lambda tenant: self._count("shed", tenant)
        self._entries: dict = {}
        self._entries_lock = threading.Lock()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._counts: collections.Counter = collections.Counter()
        self._counts_lock = threading.Lock()
        self.degradations: list = []
        self._deg_lock = threading.Lock()
        self._retry_rng = random.Random()
        self._closing = False
        self.monitor = HeartbeatMonitor(
            self, interval_s=heartbeat_s, misses=heartbeat_misses
        )
        self._worker = None
        if start:
            self.monitor.start()
            self._worker = threading.Thread(
                target=self._dispatch_loop,
                name="spfft-cluster-dispatch",
                daemon=True,
            )
            self._worker.start()

    # ---- host liveness -------------------------------------------------------

    def live_hosts(self) -> list:
        return [h for h in self.hosts if not h.lost]

    def _pick_host(self) -> HostHandle:
        """Round-robin over the live hosts; typed when none remain."""
        live = self.live_hosts()
        if not live:
            raise HostLostError(
                f"no live worker hosts remain (all {len(self.hosts)} lost)"
            )
        with self._rr_lock:
            handle = live[self._rr % len(live)]
            self._rr += 1
        return handle

    def _mark_lost(self, handle: HostHandle, reason: str) -> None:
        """Declare one host lost (idempotent): counted once, traced, a
        ``host_lost`` degradation recorded on the front."""
        if not handle.mark_lost(reason):
            return
        obs.counter("hosts_lost_total", host=handle.name).inc()
        obs.trace.event(
            "host", what="lost", host=handle.name, reason=str(reason)[:200]
        )
        entry = faults.record_degradation(
            "host_lost", str(reason), host=handle.name
        )
        with self._deg_lock:
            self.degradations.append(entry)
        # the rung lands on every geometry card: a host loss degrades the
        # whole fleet's capacity, and a capture's cards must show it even
        # when no in-flight chunk happened to be requeued
        with self._entries_lock:
            entries = list(self._entries.values())
        for geom in entries:
            geom.append_degradation(entry)
        handle.client.close()

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
    ):
        """Admit one request into the fleet; returns its ticket without
        waiting (the same contract as
        :meth:`~spfft_tpu_torch.serve.service.TransformService.submit`, minus
        plan building — workers own plans). Each request gets its own trace
        run ID: the worker host records its spans under the same key (the
        ``runs`` wire field) and the reply splices them back, so the
        request's whole cross-host life joins on one run."""
        tenant = str(tenant)
        run = obs.trace.new_run_id()
        try:
            if self._closing:
                obs.counter("serve_sheds_total", reason="closing").inc()
                raise ServiceOverloadError("cluster front is closing")
            if direction not in ("backward", "forward"):
                raise InvalidParameterError(
                    f"unknown direction {direction!r}: expected "
                    "backward/forward"
                )
            deadline = self._resolve_deadline(timeout_s)
            if deadline is not None and deadline <= time.monotonic():
                raise DeadlineExceededError(
                    "request deadline expired before admission"
                )
            ttype = TransformType(transform_type)
            dims = tuple(int(d) for d in dims)
            if len(dims) != 3:
                raise InvalidParameterError(
                    "dims must be (dim_x, dim_y, dim_z)"
                )
            entry = self._ensure_entry(ttype, dims, indices)
            payload = self._stage_payload(entry, direction, payload)
            request = Request(
                tenant=tenant, direction=direction,
                scaling=ScalingType(scaling), plan_key=entry.digest,
                payload=payload, order_map=None, deadline=deadline,
                run=run,
            )
            self.queue.admit(request)
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

    def _resolve_deadline(self, timeout_s):
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        timeout_s = float(timeout_s)
        if timeout_s <= 0:
            return None
        return time.monotonic() + timeout_s

    def _ensure_entry(self, ttype, dims, indices) -> _GeomEntry:
        trip = np.ascontiguousarray(indices, dtype=np.int32)
        if trip.ndim != 2 or trip.shape[1] != 3:
            raise InvalidParameterError(
                f"indices must be (V, 3) int triplets, got shape "
                f"{trip.shape}"
            )
        h = hashlib.sha1()
        h.update(ttype.name.encode())
        h.update(np.asarray(dims, dtype=np.int64).tobytes())
        h.update(trip.tobytes())
        digest = h.hexdigest()
        with self._entries_lock:
            entry = self._entries.get(digest)
            if entry is None:
                entry = _GeomEntry(digest, ttype, dims, trip)
                self._entries[digest] = entry
        return entry

    def _stage_payload(self, entry: _GeomEntry, direction: str, payload):
        if direction == "backward":
            values = np.asarray(payload).reshape(-1)
            if values.size != len(entry.indices):
                raise InvalidParameterError(
                    f"expected {len(entry.indices)} frequency values, got "
                    f"{values.size}"
                )
            return values
        space = np.asarray(payload)
        expect = int(np.prod(entry.dims))
        if space.size != expect:
            raise InvalidParameterError(
                f"expected a {entry.dims[2]}x{entry.dims[1]}x"
                f"{entry.dims[0]} space slab ({expect} elements), got "
                f"{space.size}"
            )
        return space.reshape(entry.dims[2], entry.dims[1], entry.dims[0])

    # ---- dispatch ------------------------------------------------------------

    def pump(self, max_batches: int | None = None) -> int:
        """Drain coalesced batches synchronously (``start=False`` fronts)."""
        if self._worker is not None and self._worker.is_alive():
            raise InvalidParameterError(
                "pump() on a threaded cluster front: the dispatcher owns "
                "the queue"
            )
        processed = 0
        while max_batches is None or processed < max_batches:
            limit = 2 * max(1, len(self.live_hosts()))
            if max_batches is not None:
                limit = min(limit, max_batches - processed)
            batches = self._pop_batches(limit, timeout=0.0)
            if not batches:
                break
            self._process(batches)
            processed += len(batches)
        return processed

    def _dispatch_loop(self) -> None:
        while True:
            batches = self._pop_batches(
                2 * max(1, len(self.live_hosts())), timeout=0.05
            )
            if not batches:
                if self._closing:
                    return
                continue
            self._process(batches)

    def _pop_batches(self, limit: int, timeout: float) -> list:
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

    def _process(self, batches: list) -> None:
        """One dispatch cycle, resolving every ticket (the catch-all
        no-deadlock contract of :meth:`TransformService._process_batch`,
        spanning hosts)."""
        try:
            self._process_inner(batches)
        except Exception as e:  # noqa: BLE001 — see _process_batch docstring
            err = as_typed(e, self.platform)
            for batch in batches:
                for req in batch:
                    if req.ticket.fail(err):
                        self._count("failed", req.tenant)

    def _process_inner(self, batches: list) -> None:
        graph = sched.TaskGraph()
        jobs = []
        for batch in batches:
            obs.counter("serve_batches_total").inc()
            survivors = self._shed_expired(batch)
            if not survivors:
                continue
            with self._entries_lock:
                entry = self._entries[batch[0].plan_key]
            for chunk in _batch_chunks(survivors, self.batch_max):
                try:
                    # one RemotePlan per chunk: no shared-object edges, so
                    # chunks spread across hosts and run concurrently
                    plan = RemotePlan(
                        self, entry, self._pick_host(), requests=chunk
                    )
                except HostLostError as e:
                    for req in chunk:
                        if req.ticket.fail(e):
                            self._count("failed", req.tenant)
                            self._count_only("host_lost")
                            # no survivors left: each request's trace still
                            # closes TYPED under its own run ID
                            with obs.trace.with_run(req.run):
                                obs.trace.event(
                                    "error", what="host_lost",
                                    tenant=req.tenant,
                                )
                    continue
                deadlines = [r.deadline for r in chunk]
                obs.histogram("serve_batch_occupancy").observe(len(chunk))
                tid = graph.add(
                    chunk[0].direction,
                    payload=[r.payload for r in chunk],
                    scaling=chunk[0].scaling,
                    transform=plan,
                    deadline=None
                    if any(d is None for d in deadlines)
                    else max(deadlines),
                    batch=True,
                )
                jobs.append((tid, chunk))
        if not jobs:
            return
        obs.trace.event(
            "serve", what="dispatch", engine="cluster", occupancy=len(jobs),
            attempt=0,
        )
        for _tid, chunk in jobs:
            for req in chunk:
                req.ticket.stamp("dispatched")
        report = sched.run_graph(
            graph, retries=self.retries, demote=False, on_error="resolve",
            backoff_s=self.backoff_s, backoff_rng=self._retry_rng,
            host_retries=self.host_retries,
            host_backoff_s=self.host_backoff_s,
        )
        for tid, chunk in jobs:
            outcome = report.outcomes[tid]
            err = report.errors.get(tid)
            if outcome == "completed":
                results = report.results[tid]
                now = time.monotonic()
                for req, res in zip(chunk, results):
                    if isinstance(res, GenericError):
                        # the member's OWN typed failure from the worker
                        # (refusal, deadline, execution error), held as a
                        # value so its completed peers resolve normally
                        if isinstance(res, DeadlineExceededError):
                            self._shed_one(req, res)
                        elif req.ticket.fail(res):
                            self._count("failed", req.tenant)
                        continue
                    if req.expired(now):
                        # the chunk ran under its LATEST member's deadline;
                        # an individually-expired member still lands as a
                        # deadline miss (the per-request contract)
                        self._shed_one(req)
                        continue
                    if req.ticket.resolve(res):
                        self._observe_completion(req)
            elif isinstance(err, DeadlineExceededError):
                for req in chunk:
                    self._shed_one(req, err)
            else:
                if outcome == "host_lost":
                    self._count_only("host_lost")
                    for req in chunk:
                        # the request's trace closes TYPED under its own
                        # run: a SIGKILLed worker reads as host_lost in the
                        # per-request timeline, never a silent gap
                        with obs.trace.with_run(req.run):
                            obs.trace.event(
                                "error", what="host_lost", tenant=req.tenant
                            )
                err = (
                    as_typed(err, self.platform) if err is not None
                    else ServiceOverloadError("cluster task unresolved")
                )
                for req in chunk:
                    if req.ticket.fail(err):
                        self._count("failed", req.tenant)

    def _shed_one(self, req, err=None) -> None:
        obs.counter("serve_deadline_misses_total", tenant=req.tenant).inc()
        obs.counter("serve_sheds_total", reason="deadline").inc()
        obs.trace.event(
            "serve", what="shed", reason="deadline", tenant=req.tenant
        )
        if req.ticket.fail(
            err
            if err is not None
            else DeadlineExceededError(
                "request deadline expired inside a cluster dispatch"
            ),
            outcome="deadline_miss",
        ):
            self._count("deadline_miss", req.tenant)

    def _shed_expired(self, batch: list) -> list:
        now = time.monotonic()
        survivors = []
        for req in batch:
            if req.expired(now):
                self._shed_one(req)
            else:
                survivors.append(req)
        return survivors

    def _observe_completion(self, req) -> None:
        self._count("completed", req.tenant)
        obs.counter(
            "serve_requests_total", tenant=req.tenant, outcome="completed"
        ).inc()
        latency = req.ticket.latency_s()
        if latency is not None:
            obs.histogram(
                "serve_latency_seconds", tenant=req.tenant
            ).observe(latency)
        # the dispatcher thread's completion event joins the caller's trace
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
        with self._counts_lock:
            counts = dict(self._counts)
        return {
            "counts": counts,
            "queue_depth": self.queue.depth(),
            "queue_high_water": self.queue.high_water,
            "queue_capacity": self.queue.capacity,
            "tenant_quota_slots": self.queue.quota,
            "batch_max": self.batch_max,
            "hosts": len(self.hosts),
            "hosts_live": len(self.live_hosts()),
            "hosts_lost": len(self.hosts) - len(self.live_hosts()),
        }

    def fleet_metrics(self, timeout_s: float | None = None) -> dict:
        """The fleet's merged metrics document: every live worker host's
        ``obs.snapshot()`` scraped over the ``metrics`` RPC op and folded
        into one host-labeled ``spfft_tpu.obs.fleet/1`` document (lost
        hosts stamped and skipped — see :mod:`spfft_tpu_torch.obs.fleet`)."""
        return obs.fleet.fleet_snapshot(self.hosts, timeout_s=timeout_s)

    def describe(self) -> dict:
        """Front configuration + host topology + per-geometry cards (each
        carrying its ``host_lost`` degradations) + the front-level
        degradation list + the merged fleet metrics document — the
        loadgen/CI provenance surface."""
        with self._entries_lock:
            entries = list(self._entries.values())
        with self._deg_lock:
            degradations = list(self.degradations)
        return {
            "config": {
                "queue_capacity": self.queue_capacity,
                "batch_max": self.batch_max,
                "tenant_quota_slots": self.queue.quota,
                "default_timeout_s": self.default_timeout_s,
                "retries": self.retries,
                "backoff_s": self.backoff_s,
                "host_retries": self.host_retries,
                "host_backoff_s": self.host_backoff_s,
                "heartbeat_s": self.monitor.interval_s,
                "heartbeat_misses": self.monitor.misses,
                "threaded": self._worker is not None,
                "platform": self.platform,
            },
            "hosts": [h.describe() for h in self.hosts],
            "plan_cards": [e.describe() for e in entries],
            "degradations": degradations,
            "stats": self.stats(),
            "fleet": self.fleet_metrics(),
        }

    # ---- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the front; pending tickets drain or fail typed, never leak
        (the service close contract)."""
        self._closing = True
        self.queue.shut()
        if not drain:
            self._shed_closing()
        if self._worker is not None:
            self.queue.wake()
            self._worker.join(timeout)
            self._worker = None
        elif drain:
            self.pump()
        self._shed_closing()
        self.monitor.stop()
        for h in self.hosts:
            h.client.close()

    def _shed_closing(self) -> None:
        for req in self.queue.drain():
            obs.counter("serve_sheds_total", reason="closing").inc()
            if req.ticket.fail(
                ServiceOverloadError("cluster front closed before dispatch"),
                outcome="shed",
            ):
                self._count("shed", req.tenant)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
