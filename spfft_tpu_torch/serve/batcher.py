"""Plan cache + same-geometry coalescing into batched executions.

The port of ``spfft_tpu/serve/batcher.py``. The throughput half of the
serving layer (AccFFT's framing: amortize fixed per-dispatch cost across
batched executions; arxiv 1506.07933): requests
whose sparse index sets share a stick layout resolve to ONE cached plan —
keyed like the tuning wisdom store (dims / transform type / dtype /
precision / platform / sparsity-signature digest,
:func:`spfft_tpu_torch.tuning.wisdom.key_digest`) — and a coalesced batch of them
executes through the task-graph scheduler (:func:`spfft_tpu_torch.sched.run_tasks`
over the same split-phase halves ``multi_transform`` pipelines: all
dispatches enqueued back-to-back, then finalized in completion order), so B
small transforms pay ~one dispatch latency instead of B.

Raggedness is handled at the *value-order* level: two callers with the same
index-triplet set pack their values in their own submission orders, so each
request carries a static whole-row permutation onto the plan's storage order
(:func:`spfft_tpu_torch.parallel.ragged.value_order_map` — the same
static-map-over-rows discipline as the exchange transports, applied to the
request axis). Backward inputs gather through it; forward outputs scatter
back through it.

Plans are built once per geometry key and **leased** per batch: each cached
entry holds the canonical plan plus up to ``batch_max - 1`` clones (a plan
object's retained space buffer is per-object state, so a batch needs one
object per in-flight request — the same rule that makes
``multi_transform_*`` reject duplicate transform objects). The cache is LRU
over whole entries (``SPFFT_TPU_SERVE_PLANS``).

The ``serve.batch`` fault site fires at batch assembly, so chaos runs prove
a blown-up coalesce/dispatch surfaces as typed ticket failures.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import threading

import numpy as np
import torch

from .. import faults, obs, sched
from ..tuning.wisdom import key_digest, sparsity_signature

# Bound on remembered per-caller value orderings per plan entry (each is one
# (V,) int array): callers with stable submission orders hit this cache on
# every request; an adversarial stream of novel orderings evicts FIFO
# instead of growing without bound.
ORDER_MAP_CACHE = 64

# Bound on the request geometries the submit path remembers (GeometryMemo):
# each entry holds two (V, 3) int64 arrays, the wrapped and the sorted
# triplets.
GEOMETRY_CACHE = 8


def wrap_triplets(indices, dims) -> np.ndarray:
    """(V, 3) triplets in storage form: centered (negative-frequency)
    coordinates wrapped modulo the dims — the representation the plans'
    storage-order triplets use, so order maps compare like with like.
    Wrapping never changes which frequency a value belongs to.

    Bounds are validated BEFORE wrapping against the union of the storage
    interval ``[0, dim)`` and the centered interval ``[dim//2 + 1 - dim,
    dim//2]`` (the package accepts both conventions per element): a typo'd
    out-of-range index must raise typed :class:`InvalidIndicesError` like
    the direct Transform path does, never silently alias onto the wrong
    frequency — the canonical plan is built from the wrapped form, which
    would otherwise bypass plan-construction validation entirely."""
    t = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    d = np.asarray([int(dims[0]), int(dims[1]), int(dims[2])], dtype=np.int64)
    lo = d // 2 + 1 - d  # centered minimum; storage minimum is 0
    hi = d - 1           # storage maximum; centered maximum is d // 2
    if t.size and bool(((t < lo[None, :]) | (t > hi[None, :])).any()):
        from ..errors import InvalidIndicesError

        bad = t[((t < lo[None, :]) | (t > hi[None, :])).any(axis=1)][0]
        raise InvalidIndicesError(
            f"frequency index triplet {tuple(int(v) for v in bad)} out of "
            f"bounds for dims {tuple(int(v) for v in d)}"
        )
    return np.mod(t, d[None, :])


def sort_triplets(wrapped: np.ndarray) -> np.ndarray:
    """Lexicographic sort of already-wrapped (V, 3) triplets — the sort half
    of :func:`canonical_triplets`, for callers (the submit hot path) that
    wrapped once and must not pay the bounds check twice."""
    return wrapped[np.lexsort((wrapped[:, 2], wrapped[:, 1], wrapped[:, 0]))]


def canonical_triplets(indices, dims) -> np.ndarray:
    """Wrapped, lexicographically sorted (V, 3) triplets — the geometry in
    layout- and sign-convention-independent form. Requests whose frequency
    SETS are equal share a canonical form, hence a plan-cache key, hence a
    coalesced batch."""
    return sort_triplets(wrap_triplets(indices, dims))


class GeometryMemo:
    """The submit path's memo of request geometries, a port addition: the
    caller's index array, keyed by the sha1 of its bytes, its dtype, shape
    and the dims, -> its wrapped triplets, their canonical sort and the two
    layout digests. A request of a geometry seen before then pays one hash
    of its indices where the JAX service checks, wraps, sorts and digests
    them again on every submit (about 48 ms a request at 128³ on the host of
    an H100 machine, ``PERF.md`` §6). Keyed by content, so an array the
    caller mutated in place is a new geometry; LRU over ``GEOMETRY_CACHE``."""

    def __init__(self, capacity: int = GEOMETRY_CACHE):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def resolve(self, indices, dims) -> tuple:
        """``(wrapped, canonical, canonical digest, wrapped digest)``."""
        raw = np.ascontiguousarray(indices)
        ident = (hashlib.sha1(raw.reshape(-1).view(np.uint8)).hexdigest(), raw.dtype.str,
                 raw.shape, tuple(int(d) for d in dims))
        with self._lock:
            hit = self._entries.get(ident)
            if hit is not None:
                self._entries.move_to_end(ident)
                return hit
        wrapped = wrap_triplets(raw, dims)
        canonical = sort_triplets(wrapped)
        hit = (wrapped, canonical, sparsity_signature(canonical), sparsity_signature(wrapped))
        with self._lock:
            self._entries[ident] = hit
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return hit

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class PlanEntry:
    """One cached geometry: the canonical plan, its clone pool, and the
    per-caller value-order maps.

    The clone pool exists for the split-phase loop only (B in-flight
    split-phase requests need B plan objects — retained-buffer state is
    per-object); leasing is LAZY, so batch-fused entries — whose whole batch
    runs through ONE stacked program on the canonical plan — never build the
    ``batch_max - 1`` clones they would never use."""

    __slots__ = (
        "plan", "clones", "order_maps", "storage_triplets",
        # tuner-owned fused batch size (spfft_tpu_torch.tuning.tuned_batch):
        # resolved lazily once per entry; _UNSET until then, then None
        # (uncapped) or the wisdom/trial-measured cap
        "batch_cap", "batch_record",
    )

    def __init__(self, plan):
        self.plan = plan
        self.clones: list = []
        self.order_maps: collections.OrderedDict = collections.OrderedDict()
        self.storage_triplets = plan._verify_triplets()
        self.batch_cap = _UNSET
        self.batch_record = None

    def lease(self, n: int, build_clone) -> list:
        """``n`` distinct plan objects for one batch (clone on demand)."""
        while 1 + len(self.clones) < n:
            self.clones.append(build_clone(self.plan))
        return [self.plan] + self.clones[: max(0, n - 1)]


_UNSET = object()  # PlanEntry.batch_cap sentinel (None is a valid cap)


class PlanCache:
    """LRU plan cache keyed like the wisdom store; thread-safe."""

    def __init__(self, build_plan, capacity: int):
        self._build = build_plan  # (canonical_triplets, key_dict) -> Transform
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._building: dict = {}  # digest -> per-build lock (see ensure)

    def key(self, transform_type, dims, canonical, *, dtype, precision,
            engine, platform, sticks=None) -> tuple:
        """(digest, key dict) of one request geometry — the same shape of
        key the wisdom store uses, so a serving fleet's plan population and
        its tuning wisdom line up one-to-one. ``sticks``: the canonical
        triplets' digest where the caller has it (:class:`GeometryMemo`)."""
        from ..types import TransformType

        key = {
            "kind": "serve.plan",
            "type": TransformType(transform_type).name,
            "dims": [int(d) for d in dims],
            "dtype": str(np.dtype(dtype)),
            "precision": str(precision),
            "engine": str(engine),
            "platform": str(platform),
            "sticks": sparsity_signature(canonical) if sticks is None else sticks,
        }
        return key_digest(key), key

    def ensure(self, digest: str, key: dict, canonical, request_triplets, order_sig=None):
        """Resolve ``digest`` to a (entry, order_map) pair, building the
        canonical plan on a miss and the caller's value-order map on first
        sight of its packing order.

        Plan construction (matrix uploads, kernel libraries) runs
        OUTSIDE the global cache lock under a per-digest build latch: one
        build per key, while cache hits for other geometries (and the
        dispatcher's lookups) proceed unblocked. Admission stays O(1)
        backpressure for every tenant not waiting on exactly this cold
        geometry."""
        entry = self._lookup(digest)
        if entry is None:
            with self._build_latch(digest):
                entry = self._lookup(digest)  # a racer may have built it
                if entry is None:
                    obs.counter("serve_plan_cache_total", event="miss").inc()
                    plan = self._build(canonical, key)  # no cache lock held
                    entry = PlanEntry(plan)
                    with self._lock:
                        entry = self._entries.setdefault(digest, entry)
                        self._entries.move_to_end(digest)
                        while len(self._entries) > self.capacity:
                            self._entries.popitem(last=False)
                            obs.counter(
                                "serve_plan_cache_total", event="evict"
                            ).inc()
        return entry, self._order_map(entry, request_triplets, order_sig)

    def _lookup(self, digest: str):
        """LRU-touching cache probe (counts a hit when found)."""
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                obs.counter("serve_plan_cache_total", event="hit").inc()
                self._entries.move_to_end(digest)
            return entry

    @contextlib.contextmanager
    def _build_latch(self, digest: str):
        """Per-digest mutex for the build path; dropped from the table once
        no builder holds it (the table stays bounded by in-flight builds)."""
        with self._lock:
            latch = self._building.setdefault(digest, threading.Lock())
        with latch:
            try:
                yield
            finally:
                with self._lock:
                    self._building.pop(digest, None)

    def _order_map(self, entry, request_triplets, order_sig=None):
        if order_sig is None:
            order_sig = sparsity_signature(request_triplets)
        # the map computation is O(V log V) numpy — done outside any lock,
        # with a double-checked insert (racers compute identical maps)
        with self._lock:
            src = entry.order_maps.get(order_sig)
            if src is not None:
                entry.order_maps.move_to_end(order_sig)
                return src
        from ..parallel.ragged import value_order_map

        src = value_order_map(entry.storage_triplets, request_triplets)
        if src is None:
            # cannot happen for equal-set triplets (the digest pinned the
            # canonical set) — guard against hash collisions
            from ..errors import InvalidParameterError

            raise InvalidParameterError(
                "plan-cache digest collision: triplet sets differ"
            )
        with self._lock:
            entry.order_maps[order_sig] = src
            entry.order_maps.move_to_end(order_sig)
            while len(entry.order_maps) > ORDER_MAP_CACHE:
                entry.order_maps.popitem(last=False)
        return src

    def get(self, digest: str):
        with self._lock:
            return self._entries.get(digest)

    def describe(self) -> list:
        """JSON-plain cache inventory: one row per entry with its wisdom-
        style key, pool width, and the plan's card run ID (the join key into
        metrics and traces)."""
        with self._lock:
            rows = []
            for digest, entry in self._entries.items():
                rows.append(
                    {
                        "digest": digest,
                        "plans": 1 + len(entry.clones),
                        "order_maps": len(entry.order_maps),
                        "run_id": entry.plan._run_id,
                        "engine": entry.plan._engine,
                        # tuner-owned fused batch cap: None = uncapped,
                        # "unresolved" = no batch dispatched yet
                        "batch_cap": (
                            "unresolved"
                            if entry.batch_cap is _UNSET
                            else entry.batch_cap
                        ),
                        # the cap's decision provenance (tuned entries only)
                        "batch_tuning": (
                            None
                            if entry.batch_record is None
                            else {
                                "provenance": entry.batch_record["provenance"],
                                "hit": entry.batch_record["hit"],
                                "choice": entry.batch_record["choice"],
                            }
                        ),
                    }
                )
            return rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def run_batch(entry, requests: list, build_clone, *, batch_cap=None) -> list:
    """Execute one coalesced batch; returns per-request results in request
    value order. Verified plans (``verify=`` armed) execute supervised
    per-request — the recovery ladder (retry -> torch.fft reference ->
    typed ``VerificationError``) must
    own each request's attempt. Unverified batches take the **batch-fused**
    path when it is live (``SPFFT_TPU_BATCH_FUSE``, :mod:`spfft_tpu_torch.ir`):
    the whole batch — every request already bridged into plan storage order
    — stacks into ONE program per direction on the canonical plan (on the
    card one CUDA-graph replay), in ``batch_cap``-sized chunks when the tuner capped the axis, with
    no plan clones leased at all. The rung below it is today's split-phase
    loop through the task-graph scheduler (:func:`spfft_tpu_torch.sched.run_tasks`
    on lazily-leased clones, completion-order finalize): a failed batched
    build records ``batch_fuse_failed`` on the plan card and the loop
    answers — never a failed batch. Failure semantics are unchanged: the
    scheduler runs without its own retry/demote rungs here
    (``on_error="raise"``) because the service's retry loop and breaker
    ladder own batch recovery."""
    faults.site("serve.batch")
    direction = requests[0].direction
    obs.histogram("serve_batch_occupancy").observe(len(requests))
    obs.trace.event(
        "serve", what="coalesce", direction=direction, occupancy=len(requests)
    )
    plan = entry.plan
    supervised = plan._verifier is not None
    if not supervised:
        outs = _run_batch_fused(plan, requests, direction, batch_cap)
        if outs is not None:
            return outs
    plans = entry.lease(len(requests), build_clone)
    if direction == "backward":
        if supervised:
            outs = [p.backward(r.payload) for p, r in zip(plans, requests)]
        else:
            # window = whole batch: every dispatch enqueues back-to-back
            # before any finalize (the one-dispatch-latency contract), even
            # when batch_max exceeds the scheduler's default window
            outs = sched.run_tasks(
                plans, "backward", [r.payload for r in requests],
                max_inflight=len(requests),
            )
        return outs
    if supervised:
        outs = [p.forward(r.payload, r.scaling) for p, r in zip(plans, requests)]
    else:
        outs = sched.run_tasks(
            plans, "forward", [r.payload for r in requests],
            [r.scaling for r in requests], max_inflight=len(requests),
        )
    return [_to_request_order(r, out) for r, out in zip(requests, outs)]


def _run_batch_fused(plan, requests: list, direction: str, cap) -> list | None:
    """The batch-fused arm of :func:`run_batch`: one stacked program
    dispatch per ``cap``-sized chunk (forward additionally groups by
    scaling — the program is scaling-specialized). Returns per-request
    results, or ``None`` when the path is unavailable or took its
    ``batch_fuse_failed`` rung mid-flight (the caller's split-phase loop
    then answers; partial chunk results are discarded — correctness over
    thrift on the degraded path)."""
    if not plan._exec._ir.batch_available():
        return None
    cap = len(requests) if not cap else max(1, int(cap))
    obs.trace.event(
        "serve", what="batch_fused", direction=direction,
        occupancy=len(requests), cap=cap,
    )
    if direction == "backward":
        outs = []
        for i in range(0, len(requests), cap):
            chunk = requests[i : i + cap]
            payloads, n = _bucket_pad([r.payload for r in chunk])
            res = plan.backward_batch(payloads, fallback=False, count=n)
            if res is None:
                return None
            outs.extend(res)
        return outs
    outs: list = [None] * len(requests)
    groups: dict = {}
    for idx, r in enumerate(requests):
        groups.setdefault(r.scaling, []).append(idx)
    for scaling, idxs in groups.items():
        for j in range(0, len(idxs), cap):
            sub = idxs[j : j + cap]
            payloads, n = _bucket_pad([requests[k].payload for k in sub])
            res = plan.forward_batch(payloads, scaling, fallback=False, count=n)
            if res is None:
                return None
            for k, out in zip(sub, res):
                outs[k] = _to_request_order(requests[k], out)
    return outs


def _bucket_pad(payloads: list) -> tuple:
    """Pad a chunk's payload list to the next power of two by repeating the
    last payload; returns ``(padded, real_count)``. The batched program is
    captured per batch extent (one CUDA graph per size, direction and
    scaling, each with its static inputs), so without bucketing a serving
    stream with fluctuating occupancy pays one capture per distinct size —
    bucketing bounds them to the powers of two up to batch_max at the cost
    of a few duplicate rows' compute. The real count
    rides as ``count=`` into the batch calls, so metrics/guard checks and
    returned results cover exactly the real requests."""
    n = len(payloads)
    bucket = 1
    while bucket < n:
        bucket *= 2
    return payloads + [payloads[-1]] * (bucket - n), n


def run_reference(plan, request):
    """Execute one request through the plan's ``torch.fft`` reference rung
    (the breaker-open demotion path): a code path disjoint from the primary
    engine's dispatch, mirroring the verify supervisor's demote rung."""
    if request.direction == "backward":
        return plan._reference_backward(request.payload)
    out = plan._reference_forward(plan._device_space(request.payload), request.scaling)
    return _to_request_order(request, out)


def _to_request_order(request, packed):
    """Scatter a plan-order packed forward result back into the caller's
    value order (``out[src] = plan_result``; see value_order_map), on the
    result's device."""
    if request.order_map is None:
        return packed
    out = torch.empty_like(packed)
    out[torch.as_tensor(request.order_map, device=packed.device)] = packed
    return out
