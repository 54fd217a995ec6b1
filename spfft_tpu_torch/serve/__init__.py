"""spfft_tpu_torch.serve: overload-safe multi-tenant transform serving.

The port of ``spfft_tpu/serve/``, with its exports:

1. **Admission queue** (:mod:`.queue`): bounded, per-tenant accounted.
   Overload becomes immediate typed :class:`ServiceOverloadError`
   backpressure (queue full, tenant quota) or fair-share shedding, never
   unbounded latency. Deadlines are enforced at admission and before every
   dispatch.
2. **Coalesced batching** (:mod:`.batcher`): requests whose sparse index sets
   share a stick layout resolve to one cached plan (keyed like the tuning
   wisdom store) and run batch-fused (``SPFFT_TPU_BATCH_FUSE``): the whole
   same-geometry batch is one program per direction on the canonical plan,
   on the card one CUDA-graph replay, with batch sizes bucketed to powers of
   two; per-caller value orders are bridged by static maps
   (:func:`spfft_tpu_torch.parallel.ragged.value_order_map`). The rung below
   it (``batch_fuse_failed``) is the split-phase loop through
   :func:`spfft_tpu_torch.sched.run_tasks`.
3. **Service** (:mod:`.service`): the dispatcher, with retry and jittered
   backoff, the verify breaker's shed-or-demote ladder, ``serve_*`` metrics,
   ``serve`` trace events and the fault sites ``serve.admit``,
   ``serve.batch`` and ``serve.dispatch``; ``sched=True`` runs several
   coalesced batches, mixed geometries included, as one task graph.
4. **RPC and the cluster front** (:mod:`.rpc`, :mod:`.cluster`): the JAX
   package's length-prefixed JSON wire, worker hosts behind
   :class:`RpcServer`, and a :class:`ClusterFront` whose heartbeats and
   requeue ladder turn a lost host into a typed, recoverable event.

The service runs on the card unless the caller asks for the CPU
(``ProcessingUnit.HOST``); a ticket resolves to a tensor on the plan's
device.

Guarantee (``tests/test_torch_serve.py``): at offered load beyond capacity,
with faults armed on every ``serve.*`` site, the queue stays bounded,
refusals are typed, the dispatcher never deadlocks, and every accepted
request's ticket resolves: completed, or failed with a typed
:mod:`spfft_tpu_torch.errors` member.
"""
from .errors import (  # noqa: F401
    OUTCOMES,
    SHED_REASONS,
    DeadlineExceededError,
    ServiceOverloadError,
    as_typed,
)
from .queue import AdmissionQueue, Request, Ticket  # noqa: F401
from .batcher import PlanCache, canonical_triplets, wrap_triplets  # noqa: F401
from .rpc import RpcClient, RpcServer  # noqa: F401
from .cluster import (  # noqa: F401
    ClusterFront,
    HeartbeatMonitor,
    HostHandle,
    RemotePlan,
)
from .service import (  # noqa: F401
    DEFAULT_BACKOFF_S,
    DEFAULT_BATCH_MAX,
    DEFAULT_PLANS,
    DEFAULT_QUEUE_CAP,
    DEFAULT_RETRIES,
    DEFAULT_SCHED_BATCHES,
    DEFAULT_TENANT_QUOTA,
    RETRYABLE_ERRORS,
    SERVE_BACKOFF_ENV,
    SERVE_BATCH_MAX_ENV,
    SERVE_ON_BREAKER_ENV,
    SERVE_PLANS_ENV,
    SERVE_QUEUE_CAP_ENV,
    SERVE_RETRIES_ENV,
    SERVE_SCHED_BATCHES_ENV,
    SERVE_SCHED_ENV,
    SERVE_TENANT_QUOTA_ENV,
    SERVE_TIMEOUT_ENV,
    TransformService,
    resolve_on_breaker,
)
