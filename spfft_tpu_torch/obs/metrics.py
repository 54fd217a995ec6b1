"""The run-metrics vocabulary: every instrument the port records, declared once.

The JAX package's ``spfft_tpu/obs/metrics.py``, limited to the metrics that
the ported paths record, with the same names, kinds, label keys and docs.
The JAX package's one other row, ``sync_probe_failures_total`` of the
TPU-only fence probes, waits with them (ROADMAP item 8b).

Rows are ``(name, kind, label_keys, doc)``. Label values are free-form; only
the key set is pinned.
"""
from __future__ import annotations

METRICS = (
    # ---- transform execution ------------------------------------------------
    ("transforms_total", "counter", ("direction", "engine"),
     "host-facing transforms executed, per direction and engine"),
    ("staged_bytes_total", "counter", ("direction",),
     "bytes staged across the host boundary (host_to_device / "
     "device_to_host)"),
    ("exchange_wire_bytes_total", "counter", ("engine",),
     "exact geometry wire bytes shipped through mesh exchanges"),
    ("dispatch_seconds", "histogram", ("direction",),
     "host time to enqueue one compiled program (async dispatch)"),
    ("wait_seconds", "histogram", ("direction",),
     "host time blocked on completion (fence / block_until_ready)"),
    ("execution_failures_total", "counter", ("op",),
     "dispatch/fence failures converted to typed execution errors"),
    ("engine_fallbacks_total", "counter", ("from", "to"),
     "degradation-ladder engine substitutions (e.g. MXU compile failure "
     "-> jnp.fft)"),
    ("degradations_total", "counter", ("event",),
     "degradation-ladder rungs taken, by recorded event name"),
    ("ir_dispatches_total", "counter", ("mode", "direction"),
     "stage-graph IR program dispatches (fused=1/direction, staged=1/node, "
     "batched=1/batch)"),
    # ---- guard / faults -----------------------------------------------------
    ("guard_checks_total", "counter", ("check",),
     "guard-mode validations performed (NaN/Inf scans, contracts)"),
    ("guard_failures_total", "counter", ("check",),
     "guard-mode validations that raised typed"),
    ("faults_injected_total", "counter", ("site", "kind"),
     "chaos injections that actually fired, per site and kind"),
    # ---- tuning / wisdom ----------------------------------------------------
    ("tuning_trials_total", "counter", ("candidate",),
     "autotuner trial candidates measured"),
    ("tuning_trial_failures_total", "counter", ("candidate",),
     "trial candidates that errored into an error row"),
    ("tuning_trial_seconds", "histogram", (),
     "wall time of one trial measurement (warmup + repeats)"),
    ("wisdom_quarantined_total", "counter", (),
     "corrupt wisdom stores/bundles moved aside to *.corrupt"),
    ("wisdom_retries_total", "counter", (),
     "wisdom write retries (transient filesystem failures)"),
    ("wisdom_save_failures_total", "counter", (),
     "wisdom writes abandoned after the retry budget (recorded loss)"),
    # ---- verification / breaker ---------------------------------------------
    ("verify_checks_total", "counter", ("check", "verdict"),
     "ABFT check evaluations, per check and pass/fail verdict"),
    ("verify_retries_total", "counter", ("direction",),
     "supervisor re-executions after a failed check or typed error"),
    ("verify_recoveries_total", "counter", ("direction",),
     "supervised transforms that recovered (retry or demote rung)"),
    ("verify_failures_total", "counter", ("direction",),
     "supervised attempts that failed a check or raised typed"),
    ("verify_breaker_state", "gauge", ("engine",),
     "per-engine circuit-breaker state (0 closed / 1 half-open / 2 open)"),
    ("verify_breaker_trips_total", "counter", ("engine",),
     "circuit-breaker open transitions"),
    # ---- scheduler ----------------------------------------------------------
    ("sched_tasks_total", "counter", ("outcome",),
     "task-graph tasks resolved, per outcome"),
    ("sched_place_total", "counter", ("provenance",),
     "placement decisions, per provenance (model / wisdom / pinned)"),
    ("sched_retries_total", "counter", (),
     "task re-dispatches inside the executor ladder"),
    ("sched_inflight", "gauge", (),
     "transform executions currently dispatched and unfinalized"),
    ("sched_graph_depth", "gauge", (),
     "critical-path depth of the last scheduled graph"),
    ("host_requeues_total", "counter", (),
     "in-flight tasks requeued onto a surviving host after host loss"),
    # ---- serving ------------------------------------------------------------
    ("serve_requests_total", "counter", ("tenant", "outcome"),
     "serviced requests, per tenant and resolution outcome"),
    ("serve_sheds_total", "counter", ("reason",),
     "requests refused/shed (queue_full, tenant_quota, fair_share, "
     "deadline, breaker_open, plan_evicted, closing)"),
    ("serve_deadline_misses_total", "counter", ("tenant",),
     "requests that expired before or during dispatch"),
    ("serve_batches_total", "counter", (),
     "coalesced batches executed"),
    ("serve_retries_total", "counter", (),
     "batch re-dispatches after transient typed failures"),
    ("serve_demotions_total", "counter", ("engine",),
     "batches rerouted through the jnp.fft reference rung on an open "
     "breaker"),
    ("serve_plan_cache_total", "counter", ("event",),
     "plan-cache traffic (hit / miss / evict)"),
    ("serve_queue_depth", "gauge", (),
     "admission-queue depth high-water tracking"),
    ("serve_batch_occupancy", "histogram", (),
     "requests coalesced per executed batch"),
    ("serve_latency_seconds", "histogram", ("tenant",),
     "admission-to-resolution latency per request"),
    ("serve_phase_seconds", "histogram", ("phase",),
     "per-request seconds spent reaching each ticket phase stamp from the "
     "previous one (admitted -> coalesced -> dispatched -> wire -> "
     "remote_execute -> finalized); labeled by the phase REACHED, so "
     "phase=\"coalesced\" is queue wait and phase=\"remote_execute\" is "
     "the cross-host round trip"),
    # ---- multi-host serving -------------------------------------------------
    ("hosts_lost_total", "counter", ("host",),
     "worker hosts declared lost (missed heartbeat budget or dead RPC "
     "transport)"),
    ("host_heartbeats_total", "counter", ("verdict",),
     "liveness probes sent to worker hosts, per ok/missed verdict"),
    ("rpc_requests_total", "counter", ("op", "outcome"),
     "length-prefixed-JSON RPC requests served by a worker host, per op "
     "and ok/error outcome"),
    ("fleet_scrapes_total", "counter", ("host", "outcome"),
     "per-host metric scrapes by the fleet aggregator (obs.fleet), per "
     "ok / lost (skipped typed) / unreachable outcome"),
    ("remote_spans_spliced_total", "counter", ("host",),
     "remote trace-segment events spliced into the local flight recorder "
     "by the cluster front (cross-host run-ID join)"),
    # ---- performance observatory --------------------------------------------
    ("perf_pair_seconds", "histogram", ("engine", "decomposition"),
     "fenced seconds per backward+forward pair (perf reports)"),
    ("perf_stage_seconds", "histogram", ("stage",),
     "modeled per-stage seconds from the perf attribution"),
    ("perf_gflops", "gauge", ("engine", "decomposition"),
     "dense-equivalent GFLOP/s of the last perf report"),
    ("perf_exchange_fraction", "gauge", ("engine", "decomposition"),
     "exposed exchange fraction of the last perf report (the overlap "
     "scoreboard)"),
)

KINDS = ("counter", "gauge", "histogram")


def names() -> tuple:
    """Declared metric names, registration order."""
    return tuple(row[0] for row in METRICS)


def describe() -> list:
    """JSON-plain dump of the vocabulary (docs generation / tests)."""
    return [
        {"name": n, "kind": k, "labels": list(labels), "doc": d}
        for n, k, labels, d in METRICS
    ]
