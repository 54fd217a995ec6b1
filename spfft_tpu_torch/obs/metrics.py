"""The run-metrics vocabulary: every instrument the port records, declared once.

The JAX package's ``spfft_tpu/obs/metrics.py``, limited to the metrics that
the ported paths record, with the same names, kinds, label keys and docs.
The JAX package's other rows (guard and fault injection, tuning and wisdom,
verification and the breaker, serving, multi-host and the scheduler, the
engine fallback ladder) wait for those subsystems (ROADMAP queue A).

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
    ("ir_dispatches_total", "counter", ("mode", "direction"),
     "stage-graph IR program dispatches (fused=1/direction, staged=1/node, "
     "batched=1/batch)"),
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
