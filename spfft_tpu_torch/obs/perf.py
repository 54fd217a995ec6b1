"""Performance reports: fenced pair time attributed to pipeline stages.

The port of ``spfft_tpu/obs/perf.py``, under the same schema
(``spfft_tpu.obs.perf/1``, :func:`validate_perf_report`): one measured,
fenced seconds-per-pair figure (:func:`measure_pair_seconds`), distributed
over the canonical :data:`~spfft_tpu_torch.obs.STAGES` by an **analytic cost
model**: ``5 * n * log2(n)`` flops per 1-D FFT line (the z pass counts only
the active sticks) and exact byte counts for the data-movement stages, the
exchange's from the plan's wire accounting. Flops and bytes combine through
one machine balance (:func:`flop_per_byte`: ``SPFFT_TPU_PERF_FLOP_PER_BYTE``
when set, else :data:`CUDA_FLOP_PER_BYTE` for a plan on a CUDA device,
measured on an H100, else the JAX package's :data:`DEFAULT_FLOP_PER_BYTE`),
recorded in ``attribution``: the per-stage seconds are model-apportioned,
not timed, and sum to the measured pair time by construction. The engines'
``stage_accounting()`` gives the model's rows; :func:`fit_flop_per_byte`
fits the balance to measured per-stage device times.

``gflops`` is the dense model (``2 * 5 N log2 N`` per pair over the whole
grid) over the measured seconds; ``exchange_fraction`` is the share
attributed to the exchange. Every report also lands in the metrics registry
(``perf_pair_seconds``, ``perf_stage_seconds``, ``perf_gflops``,
``perf_exchange_fraction``) and emits a ``perf`` trace event under the plan's
run ID.
"""
from __future__ import annotations

import math

import torch

from .. import knobs
from . import trace
from .registry import gauge, histogram
from .stages import STAGES

PERF_SCHEMA = "spfft_tpu.obs.perf/1"
# a programs/dbench.py (or discipline_compare --matrix) document of keyed rows
SCALING_SCHEMA = "spfft_tpu.obs.perf.scaling/1"
FLOP_PER_BYTE_ENV = "SPFFT_TPU_PERF_FLOP_PER_BYTE"

# Machine balance used to mix flop-weighted compute stages and byte-weighted
# movement stages into one attribution scale: flops that cost the same time
# as moving one byte. The default is the JAX package's (a TPU's), and the CPU's.
DEFAULT_FLOP_PER_BYTE = knobs.default(FLOP_PER_BYTE_ENV)
# The balance of a plan on a CUDA device, measured by `python3 chip_smoke.py`
# (its balance_fit line) in two runs on an "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi), torch 2.11.0+cu128, CUDA 12.8: the per-stage least-squares fit
# to the staged twins' device ms at 256^3 C2C over 4 shards and 512^3 R2C over
# 16 shards in float32 and float64 was 2.205 and 2.194 flop/byte; the model's
# exchange share read within 1.5x of the measured one on all three from 1.225
# to 1.847 in the first run and from 1.202 to 1.794 in the second; the value is
# the best fit inside both.
CUDA_FLOP_PER_BYTE = 1.794

# The pipeline-stage vocabulary the perf model covers: exactly the engine
# stages of obs.STAGES (the autotuner's "tune warmup"/"tune trial" phases are
# trial harness stages and carry no flop/byte model).
MODELED_STAGES = (
    "compression",
    "stick symmetry",
    "plane symmetry",
    "z transform",
    "y transform",
    "y transform sparse",
    "y transform blocked",
    "x transform",
    "expand",
    "pack",
    "exchange",
    "unpack",
    "pack A",
    "exchange A",
    "unpack A",
    "pack B",
    "exchange B",
    "unpack B",
    "exchange overlapped",
    "exchange A overlapped",
    "exchange B overlapped",
)

# The stages whose attributed seconds make up ``exchange_fraction`` — the
# interconnect collectives, not their local pack/unpack bookends. The
# overlapped variants contribute their EXPOSED (non-hidden) seconds, so the
# fraction is the share of wall time communication actually costs.
EXCHANGE_STAGES = (
    "exchange",
    "exchange A",
    "exchange B",
    "exchange overlapped",
    "exchange A overlapped",
    "exchange B overlapped",
)

REQUIRED_KEYS = (
    "schema",
    # the plan's construction run ID (obs.trace): perf rows join
    # plan cards, metrics windows and flight-recorder events on this key
    "run_id",
    "kind",
    "engine",
    "decomposition",
    "transform_type",
    "dims",
    "num_elements",
    "nnz_fraction",
    "dtype",
    "device_count",
    "mesh",
    "exchange_discipline",
    "seconds_per_pair",
    "repeats",
    "gflops",
    "model_gflops",
    "dense_flops_per_pair",
    "model_flops_per_pair",
    "wire_bytes_per_pair",
    "exchange_seconds",
    "exchange_fraction",
    "exchange_gbps",
    "attribution",
    "stages",
)
STAGE_KEYS = ("stage", "flops", "bytes", "seconds", "fraction", "gflops", "gbps")
ATTRIBUTION_KEYS = ("method", "flop_per_byte")


def flop_per_byte(device=None) -> float:
    """The flops-per-byte machine balance of a plan on ``device``:
    ``SPFFT_TPU_PERF_FLOP_PER_BYTE`` when it is set, on any device; else
    :data:`CUDA_FLOP_PER_BYTE` on a CUDA device; else
    :data:`DEFAULT_FLOP_PER_BYTE` (the CPU, and ``device`` None)."""
    if knobs.raw(FLOP_PER_BYTE_ENV) not in (None, ""):
        return knobs.get_float(FLOP_PER_BYTE_ENV)
    if device is not None and torch.device(device).type == "cuda":
        return CUDA_FLOP_PER_BYTE
    return DEFAULT_FLOP_PER_BYTE


def stage_shares(rows: list, balance: float) -> dict:
    """Each model row's share of the pair at ``balance`` (the weights of
    :func:`_attribute`), by stage name."""
    return {r["stage"]: r["fraction"] for r in _attribute(rows, 1.0, balance)}


def share_error(cases: list, balance: float) -> float:
    """The root mean square difference, over the measured stages of every
    case, between the model's stage share at ``balance`` and the measured
    one. ``cases``: ``(model_rows, measured)`` pairs, the :func:`stage_model`
    rows of a plan and its measured device ms by stage name. A model row
    without a measured stage is left out (on one device the slab and pencil
    exchanges pack and unpack inside their one gather, so the model's
    ``pack``/``unpack`` rows have no time of their own); a measured stage
    without a model row counts 0 on the model's side."""
    err, count = 0.0, 0
    for rows, ms in cases:
        total = sum(ms.values())
        got = stage_shares([r for r in rows if r["stage"] in ms], balance)
        for stage, v in ms.items():
            err += (got.get(stage, 0.0) - (v / total if total > 0 else 0.0)) ** 2
            count += 1
    return math.sqrt(err / max(1, count))


def fit_flop_per_byte(cases: list, lo: float = 1e-3, hi: float = 1e4) -> dict:
    """The one balance that best matches measured per-stage times: the
    least :func:`share_error` over ``cases`` (a log-spaced scan of
    ``[lo, hi]``, then a golden-section refinement). Returns
    ``{"flop_per_byte", "residual"}``, the residual the error at the fit."""
    loss = lambda log_b: share_error(cases, math.exp(log_b))  # noqa: E731
    grid = [math.log(lo) + i * (math.log(hi) - math.log(lo)) / 400 for i in range(401)]
    best = min(range(len(grid)), key=lambda i: loss(grid[i]))
    a, b = grid[max(0, best - 1)], grid[min(len(grid) - 1, best + 1)]
    golden = (math.sqrt(5) - 1) / 2
    for _ in range(60):
        c, d = b - golden * (b - a), a + golden * (b - a)
        if loss(c) < loss(d):
            b = d
        else:
            a = c
    balance = math.exp((a + b) / 2)
    return {"flop_per_byte": balance, "residual": share_error(cases, balance)}


def fft_pass_flops(lines: int, length: int) -> int:
    """Analytic flops of one 1-D FFT pass: ``5 * n * log2(n)`` per length-n
    line (the standard FFT cost model every benchmark in this repo uses),
    times the number of lines transformed. Zero for degenerate lengths."""
    if length <= 1 or lines <= 0:
        return 0
    return int(round(5.0 * lines * length * math.log2(length)))


def pipeline_head_rows(
    total_values: int,
    total_sticks: int,
    dim_z: int,
    c_item: int,
    *,
    stick_symmetry: bool,
) -> list:
    """Shared head of every engine's stage model — ``compression`` (packed
    values <-> sticks), the optional (0,0)-stick hermitian fill, and the
    sparse-aware z pass. One builder for all six engines so the common rows
    cannot drift; each hook passes its own pipeline's guard for the
    symmetry stage (the engines gate it differently)."""
    rows = [
        {
            "stage": "compression",
            "flops": 0,
            "bytes": 2 * (total_values + total_sticks * dim_z) * c_item,
        }
    ]
    if stick_symmetry:
        rows.append(
            {"stage": "stick symmetry", "flops": 0, "bytes": 2 * dim_z * c_item}
        )
    rows.append(
        {
            "stage": "z transform",
            "flops": 2 * fft_pass_flops(total_sticks, dim_z),
            "bytes": 0,
        }
    )
    return rows


def pipeline_tail_rows(
    dim_z: int,
    dim_y: int,
    dim_x: int,
    y_lines: int,
    c_item: int,
    *,
    plane_symmetry: bool,
    y_scope: str = "y transform",
) -> list:
    """Shared tail of every engine's stage model — the optional x=0 plane
    hermitian fill, the y pass (label and line count supplied by the engine:
    the sparse-y MXU variants carry their disambiguated scope and count only
    active x columns), and the x pass. Counterpart of
    :func:`pipeline_head_rows`."""
    rows = []
    if plane_symmetry:
        rows.append(
            {
                "stage": "plane symmetry",
                "flops": 0,
                "bytes": 2 * dim_z * dim_y * c_item,
            }
        )
    rows.append(
        {"stage": y_scope, "flops": 2 * fft_pass_flops(y_lines, dim_y), "bytes": 0}
    )
    rows.append(
        {
            "stage": "x transform",
            "flops": 2 * fft_pass_flops(dim_z * dim_y, dim_x),
            "bytes": 0,
        }
    )
    return rows


def dense_pair_flops(dims) -> int:
    """The dense-model flops of one backward+forward pair over the full
    grid: ``2 * 5 * N * log2(N)``, the figure the benchmark programs divide
    by wall time."""
    n = 1
    for d in dims:
        n *= int(d)
    if n <= 1:
        return 0
    return int(round(2 * 5.0 * n * math.log2(n)))


def _exposed_weight(row: dict, base: dict, balance: float) -> float:
    """Attribution weight of one stage row (the JAX package's
    ``_exposed_weight``, ``spfft_tpu/obs/perf.py:248-271``).

    Plain rows weigh ``flops + bytes * balance``. An OVERLAPPED exchange row
    (an ``overlap`` record from the engine's ``stage_accounting``) weighs its
    **exposed** time alone: with C chunks pipelined against the stage it
    hides behind, at most ``(C-1)/C`` of ``min(exchange, compute)``
    overlaps, so ``exposed = full - min(full, hidden) * (C-1)/C``. The row's
    ``bytes`` stay the exact wire volume; the hiding stage keeps its full
    weight."""
    w = row["flops"] + row["bytes"] * balance
    ov = row.get("overlap")
    chunks = max(1, int(ov.get("chunks", 1))) if ov else 1
    if chunks == 1:
        return w
    hide_w = base.get(ov.get("hides"), 0.0)
    return max(w - min(w, hide_w) * (chunks - 1) / chunks, 0.0)


def _attribute(rows: list, seconds: float, balance: float) -> list:
    """Distribute ``seconds`` over the stage rows by model weight
    (``flops + bytes * balance``; OVERLAPPED exchange rows by their exposed
    share, :func:`_exposed_weight`); equal split when the model is
    all-zero. The attributed stage seconds sum to ``seconds`` by
    construction."""
    base = {r["stage"]: r["flops"] + r["bytes"] * balance for r in rows}
    weights = [_exposed_weight(r, base, balance) for r in rows]
    total_w = sum(weights)
    out = []
    for r, w in zip(rows, weights):
        frac = (w / total_w) if total_w > 0 else (1.0 / len(rows) if rows else 0.0)
        sec = seconds * frac
        row = {
            "stage": r["stage"],
            "flops": int(r["flops"]),
            "bytes": int(r["bytes"]),
            "seconds": sec,
            "fraction": frac,
            "gflops": (r["flops"] / sec / 1e9) if sec > 0 else 0.0,
            "gbps": (r["bytes"] / sec / 1e9) if sec > 0 else 0.0,
        }
        if r.get("overlap"):
            row["overlap"] = dict(r["overlap"])
        out.append(row)
    return out


def _merge_rows(rows: list) -> list:
    """Aggregate duplicate stage names (an engine hook may emit a stage once
    per direction) into one row each, preserving first-seen order and an
    ``overlap`` record (the first)."""
    order, table = [], {}
    for r in rows:
        name = r["stage"]
        if name not in table:
            table[name] = {"stage": name, "flops": 0, "bytes": 0}
            order.append(name)
        table[name]["flops"] += int(r.get("flops", 0))
        table[name]["bytes"] += int(r.get("bytes", 0))
        if r.get("overlap") and "overlap" not in table[name]:
            table[name]["overlap"] = dict(r["overlap"])
    return [table[n] for n in order]


def stage_model(transform) -> list:
    """The analytic per-stage flop/byte model of one backward+forward pair
    for ``transform``'s actual pipeline — the engine's ``stage_accounting()``
    hook (every engine implements it; exchange bytes come from the same
    geometry accounting the plan card embeds), duplicate stages merged and
    names checked against :data:`MODELED_STAGES`."""
    rows = _merge_rows(transform._exec.stage_accounting())
    for r in rows:
        if r["stage"] not in MODELED_STAGES:
            from ..errors import InvalidParameterError

            raise InvalidParameterError(
                f"engine stage_accounting emitted unmodeled stage {r['stage']!r}"
            )
    return rows


def perf_report(
    transform,
    seconds: float,
    *,
    repeats: int | None = None,
    batch: int | None = None,
) -> dict:
    """Build the performance report for one measured ``transform`` pair.

    ``seconds`` is the measured, fenced wall time of one backward+forward
    pair (see :func:`measure_pair_seconds`); ``repeats`` records how many
    timed repetitions the best-of came from. ``batch`` (default 1) says the
    measured pair carried B stacked transforms through one dispatch (the
    batch-fused path): the flop/byte models — stage rows, dense flops, wire
    bytes — scale by B so per-stage GFLOP/s and the headline ``gflops``
    read as aggregate throughput of the batched dispatch, and the extent is
    stamped into ``attribution["batch"]`` (validation-optional: consumers
    read a missing value as 1).
    The report validates against :func:`validate_perf_report`, feeds the
    run registry, and emits a ``perf`` trace instant under the plan's run
    ID."""
    seconds = float(seconds)
    b = 1 if batch is None else int(batch)
    if b < 1:
        from ..errors import InvalidParameterError

        raise InvalidParameterError(f"batch must be >= 1, got {batch}")
    model_rows = stage_model(transform)
    if b > 1:
        model_rows = [
            dict(r, flops=r["flops"] * b, bytes=r["bytes"] * b)
            for r in model_rows
        ]
    balance = flop_per_byte(transform.device)
    rows = _attribute(model_rows, seconds, balance)
    dims = [int(transform.dim_x), int(transform.dim_y), int(transform.dim_z)]
    distributed = getattr(transform, "_mesh", None) is not None
    if distributed:
        from .plancard import _mesh_card

        mesh_card = _mesh_card(transform.mesh)
        device_count = int(transform.num_shards)
        decomposition = "pencil2" if transform.engine.startswith("pencil2") else "slab"
        discipline = transform.exchange_type.name
        overlap_chunks = int(transform.overlap_chunks)
        wire_bytes = 2 * int(transform.exchange_wire_bytes())  # fwd + bwd
        num_elements = int(transform.num_global_elements)
    else:
        mesh_card = None
        device_count = 1
        decomposition = "local"
        discipline = None
        overlap_chunks = 1
        wire_bytes = 0
        num_elements = int(transform.num_local_elements)
    if b > 1:
        wire_bytes *= b  # the batched dispatch ships every member's slabs
    model_flops = sum(r["flops"] for r in rows)
    dense_flops = dense_pair_flops(dims) * b
    exchange_seconds = sum(
        r["seconds"] for r in rows if r["stage"] in EXCHANGE_STAGES
    )
    report = {
        "schema": PERF_SCHEMA,
        "run_id": transform._run_id,
        "kind": "distributed" if distributed else "local",
        "engine": transform.engine,
        "decomposition": decomposition,
        "transform_type": transform.transform_type.name,
        "dims": dims,
        "num_elements": num_elements,
        "nnz_fraction": num_elements / float(transform.global_size),
        "dtype": str(transform.dtype),
        "device_count": device_count,
        "mesh": mesh_card,
        "exchange_discipline": discipline,
        # effective OVERLAPPED-discipline chunk count (1 = bulk-synchronous)
        # and the fusion state: part of a row's identity, validation-optional
        # as in the JAX schema
        "overlap_chunks": overlap_chunks,
        "fused": bool(transform.fused),
        "seconds_per_pair": seconds,
        "repeats": repeats,
        "gflops": (dense_flops / seconds / 1e9) if seconds > 0 else 0.0,
        "model_gflops": (model_flops / seconds / 1e9) if seconds > 0 else 0.0,
        "dense_flops_per_pair": dense_flops,
        "model_flops_per_pair": int(model_flops),
        "wire_bytes_per_pair": wire_bytes,
        "exchange_seconds": exchange_seconds,
        "exchange_fraction": (exchange_seconds / seconds) if seconds > 0 else 0.0,
        "exchange_gbps": (
            wire_bytes / exchange_seconds / 1e9 if exchange_seconds > 0 else 0.0
        ),
        "attribution": {
            "method": "analytic",
            "flop_per_byte": balance,
            "batch": b,
        },
        "stages": rows,
    }
    _record(report)
    return report


def _record(report: dict) -> None:
    """Feed the run registry + flight recorder from a finished report."""
    labels = {
        "engine": report["engine"],
        "decomposition": report["decomposition"],
    }
    histogram("perf_pair_seconds", **labels).observe(report["seconds_per_pair"])
    gauge("perf_gflops", **labels).set(report["gflops"])
    gauge("perf_exchange_fraction", **labels).set(report["exchange_fraction"])
    for row in report["stages"]:
        histogram("perf_stage_seconds", stage=row["stage"]).observe(
            row["seconds"]
        )
    with trace.with_run(report["run_id"]):
        trace.event(
            "perf",
            gflops=round(report["gflops"], 3),
            exchange_fraction=round(report["exchange_fraction"], 4),
            devices=report["device_count"],
            decomposition=report["decomposition"],
        )


def _stage_inputs(transform):
    """Random frequency values of the plan's exact shape on its device
    (seed 0, as the JAX package's ``tuning.runner._stage_inputs``): the
    ``(V,)`` pair of a local plan, the stacked ``(P_local, V_max)`` pair of a
    distributed one. Staging is not billed to the measurement."""
    import numpy as np

    rng = np.random.default_rng(0)
    if getattr(transform, "_mesh", None) is not None:
        vps = [rng.standard_normal(transform.num_local_elements(r))
               + 1j * rng.standard_normal(transform.num_local_elements(r))
               if r in transform.mesh.local_shards else None
               for r in range(transform.num_shards)]
        return transform._exec.pad_values(vps)
    n = transform.num_local_elements
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return transform._exec.values_pair(torch.as_tensor(values))


def measure_pair_seconds(transform, *, chain: int = 4, repeats: int = 3,
                         warmup: int = 1) -> dict:
    """Measure one fenced backward+forward pair on ``transform``.

    Random inputs of the plan's exact shape on its device; ``chain``
    dependent pairs per repeat, the forward(FULL) output feeding the next
    backward (FULL scaling makes each C2C pair the identity, so the chain is
    exact); ``warmup`` untimed chains (CUDA-graph capture, the kernels'
    libraries, cuFFT plans); then best-of-``repeats`` chains, each timed by
    the host clock from its first dispatch to the :func:`~spfft_tpu_torch.sync.fence`
    after its last pair. The JAX package chains the pairs inside one jitted
    ``lax.scan``; here each pair is two host calls (on a fused plan two
    CUDA-graph replays), so the host's per-pair cost is part of what is
    measured.

    Returns ``{"seconds_per_pair", "rep_seconds", "chain", "repeats",
    "roundtrip_residual"}``: ``rep_seconds`` per pair for each repeat; the
    residual is the C2C chain-identity check over the first 64 values (None
    for R2C, whose round trip projects onto hermitian-consistent spectra)."""
    import time

    from ..sync import fence
    from ..types import ScalingType, TransformType

    chain = max(1, int(chain))
    repeats = max(1, int(repeats))
    staged = _stage_inputs(transform)

    def run():
        re, im = staged
        for _ in range(chain):
            transform.backward_pair(re, im)
            re, im = transform.forward_pair(ScalingType.FULL)
        return fence((re, im))

    for _ in range(max(0, int(warmup))):
        run()
    rep_seconds = []
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        rep_seconds.append((time.perf_counter() - t0) / chain)
    residual = None
    if transform.transform_type != TransformType.R2C:
        # a diverged chain means the measurement ran a broken pipeline
        got = out[0].reshape(-1)[:64]
        want = staged[0].reshape(-1)[:64]
        residual = float(torch.abs(got - want).max())
    return {
        "seconds_per_pair": min(rep_seconds),
        "rep_seconds": rep_seconds,
        "chain": chain,
        "repeats": repeats,
        "roundtrip_residual": residual,
    }


def validate_perf_report(report: dict) -> list:
    """Missing/malformed key paths of a perf report ([] when valid) — the
    schema pin, same contract as ``obs.validate_plan_card`` /
    ``trace.validate_trace``. Stage names must come from the canonical
    ``obs.STAGES`` vocabulary."""
    missing = [k for k in REQUIRED_KEYS if k not in report]
    if report.get("schema") not in (None, PERF_SCHEMA):
        missing.append(f"schema (unknown: {report['schema']!r})")
    att = report.get("attribution")
    if isinstance(att, dict):
        missing.extend(
            f"attribution.{k}" for k in ATTRIBUTION_KEYS if k not in att
        )
    for i, row in enumerate(report.get("stages", ())):
        missing.extend(f"stages[{i}].{k}" for k in STAGE_KEYS if k not in row)
        name = row.get("stage")
        if name not in STAGES:
            missing.append(f"stages[{i}].stage (unknown: {name!r})")
    return missing


def validate_scaling_doc(doc: dict) -> list:
    """Missing-key paths of a ``programs/dbench.py`` scaling document
    (schema :data:`SCALING_SCHEMA`): header keys plus every row's perf-report
    schema. [] when valid."""
    missing = [k for k in ("schema", "config", "rows") if k not in doc]
    if doc.get("schema") not in (None, SCALING_SCHEMA):
        missing.append(f"schema (unknown: {doc['schema']!r})")
    for i, row in enumerate(doc.get("rows", ())):
        for k in ("key", "scaling", "seconds_noise"):
            if k not in row:
                missing.append(f"rows[{i}].{k}")
        missing.extend(f"rows[{i}].{m}" for m in validate_perf_report(row))
    return missing
