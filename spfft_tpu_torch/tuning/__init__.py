"""spfft_tpu_torch.tuning: the empirical autotuner and its persistent wisdom.

The port of ``spfft_tpu/tuning/``. A plan built with ``policy="tuned"`` (or
``SPFFT_TPU_POLICY=tuned``) measures the real alternatives on its own
geometry, mesh, dtype and card, and remembers the winner:

1. **Candidates** (:mod:`.candidates`): the exchange disciplines of a mesh
   plan, and the local engine axis (``mxu`` under its sparse-y knobs, forced
   dense, staged, with bfloat16 matrices; ``torch.fft`` fused and staged).
2. **Trials** (:mod:`.runner`): each candidate built as a whole plan and
   timed on its device (warm-up, then the best of the repeats, fenced).
3. **Wisdom** (:mod:`.wisdom`): the choice persists (``SPFFT_TPU_WISDOM``,
   else process memory), keyed by every property that decides it, the
   card's name and the torch and CUDA versions among them, so that the same
   plan built again runs no trial and wisdom taken on one card never
   answers for another.

Tuning degrades and never fails a plan: a CPU plan without
``SPFFT_TPU_TUNE_CPU=1``, a mesh over more than one process, a corrupt store,
a schema mismatch or candidates that all fail take the model policy, and
``plan.report()["tuning"]`` records the provenance (``wisdom`` or ``model``,
hit or miss, why, the trial table) and the chosen plan's K1 form
(``k1_form``: ``"highest-bf16"`` names bfloat16 DFT matrices). The one
exception is a kernel's own failure (:data:`KERNEL_ERRORS`): it raises, as
it does from any plan, and no wisdom is written.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import knobs
from .candidates import (  # noqa: F401
    batch_candidates,
    exchange_candidates,
    local_candidates,
    sched_candidates,
)
from .runner import (  # noqa: F401
    KERNEL_ERRORS,
    TRIAL_ERRORS,
    TUNE_CPU_ENV,
    TUNE_REPEATS_ENV,
    TUNE_WARMUP_ENV,
    TrialDegradedError,
    TrialTimeout,
    measure_batch_seconds,
    measure_candidate,
    run_batch_trials,
    run_trials,
    trial_budget,
    trial_deadline_s,
    trials_allowed,
)
from .wisdom import (  # noqa: F401
    PERF_ENV_KNOBS,
    WISDOM_ENV,
    WISDOM_SCHEMA,
    MemoryStore,
    WisdomStore,
    active_store,
    best_measured_ms,
    clear_memory,
    env_signature,
    key_digest,
    make_entry,
    merge_entries,
    sparsity_signature,
)

CPU_SKIP = f"trials skipped on CPU-only host (set {TUNE_CPU_ENV}=1 to allow)"


@contextlib.contextmanager
def env_overrides(overrides: dict):
    """Apply a candidate's knob overrides around a trial's or the chosen
    plan's engine construction (the knobs are read at construction), and
    restore each verbatim after (unset stays unset). Process-global: tuned
    plans must not be built concurrently with other plans."""
    if not overrides:
        yield
        return
    # The trial isolation scope is the package's ONE deliberate raw env
    # path (noqa: SA014): it saves/restores ambient values VERBATIM — typed
    # parsing here would destroy the "unset stays unset" round-trip.
    saved = {k: os.environ.get(k) for k in overrides}  # noqa: SA014
    try:
        os.environ.update({k: str(v) for k, v in overrides.items()})
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)  # noqa: SA014 — verbatim restore
            else:
                os.environ[k] = old  # noqa: SA014 — verbatim restore


def platform_of(device) -> str:
    """``"gpu"`` for a CUDA device, else its type (the JAX ``platform``)."""
    return "gpu" if torch.device(device).type == "cuda" else str(torch.device(device).type)


def _record(provenance, *, hit, store, choice, trials, reason, key):
    """The tuning record a plan keeps (``_tuning``) and its card embeds."""
    return {
        "policy": "tuned",
        "provenance": provenance,  # "wisdom" (measured) or "model" (fallback)
        "hit": bool(hit),
        "wisdom_path": getattr(store, "path", None),
        "key_digest": key_digest(key),
        "reason": reason,
        "choice": choice,
        "trials": trials,
    }


def with_k1_form(record, execution) -> dict:
    """The record of a built tuned plan, with the K1 form its engine runs
    (``"highest-bf16"``: bfloat16 DFT matrices; None: no K1, the
    ``torch.fft`` engine), so that a caller sees what precision it got."""
    return dict(record, k1_form=getattr(execution, "k1_precision", None))


def _device_key(device) -> dict:
    """What the key holds of the device and the software under it: where
    JAX keys ``jax.__version__``, the torch and CUDA versions and the card's
    name (wisdom of one card never answers for another)."""
    device = torch.device(device)
    return {
        "platform": platform_of(device),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def _base_key(kind, transform_type, dims, dtype, engine, precision, device) -> dict:
    return {
        "kind": kind,
        "transform_type": transform_type.name,
        "dims": [int(d) for d in dims],
        "dtype": str(dtype),
        "engine": str(engine),
        "precision": str(precision),
        **_device_key(device),
        "env": env_signature(),
    }


def _dims(params):
    return params.dim_x, params.dim_y, params.dim_z


def exchange_key(params, mesh, dtype, engine, precision, pencil2) -> dict:
    """The key of a mesh plan's exchange decision: geometry and per-shard
    layout, the mesh, dtype, the requested engine, the device."""
    from ..obs.plancard import _mesh_card

    key = _base_key("exchange", params.transform_type, _dims(params), dtype, engine,
                    precision, mesh.device)
    key.update({
        "decomposition": "pencil2" if pencil2 else "slab",
        "mesh": _mesh_card(mesh),
        "sticks_per_shard": [int(n) for n in params.num_sticks_per_shard],
        "local_z_lengths": [int(n) for n in params.local_z_lengths],
        "values_per_shard": [int(n) for n in params.num_values_per_shard],
        # the port has no OVERLAPPED axis: every candidate runs at overlap 1
        "overlap": 1,
    })
    return key


def _local_layout(params) -> dict:
    return {
        "num_sticks": int(params.num_sticks),
        "num_elements": int(params.num_values),
        "sparsity_signature": sparsity_signature(params.stick_x, params.stick_y,
                                                 params.value_indices),
    }


def local_key(params, device, dtype, precision) -> dict:
    """The key of a local plan's engine decision: dims, the stick layout
    (hashed), dtype, precision, the device."""
    key = _base_key("local", params.transform_type, _dims(params), dtype, "auto", precision,
                    device)
    key.update(_local_layout(params))
    return key


def batch_key(params, device, dtype, precision, batch_max) -> dict:
    """The key of the fused batch-size decision: the local key's facts and
    the batcher's bound (which caps the candidates)."""
    key = _base_key("batch", params.transform_type, _dims(params), dtype, "auto", precision,
                    device)
    key.update(_local_layout(params))
    key["batch_max"] = None if batch_max is None else int(batch_max)
    return key


def _resolve(key, store, platform, run, model_choice, fields, unavailable=None):
    """The ladder every tuned decision takes: a wisdom hit (no trial); else
    the model where trials may not run (or for the reason ``unavailable``);
    else the trials (``run()``), the best persisted, or the model if every
    candidate failed. Returns ``(choice, record)``; ``fields`` picks the
    choice's keys from the winning trial row."""
    entry = store.lookup(key)
    if entry is not None:
        return dict(entry["choice"]), _record(
            "wisdom", hit=True, store=store, choice=entry["choice"],
            trials=entry.get("trials", []), reason="wisdom hit", key=key)

    def model(reason, trials=()):
        return dict(model_choice), _record(
            "model", hit=False, store=store, choice=dict(model_choice), trials=list(trials),
            reason=reason, key=key)

    if not trials_allowed(platform):
        return model(store.fallback_reason or CPU_SKIP)
    if unavailable:
        return model(unavailable)
    trials = run()
    measured = [row for row in trials if "ms" in row]
    if not measured:
        return model("all trial candidates failed", trials)
    choice = {k: measured[0][k] for k in fields}
    store.record(key, make_entry(key, choice, trials))
    return dict(choice), _record(
        "wisdom", hit=False, store=store, choice=choice, trials=trials,
        reason=store.fallback_reason or "measured", key=key)


def tuned_exchange(params, mesh, dtype, engine, precision, pencil2, build):
    """``ExchangeType.DEFAULT`` under the tuned policy: returns
    ``(ExchangeType, record)``. ``build(candidate)`` makes an explicit
    discipline's trial plan with the model policy. The model fallback is the
    slab rule (``parallel/policy.py``), or DEFAULT itself on a pencil mesh,
    which its engine resolves with its cost model."""
    from ..parallel.policy import resolve_default_for_plan
    from ..types import ExchangeType, wire_scalar_bytes

    key = exchange_key(params, mesh, dtype, engine, precision, pencil2)
    store = active_store()
    pick = ExchangeType.DEFAULT if pencil2 else resolve_default_for_plan(params)
    model_choice = {"exchange_type": pick.name, "overlap": 1}

    def model(reason):
        return pick, _record("model", hit=False, store=store, choice=model_choice, trials=[],
                             reason=reason, key=key)

    if params.num_shards <= 1:
        # no exchange happens: the decision has no effect, so no trial
        return model("single shard: exchange discipline has no effect")
    if mesh.world > 1:
        # every process must reach the same discipline, or the collectives
        # mismatch: the model, which depends only on the replicated geometry
        return model("multi-host mesh: tuning requires cross-process agreement")
    cands = exchange_candidates(
        params.num_sticks_per_shard, params.local_z_lengths,
        wire_scalar_bytes=wire_scalar_bytes(ExchangeType.DEFAULT, dtype), pencil2=pencil2)
    choice, record = _resolve(key, store, platform_of(mesh.device),
                              lambda: run_trials(build, cands), model_choice,
                              ("exchange_type", "overlap"))
    return ExchangeType[choice["exchange_type"]], record


def _model_engine(platform: str) -> dict:
    engine = "xla" if platform == "cpu" else "mxu"
    return {"label": engine, "engine": engine, "env": {}}


def tuned_local(params, device, dtype, precision, build, fuse=None):
    """A local plan's ``engine="auto"`` under the tuned policy: returns
    ``(choice, record)``, ``choice`` a local candidate (``engine`` and the
    ``env`` overrides to build it under). The model fallback is the static
    auto rule (``torch.fft`` on the CPU, ``mxu`` on the card). An explicit
    ``fuse`` is part of the key: a pinned plan's winner never answers a
    lookup where the tuner owns the fusion axis."""
    key = local_key(params, device, dtype, precision)
    key["fuse"] = "tuned" if fuse is None else int(bool(fuse))
    platform = platform_of(device)
    return _resolve(key, active_store(), platform,
                    lambda: run_trials(build, local_candidates(platform, dtype, fuse=fuse,
                                                               precision=precision)),
                    _model_engine(platform), ("label", "engine", "env"))


def tuned_batch(transform, batch_max=None):
    """The fused batch size of ``transform`` (``fused/bN``): returns
    ``(choice, record)``, ``choice["batch"]`` the measured size or None
    (uncapped) on every model fallback. Trials run on the plan's own batched
    programs."""
    key = batch_key(transform._params, transform.device, transform.dtype,
                    transform._precision, batch_max)
    unavailable = (None if transform._exec._ir.batch_available()
                   else "batch fusion unavailable on this plan")
    return _resolve(key, active_store(), platform_of(transform.device),
                    lambda: run_batch_trials(transform, batch_candidates(batch_max)),
                    {"label": "fused/uncapped", "batch": None}, ("label", "batch"), unavailable)


def wisdom_state(transform=None) -> dict:
    """The reproducibility stamp of a benchmark document: where wisdom
    lives and how the given plan's decision was made."""
    path = knobs.get_str(WISDOM_ENV)
    state = {"path": path, "configured": path is not None}
    if transform is not None:
        state["policy"] = getattr(transform, "_policy", "default")
        rec = getattr(transform, "_tuning", None)
        state["provenance"] = rec["provenance"] if rec else "model"
        state["hit"] = rec["hit"] if rec else None
    return state
