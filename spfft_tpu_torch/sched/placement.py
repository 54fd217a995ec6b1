"""The placement pass: each spec'd task gets a device and a plan, tuned.

The port of ``spfft_tpu/sched/placement.py``. Placement is a plan decision,
resolved on :mod:`spfft_tpu_torch.tuning`'s own ladder: the candidates are
round-robin widths over the devices (``tuning.candidates.sched_candidates``),
each measured by running the graph's own workload; the winner persists in
wisdom under a ``kind: "sched"`` key and a warm store answers with no trial.
Under another policy, or where trials may not run, the **model placement**
spreads the tasks round-robin over every device.

Devices are ``torch.device``s: by default every visible CUDA device (one
H100 on a one-card machine). A CPU device placement is for tests, on the
CPU device the caller names. The fault site ``sched.place`` fires at the
head of the pass; an injected failure degrades to the model placement
(``sched_place_failed``). Each plan the pool builds carries its decision as
``plan._placement``, the plan card's ``placement`` section.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import faults, obs
from .. import tuning as _tuning
from ..errors import InvalidParameterError
from ..tuning import _device_key, platform_of
from ..tuning import wisdom as _wisdom
from ..tuning.candidates import sched_candidates
from ..tuning.runner import _trials

SPEC_KEYS = ("transform_type", "dims", "indices")


def default_devices() -> list:
    """Every visible CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def spec_digest(spec: dict, sticks: str | None = None) -> str:
    """The identity of one task spec (geometry and construction knobs);
    ``sticks``: the indices' sparsity signature, if the caller has it (a
    graph computes it once for each indices array its tasks share: hashing a
    large grid's triplets costs tens of milliseconds)."""
    for k in SPEC_KEYS:
        if k not in spec:
            raise InvalidParameterError(f"task spec is missing {k!r} (required: {SPEC_KEYS})")
    ttype = spec["transform_type"]
    ttype = ttype.name if hasattr(ttype, "name") else str(ttype)
    key = {
        "type": ttype,
        "dims": [int(d) for d in spec["dims"]],
        "dtype": str(np.dtype(spec["dtype"])) if spec.get("dtype") is not None else None,
        "engine": str(spec.get("engine", "auto")),
        "precision": str(spec.get("precision", "highest")),
        "sticks": sticks or _wisdom.sparsity_signature(np.asarray(spec["indices"])),
    }
    return _wisdom.key_digest(key)


def build_plan(spec: dict, device):
    """The pool's plan builder: a local :class:`Transform` of the spec's
    geometry on ``device`` (a HOST plan on the CPU, a GPU plan on a card)."""
    from ..transform import Transform
    from ..types import ProcessingUnit, TransformType

    ttype = spec["transform_type"]
    if not hasattr(ttype, "name"):
        ttype = TransformType[str(ttype)]
    dx, dy, dz = (int(d) for d in spec["dims"])
    device = torch.device(device)
    pu = ProcessingUnit.HOST if device.type == "cpu" else ProcessingUnit.GPU
    return Transform(
        pu, ttype, dx, dy, dz, indices=spec["indices"], dtype=spec.get("dtype"),
        engine=spec.get("engine", "auto"), precision=spec.get("precision", "highest"),
        device=device, policy=spec.get("policy"), guard=spec.get("guard"),
        verify=spec.get("verify"))


class PlanPool:
    """Plans keyed by (spec digest, device): one build per geometry and
    device, reused across graphs (the owner scopes its lifetime)."""

    def __init__(self, build=None):
        self._build = build or build_plan
        self._plans: dict = {}

    def plan_for(self, spec: dict, device, digest: str | None = None):
        key = (digest or spec_digest(spec), str(device))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = self._build(spec, device)
        return plan

    def __len__(self) -> int:
        return len(self._plans)


def workload_key(graph, num_devices: int, device) -> dict:
    """The wisdom key of one graph workload: the spec geometries (digest ->
    count), the graph's size and depth, the device count, the device and
    software (``tuning._device_key``) and the perf knobs."""
    counts: dict = {}
    pinned = 0
    for task in graph:
        if task.spec is None:
            pinned += 1
            continue
        counts[task.digest] = counts.get(task.digest, 0) + 1
    return {
        "kind": "sched",
        "workload": sorted(counts.items()),
        "pinned_tasks": pinned,
        "tasks": len(graph),
        "depth": graph.depth(),
        "num_devices": int(num_devices),
        **_device_key(device if device is not None else "cpu"),
        "env": _wisdom.env_signature(),
    }


def _placement(record: dict) -> dict:
    """A decision record of the tuning ladder as a placement record: its
    policy says ``tuned`` only where the width was measured."""
    return dict(record, policy="tuned" if record["provenance"] == "wisdom"
                else record["provenance"])


def _model(graph, devices, reason: str) -> dict:
    """The model placement's record: round-robin over every device."""
    num = len(devices)
    key = workload_key(graph, num, devices[0] if num else None)
    return _placement(_tuning._record(
        "model", hit=False, store=_wisdom.active_store(),
        choice={"label": f"rr{num}", "width": num}, trials=[], reason=reason, key=key))


def _timed(measure):
    """A placement trial: the seconds ``measure(candidate)`` takes."""
    def trial(cand):
        t0 = time.perf_counter()
        measure(cand)
        return time.perf_counter() - t0

    return trial


def resolve_width(graph, devices, policy, measure) -> dict:
    """The placement width for one graph: ``measure(candidate)`` runs the
    graph at the candidate's width (the trial is the workload). Under the
    tuned policy the width takes the tuning ladder (``tuning._resolve``): a
    wisdom hit runs no trial; a miss where trials may run measures every
    width and persists the best; otherwise the model (width = the device
    count)."""
    if policy != "tuned":
        return _model(graph, devices, f"policy={policy!r}: model placement (round-robin)")
    num = len(devices)
    device = devices[0] if num else None
    platform = platform_of(device) if device is not None else "cpu"
    _, record = _tuning._resolve(
        workload_key(graph, num, device), _wisdom.active_store(), platform,
        lambda: _trials(sched_candidates(num), _timed(measure)),
        {"label": f"rr{num}", "width": num}, ("label", "width"))
    return _placement(record)


def assign(tasks, devices, pool: PlanPool, record: dict, width: int) -> None:
    """Each spec'd task round-robin over the first ``width`` devices, its
    plan from the pool, stamped with ``record`` and its device."""
    for i, task in enumerate(tasks):
        device = devices[i % width]
        task.plan = pool.plan_for(task.spec, device, task.digest)
        task.plan._placement = dict(record, device=str(device), device_index=int(i % width))


def place(graph, devices, pool: PlanPool, policy, measure) -> dict:
    """The placement pass (module docstring): the width, then the spec'd
    tasks round-robin in submission order. Pinned tasks keep their plans.
    Returns the placement record."""
    specd = [t for t in graph if t.spec is not None]
    if not specd:
        return {"provenance": "pinned", "reason": "all tasks carry plans"}
    if not devices:
        raise InvalidParameterError("placement needs at least one device")
    try:
        faults.site("sched.place")
        record = resolve_width(graph, devices, policy, measure)
    except faults.InjectedFault as e:
        faults.record_degradation("sched_place_failed", faults.summarize(e))
        record = _model(graph, devices, f"placement fault: {faults.summarize(e)}")
    width = max(1, min(int(record["choice"]["width"]), len(devices)))
    if width != int(record["choice"]["width"]):
        # wisdom from a wider host: the record states the spread that ran
        record = dict(record, choice={"label": f"rr{width}", "width": width},
                      reason=record["reason"] + f" (clamped from rr{record['choice']['width']}: "
                      f"{len(devices)} devices visible)")
    obs.counter("sched_place_total", provenance=record["provenance"]).inc()
    obs.trace.event("sched", what="place", width=width, provenance=record["provenance"],
                    tasks=len(specd))
    assign(specd, devices, pool, record, width)
    return record
