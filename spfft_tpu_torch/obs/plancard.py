"""Plan cards: one JSON-stable record of what a plan chose and why.

The port of ``spfft_tpu/obs/plancard.py``, under the same schema
(``spfft_tpu.obs.plan_card/1``) and the same keys: grid geometry and sparsity,
engine and precision, the engine's decisions (``execution``: active-x
compaction, the y plan), the stage-graph IR section and the batch section;
distributed plans add the exchange (discipline, wire dtype and bytes,
rounds, transport) and the DEFAULT policy's table of alternatives (a pencil
plan's, ``decomposition: "pencil2"``, only where DEFAULT was resolved: the
JAX cost model's table that its engine weighed).

``degradations`` lists the rungs of the degradation ladder the plan took
(:mod:`spfft_tpu_torch.faults`), live: a rung taken at a first dispatch
appears in a later card. ``verification`` is the supervisor's own record
(:mod:`spfft_tpu_torch.verify`) when verification is armed, else the
``"off"`` record with the engine's breaker. ``tuning`` is a tuned plan's
decision record (:mod:`spfft_tpu_torch.tuning`), ``placement`` the record of
a plan that the scheduler's placement pass built (:mod:`spfft_tpu_torch.sched`);
each is absent otherwise, as in the JAX card.
``include_compiled=True`` adds the ``compiled`` section
(:func:`spfft_tpu_torch.obs.hlo.compiled_stats`: the backward program's op
classes, its element-granular gathers and scatters, its compile time and
memory, and on a CUDA plan its CUDA graph's nodes). It is optional: a
failure there (fault site ``hlo.stats``) gives the card without it and the
``hlo_stats_unavailable`` degradation, never a failed report. Over a process
group every process reports together, as it calls the plan.
"""
from __future__ import annotations

PLAN_CARD_SCHEMA = "spfft_tpu.obs.plan_card/1"

# Keys every card carries / keys distributed cards add (the JAX schema).
REQUIRED_KEYS = (
    "schema",
    "kind",
    # construction run ID (obs.trace): the join key between this card, the
    # metrics window it ran under and the flight-recorder events
    "run_id",
    "engine",
    "transform_type",
    "dims",
    "num_elements",
    "num_sticks",
    "nnz_fraction",
    "dtype",
    "precision",
    "policy",
    "platform",
    "execution",
    "degradations",
    "verification",
)
DEGRADATION_KEYS = ("event", "reason")
VERIFICATION_KEYS = ("mode", "checks", "rtol", "retries", "breaker")
BREAKER_KEYS = ("engine", "state", "consecutive_failures", "trips", "threshold")
DISTRIBUTED_KEYS = ("num_shards", "mesh", "decomposition", "exchange")
EXCHANGE_KEYS = (
    "discipline",
    "wire_dtype",
    "wire_bytes",
    "rounds",
    "transport",
    # effective OVERLAPPED-discipline chunk count (1 = bulk-synchronous)
    "overlap_chunks",
)
POLICY_KEYS = ("round_cost_bytes", "one_shot_supported", "chosen", "alternatives")
ALTERNATIVE_KEYS = ("discipline", "wire_bytes", "rounds", "cost_bytes", "chosen")
# the tuned policy's record (spfft_tpu_torch.tuning._record); a trial row is
# measured ("ms") or failed ("error")
TUNING_KEYS = ("policy", "provenance", "hit", "wisdom_path", "key_digest", "reason", "choice",
               "trials")
TRIAL_KEYS = ("label",)
TRIAL_RESULT_KEYS = ("ms", "error")
# the scheduler's placement record (spfft_tpu_torch.sched.placement)
PLACEMENT_KEYS = ("provenance", "hit", "reason", "choice", "device", "device_index")
# the IR section (spfft_tpu_torch/ir/compile.py IR_KEYS) and the batch section
IR_SECTION_KEYS = ("fused", "path", "requested", "stages", "donation")
# the compiled section (obs.hlo.compiled_stats); a CUDA plan adds graph_nodes
COMPILED_KEYS = ("compile_seconds", "hlo_op_classes", "element_granular_ops", "memory_analysis")
BATCH_SECTION_KEYS = ("enabled", "requested", "sizes", "failed")


def base_discipline(exchange_type):
    """A wire-format variant (*_FLOAT / *_BF16) -> its base discipline, the
    granularity at which the DEFAULT policy reasons."""
    from ..types import BF16_EXCHANGES, FLOAT_EXCHANGES, ExchangeType

    if exchange_type in (ExchangeType.BUFFERED_FLOAT, ExchangeType.BUFFERED_BF16):
        return ExchangeType.BUFFERED
    if exchange_type in FLOAT_EXCHANGES + BF16_EXCHANGES:
        return ExchangeType.COMPACT_BUFFERED
    return ExchangeType(exchange_type)


def _exchange_policy(transform) -> dict:
    """The ``exchange_policy`` section: the wire bytes of each base
    discipline for this plan's geometry and wire width, with the one the
    plan runs flagged. Every discipline here is one collective round
    (``all_to_all_single`` takes uneven split sizes, so the one-shot exchange
    is always supported) and the port's DEFAULT rule weighs wire bytes
    alone, with no per-round term (``parallel/policy.py``): so
    ``round_cost_bytes`` is 0 and ``cost_bytes`` equals ``wire_bytes``."""
    from ..parallel.policy import discipline_volumes
    from ..types import wire_scalar_bytes

    p = transform._params
    width = 2 * wire_scalar_bytes(transform.exchange_type, transform.dtype)
    chosen = base_discipline(transform.exchange_type)
    volumes = discipline_volumes(p.num_sticks_per_shard, p.local_z_lengths)
    ov = int(transform.overlap_chunks)
    alternatives = [
        {"discipline": d.name, "wire_bytes": int(v * width), "rounds": 1,
         "cost_bytes": int(v * width), "chosen": d == chosen and ov == 1}
        for d, v in volumes.items()
    ]
    name = transform.exchange_type.name
    if ov > 1:
        # the OVERLAPPED variant the plan runs: its base discipline's exact
        # wire bytes in C chunk collectives
        name = f"{name}/ov{ov}"
        base = next(a for a in alternatives if a["discipline"] == chosen.name)
        alternatives.append({"discipline": name, "wire_bytes": base["wire_bytes"],
                             "rounds": ov, "cost_bytes": base["wire_bytes"], "chosen": True})
    return {"round_cost_bytes": 0, "one_shot_supported": True, "chosen": name,
            "alternatives": alternatives}


def _exchange_policy_pencil(transform):
    """The ``exchange_policy`` section of a pencil plan: the cost table that
    the engine's DEFAULT resolution weighed with the one-shot exchange
    supported (``parallel/pencil2.py`` ``resolve_pencil2_default``, which
    keeps the tables of both flags), the plan's discipline flagged; None
    for an explicit discipline, where the cost model did not run."""
    tables = transform._exec.geometry.policy_tables
    if tables is None:
        return None
    costs = dict(tables[True])
    chosen = transform.exchange_type.name
    ov = int(transform.overlap_chunks)
    costs["alternatives"] = [dict(alt, chosen=alt["discipline"] == chosen and ov == 1)
                             for alt in costs["alternatives"]]
    if ov > 1:
        # the OVERLAPPED variant the plan runs: the padded base's exact wire
        # bytes in 2C chunk collectives (A and B per z window)
        base = next(a for a in costs["alternatives"] if a["discipline"] == chosen)
        chosen = f"{chosen}/ov{ov}"
        costs["alternatives"].append({
            "discipline": chosen, "wire_bytes": int(base["wire_bytes"]), "rounds": 2 * ov,
            "cost_bytes": int(base["wire_bytes"]) + 2 * ov * int(costs["round_cost_bytes"]),
            "chosen": True})
    costs["chosen"] = chosen
    return costs


def _mesh_card(mesh) -> dict:
    """The mesh as the JAX card names it: its ``"fft"`` axis, and on a
    pencil mesh its ``"fft2"`` axis."""
    if mesh.shape is not None:
        return {"fft": int(mesh.shape[0]), "fft2": int(mesh.shape[1])}
    return {"fft": int(mesh.num_shards)}


def _platform(device) -> str:
    """``"gpu"`` on the card, ``"cpu"`` on the CPU (JAX's ``device.platform``)."""
    return "gpu" if device.type == "cuda" else str(device.type)


def plan_card(transform, *, include_compiled: bool = False) -> dict:
    """Build the card of a local or distributed plan (module docstring)."""
    from ..types import TransformType, wire_dtype

    ex = transform._exec
    distributed = getattr(transform, "_mesh", None) is not None
    p = transform._params
    if distributed:
        num_elements = int(transform.num_global_elements)
        num_sticks = int(sum(int(n) for n in p.num_sticks_per_shard))
    else:
        num_elements = int(transform.num_local_elements)
        num_sticks = int(p.num_sticks)
    card = {
        "schema": PLAN_CARD_SCHEMA,
        "kind": "distributed" if distributed else "local",
        "run_id": transform._run_id,
        "engine": transform.engine,
        "transform_type": TransformType(transform.transform_type).name,
        "dims": [int(transform.dim_x), int(transform.dim_y), int(transform.dim_z)],
        "num_elements": num_elements,
        "num_sticks": num_sticks,
        "nnz_fraction": num_elements / float(transform.global_size),
        "dtype": str(transform.dtype),
        "precision": str(transform.precision),
        "policy": getattr(transform, "_policy", "default"),
        "platform": _platform(transform.device),
        "execution": ex.describe(),
        # the fallbacks this plan took (spfft_tpu_torch.faults.ladder)
        "degradations": [dict(d) for d in transform._degradations],
        "verification": _verification_section(transform),
        "ir": ex._ir.describe(),
        "batch": ex._ir.describe_batch(),
    }
    if distributed:
        card["num_shards"] = int(p.num_shards)
        card["mesh"] = _mesh_card(transform.mesh)
        pencil = transform.engine.startswith("pencil2")
        card["decomposition"] = "pencil2" if pencil else "slab"
        card["num_sticks_per_shard"] = [int(n) for n in p.num_sticks_per_shard]
        card["local_z_lengths"] = [int(n) for n in p.local_z_lengths]
        card["exchange"] = {
            "discipline": transform.exchange_type.name,
            "wire_dtype": str(wire_dtype(transform.exchange_type, transform.dtype)
                              ).removeprefix("torch."),
            "wire_bytes": int(transform.exchange_wire_bytes()),
            "rounds": int(transform.exchange_rounds()),
            "transport": ex.exchange_transport(),
            "overlap_chunks": int(transform.overlap_chunks),
        }
        if pencil:
            costs = _exchange_policy_pencil(transform)
            if costs is not None:
                card["exchange_policy"] = costs
        else:
            card["exchange_policy"] = _exchange_policy(transform)
    if include_compiled:
        from ..faults import InjectedFault, record_degradation, summarize
        from .hlo import compiled_stats

        # Compiled introspection is optional (ladder rung 5): a record,
        # capture or stats failure (fault site hlo.stats) degrades to a card
        # without the "compiled" section, recorded; never a failed report().
        try:
            card["compiled"] = compiled_stats(transform)
        except (InjectedFault, RuntimeError, OSError) as e:
            card["degradations"].append(record_degradation("hlo_stats_unavailable", summarize(e)))
    if getattr(transform, "_tuning", None) is not None:
        card["tuning"] = transform._tuning
    if getattr(transform, "_placement", None) is not None:
        card["placement"] = transform._placement
    return card


def _verification_section(transform) -> dict:
    """The supervisor's record when verification is armed, else the "off"
    record with the engine's breaker (a broken engine matters to unverified
    plans too)."""
    if transform._verifier is not None:
        return transform._verifier.describe()
    from ..verify import breaker

    return {"mode": transform._verify_mode, "checks": [], "rtol": None, "retries": 0,
            "breaker": breaker.describe(transform.engine)}


def validate_plan_card(card: dict) -> list:
    """Missing/malformed key paths of a plan card ([] when valid): the JAX
    package's check, for the sections the port's cards carry."""
    missing = [k for k in REQUIRED_KEYS if k not in card]
    if card.get("schema") not in (None, PLAN_CARD_SCHEMA):
        missing.append(f"schema (unknown: {card['schema']!r})")
    for i, entry in enumerate(card.get("degradations", ())):
        missing.extend(f"degradations[{i}].{k}" for k in DEGRADATION_KEYS if k not in entry)
    ver = card.get("verification")
    if isinstance(ver, dict):
        missing.extend(f"verification.{k}" for k in VERIFICATION_KEYS if k not in ver)
        missing.extend(f"verification.breaker.{k}" for k in BREAKER_KEYS
                       if k not in (ver.get("breaker") or {}))
    if card.get("kind") == "distributed":
        missing.extend(k for k in DISTRIBUTED_KEYS if k not in card)
        missing.extend(f"exchange.{k}" for k in EXCHANGE_KEYS if k not in card.get("exchange", {}))
        policy = card.get("exchange_policy")
        if policy is not None:
            missing.extend(f"exchange_policy.{k}" for k in POLICY_KEYS if k not in policy)
            for i, alt in enumerate(policy.get("alternatives", ())):
                missing.extend(f"exchange_policy.alternatives[{i}].{k}"
                               for k in ALTERNATIVE_KEYS if k not in alt)
        elif card.get("decomposition") == "slab":
            missing.append("exchange_policy")
    if "ir" in card:
        rec = card["ir"]
        missing.extend(f"ir.{k}" for k in IR_SECTION_KEYS if k not in rec)
        if rec.get("path") not in ("fused", "staged", "legacy"):
            missing.append(f"ir.path (unknown: {rec.get('path')!r})")
        don = rec.get("donation")
        if not isinstance(don, dict) or not {"backward", "forward"} <= set(don or {}):
            missing.append("ir.donation.backward|forward")
    if "batch" in card:
        rec = card["batch"]
        missing.extend(f"batch.{k}" for k in BATCH_SECTION_KEYS if k not in rec)
        if rec.get("requested") not in ("env", "default"):
            missing.append(f"batch.requested (unknown: {rec.get('requested')!r})")
    if "compiled" in card:
        missing.extend(f"compiled.{k}" for k in COMPILED_KEYS if k not in card["compiled"])
    if "placement" in card:
        rec = card["placement"]
        missing.extend(f"placement.{k}" for k in PLACEMENT_KEYS if k not in rec)
        if rec.get("provenance") not in ("wisdom", "model", "pinned"):
            missing.append(f"placement.provenance (unknown: {rec.get('provenance')!r})")
    if "tuning" in card:
        rec = card["tuning"]
        missing.extend(f"tuning.{k}" for k in TUNING_KEYS if k not in rec)
        if rec.get("provenance") not in ("wisdom", "model"):
            missing.append(f"tuning.provenance (unknown: {rec.get('provenance')!r})")
        for i, trial in enumerate(rec.get("trials", ())):
            missing.extend(f"tuning.trials[{i}].{k}" for k in TRIAL_KEYS if k not in trial)
            if not any(k in trial for k in TRIAL_RESULT_KEYS):
                missing.append(f"tuning.trials[{i}].ms|error")
    return missing
