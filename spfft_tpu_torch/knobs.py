"""The port's environment knobs: the engine settings it shares with the JAX
package, under the same names, defaults and validation (``spfft_tpu/knobs.py``).

Each knob is read from ``os.environ`` at every call, so a test can set it for
both packages at once. An empty value counts as unset. A malformed value, or
one outside a knob's choices, raises :class:`InvalidParameterError`; a floor
clamps.

``SPFFT_TPU_SPARSE_Y_MATRIX_MB`` is not ported: it bounds the bucket matrices
that XLA embeds in a compiled program as constants, and PyTorch embeds none.
Neither is ``SPFFT_TPU_ADVISORY_FENCE``: it selects the scalar-probe fence of
a TPU runtime whose ``block_until_ready`` returns early (:mod:`.sync`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import InvalidParameterError

PREFIX = "SPFFT_TPU_"


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "str", "int", "float" or "bool"
    default: object
    doc: str
    choices: tuple | None = None
    floor: float | None = None
    # a knob that only tests, drivers or measurements read: kept out of the
    # docs' knob table, as the JAX registry's ``internal=True`` rows are
    internal: bool = False


REGISTRY = {k.name: k for k in (
    Knob("SPFFT_TPU_SPARSE_Y", "str", "auto",
         "per-slot y-DFT contraction off the stick table; auto engages below the "
         "Sy/Y < 0.6 crossover (`1`/`0` force on/off)", choices=("auto", "0", "1")),
    Knob("SPFFT_TPU_SPARSE_Y_BLOCKS", "str", "auto",
         "blocked sparse-y bucket count; auto = 4 at dim_y <= 256, 8 above; `0` "
         "disables, a positive integer forces G"),
    Knob("SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC", "float", 0.8,
         "auto blocked-y engages when padded bucket rows < frac x dense extent"),
    Knob("SPFFT_TPU_XPAD", "int", 8, "active-x extent padding quantum", floor=1),
    Knob("SPFFT_TPU_FUSE", "str", "1",
         "stage-graph fusion (`spfft_tpu_torch.ir`): `1` runs each direction's stage "
         "graph as one program (one CUDA-graph replay on the card); `0` runs the staged "
         "per-node reference path (a plan's `fuse=` argument wins)", choices=("0", "1")),
    Knob("SPFFT_TPU_BATCH_FUSE", "str", "1",
         "batch fusion: `1` lets a same-plan batch of B transforms run as one program "
         "per direction; `0` keeps the per-request loop. Read at call time",
         choices=("0", "1")),
    Knob("SPFFT_TPU_TWIDDLE_BF16", "bool", False,
         "`1` rounds the matrix-product engines' DFT stage matrices to bfloat16 "
         "(float32 plans only; float64 plans ignore it). At `highest` K1 runs its "
         "`highest-bf16` form, which reads them as bfloat16; the plan is then about "
         "1e-3 from the exact transform. The `mxu/bf16-twiddle` tuning candidate "
         "sets it"),
    # ---- plan decisions, tuning and scheduling (spfft_tpu_torch.tuning, .sched) ----
    Knob("SPFFT_TPU_POLICY", "str", "default",
         "plan-decision policy: `tuned` resolves `ExchangeType.DEFAULT` and "
         "`engine=\"auto\"` by measurement through `spfft_tpu_torch.tuning` (a "
         "plan's `policy=` argument wins)", choices=("default", "tuned")),
    Knob("SPFFT_TPU_WISDOM", "str", None,
         "path of the wisdom JSON file that the tuned policy reads and writes; "
         "unset = a store in process memory"),
    Knob("SPFFT_TPU_TUNE_REPEATS", "int", 5,
         "timed round trips per tuning trial candidate (the best counts)", floor=1),
    Knob("SPFFT_TPU_TUNE_WARMUP", "int", 1,
         "untimed round trips per trial candidate before the timed ones (CUDA-graph "
         "capture and kernel builds land there)", floor=0),
    Knob("SPFFT_TPU_TUNE_CPU", "bool", False,
         "`1` lets tuning trials run on CPU plans (tests); by default a CPU plan "
         "takes the model policy, so CPU timings never enter wisdom"),
    Knob("SPFFT_TPU_SCHED_INFLIGHT", "int", 8,
         "task-graph executor window: transform executions dispatched at once "
         "before one must be finalized (`sched.run_graph(max_inflight=)` wins)", floor=1),
    # ---- serving and the fleet (spfft_tpu_torch.serve, .hostmesh, .obs.fleet) ----
    Knob("SPFFT_TPU_SERVE_QUEUE_CAP", "int", 256,
         "bounded admission-queue capacity of a `serve.TransformService`: offered "
         "load beyond it is refused with typed `ServiceOverloadError`", floor=1),
    Knob("SPFFT_TPU_SERVE_BATCH_MAX", "int", 8,
         "max requests coalesced into one batched execution (and the plan-clone "
         "pool width per cached geometry)", floor=1),
    Knob("SPFFT_TPU_SERVE_TENANT_QUOTA", "float", 0.5,
         "fraction of the queue one tenant may hold (floor 1 slot)", floor=0.0),
    Knob("SPFFT_TPU_SERVE_TIMEOUT_S", "float", 0.0,
         "default per-request deadline (0 = none; `timeout_s=` wins): enforced at "
         "admission and before every dispatch attempt", floor=0.0),
    Knob("SPFFT_TPU_SERVE_RETRIES", "int", 1,
         "re-dispatches of a batch after a transient typed execution failure, "
         "with jittered exponential backoff", floor=0),
    Knob("SPFFT_TPU_SERVE_BACKOFF_S", "float", 0.005,
         "base of the serving retry backoff (jittered x[0.5, 1.5))", floor=0.0),
    Knob("SPFFT_TPU_SERVE_ON_BREAKER", "str", "demote",
         "what the service does with a batch whose engine's breaker is open: "
         "`demote` (the plan's `torch.fft` reference rung) or `shed` (typed "
         "refusal)", choices=("demote", "shed")),
    Knob("SPFFT_TPU_SERVE_PLANS", "int", 16,
         "plan-cache capacity (whole geometry entries, LRU-evicted; keyed like "
         "the wisdom store)", floor=1),
    Knob("SPFFT_TPU_SERVE_SCHED", "bool", False,
         "`1` = one dispatch cycle pops up to `SPFFT_TPU_SERVE_SCHED_BATCHES` "
         "coalesced batches, mixed geometries included, and runs them as one "
         "task graph"),
    Knob("SPFFT_TPU_SERVE_SCHED_BATCHES", "int", 4,
         "coalesced batches one graph-scheduled dispatch cycle may drain", floor=1),
    Knob("SPFFT_TPU_HOSTS_HEARTBEAT_S", "float", 0.25,
         "heartbeat interval of the cluster front's liveness monitor (sleeps "
         "jittered x[0.5, 1.5))", floor=0.01),
    Knob("SPFFT_TPU_HOSTS_HEARTBEAT_MISSES", "int", 3,
         "consecutive failed heartbeat probes after which a worker host is "
         "declared lost", floor=1),
    Knob("SPFFT_TPU_HOSTS_RETRIES", "int", 2,
         "times one in-flight task may be requeued onto a surviving host before "
         "it resolves typed `HostLostError`", floor=0),
    Knob("SPFFT_TPU_HOSTS_BACKOFF_S", "float", 0.02,
         "base of the jittered backoff between host-loss requeues", floor=0.0),
    Knob("SPFFT_TPU_HOSTS_WISDOM_BUNDLE", "str", None,
         "fleet wisdom bundle a worker host merges into its own store at boot "
         "(`hostmesh.warm_start`); unset = cold store"),
    Knob("SPFFT_TPU_RPC_TIMEOUT_S", "float", 30.0,
         "per-call wall deadline of the RPC transport: a connect/send/receive "
         "past it raises typed `HostLostError` naming the host", floor=0.1),
    Knob("SPFFT_TPU_FLEET_SCRAPE_S", "float", 5.0,
         "per-host wall deadline of one fleet metric scrape: a host that cannot "
         "answer inside it is stamped `unreachable`", floor=0.1),
    # ---- observability (spfft_tpu_torch.obs, .timing, .sync) ----
    Knob("SPFFT_TPU_METRICS", "bool", True,
         "`0` disables the `spfft_tpu_torch.obs` run-metrics registry at import: "
         "instrument factories hand out one shared no-op (`obs.enable()/disable()` "
         "override at runtime)"),
    Knob("SPFFT_TPU_TRACE", "bool", False,
         "`1` arms the flight recorder at import (`obs.trace.enable()` overrides at "
         "runtime); events land in a bounded ring buffer joined to plan cards by run ID"),
    Knob("SPFFT_TPU_TRACE_CAP", "int", 4096,
         "flight-recorder ring-buffer capacity (oldest events evicted; `dropped` "
         "counts them)", floor=1),
    Knob("SPFFT_TPU_TRACE_DUMP", "str", None,
         "directory the recorder flushes to when a typed error is constructed; "
         "unset = no dumps"),
    Knob("SPFFT_TPU_PERF_FLOP_PER_BYTE", "float", 8.0,
         "machine balance (flop/byte) with which the perf report's stage model "
         "mixes flop-weighted and byte-weighted stages"),
    Knob("SPFFT_TPU_FENCE_BUDGET_S", "float", 0.0,
         "wall-clock deadline of one completion fence: past it the fence raises "
         "`FenceTimeout`; 0 or unset = an unbudgeted wait"),
    # ---- fault injection and guard (spfft_tpu_torch.faults) ----
    Knob("SPFFT_TPU_FAULTS", "str", None,
         "arms fault-injection sites: `\"site=kind[:rate],...\"` over the "
         "`spfft_tpu_torch.faults.SITES` vocabulary with kinds "
         "`raise`/`nan`/`corrupt`/`delay`; unset = every site is a no-op check"),
    Knob("SPFFT_TPU_FAULTS_SEED", "int", 0,
         "seed of the sub-1.0-rate fault draw stream (`faults.reseed`)"),
    Knob("SPFFT_TPU_FAULTS_DELAY_S", "float", 0.005,
         "sleep injected by the `delay` fault kind"),
    Knob("SPFFT_TPU_GUARD", "bool", False,
         "`1` turns on guard mode on every plan (a plan's `guard=` wins): "
         "non-finite scans on the device plus shape/dtype/device checks around "
         "host-facing transforms, raising typed errors"),
    # ---- verification and the breaker (spfft_tpu_torch.verify) ----
    Knob("SPFFT_TPU_VERIFY", "str", "0",
         "`1` arms ABFT self-verification on every plan (a plan's `verify=` wins): "
         "algebraic checks and the retry, demote and break supervisor; `strict` "
         "raises `VerificationError` on the first failed check",
         choices=("0", "1", "on", "off", "strict")),
    Knob("SPFFT_TPU_VERIFY_RTOL", "float", None,
         "relative tolerance of the verification checks (unset: 1e-4 for float32 "
         "plans, 1e-9 for float64)"),
    Knob("SPFFT_TPU_VERIFY_SEED", "int", 0,
         "seed of the deterministic probe-site stream"),
    Knob("SPFFT_TPU_VERIFY_RETRIES", "int", 2,
         "re-executions after a failed check or typed execution error, before the "
         "`torch.fft` reference rung", floor=0),
    Knob("SPFFT_TPU_VERIFY_BACKOFF_S", "float", 0.01,
         "base of the exponential retry backoff, jittered x[0.5, 1.5)", floor=0.0),
    Knob("SPFFT_TPU_VERIFY_JITTER_SEED", "int", None,
         "seeds the retry-backoff jitter stream; unset, each supervisor draws "
         "from system entropy"),
    Knob("SPFFT_TPU_VERIFY_BREAKER_K", "int", 3,
         "consecutive verified-failure episodes that trip an engine's "
         "process-global circuit breaker", floor=1),
    Knob("SPFFT_TPU_VERIFY_BREAKER_COOLDOWN_S", "float", 30.0,
         "open -> half-open probe delay of the engine circuit breaker", floor=0.0),
    # ---- static analysis and runtime lockdep (spfft_tpu_torch.analysis) ----
    Knob("SPFFT_TPU_LOCKDEP", "bool", False,
         "`1` arms the runtime lockdep validator at import "
         "(`spfft_tpu_torch.analysis.lockdep`): every `threading.Lock/RLock/"
         "Condition/Event` the package creates is wrapped to record the real "
         "acquisition-order graph (cycles, and waits entered with another lock "
         "still held), which cross-checks against the SA011 static model "
         "(`spfft_tpu_torch/programs/analyze.py --lockdep-check`)"),
    Knob("SPFFT_TPU_LOCKDEP_REPORT", "str", None,
         "path the armed lockdep validator writes its "
         "`spfft_tpu_torch.analysis.lockdep/1` JSON report to at process exit; "
         "unset = in-process only (`lockdep.report()`); not propagated to "
         "spawned workers (`hostmesh.spawn_workers(lockdep_dir=)` gives each its "
         "own)"),
    # ---- test-only ----
    Knob("SPFFT_TPU_FUZZ_SEED", "int", 0,
         "test-only: seed offset of the scheduler's fuzzed task graphs "
         "(tests/test_torch_sched.py)", internal=True),
)}

_TRUE_WORDS = ("1", "true", "on")
_FALSE_WORDS = ("0", "false", "off")


def _knob(name: str) -> Knob:
    knob = REGISTRY.get(name)
    if knob is None:
        raise InvalidParameterError(f"unregistered env knob {name!r}")
    return knob


def default(name: str):
    """The registered default of ``name`` (modules bind their ``DEFAULT_*``
    constants to it, so that the registry stays the one holder)."""
    return _knob(name).default


def raw(name: str):
    """The verbatim value of a registered knob, None when unset: for the
    resolvers that report where a setting came from (``ir.compile``)."""
    _knob(name)
    return os.environ.get(name)


def _ambient(name: str):
    value = os.environ.get(name)
    return None if value is None or value == "" else value


def get_str(name: str, override=None):
    """The value as a string; None for an unset knob without a default.
    ``override`` (an explicit caller argument) wins over the environment."""
    knob = _knob(name)
    value = override if override is not None else (_ambient(name) or knob.default)
    if value is None:
        return None
    value = str(value)
    if knob.choices and value not in knob.choices:
        raise InvalidParameterError(
            f"invalid {name} value {value!r}: expected one of {'/'.join(knob.choices)}"
        )
    return value


def _get_number(name: str, cast, what: str, override=None):
    """The value cast; None for an unset knob without a default."""
    knob = _knob(name)
    value = override if override is not None else _ambient(name)
    if value is None and knob.default is None:
        return None
    try:
        value = cast(knob.default if value is None else value)
    except (TypeError, ValueError):
        raise InvalidParameterError(f"invalid {name} value {value!r}: expected {what}") from None
    return value if knob.floor is None else max(cast(knob.floor), value)


def get_int(name: str, override=None) -> int:
    """``override`` (an explicit caller argument) wins, else the environment,
    else the default; the floor clamps either."""
    return _get_number(name, int, "an integer", override)


def get_float(name: str, override=None) -> float:
    return _get_number(name, float, "a float", override)


def get_bool(name: str, override=None) -> bool:
    """``1/true/on`` and ``0/false/off`` (any case); anything else raises.
    ``override`` wins."""
    knob = _knob(name)
    if override is not None:
        return bool(override)
    value = _ambient(name)
    if value is None:
        return bool(knob.default)
    lowered = value.strip().lower()
    if lowered in _TRUE_WORDS:
        return True
    if lowered in _FALSE_WORDS:
        return False
    raise InvalidParameterError(
        f"invalid {name} value {value!r}: expected 0/1 (or true/false, on/off)")
