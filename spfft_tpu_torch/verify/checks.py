"""Algebraic self-verification checks (ABFT) of sparse-FFT results.

The port of ``spfft_tpu/verify/checks.py``: the same checks, applicability,
probe-site stream, tolerances and verdict rows. Each check recomputes an
invariant of the transform from its input and compares it with the engine's
output:

- ``parseval``: ``sum|space|^2 == N * sum|freq|^2`` (backward, C2C);
- ``dc``: ``sum(space) == N * F(0,0,0)`` (backward) and ``F(0,0,0) ==
  scale * sum(space)`` (forward, when the index set holds the origin);
- ``probe``: one output element recomputed from the DFT's definition, at a
  site drawn from ``SPFFT_TPU_VERIFY_SEED`` and the plan's geometry
  (backward: a phase sum over the values; forward: the separable contraction
  ``ez @ ((space @ ex) @ ey)``).

Where the JAX package copies the result to the host as complex128, the port
computes every sum where the tensor lives: on the card, the sums over the
space grid (``sum|space|^2``, ``sum(space)``, ``sum|space|``, the forward
contraction, the backward probe's element) run as float64 reductions on the
device, and the scalars of one call come back to the host in one transfer.
The sums over ``freq`` run on its device too (the host for numpy values).
On the CPU the same code runs on CPU tensors. Every sum is taken in float64
(complex128), as in the JAX package.

Fault site ``verify.check`` fires at the top of :func:`run_checks`, so the
detector itself can fail under test.

A mesh plan over a process group (:class:`Shards`) checks the same
invariants of the global transform: each process takes every sum over its
own shards' values and space blocks, a scalar that lives on one shard (the
origin's value, the probe's element) comes from the process that holds it
(0 from the others), and the call's scalars travel in one float64 tensor
through one ``all_reduce(SUM)``, with a flag for a process whose attempt or
detector failed. Every process then forms the same verdicts from the same
sums, or raises the same :class:`GroupFailure`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import faults, knobs, obs
from ..errors import InvalidParameterError

VERIFY_ENV = "SPFFT_TPU_VERIFY"
VERIFY_RTOL_ENV = "SPFFT_TPU_VERIFY_RTOL"
VERIFY_SEED_ENV = "SPFFT_TPU_VERIFY_SEED"

# The JAX package's check vocabulary (spfft_tpu/verify/checks.py CHECKS).
CHECKS = (
    "parseval",
    "dc",
    "probe",
)

_TINY = 1e-300  # denominator floor: never divide by an exactly-zero scale

# Failures of the detector itself (the verify.check site raises
# InjectedFault, a RuntimeError; GroupFailure is one too): an unverifiable
# result is a failed episode.
CHECKER_ERRORS = (RuntimeError,)


def resolve_mode(explicit=None) -> str:
    """``"off"``, ``"on"`` or ``"strict"``: an explicit ``verify=`` wins
    (``True``/``"1"``/``"on"``, ``"strict"``, ``False``/``"0"``/``"off"``),
    else ``SPFFT_TPU_VERIFY`` with the same values; anything else raises."""
    value = knobs.get_str(VERIFY_ENV) if explicit is None else explicit
    if value in (False, None, "0", "off", ""):
        return "off"
    if value in (True, "1", "on"):
        return "on"
    if value == "strict":
        return "strict"
    raise InvalidParameterError(
        f"invalid verification mode {value!r}: expected 0/off, 1/on, or strict"
    )


def resolve_rtol(real_dtype) -> float:
    """``SPFFT_TPU_VERIFY_RTOL`` when set, else 1e-9 for float64 plans and
    1e-4 for float32: far above the engines' error, far below corruption.
    The port's float64 plans always run in float64."""
    rtol = knobs.get_float(VERIFY_RTOL_ENV)
    if rtol is not None:
        if rtol <= 0:
            raise InvalidParameterError(
                f"{VERIFY_RTOL_ENV} must be positive, got {rtol}"
            )
        return rtol
    return 1e-9 if np.dtype(real_dtype) == np.dtype(np.float64) else 1e-4


def applicable_checks(direction: str, transform_type) -> tuple:
    """The checks valid for one call: C2C backward all three; forward
    ``dc`` and ``probe``; R2C backward none (the engine completes the
    hermitian half, which the values alone do not determine)."""
    from ..types import TransformType

    r2c = TransformType(transform_type) == TransformType.R2C
    if direction == "backward":
        return () if r2c else ("parseval", "dc", "probe")
    return ("dc", "probe")


def _probe_rng(dims, num_values, direction: str):
    """The probe-site stream: ``SPFFT_TPU_VERIFY_SEED``, the geometry and
    the direction, so that a plan's site is stable and a failure replays."""
    seed = knobs.get_int(VERIFY_SEED_ENV)
    return np.random.default_rng(
        [seed, *(int(d) for d in dims), int(num_values), direction == "forward"]
    )


def _verdict(check, measured, expected, denom, rtol):
    rel = abs(measured - expected) / max(float(denom), _TINY)
    return {
        "check": check,
        "verdict": "pass" if rel <= rtol else "fail",
        "rel": float(rel),
        "rtol": float(rtol),
        "measured": str(measured),
        "expected": str(expected),
    }


class Geometry:
    """The plan-constant side of the checks: the storage-order index rows
    aligned with the packed values (on the host), the row of the origin,
    and a copy of the rows on each device that asks (a verified plan keeps
    one, so that a call moves no index rows)."""

    def __init__(self, triplets):
        self.rows = np.asarray(triplets).reshape(-1, 3)
        hit = np.where(~self.rows.any(axis=1))[0]
        self.origin = int(hit[0]) if hit.size else None
        self._on = {}

    def on(self, device) -> torch.Tensor:
        """The rows as a float64 tensor on ``device``."""
        device = torch.device(device)
        rows = self._on.get(device)
        if rows is None:
            rows = self._on[device] = torch.as_tensor(
                self.rows.astype(np.float64), device=device)
        return rows


class Shards:
    """This process's part of a mesh plan, for checks over a process group:
    the global ``dims`` ``(Z, Y, X)`` and value count, the offset of this
    process's values in the packed order (its shards' values, concatenated,
    are one run of it), and the group (NCCL reduces on ``device``, gloo on
    the CPU)."""

    def __init__(self, group, dims, num_values, value_offset, device):
        self.group = group
        self.dims = tuple(int(d) for d in dims)
        self.num_values = int(num_values)
        self.value_offset = int(value_offset)
        self.device = torch.device(device)


class GroupFailure(RuntimeError):
    """A check over a process group that some process could not complete:
    its attempt raised, or its detector did. Every process raises it for
    the same reduced flags, so the supervisor's next step is the same on
    all of them."""


def _tensor(a) -> torch.Tensor:
    """A tensor over ``a`` (numpy arrays shared where torch can)."""
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.asarray(a))


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float64, or complex128 for a complex tensor (its layout kept)."""
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as one vector in memory order: a view, whatever the
    axis order of the layout."""
    s = t.permute(sorted(range(t.dim()), key=lambda a: -t.stride(a)))
    return (s if s.is_contiguous() else s.contiguous()).reshape(-1)


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    """``sum|t|^2`` in one pass (a dot product: no temporary)."""
    flat = _flat(t)
    return (torch.vdot(flat, flat) if t.is_complex() else torch.dot(flat, flat)).real


def _contract(space: torch.Tensor, vecs) -> tuple:
    """``(sum space, sum space[z, y, x] * vz[z] * vy[y] * vx[x])`` in one
    read of the grid, with the axes taken in memory order: the minor axis
    first, one matrix product against ``[vx, 1]`` that reads the grid in
    place, then the small rest."""
    order = sorted(range(3), key=lambda a: -space.stride(a))
    s = space.permute(order)
    rows = (s if s.is_contiguous() else s.contiguous()).reshape(-1, s.shape[2])
    ones = torch.ones(s.shape[2], dtype=rows.dtype, device=rows.device)
    v0, v1, v2 = (vecs[a] for a in order)
    if rows.is_complex():
        both = rows @ torch.stack([v2, ones], dim=1)
        first, row_sums = both[:, 0], both[:, 1]
    else:  # a real grid: v2's real and imaginary parts in the same product
        both = rows @ torch.stack([v2.real, v2.imag, ones], dim=1)
        first, row_sums = torch.complex(both[:, 0], both[:, 1]), both[:, 2]
    return row_sums.sum(), v0 @ (first.reshape(s.shape[0], s.shape[1]) @ v1)


def _phase_vec(k: float, n: int, device) -> torch.Tensor:
    """``exp(-2j*pi * k * arange(n) / n)`` in complex128, made on ``device``
    (a host array would cost a copy, which waits for the device)."""
    angle = torch.arange(n, dtype=torch.float64, device=device) * (-2 * math.pi * k / n)
    return torch.polar(torch.ones_like(angle), angle)


# ---- the checks: each names the scalars it needs, then forms its verdict ----
# A check's ``needs(ctx)`` returns ``{key: scalar tensor}``, computed where
# its operand lives; run_checks fetches every check's scalars at once and
# hands them to ``verdict(ctx, got)``, which returns the row (or None: the
# check does not apply to this call).


def _total(parts):
    """The sum of scalar tensors (the one itself for a single block)."""
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum()


def _space_sum_sq(ctx):
    """``sum|space|^2``, which ``parseval`` and ``dc`` share: taken once."""
    if "sumsq" not in ctx:
        ctx["sumsq"] = _total([_sum_sq(b) for b, _, _ in ctx["blocks"]])
    return ctx["sumsq"]


def _parseval_needs(ctx):
    return {"sumsq": _space_sum_sq(ctx), "freq_sumsq": _sum_sq(ctx["freq"])}


def _parseval(ctx, got):
    """Backward energy conservation: ``sum|space|^2 == N * sum|freq|^2``."""
    measured = got["sumsq"].real
    expected = float(ctx["size"]) * got["freq_sumsq"].real
    return _verdict("parseval", measured, expected, expected, ctx["rtol"])


def _space_sum(ctx):
    """``sum(space)``: forward, with the probe's contraction in the same
    read of the grid (:func:`_contract`, once for both checks)."""
    if "sum" not in ctx:
        vecs = _probe_vecs(ctx) if ctx["direction"] == "forward" else None
        if vecs is None:
            ctx["sum"], ctx["contract"] = _total([b.sum() for b, _, _ in ctx["blocks"]]), None
        else:  # each block against its window of the phase vectors
            vz, vy, vx = vecs
            parts = [_contract(b, (vz[z0:z0 + b.shape[0]], vy[y0:y0 + b.shape[1]], vx))
                     for b, z0, y0 in ctx["blocks"]]
            ctx["sum"] = _total([p[0] for p in parts])
            ctx["contract"] = _total([p[1] for p in parts])
    return ctx["sum"]


def _value_at(ctx, j):
    """Packed value ``j`` (a global index) where this process holds it, else 0."""
    lo = ctx["lo"]
    if lo <= j < lo + ctx["freq"].numel():
        return ctx["freq"][j - lo]
    return ctx["freq"].new_zeros(())


def _space_at(ctx, z, y, x):
    """Space element ``(z, y, x)`` from the block that holds it, else 0."""
    for b, z0, y0 in ctx["blocks"]:
        if z0 <= z < z0 + b.shape[0] and y0 <= y < y0 + b.shape[1]:
            return b[z - z0, y - y0, x]
    return ctx["blocks"][0][0].new_zeros(())


def _dc_needs(ctx):
    need = {"sumsq": _space_sum_sq(ctx), "sum": _space_sum(ctx)}
    j = ctx["geometry"].origin
    if j is not None:
        need["f0"] = _value_at(ctx, j)
    return need


def _dc(ctx, got):
    """DC consistency: only the zero-frequency term survives a grid sum."""
    size = ctx["size"]
    j = ctx["geometry"].origin
    # tolerance scale: the cancellation mass of the grid sum (sqrt(N) * l2)
    mass = math.sqrt(size) * math.sqrt(max(got["sumsq"].real, 0.0))
    if ctx["direction"] == "backward":
        f0 = got["f0"] if j is not None else 0.0
        measured = got["sum"]
        expected = float(size) * f0
        denom = max(abs(expected), mass)
    else:
        if j is None:
            return None  # origin not in the sparse set: nothing to compare
        scale = ctx["scale"]
        measured = got["f0"]
        expected = scale * got["sum"]
        denom = max(abs(expected), scale * mass)
    return _verdict("dc", measured, expected, denom, ctx["rtol"])


def _probe_site(ctx):
    """The probe's site: ``(z, y, x)`` backward, a value's index forward."""
    dz, dy, dx = ctx["dims"]
    rng = _probe_rng((dx, dy, dz), ctx["num_values"], ctx["direction"])
    if ctx["direction"] == "backward":
        return int(rng.integers(dz)), int(rng.integers(dy)), int(rng.integers(dx))
    return int(rng.integers(ctx["num_values"]))


def _probe_needs(ctx):
    freq = ctx["freq"]
    if not ctx["num_values"]:
        return {}
    dz, dy, dx = ctx["dims"]
    site = _probe_site(ctx)
    if ctx["direction"] == "backward":
        zs, ys, xs = site
        k = ctx["geometry"].on(freq.device)[ctx["lo"]:ctx["lo"] + freq.numel()]
        phase = 2 * math.pi * (k[:, 0] * xs / dx + k[:, 1] * ys / dy + k[:, 2] * zs / dz)
        return {"probe_expected": (freq * torch.polar(torch.ones_like(phase), phase)).sum(),
                "probe_measured": _space_at(ctx, zs, ys, xs),
                "freq_l1": torch.linalg.vector_norm(freq, ord=1)}
    _space_sum(ctx)
    return {"contract": ctx["contract"], "probe_measured": _value_at(ctx, site),
            "l1": _total([torch.linalg.vector_norm(_flat(b), ord=1)
                          for b, _, _ in ctx["blocks"]])}


def _probe_vecs(ctx):
    """The forward probe's phase vectors ``(ez, ey, ex)``, or None when there
    is no value to probe."""
    if not ctx["num_values"]:
        return None
    dz, dy, dx = ctx["dims"]
    kx, ky, kz = (float(v) for v in ctx["geometry"].rows[_probe_site(ctx)])
    device = ctx["blocks"][0][0].device
    return [_phase_vec(k, n, device) for k, n in ((kz, dz), (ky, dy), (kx, dx))]


def _probe(ctx, got):
    """Random-probe linearity: one output element recomputed from the DFT
    definition (backward: a phase sum over the values at one space site;
    forward: one separable contraction over the space grid)."""
    if not ctx["num_values"]:
        return None
    if ctx["direction"] == "backward":
        expected = got["probe_expected"]
        denom = max(abs(expected), got["freq_l1"].real)
    else:
        scale = ctx["scale"]
        expected = scale * got["contract"]
        denom = max(abs(expected), scale * got["l1"].real)
    return _verdict("probe", got["probe_measured"], expected, denom, ctx["rtol"])


# name -> (needs, verdict); CHECKS == CHECK_FNS keys, as in the JAX package
CHECK_FNS = {
    "parseval": (_parseval_needs, _parseval),
    "dc": (_dc_needs, _dc),
    "probe": (_probe_needs, _probe),
}


def _fetch(named: dict) -> dict:
    """The scalar tensors of ``named`` as Python complex numbers: one host
    transfer per device."""
    out, by_device = {}, {}
    for key, t in named.items():
        by_device.setdefault(t.device, []).append(key)
    for keys in by_device.values():
        vals = torch.stack([named[k].to(torch.complex128).reshape(()) for k in keys]).cpu()
        out.update(zip(keys, vals.tolist()))
    return out


# Every scalar a check may need, in the order of the reduced vector; a call
# that needs fewer sends zeros in the others' places.
SCALARS = ("sumsq", "freq_sumsq", "sum", "f0", "probe_expected", "probe_measured",
           "freq_l1", "contract", "l1")


def _group_device(group, device) -> torch.device:
    """Where a collective of ``group`` runs: on ``device`` over NCCL, on the
    CPU over gloo."""
    import torch.distributed as dist

    return torch.device(device) if dist.get_backend(group) == "nccl" else torch.device("cpu")


def group_scalar(value: float, group, device, op=None) -> float:
    """``value`` reduced over ``group`` (SUM, or ``op``) in one all-reduce."""
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=_group_device(group, device))
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return float(t.item())


def _reduce(named: dict, shards: Shards, failure) -> dict:
    """The scalars of ``named`` summed over the group: one float64 tensor
    (each scalar's real and imaginary parts, then the counts of processes
    whose attempt and whose detector failed) through one
    ``all_reduce(SUM)``, then one host transfer. Raises
    :class:`GroupFailure` on every process if any process failed."""
    import torch.distributed as dist

    device = _group_device(shards.group, shards.device)
    zero = torch.zeros((), dtype=torch.complex128, device=device)
    parts = [named[k].to(device=device, dtype=torch.complex128).reshape(()) if k in named
             else zero for k in SCALARS]
    flags = [failure is not None and failure[0] == "execution",
             failure is not None and failure[0] == "checker"]
    vec = torch.cat([torch.view_as_real(torch.stack(parts)).reshape(-1),
                     torch.tensor(flags, dtype=torch.float64).to(device)])
    dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=shards.group)
    host = vec.cpu().tolist()
    executions, checkers = int(host[-2]), int(host[-1])
    if executions or checkers:
        world = dist.get_world_size(shards.group)
        mine = f"; this process: {failure[0]}: {failure[1]}" if failure is not None else ""
        raise GroupFailure(
            f"{executions} of {world} process(es) failed to execute and {checkers} "
            f"failed to check{mine}")
    return {k: complex(host[2 * i], host[2 * i + 1]) for i, k in enumerate(SCALARS)
            if k in named}


def run_checks(
    *,
    direction: str,
    freq,
    space,
    triplets,
    transform_type,
    scale: float = 1.0,
    rtol: float,
    shards: Shards | None = None,
    failure=None,
) -> list:
    """Run every applicable check of one call; returns the verdict rows
    (``check``/``verdict``/``rel``/``rtol``/``measured``/``expected``).

    ``freq`` is the packed value vector (the input of backward, the output
    of forward), ``space`` the ``(Z, Y, X)`` grid (any strides, on any
    device), both tensors or numpy arrays; ``triplets`` the storage-order
    rows aligned with ``freq`` (or a :class:`Geometry`), ``scale`` the
    forward scaling (1/N under ``ScalingType.FULL``).

    Over a process group (``shards``) ``freq`` is this process's values,
    ``space`` its blocks as ``(block, z0, y0)``, each at its offset in the
    global grid, and ``triplets`` the global rows; ``failure`` is ``("execution", reason)``
    when this process's attempt raised (``freq`` or ``space`` may then be
    None). Every process of the group must call, whatever its own attempt
    did: the call holds the group's one all-reduce.

    Each verdict counts ``verify_checks_total{check,verdict}`` and lands as
    a ``verify`` event. Fault site ``verify.check`` fires first: a ``raise``
    there is the detector failing, which the supervisor treats as a failed
    check, never as a pass."""
    names = applicable_checks(direction, transform_type)
    geometry = triplets if isinstance(triplets, Geometry) else Geometry(triplets)
    if shards is None:
        faults.site("verify.check")
        if not names:  # nothing to verify: no pass over the grid
            return []
        space = _wide(_tensor(space))
        freq = _wide(_tensor(freq).reshape(-1))
        ctx = _context(direction, freq, [(space, 0, 0)], tuple(space.shape), 0,
                       freq.numel(), geometry, scale, rtol)
        got = _fetch(_needs(ctx, names))
    else:
        need, ctx = {}, None
        if failure is None:
            try:
                faults.site("verify.check")
                if names:
                    ctx = _context(direction, _wide(_tensor(freq).reshape(-1)),
                                   [(_wide(_tensor(b)), z0, y0) for b, z0, y0 in space],
                                   shards.dims, shards.value_offset, shards.num_values,
                                   geometry, scale, rtol)
                    need = _needs(ctx, names)
            except CHECKER_ERRORS as e:
                failure = ("checker", faults.summarize(e))
        got = _reduce(need, shards, failure)
        if ctx is None:  # no check applies to this call
            return []
    verdicts = []
    for name in names:
        row = CHECK_FNS[name][1](ctx, got)
        if row is None:
            continue
        obs.counter("verify_checks_total", check=name, verdict=row["verdict"]).inc()
        obs.trace.event(
            "verify",
            what="check",
            check=name,
            verdict=row["verdict"],
            direction=direction,
            rel=row["rel"],
        )
        verdicts.append(row)
    return verdicts


def _context(direction, freq, blocks, dims, lo, num_values, geometry, scale, rtol) -> dict:
    """One call's operands: the values (this process's, from global index
    ``lo``), the space blocks ``(block, z0, y0)``, the global dims and value
    count."""
    dims = tuple(int(d) for d in dims)
    return {
        "direction": direction,
        "freq": freq,
        "blocks": blocks,
        "dims": dims,
        "size": dims[0] * dims[1] * dims[2],
        "lo": int(lo),
        "num_values": int(num_values),
        "geometry": geometry,
        "scale": float(scale),
        "rtol": float(rtol),
    }


def _needs(ctx, names) -> dict:
    need = {}
    for name in names:
        need.update(CHECK_FNS[name][0](ctx))
    return need
