"""The comparison that decides ``correct``.

What the timed path produced is held to :mod:`perfbench.reference`, band by
band, on the device, after the port's state is freed:

- ``bwd_err``: the space of every sampled band (the band's last pair of the
  run), as the program's backward returned it and the harness multiplied it
  by ``V(r)``, against ``V`` times the reference's backward:
  ``max |space - reference| / max |reference|``;
- ``fwd_err``: every band's last forward(FULL) values against the
  reference's forward of ``V`` times the reference's space, by the same
  measure. ``V`` is not constant, so the pair is not the identity: a
  forward that handed back the backward's input values would fail.

A band with no result counts as failed. Each number has its limit in the
configuration's file (``check.limits``).
"""
from __future__ import annotations

import math

import torch

from . import inputs, reference


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(torch.complex128) if want.is_complex() else want.double()
    err = float((got.to(want.dtype) - want).abs().max() / want.abs().max())
    return err if math.isfinite(err) else math.inf


def to_zyx(data: torch.Tensor, layout: str) -> torch.Tensor:
    """A tensor in the native ``layout`` (``"yxz"`` or ``"zyx"``) as ``(Z, Y, X)``."""
    return data.permute(2, 0, 1) if layout == "yxz" else data


def space_zyx(space, layout: str, r2c: bool) -> torch.Tensor:
    """The port's native space -> the ``(Z, Y, X)`` tensor (complex for C2C)."""
    return to_zyx(space if r2c else torch.complex(space[0].double(), space[1].double()), layout)


def band_errors(cfg: dict, trip, values_b, potential, space=None, result=None) -> dict:
    """``bwd_err`` of ``space`` and ``fwd_err`` of ``result`` (complex values)
    for one band's ``(2, n)`` values; ``potential`` and ``space`` are
    ``(Z, Y, X)``; None where not given."""
    grid, r2c = inputs.dims(cfg), inputs.is_r2c(cfg)
    v = torch.complex(values_b[0].double(), values_b[1].double())
    ref_space = reference.backward(v, trip, grid, r2c) * potential.double()
    out = {"bwd_err": None, "fwd_err": None}
    if space is not None:
        out["bwd_err"] = rel_err(space, ref_space)
    if result is not None:
        out["fwd_err"] = rel_err(result, reference.forward_full(ref_space, trip, grid))
    return out


def compare(cfg: dict, trip, values, potential, results: list, kept: dict, layout: str) -> dict:
    """The numbers of a run: the worst band's of each, every band's, and
    the bands that have no result; ``potential`` in the native ``layout``."""
    r2c = inputs.is_r2c(cfg)
    potential = to_zyx(potential, layout).double()
    per_band = []
    for b, res in enumerate(results):
        space = space_zyx(kept[b], layout, r2c) if b in kept else None
        got = None if res is None else torch.complex(res[0].double(), res[1].double())
        per_band.append(None if got is None
                        else band_errors(cfg, trip, values[b], potential, space, got))
    worst = {name: max((e[name] for e in per_band if e and e[name] is not None), default=0.0)
             for name in ("bwd_err", "fwd_err")}
    return {**worst, "missing": sum(e is None for e in per_band), "per_band": per_band}


def judge(numbers: dict, limits: dict) -> tuple[bool, int, dict]:
    """(correct, failed bands, ``{name: {"value", "limit"}}``): correct when
    each number is at or under its limit and no band is missing."""
    shown = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    shown["missing"] = {"value": numbers["missing"], "limit": 0}
    failed = sum(e is None or any(e[n] is not None and e[n] > limits[n] for n in limits)
                 for e in numbers["per_band"])
    return all(s["value"] <= s["limit"] for s in shown.values()), failed, shown
