"""The port's environment knobs: the engine settings it shares with the JAX
package, under the same names, defaults and validation (``spfft_tpu/knobs.py``).

Each knob is read from ``os.environ`` at every call, so a test can set it for
both packages at once. An empty value counts as unset. A malformed value, or
one outside a knob's choices, raises :class:`InvalidParameterError`; a floor
clamps.

``SPFFT_TPU_SPARSE_Y_MATRIX_MB`` is not ported: it bounds the bucket matrices
that XLA embeds in a compiled program as constants, and PyTorch embeds none.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from .errors import InvalidParameterError


@dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "str", "int" or "float"
    default: object
    doc: str
    choices: tuple | None = None
    floor: float | None = None


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
)}


def _knob(name: str) -> Knob:
    knob = REGISTRY.get(name)
    if knob is None:
        raise InvalidParameterError(f"unregistered env knob {name!r}")
    return knob


def raw(name: str):
    """The verbatim value of a registered knob, None when unset: for the
    resolvers that report where a setting came from (``ir.compile``)."""
    _knob(name)
    return os.environ.get(name)


def _ambient(name: str):
    value = os.environ.get(name)
    return None if value is None or value == "" else value


def get_str(name: str) -> str:
    knob = _knob(name)
    value = str(_ambient(name) or knob.default)
    if knob.choices and value not in knob.choices:
        raise InvalidParameterError(
            f"invalid {name} value {value!r}: expected one of {'/'.join(knob.choices)}"
        )
    return value


def _get_number(name: str, cast, what: str):
    knob = _knob(name)
    value = _ambient(name)
    try:
        value = cast(knob.default if value is None else value)
    except (TypeError, ValueError):
        raise InvalidParameterError(f"invalid {name} value {value!r}: expected {what}") from None
    return value if knob.floor is None else max(cast(knob.floor), value)


def get_int(name: str) -> int:
    return _get_number(name, int, "an integer")


def get_float(name: str) -> float:
    return _get_number(name, float, "a float")
