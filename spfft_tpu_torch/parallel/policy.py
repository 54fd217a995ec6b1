"""The rule that resolves ``ExchangeType.DEFAULT``, and the plan options that
only take their defaults here.

The port of ``spfft_tpu/parallel/policy.py``. The reference hardwires DEFAULT
to COMPACT_BUFFERED (src/spfft/grid_internal.cpp:176-179); the JAX package
picks the discipline of least ``wire_bytes(d) + rounds(d) * round_cost``.
With its one-shot exchange supported, which the port's always is
(``all_to_all_single`` takes uneven split sizes on every backend), that
minimum does not depend on the round cost:

* BUFFERED and UNBUFFERED each take one round, and UNBUFFERED's exact rows
  (``(P-1) sum_i sticks_i L_max``) never exceed BUFFERED's padded blocks
  (``P (P-1) S_max L_max``); they tie exactly when every shard holds the
  same number of sticks, and ties go to BUFFERED;
* COMPACT_BUFFERED ships BUFFERED's volume in P-1 rounds, so it never wins.

DEFAULT is therefore UNBUFFERED when the shards' stick counts differ and
BUFFERED otherwise (:func:`resolve_default_exchange`). A round-cost knob
returns with a discipline that takes more than one round on this transport.
Explicit disciplines are never overridden.
"""
from __future__ import annotations

import numpy as np

from .. import knobs
from ..errors import InvalidParameterError
from ..types import ExchangeType

# "default": this module's rule resolves ExchangeType.DEFAULT and the static
#            auto rule picks the engine;
# "tuned":   spfft_tpu_torch.tuning measures the alternatives on the plan's
#            own geometry and device and keeps the winner in wisdom
#            (SPFFT_TPU_WISDOM), falling back to "default" where trials
#            cannot run.
POLICY_ENV = "SPFFT_TPU_POLICY"
POLICIES = ("default", "tuned")
# The OVERLAPPED exchange: a padded exchange split into C chunk collectives,
# each pipelined against its neighbour chunks' DFT stages (parallel/execution.py).
OVERLAP_ENV = "SPFFT_TPU_OVERLAP_CHUNKS"


def resolve_policy(policy=None) -> str:
    """The plan-decision policy: the explicit argument, else
    ``SPFFT_TPU_POLICY``, else ``"default"``."""
    policy = knobs.get_str(POLICY_ENV) if policy is None else str(policy)
    if policy not in POLICIES:
        raise InvalidParameterError(f"unknown policy {policy!r}: expected one of {POLICIES}")
    return policy


def resolve_overlap_chunks(overlap=None) -> int:
    """The requested exchange-overlap chunk count (the OVERLAPPED
    discipline): the explicit argument, else ``SPFFT_TPU_OVERLAP_CHUNKS``,
    else 1. The engines clamp it to what their geometry can chunk (the
    stick extent on a slab mesh, the local z window on a pencil mesh; 1 for
    the exact-count disciplines and for one shard): this resolves intent,
    not feasibility."""
    overlap = knobs.get_int(OVERLAP_ENV) if overlap is None else int(overlap)
    if overlap < 1:
        raise InvalidParameterError(f"overlap chunk count must be >= 1, got {overlap}")
    return overlap


def discipline_volumes(num_sticks_per_shard, local_z_lengths) -> dict:
    """Off-shard complex elements of one exchange, per discipline, the same
    rule as the engines' ``exchange_wire_bytes``: BUFFERED and
    COMPACT_BUFFERED ``P (P-1) S_max L_max`` (COMPACT's window is the padded
    block), UNBUFFERED ``(P-1) sum_i sticks_i L_max`` (exact rows of
    ``L_max`` planes)."""
    s = np.asarray(num_sticks_per_shard, dtype=np.int64)
    l = np.asarray(local_z_lengths, dtype=np.int64)
    P = int(s.size)
    if P <= 1:
        return {d: 0 for d in (ExchangeType.BUFFERED, ExchangeType.COMPACT_BUFFERED,
                               ExchangeType.UNBUFFERED)}
    padded = P * (P - 1) * int(s.max()) * int(max(1, l.max()))
    return {
        ExchangeType.BUFFERED: padded,
        ExchangeType.COMPACT_BUFFERED: padded,
        ExchangeType.UNBUFFERED: (P - 1) * int(s.sum()) * int(max(1, l.max())),
    }


def resolve_default_exchange(num_sticks_per_shard) -> ExchangeType:
    """The discipline DEFAULT resolves to: UNBUFFERED when the shards' stick
    counts differ, else BUFFERED (the module docstring says why)."""
    s = np.asarray(num_sticks_per_shard)
    if s.size > 1 and s.min() != s.max():
        return ExchangeType.UNBUFFERED
    return ExchangeType.BUFFERED


def resolve_default_for_plan(params) -> ExchangeType:
    """DEFAULT for a slab plan."""
    return resolve_default_exchange(params.num_sticks_per_shard)
