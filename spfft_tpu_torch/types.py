"""Public enums of spfft_tpu_torch.

The same names and values as the reference C enums (reference:
include/spfft/types.h:67-117), so callers of the original library and of the
JAX package find the same vocabulary.
"""
from __future__ import annotations

import enum

import torch


class ExchangeType(enum.IntEnum):
    """The slab <-> pencil exchange discipline of a distributed transform.
    Reference: include/spfft/types.h:33-62; the JAX package's extensions
    (``*_BF16``) keep their numbers.

    * BUFFERED: every shard pair exchanges one padded ``S_max x L_max``
      block, in one equal-split ``all_to_all``;
    * COMPACT_BUFFERED: the blocks the JAX package's COMPACT chain ships
      (its constant ``(S_max, L_max)`` window per pair), in one collective;
    * UNBUFFERED: exactly ``sticks_i`` rows of ``L_max`` planes per pair
      ``i -> j``, in one collective with uneven split sizes (the
      reference's ``MPI_Alltoallw``);
    * ``*_FLOAT``: the payload crosses the wire in float32 (halving it for
      float64 plans); ``*_BF16``: in bfloat16, about 3 significant digits,
      an explicit opt-in.

    DEFAULT resolves per plan through the cost model of
    :mod:`spfft_tpu_torch.parallel.policy`, not to COMPACT_BUFFERED as in the
    reference.
    """

    DEFAULT = 0
    BUFFERED = 1
    BUFFERED_FLOAT = 2
    COMPACT_BUFFERED = 3
    COMPACT_BUFFERED_FLOAT = 4
    UNBUFFERED = 5
    BUFFERED_BF16 = 6
    COMPACT_BUFFERED_BF16 = 7


FLOAT_EXCHANGES = (ExchangeType.BUFFERED_FLOAT, ExchangeType.COMPACT_BUFFERED_FLOAT)
BF16_EXCHANGES = (ExchangeType.BUFFERED_BF16, ExchangeType.COMPACT_BUFFERED_BF16)
# The exact-count disciplines (parallel/ragged.py): every other one ships
# the padded blocks.
RAGGED_EXCHANGES = (
    ExchangeType.COMPACT_BUFFERED,
    ExchangeType.COMPACT_BUFFERED_FLOAT,
    ExchangeType.COMPACT_BUFFERED_BF16,
    ExchangeType.UNBUFFERED,
)


def wire_dtype(exchange_type, real_dtype) -> torch.dtype:
    """The real dtype an exchange puts on the wire for a plan of
    ``real_dtype`` (numpy or torch): the one rule that the engines cast with
    and the wire-byte accounting reads."""
    real = real_dtype if isinstance(real_dtype, torch.dtype) else (
        torch.float64 if str(real_dtype) == "float64" else torch.float32)
    if exchange_type in BF16_EXCHANGES:
        return torch.bfloat16
    if exchange_type in FLOAT_EXCHANGES:
        return torch.float32
    return real


def wire_scalar_bytes(exchange_type, real_dtype) -> int:
    """Bytes per real scalar on the wire under ``exchange_type``."""
    return wire_dtype(exchange_type, real_dtype).itemsize


class ProcessingUnit(enum.IntFlag):
    """Where a transform executes. Reference: include/spfft/types.h:67-76.

    HOST runs on the CPU with the kernels' plain PyTorch versions; GPU runs on
    the CUDA card with the hand-written kernels.
    """

    HOST = 1
    GPU = 2


class IndexFormat(enum.IntEnum):
    """Sparse frequency index format. Reference: include/spfft/types.h:78-83."""

    TRIPLETS = 0


class TransformType(enum.IntEnum):
    """C2C or R2C. Reference: include/spfft/types.h:85-95."""

    C2C = 0
    R2C = 1


class ScalingType(enum.IntEnum):
    """Forward-transform scaling. Reference: include/spfft/types.h:97-106."""

    NONE = 0
    FULL = 1


class ExecType(enum.IntEnum):
    """Synchronous vs asynchronous execution. Reference: include/spfft/types.h:108-117.

    SYNCHRONOUS waits for the card at the end of each transform; ASYNCHRONOUS
    returns once the kernels are enqueued on the current CUDA stream.
    """

    SYNCHRONOUS = 0
    ASYNCHRONOUS = 1


# The reference's C enum names (include/spfft/types.h), as the JAX package
# exports them.
SPFFT_EXCH_DEFAULT = ExchangeType.DEFAULT
SPFFT_EXCH_BUFFERED = ExchangeType.BUFFERED
SPFFT_EXCH_BUFFERED_FLOAT = ExchangeType.BUFFERED_FLOAT
SPFFT_EXCH_COMPACT_BUFFERED = ExchangeType.COMPACT_BUFFERED
SPFFT_EXCH_COMPACT_BUFFERED_FLOAT = ExchangeType.COMPACT_BUFFERED_FLOAT
SPFFT_EXCH_UNBUFFERED = ExchangeType.UNBUFFERED
SPFFT_EXCH_BUFFERED_BF16 = ExchangeType.BUFFERED_BF16
SPFFT_EXCH_COMPACT_BUFFERED_BF16 = ExchangeType.COMPACT_BUFFERED_BF16

SPFFT_PU_HOST = ProcessingUnit.HOST
SPFFT_PU_GPU = ProcessingUnit.GPU

SPFFT_INDEX_TRIPLETS = IndexFormat.TRIPLETS

SPFFT_TRANS_C2C = TransformType.C2C
SPFFT_TRANS_R2C = TransformType.R2C

SPFFT_NO_SCALING = ScalingType.NONE
SPFFT_FULL_SCALING = ScalingType.FULL

SPFFT_EXEC_SYNCHRONOUS = ExecType.SYNCHRONOUS
SPFFT_EXEC_ASYNCHRONOUS = ExecType.ASYNCHRONOUS
