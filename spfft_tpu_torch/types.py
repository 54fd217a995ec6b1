"""Public enums of spfft_tpu_torch.

The same names and values as the reference C enums (reference:
include/spfft/types.h:67-117), so callers of the original library and of the
JAX package find the same vocabulary.
"""
from __future__ import annotations

import enum


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
