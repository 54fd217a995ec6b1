"""Sparse values <-> the flat z-stick table.

The reference's compression component (reference:
src/compression/compression_host.hpp:50-92): *decompress* scatters the
caller's packed values into a zeroed stick table, *compress* gathers them back.
The forward scaling is folded into the forward-z DFT matrix (ops/fft.py), so
compress carries none. Plain index scatter and gather on the flat ``(S*Z)``
table: data movement that stays plain PyTorch in this slice.
"""
from __future__ import annotations

import torch


def decompress(values, value_indices, num_rows: int, dim_z: int):
    """Scatter packed values into a zeroed (num_rows, dim_z) stick table.
    The zero fill matters: slots without a caller value must be zero."""
    flat = values.new_zeros(num_rows * dim_z)
    flat.index_copy_(0, value_indices, values)
    return flat.reshape(num_rows, dim_z)


def compress(sticks, value_indices):
    """Gather packed values out of the stick table."""
    return sticks.reshape(-1).index_select(0, value_indices)
