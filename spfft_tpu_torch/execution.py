"""Shared boundary of the execution engines.

Complex data crosses the engine boundary as (re, im) pairs of real tensors on
the plan's ``torch.device``. The transforms are unnormalised DFTs: backward is
N * ifft (reference: docs/source/details.rst:4-13,42-44).
"""
from __future__ import annotations

import numpy as np
import torch

from .parameters import LocalParameters
from .types import TransformType


def as_pair(values, real_dtype):
    """Host-side: complex array -> (re, im) contiguous numpy pair."""
    values = np.asarray(values)
    return (
        np.ascontiguousarray(values.real, dtype=real_dtype),
        np.ascontiguousarray(values.imag, dtype=real_dtype),
    )


def from_pair(pair):
    """(re, im) tensors -> one complex tensor."""
    return torch.complex(pair[0], pair[1])


class ExecutionBase:
    """Boundary state of the single-device engines: the plan, its dtypes, its
    device, and the id of the (0, 0) stick that R2C stick symmetry fills."""

    def __init__(self, params: LocalParameters, real_dtype, device: torch.device):
        self.params = params
        self.real_dtype = np.dtype(real_dtype)
        self.torch_dtype = torch.float32 if self.real_dtype == np.float32 else torch.float64
        self.device = torch.device(device)
        # Sorted stick keys => a (0,0) stick, if present, is always row 0.
        self._zero_stick_id = (
            0 if (params.num_sticks > 0 and int(params.stick_xy_indices[0]) == 0) else None
        )

    @property
    def is_r2c(self) -> bool:
        return self.params.transform_type == TransformType.R2C

    def put(self, array, dtype=None):
        """Host numpy array (or tensor) -> tensor on the plan's device."""
        return torch.as_tensor(array, dtype=dtype, device=self.device)

    def put_pair(self, pair):
        """(re, im) numpy pair -> pair of real tensors of the plan's dtype."""
        return tuple(self.put(np.ascontiguousarray(p), self.torch_dtype) for p in pair)

    def values_pair(self, values):
        """Packed complex values (numpy or tensor) -> (re, im) on the device."""
        if torch.is_tensor(values):
            v = values.to(self.device).reshape(-1)
            if v.is_complex():
                return (v.real.to(self.torch_dtype).contiguous(),
                        v.imag.to(self.torch_dtype).contiguous())
            re = v.to(self.torch_dtype).contiguous()
            return re, torch.zeros_like(re)
        return self.put_pair(as_pair(values, self.real_dtype))
