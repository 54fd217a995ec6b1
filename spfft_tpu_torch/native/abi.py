"""The C ABI of ``libspfft_tpu_torch.so`` from Python, through ctypes.

A thin caller of the library's extern-C functions, as a C program calls
them: local transforms (``spfft_transform_create_independent`` and its
float twin, ``*_backward_ptr`` / ``*_forward_ptr``) and mesh-distributed
ones (``spfft_grid_create_distributed``, ``spfft_dist_transform_*``). Every
buffer is a C-contiguous numpy array in host memory, as the C API takes it;
a non-zero ``SpfftError`` raises :class:`NativeError` with its code. Loaded
into a Python process, the library's bridge runs in this interpreter.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .._build import load_native

_P = ctypes.c_void_p
_I = ctypes.c_int
_INDEX_TRIPLETS = 0  # SPFFT_INDEX_TRIPLETS


class NativeError(RuntimeError):
    """A C API call returned a non-zero ``SpfftError`` (``code``)."""

    def __init__(self, fn: str, code: int):
        super().__init__(f"{fn} returned SpfftError {code}")
        self.code = code


def _ptr(a: np.ndarray):
    if not a.flags.c_contiguous:
        raise ValueError("C API buffers must be C-contiguous")
    return a.ctypes.data_as(_P)


class Api:
    """The library's functions with their C signatures."""

    _SIGNATURES = {
        "spfft_transform_create_independent": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "spfft_float_transform_create_independent": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "spfft_transform_destroy": [_P],
        "spfft_float_transform_destroy": [_P],
        "spfft_transform_backward_ptr": [_P, _P, _P],
        "spfft_float_transform_backward_ptr": [_P, _P, _P],
        "spfft_transform_forward_ptr": [_P, _P, _P, _I],
        "spfft_float_transform_forward_ptr": [_P, _P, _P, _I],
        "spfft_grid_create_distributed": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I],
        "spfft_grid_destroy": [_P],
        "spfft_dist_transform_create": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I],
        "spfft_dist_transform_destroy": [_P],
        "spfft_dist_transform_backward": [_P, _P, _P],
        "spfft_float_dist_transform_backward": [_P, _P, _P],
        "spfft_dist_transform_forward": [_P, _P, _P, _I],
        "spfft_float_dist_transform_forward": [_P, _P, _P, _I],
    }

    def __init__(self, lib: ctypes.CDLL | None = None):
        self.lib = load_native() if lib is None else lib
        for name, args in self._SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = args, _I

    def call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(*args)
        if code:
            raise NativeError(name, code)

    # ---- local transforms -----------------------------------------------------

    def transform(self, pu: int, transform_type: int, dims, triplets, double: bool) -> "Plan":
        """A local plan over ``triplets`` (``(n, 3)`` int32) on unit ``pu``."""
        trip = np.ascontiguousarray(triplets, dtype=np.int32)
        handle = _P()
        fn = "spfft_transform_create_independent" if double else \
            "spfft_float_transform_create_independent"
        self.call(fn, ctypes.byref(handle), 1, pu, transform_type, *(int(d) for d in dims),
                  len(trip), _INDEX_TRIPLETS, _ptr(trip))
        return Plan(self, handle, double, "transform")

    # ---- mesh-distributed transforms --------------------------------------------

    def dist_transform(self, pu: int, transform_type: int, dims, per_shard, double: bool,
                       exchange: int = 0) -> "Plan":
        """A plan over ``len(per_shard)`` shards of a slab mesh grid (the grid
        is the plan's own and goes with it)."""
        counts = np.asarray([len(t) for t in per_shard], dtype=np.int32)
        trip = np.ascontiguousarray(np.concatenate(per_shard), dtype=np.int32)
        X, Y, Z = (int(d) for d in dims)
        grid = _P()  # room for every stick on a shard, every z on a slab
        self.call("spfft_grid_create_distributed", ctypes.byref(grid), X, Y, Z, X * Y, Z,
                  len(per_shard), exchange, pu, 1)
        handle = _P()
        try:
            self.call("spfft_dist_transform_create", ctypes.byref(handle), grid, pu,
                      transform_type, X, Y, Z, len(per_shard), _ptr(counts), _INDEX_TRIPLETS,
                      _ptr(trip), int(double))
        except NativeError:
            self.call("spfft_grid_destroy", grid)
            raise
        return Plan(self, handle, double, "dist_transform", grid)


class Plan:
    """A C plan handle: ``backward(values, space_out)`` and
    ``forward(space, values_out, scaling)`` on host numpy buffers."""

    def __init__(self, api: Api, handle, double: bool, kind: str, grid=None):
        self.api, self.handle, self.double, self.kind, self.grid = api, handle, double, kind, grid

    def _fn(self, op: str) -> str:
        return f"spfft_{'' if self.double else 'float_'}{self.kind}_{op}"

    def _check(self, *arrays) -> None:
        want = np.float64 if self.double else np.float32
        for a in arrays:
            if a is not None and a.dtype != want:
                raise ValueError(f"expected {np.dtype(want)} buffers, got {a.dtype}")

    def backward(self, values: np.ndarray, space_out: np.ndarray) -> None:
        """``values``: interleaved complex reals; ``space_out``: the
        ``(Z, Y, X)`` space (interleaved complex for C2C, real for R2C)."""
        self._check(values, space_out)
        op = "backward_ptr" if self.kind == "transform" else "backward"
        self.api.call(self._fn(op), self.handle, _ptr(values), _ptr(space_out))

    def forward(self, space: np.ndarray | None, values_out: np.ndarray, scaling: int) -> None:
        """``space`` None: the distributed plan's retained space."""
        self._check(space, values_out)
        op = "forward_ptr" if self.kind == "transform" else "forward"
        self.api.call(self._fn(op), self.handle, None if space is None else _ptr(space),
                      _ptr(values_out), scaling)

    def close(self) -> None:
        if self.handle:
            kind = "dist_transform" if self.kind == "dist_transform" else \
                ("transform" if self.double else "float_transform")
            self.api.call(f"spfft_{kind}_destroy", self.handle)
            self.handle = None
        if self.grid:
            self.api.call("spfft_grid_destroy", self.grid)
            self.grid = None
