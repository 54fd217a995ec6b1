"""The port's C-API marshalling layer against the JAX package's, with no compiler.

The same ``bytearray``-backed memoryviews (read-only ones for inputs, as the
native bridge's ``view_ro`` makes them) go through ``spfft_tpu.capi`` and
``spfft_tpu_torch.capi``, for every name in ``__all__``: local C2C and R2C in
float32 and float64, grid-made plans with ``local_z_length``, clones,
every getter, the execution mode, multi-transforms, a 4-shard slab grid and
a 2x2 pencil grid with every ``dist_*`` function and shard getter, and
``error_code``. Results agree within the ``torch.fft``-engine parity bars
(1e-5 of the largest in float32, 1e-12 in float64); getters exactly; input
buffers are left as they were.
"""
import numpy as np
import pytest

import spfft_tpu.capi as jcapi
import spfft_tpu_torch as tp
import spfft_tpu_torch.capi as pcapi
from spfft_tpu import errors as jerrors
from spfft_tpu_torch import errors as perrors
from utils import storage

DIMS = (8, 10, 9)  # X, Y, Z
TOL = {np.float32: 1e-5, np.float64: 1e-12}
HOST = 1
NONE, FULL = int(tp.ScalingType.NONE), int(tp.ScalingType.FULL)
CAPIS = (jcapi, pcapi)


def test_the_port_exports_the_same_names():
    assert pcapi.__all__ == jcapi.__all__
    for table in ("_TRANSFORM_GETTERS", "_GRID_GETTERS", "_DIST_GETTERS", "_DIST_SHARD_GETTERS"):
        assert list(getattr(pcapi, table)) == list(getattr(jcapi, table))


def ro(a: np.ndarray) -> memoryview:
    """A read-only memoryview over a copy of ``a``'s bytes."""
    return memoryview(bytearray(np.ascontiguousarray(a).tobytes())).toreadonly()


def rw(nbytes: int) -> memoryview:
    return memoryview(bytearray(nbytes))


def problem(r2c, seed=3):
    X, Y, Z = DIMS
    rng = np.random.default_rng(seed)
    trip = np.asarray(tp.create_spherical_cutoff_triplets(X, Y, Z, 0.8, hermitian_symmetry=r2c),
                      dtype=np.int32)
    if r2c:
        spec = np.fft.fftn(rng.standard_normal((Z, Y, X)))
        vals = spec[storage(trip[:, 2], Z), storage(trip[:, 1], Y), trip[:, 0]]
    else:
        vals = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    return trip, vals


def cdtype(dtype):
    return np.complex64 if dtype == np.float32 else np.complex128


def close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


def pair(capi, t, vals, dtype, r2c, space_reals):
    """backward, forward of the backward's buffer (FULL), forward of the
    retained space (NONE): the three output buffers as numpy."""
    n = len(vals)
    vin = ro(vals.astype(cdtype(dtype)))
    before = bytes(vin)
    space = rw(space_reals * np.dtype(dtype).itemsize)
    capi.transform_backward(t, vin, space)
    back = rw(2 * n * np.dtype(dtype).itemsize)
    capi.transform_forward(t, ro(np.frombuffer(space, dtype=dtype)), back, FULL)
    none = rw(2 * n * np.dtype(dtype).itemsize)
    capi.transform_forward(t, None, none, NONE)
    assert bytes(vin) == before
    view = (lambda b: np.frombuffer(b, dtype=dtype)) if r2c else \
        (lambda b: np.frombuffer(b, dtype=cdtype(dtype)))
    return (view(space), np.frombuffer(back, dtype=cdtype(dtype)),
            np.frombuffer(none, dtype=cdtype(dtype)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_a_local_plan_and_its_clone(r2c, dtype):
    trip, vals = problem(r2c)
    X, Y, Z = DIMS
    reals = X * Y * Z * (1 if r2c else 2)
    got = {}
    for capi in CAPIS:
        t = capi.transform_create(HOST, int(r2c), X, Y, Z, len(trip), ro(trip),
                                  dtype == np.float64)
        c = capi.transform_clone(t)
        got[capi] = (pair(capi, t, vals, dtype, r2c, reals),
                     pair(capi, c, vals, dtype, r2c, reals),
                     {k: capi.transform_get(t, k) for k in capi._TRANSFORM_GETTERS},
                     {k: capi.transform_get(c, k) for k in capi._TRANSFORM_GETTERS})
    (jt, jc, jget, jcget), (pt, pc, pget, pcget) = got[jcapi], got[pcapi]
    assert pget == jget == pcget == jcget
    for a, b in zip(pt + pc, jt + jc):
        close(a, b, dtype)
    close(pt[1], vals, dtype)  # the round trip


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_a_grid_made_plan_with_its_local_z_length(r2c, dtype):
    trip, vals = problem(r2c, seed=4)
    X, Y, Z = DIMS
    got = {}
    for capi in CAPIS:
        g = capi.grid_create(X + 2, Y, Z + 1, X * Y, HOST, 1)
        t = capi.transform_create_from_grid(g, HOST, int(r2c), X, Y, Z, Z, len(trip), ro(trip),
                                            dtype == np.float64)
        t0 = capi.transform_create_from_grid(g, HOST, int(r2c), X, Y, Z, 0, len(trip),
                                             ro(trip), dtype == np.float64)
        reals = X * Y * Z * (1 if r2c else 2)
        got[capi] = (pair(capi, t, vals, dtype, r2c, reals),
                     {k: capi.grid_get(g, k) for k in capi._GRID_GETTERS},
                     {k: capi.transform_get(t0, k) for k in capi._TRANSFORM_GETTERS})
    (jr, jg, jt0), (pr, pg, pt0) = got[jcapi], got[pcapi]
    assert pg == jg and pt0 == jt0
    for a, b in zip(pr, jr):
        close(a, b, dtype)


def test_the_execution_mode():
    trip, _ = problem(False)
    got = {}
    for capi in CAPIS:
        t = capi.transform_create(HOST, 0, *DIMS, len(trip), ro(trip), True)
        modes = [capi.transform_get(t, "execution_mode")]
        capi.transform_set_execution_mode(t, 1)
        modes.append(capi.transform_get(t, "execution_mode"))
        capi.transform_set_execution_mode(t, 0)
        modes.append(capi.transform_get(t, "execution_mode"))
        got[capi] = modes
    assert got[pcapi] == got[jcapi] == [0, 1, 0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_multi_backward_and_forward(dtype):
    X, Y, Z = DIMS
    problems = [problem(False, 5), problem(True, 6)]
    got = {}
    for capi in CAPIS:
        ts = [capi.transform_create(HOST, int(r2c), X, Y, Z, len(trip), ro(trip),
                                    dtype == np.float64)
              for r2c, (trip, _) in zip((False, True), problems)]
        ins = [ro(v.astype(cdtype(dtype))) for _, v in problems]
        reals = [X * Y * Z * 2, X * Y * Z]
        spaces = [rw(n * np.dtype(dtype).itemsize) for n in reals]
        capi.multi_backward(ts, ins, spaces)
        outs = [rw(2 * len(v) * np.dtype(dtype).itemsize) for _, v in problems]
        capi.multi_forward(ts, [ro(np.frombuffer(s, dtype=dtype)) for s in spaces], outs,
                           [FULL, FULL])
        retained = [rw(2 * len(v) * np.dtype(dtype).itemsize) for _, v in problems]
        capi.multi_forward(ts, [None, None], retained, [NONE, NONE])
        got[capi] = [np.frombuffer(b, dtype=dtype) for b in spaces + outs + retained]
    for a, b in zip(got[pcapi], got[jcapi]):
        close(a, b, dtype)


def dist_problem(r2c, layout):
    X, Y, Z = DIMS
    trip, vals = problem(r2c, seed=8)
    kw = {} if layout is None else {"layout": layout, "dim_x": X}
    per = [np.asarray(t, dtype=np.int32)
           for t in tp.distribute_triplets(trip, 4, Y, **kw)]
    lut = {tuple(t): v for t, v in zip(map(tuple, trip), vals)}
    shard_vals = [np.asarray([lut[tuple(t)] for t in p]) for p in per]
    return per, shard_vals


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("layout", [None, (2, 2)], ids=["slab4", "pencil2x2"])
def test_a_distributed_grid_and_every_shard_getter(layout, r2c, dtype):
    X, Y, Z = DIMS
    per, shard_vals = dist_problem(r2c, layout)
    counts = np.asarray([len(p) for p in per], dtype=np.int32)
    flat = np.concatenate(per)
    vals = np.concatenate(shard_vals).astype(cdtype(dtype))
    itemsize = np.dtype(dtype).itemsize
    reals = X * Y * Z * (1 if r2c else 2)
    buffered = int(tp.ExchangeType.BUFFERED)
    got = {}
    for capi in CAPIS:
        if layout is None:
            g = capi.grid_create_distributed(X, Y, Z, X * Y, Z, 4, HOST, buffered, 1)
        else:
            g = capi.grid_create_distributed2(X, Y, Z, X * Y, Z, *layout, HOST, buffered, 1)
        t = capi.dist_transform_create(g, HOST, int(r2c), X, Y, Z, 4, ro(counts), ro(flat),
                                       dtype == np.float64)
        vin = ro(vals)
        space = rw(reals * itemsize)
        capi.dist_backward(t, vin, space)
        back = rw(2 * len(vals) * itemsize)
        capi.dist_forward(t, ro(np.frombuffer(space, dtype=dtype)), back, FULL)
        retained = rw(2 * len(vals) * itemsize)
        capi.dist_forward(t, None, retained, NONE)
        got[capi] = ([np.frombuffer(b, dtype=dtype) for b in (space, back, retained)],
                     {k: capi.grid_get(g, k) for k in capi._GRID_GETTERS},
                     {k: capi.dist_transform_get(t, k) for k in capi._DIST_GETTERS},
                     {(k, r): capi.dist_transform_get_shard(t, k, r)
                      for k in capi._DIST_SHARD_GETTERS for r in range(4)})
    (jb, jg, jt, js), (pb, pg, pt, ps) = got[jcapi], got[pcapi]
    assert pg == jg and pt == jt and ps == js
    for a, b in zip(pb, jb):
        close(a, b, dtype)
    close(np.frombuffer(pb[1].tobytes(), dtype=cdtype(dtype)), vals, dtype)  # the round trip


def test_a_shard_count_mismatch_is_the_same_error():
    X, Y, Z = DIMS
    per, _ = dist_problem(False, None)
    counts = np.asarray([len(p) for p in per], dtype=np.int32)
    counts[0] += 1
    for capi in CAPIS:
        g = capi.grid_create_distributed(X, Y, Z, X * Y, Z, 4, HOST, 0, 1)
        with pytest.raises(Exception) as e:
            capi.dist_transform_create(g, HOST, 0, X, Y, Z, 4, ro(counts),
                                       ro(np.concatenate(per)), True)
        assert capi.error_code(e.value) == int(tp.ErrorCode.INVALID_PARAMETER)


GENERIC = sorted(name for name, c in vars(perrors).items()
                 if isinstance(c, type) and issubclass(c, perrors.GenericError))


@pytest.mark.parametrize("name", GENERIC)
def test_error_code_of_each_typed_error(name):
    code = pcapi.error_code(getattr(perrors, name)("x"))
    assert code == int(getattr(perrors, name).error_code)
    if hasattr(jerrors, name):
        assert code == jcapi.error_code(getattr(jerrors, name)("x"))


@pytest.mark.parametrize("exc", [ValueError, TypeError, KeyError, MemoryError, RuntimeError])
def test_error_code_of_python_errors(exc):
    assert pcapi.error_code(exc("x")) == jcapi.error_code(exc("x"))


def test_a_gpu_grid_without_a_card_is_gpu_no_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: pcapi.grid_create(8, 8, 8, 64, 2, 1),
                 lambda: pcapi.grid_create_distributed(8, 8, 8, 64, 8, 2, 2, 0, 1),
                 lambda: pcapi.grid_create_distributed2(8, 8, 8, 64, 8, 2, 1, 2, 0, 1)):
        with pytest.raises(tp.GPUNoDeviceError) as e:
            make()
        assert pcapi.error_code(e.value) == int(tp.ErrorCode.GPU_NO_DEVICE)
