"""spfft_tpu_torch plan construction against spfft_tpu: enums, error taxonomy,
index conversion, spherical cutoffs and LocalParameters, on fuzzed triplets."""
import inspect

import numpy as np
import pytest

import spfft_tpu
import spfft_tpu.errors as jerr
import spfft_tpu.indices as jind
import spfft_tpu.parameters as jpar
import spfft_tpu_torch as tp
import spfft_tpu_torch.errors as terr
import spfft_tpu_torch.indices as tind
import spfft_tpu_torch.parameters as tpar
from utils import random_sparse_triplets

FIELDS = ("transform_type", "dim_x", "dim_y", "dim_z", "num_values",
          "value_indices", "stick_xy_indices")


def test_enums_match():
    for name in ("ProcessingUnit", "TransformType", "ScalingType", "ExecType", "IndexFormat"):
        jcls, tcls = getattr(spfft_tpu, name), getattr(tp, name)
        for member in tcls:
            assert int(getattr(jcls, member.name)) == int(member)
    assert {e.name: int(e) for e in terr.ErrorCode} == {e.name: int(e) for e in jerr.ErrorCode}


def test_error_taxonomy_matches():
    jclasses = {
        n: c for n, c in inspect.getmembers(jerr, inspect.isclass)
        if issubclass(c, jerr.GenericError)
    }
    for name, jcls in jclasses.items():
        tcls = getattr(terr, name)
        assert tcls.error_code == jcls.error_code
        assert issubclass(tcls, terr.GenericError)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("r2c", [False, True])
@pytest.mark.parametrize("centered", [False, True])
def test_local_parameters_identical(seed, r2c, centered):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(3, 13, size=3))
    trip = random_sparse_triplets(
        rng, *dims, stick_fraction=float(rng.uniform(0.1, 0.9)),
        z_fill=float(rng.uniform(0.3, 1.0)), centered=centered, hermitian=r2c,
    )
    trip = trip[rng.permutation(len(trip))]
    tt = int(r2c)
    jp = jpar.make_local_parameters(spfft_tpu.TransformType(tt), *dims, trip)
    pp = tpar.make_local_parameters(tp.TransformType(tt), *dims, trip)
    for f in FIELDS:
        a, b = getattr(jp, f), getattr(pp, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert int(a) == int(b)
    for prop in ("num_sticks", "dim_x_freq", "total_size"):
        assert getattr(jp, prop) == getattr(pp, prop)
    np.testing.assert_array_equal(jp.stick_x, pp.stick_x)
    np.testing.assert_array_equal(jp.stick_y, pp.stick_y)


@pytest.mark.parametrize("dims,radius,herm", [
    ((8, 8, 8), 0.7, False), ((11, 8, 9), 0.9, True), ((16, 12, 10), 0.659, False),
    ((16, 16, 16), 1.0, True),
])
def test_spherical_cutoff_identical(dims, radius, herm):
    a = jind.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=herm)
    b = tind.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=herm)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("herm", [False, True])
@pytest.mark.parametrize("case", ["duplicate", "x_high", "y_low", "z_high", "not_triplets"])
def test_bad_indices_raise_same_error(case, herm):
    dims = (6, 5, 4)
    trip = np.array([[0, 0, 0], [1, 2, 3], [2, 1, 1]])
    if case == "duplicate":
        trip = np.concatenate([trip, trip[1:2]])
    elif case == "x_high":
        trip[1, 0] = 6
    elif case == "y_low":
        trip[1, 1] = -3
    elif case == "z_high":
        trip[2, 2] = 4
    else:
        trip = trip.reshape(-1)[:7]
    with pytest.raises(jerr.GenericError) as je:
        jind.convert_index_triplets(herm, *dims, trip)
    with pytest.raises(terr.GenericError) as te:
        tind.convert_index_triplets(herm, *dims, trip)
    assert type(te.value).__name__ == type(je.value).__name__
    assert te.value.error_code == je.value.error_code


def test_check_stick_duplicates_matches():
    ok = [np.array([0, 3, 5]), np.array([1, 2])]
    bad = [np.array([0, 3, 5]), np.array([5, 7])]
    jind.check_stick_duplicates(ok)
    tind.check_stick_duplicates(ok)
    tind.check_stick_duplicates([])
    with pytest.raises(jerr.DuplicateIndicesError):
        jind.check_stick_duplicates(bad)
    with pytest.raises(terr.DuplicateIndicesError):
        tind.check_stick_duplicates(bad)


def test_bad_dimensions_raise():
    with pytest.raises(terr.InvalidParameterError):
        tpar.make_local_parameters(tp.TransformType.C2C, 0, 4, 4, [[0, 0, 0]])


@pytest.mark.parametrize("r2c", [False, True])
def test_from_jax_params_round_trip(r2c):
    rng = np.random.default_rng(11)
    dims = (9, 8, 7)
    trip = random_sparse_triplets(rng, *dims, stick_fraction=0.4, z_fill=0.6,
                                  centered=True, hermitian=r2c)
    jp = jpar.make_local_parameters(spfft_tpu.TransformType(int(r2c)), *dims, trip)
    carried = tpar.from_jax_params({f: getattr(jp, f) for f in FIELDS})
    own = tpar.make_local_parameters(tp.TransformType(int(r2c)), *dims, trip)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(carried, f), getattr(own, f))
    assert carried.transform_type is own.transform_type

    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    t_carried = tp.Transform.from_parameters(tp.ProcessingUnit.HOST, carried, engine="mxu")
    t_own = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, engine="mxu")
    np.testing.assert_array_equal(
        t_carried.backward(values).numpy(), t_own.backward(values).numpy()
    )
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims,
                              indices=trip, dtype=np.float64, engine="xla")
    expected = np.asarray(ref.backward(values))
    got = t_carried.backward(values).numpy()
    assert np.abs(got - expected).max() <= 1e-10 * np.abs(expected).max()


def test_from_jax_params_rejects_inconsistent_count():
    fields = {"transform_type": 0, "dim_x": 4, "dim_y": 4, "dim_z": 4, "num_values": 3,
              "value_indices": np.arange(2), "stick_xy_indices": np.arange(1)}
    with pytest.raises(terr.InvalidParameterError):
        tpar.from_jax_params(fields)
