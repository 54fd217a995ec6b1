"""The reference against ``numpy.fft``, its frozen triplets against the
generator it copies, and the inputs: the hermitian plane, the potential."""
import numpy as np
import pytest
import torch

import spfft_tpu_torch as sp
from perfbench import check, inputs, reference

def numpy_triplets(dim_x, dim_y, dim_z, radius, hermitian):
    """The plane-wave sphere as the port's generator writes it, in numpy."""
    hx, hy, hz = dim_x // 2, dim_y // 2, dim_z // 2
    xs = np.arange(0 if hermitian else -((dim_x - 1) // 2), hx + 1)
    ys = np.arange(-((dim_y - 1) // 2), hy + 1)
    zs = np.arange(-((dim_z - 1) // 2), hz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    r2 = (gx / max(hx, 1)) ** 2 + (gy / max(hy, 1)) ** 2 + (gz / max(hz, 1)) ** 2
    mask = r2 <= radius**2
    return np.stack([gx[mask], gy[mask], gz[mask]], axis=1).astype(np.int32)


def small(transform, n, bands=2):
    return {"grid": [n, n + 4, n - 2], "transform": transform, "sphere_fraction": 0.15,
            "bands": bands}


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("dims", [(8, 8, 8), (16, 12, 20), (17, 16, 15)])
def test_frozen_triplets_match_the_generator_they_copy(dims, hermitian):
    radius = reference.radius_for_fraction(0.15)
    got = reference.spherical_triplets(*dims, radius, hermitian).numpy()
    assert np.array_equal(got, numpy_triplets(*dims, radius, hermitian))
    assert np.array_equal(got, sp.create_spherical_cutoff_triplets(*dims, radius, hermitian))


def dense_numpy(values, trip, dims, r2c):
    dim_x, dim_y, dim_z = dims
    grid = np.zeros((dim_z, dim_y, dim_x), dtype=np.complex128)
    x, y, z = trip[:, 0] % dim_x, trip[:, 1] % dim_y, trip[:, 2] % dim_z
    if r2c:
        grid[(-z) % dim_z, (-y) % dim_y, (-x) % dim_x] = np.conj(values)
    grid[z, y, x] = values
    return grid


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("transform", ["c2c", "r2c"])
def test_reference_against_numpy_fft(n, transform):
    cfg = {"grid": [n, n, n], "transform": transform, "sphere_fraction": 0.15, "bands": 1}
    dims, r2c = inputs.dims(cfg), inputs.is_r2c(cfg)
    trip = inputs.triplets(cfg, "cpu")
    vals = inputs.band_values(cfg, trip, 2**31 + 5, "cpu")[0]
    v = torch.complex(vals[0].double(), vals[1].double())
    space = reference.backward(v, trip, dims, r2c)
    trip_np, v_np = trip.numpy(), v.numpy()
    want = np.fft.ifftn(dense_numpy(v_np, trip_np, dims, r2c))
    want = want * want.size
    if r2c:
        # a second witness: numpy's own real inverse of the stored half
        half = np.zeros((n, n, n // 2 + 1), dtype=np.complex128)
        half[trip_np[:, 2] % n, trip_np[:, 1] % n, trip_np[:, 0]] = v_np
        real = np.fft.irfftn(half, s=(n, n, n), axes=(0, 1, 2), norm="forward")
        np.testing.assert_allclose(want.imag, 0.0, atol=1e-12)
        np.testing.assert_allclose(real, want.real, atol=1e-12)
        want = want.real
    np.testing.assert_allclose(space.numpy(), want, atol=1e-12)
    back = reference.forward_full(space, trip, dims).numpy()
    spectrum = np.fft.fftn(want) / want.size
    np.testing.assert_allclose(back, spectrum[trip_np[:, 2] % n, trip_np[:, 1] % n,
                                              trip_np[:, 0] % n], atol=1e-12)
    np.testing.assert_allclose(back, v_np, atol=1e-12)  # the pair is the identity


def test_hermitian_plane_makes_the_x0_plane_consistent():
    cfg = small("r2c", 16, bands=3)
    trip = inputs.triplets(cfg, "cpu")
    vals = inputs.band_values(cfg, trip, 77, "cpu")
    _, dim_y, dim_z = inputs.dims(cfg)
    x0 = (trip[:, 0] == 0).nonzero(as_tuple=True)[0].tolist()
    at = {(int(trip[i, 1]) % dim_y, int(trip[i, 2]) % dim_z): i for i in x0}
    for (y, z), i in at.items():
        j = at[((-y) % dim_y, (-z) % dim_z)]
        assert torch.equal(vals[:, 0, i], vals[:, 0, j])
        assert torch.equal(vals[:, 1, i], -vals[:, 1, j])


def test_inputs_follow_the_seed_and_only_the_values_change():
    cfg = small("c2c", 8)
    trip = inputs.triplets(cfg, "cpu")
    a, b = (inputs.band_values(cfg, trip, s, "cpu") for s in (3, 3))
    c = inputs.band_values(cfg, trip, 2**40 + 3, "cpu")
    assert torch.equal(a, b) and a.shape == c.shape and not torch.equal(a, c)
    assert inputs.sampled_bands(9, 10, 4) == inputs.sampled_bands(9, 10, 4)


def test_the_potential_follows_the_seed_and_the_layout():
    cfg = small("c2c", 8)
    a = inputs.potential(cfg, "yxz", 2**33 + 1, "cpu")
    b = inputs.potential(cfg, "zyx", 2**33 + 1, "cpu")
    assert a.shape == (12, 8, 6) and b.shape == (6, 12, 8) and a.dtype == torch.float32
    assert torch.equal(a, inputs.potential(cfg, "yxz", 2**33 + 1, "cpu"))
    assert not torch.equal(a, inputs.potential(cfg, "yxz", 1, "cpu"))
    assert 0.5 <= float(a.min()) and float(a.max()) < 1.5 and float(a.std()) > 0.2
    trip = inputs.triplets(cfg, "cpu")
    vals = inputs.band_values(cfg, trip, 2**33 + 1, "cpu")  # its own stream of draws
    assert not torch.equal(vals.flatten()[:10], a.flatten()[:10])


def test_the_reference_reads_nothing_from_itself_as_wrong():
    cfg = small("r2c", 12)
    trip = inputs.triplets(cfg, "cpu")
    vals = inputs.band_values(cfg, trip, 1, "cpu")[0]
    v = torch.complex(vals[0].double(), vals[1].double())
    pot = inputs.potential(cfg, "zyx", 1, "cpu")
    space = reference.backward(v, trip, inputs.dims(cfg), True) * pot.double()
    errs = check.band_errors(cfg, trip, vals, pot, space,
                             reference.forward_full(space, trip, inputs.dims(cfg)))
    assert errs["bwd_err"] == 0.0 and errs["fwd_err"] < 1e-14
    # the pair with V between is not the identity: the input values fail
    errs = check.band_errors(cfg, trip, vals, pot, None, v)
    assert errs["fwd_err"] > 0.1
