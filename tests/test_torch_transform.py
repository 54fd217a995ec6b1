"""The spfft_tpu_torch slice end to end against spfft_tpu.Transform(engine="xla").

Tolerance: max abs diff <= 1e-10 * max|ref| in float64 and 2e-5 * max|ref| in
float32, because the port's matrix-product DFT and the reference's pocketfft
sum in different orders.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from utils import random_sparse_triplets, storage

RTOL = {np.float64: 1e-10, np.float32: 2e-5}
REPO = pathlib.Path(__file__).resolve().parent.parent


def _values(rng, trip, dims, r2c):
    """Random values; for R2C the spectrum of a real field at the triplets,
    so the x == 0 plane is hermitian-consistent."""
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    return spec[storage(t[:, 2], dz), storage(t[:, 1], dy), t[:, 0]]


def _pair(r2c, dims, trip, dtype):
    tt = int(r2c)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, tt, *dims, indices=trip,
                              dtype=dtype, engine="xla")
    port = tp.Transform(tp.ProcessingUnit.HOST, tt, *dims, indices=trip, dtype=dtype,
                        engine="mxu")
    return ref, port


def _assert_close(got, ref, dtype):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scaling", [tp.ScalingType.NONE, tp.ScalingType.FULL])
@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("r2c", [False, True])
def test_parity_with_xla_engine(r2c, centered, scaling, dtype):
    dims = (11, 8, 9) if centered else (8, 12, 10)
    rng = np.random.default_rng(7 + 2 * int(r2c) + int(centered))
    trip = random_sparse_triplets(rng, *dims, stick_fraction=0.5, z_fill=0.7,
                                  centered=centered, hermitian=r2c)
    trip = trip[rng.permutation(len(trip))]
    values = _values(rng, trip, dims, r2c)
    ref, port = _pair(r2c, dims, trip, dtype)

    space_ref = ref.backward(values)
    space = port.backward(values)
    assert space.dtype == (torch.float32 if dtype == np.float32 else torch.float64) or not r2c
    assert space.is_complex() != r2c
    _assert_close(space, space_ref, dtype)
    _assert_close(port.forward(scaling=scaling),
                  ref.forward(scaling=spfft_tpu.ScalingType(int(scaling))), dtype)
    # an explicit (Z, Y, X) space input, the same for both
    _assert_close(port.forward(np.asarray(space_ref), scaling),
                  ref.forward(np.asarray(space_ref), spfft_tpu.ScalingType(int(scaling))), dtype)


@pytest.mark.parametrize("dims", [(11, 8, 9), (16, 16, 16), (12, 10, 7)])
@pytest.mark.parametrize("r2c", [False, True])
def test_round_trip(r2c, dims):
    rng = np.random.default_rng(sum(dims) + int(r2c))
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.9, hermitian_symmetry=r2c)
    values = _values(rng, trip, dims, r2c)
    t = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, engine="mxu")
    t.backward(values)
    back = t.forward(scaling=tp.ScalingType.FULL).numpy()
    assert np.abs(back - values).max() <= 1e-10 * np.abs(values).max()
    # a second backward starts from zeroed tables
    t.backward(values)
    assert np.abs(t.forward(scaling=tp.ScalingType.FULL).numpy() - values).max() <= (
        1e-10 * np.abs(values).max()
    )


def test_space_domain_data_and_tensor_inputs():
    dims = (8, 6, 5)
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.8)
    rng = np.random.default_rng(2)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    t = tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, *dims, indices=trip,
                     engine="mxu")
    with pytest.raises(tp.InvalidParameterError):
        t.space_domain_data()
    with pytest.raises(tp.InvalidParameterError):
        t.forward()
    space = t.backward(torch.from_numpy(values))
    host = t.space_domain_data()
    assert isinstance(host, np.ndarray) and host.shape == (5, 6, 8)
    np.testing.assert_array_equal(host, space.numpy())
    # the device-side data is the engine's native buffer: (re, im) in (Y, X, Z)
    assert t.space_domain_layout == "yxz"
    re, im = t.space_domain_data(tp.ProcessingUnit.GPU)
    assert torch.equal(torch.complex(re, im), space.permute(1, 2, 0))
    clone = t.clone()
    np.testing.assert_array_equal(clone.backward(values).numpy(), space.numpy())
    assert t.num_local_elements == len(trip) and t.global_size == 240
    assert t.local_slice_size == 240 and t.local_z_length == 5 and t.local_z_offset == 0
    assert t.device == torch.device("cpu")


def test_gpu_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device error cannot happen")
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    with pytest.raises(tp.GPUNoDeviceError) as e:
        tp.Transform(tp.ProcessingUnit.GPU, tp.TransformType.C2C, 8, 8, 8, indices=trip)
    assert e.value.error_code == tp.ErrorCode.GPU_NO_DEVICE
    with pytest.raises(tp.GPUNoDeviceError):
        tp.Grid(8, 8, 8, 100, tp.ProcessingUnit.GPU)


@pytest.mark.parametrize("kwargs", [
    {"engine": "cufft"}, {"engine": "fftw"}, {"precision": "medium"}, {"dtype": np.float16},
    {"local_z_length": 3},
])
def test_invalid_options_raise(kwargs):
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    with pytest.raises(tp.InvalidParameterError):
        tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip, **kwargs)


def test_wrong_sizes_raise():
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    t = tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip,
                     engine="mxu")
    with pytest.raises(tp.InvalidParameterError):
        t.backward(np.zeros(len(trip) - 1))
    with pytest.raises(tp.InvalidParameterError):
        t.forward(np.zeros((8, 8, 7)))


def test_grid_capacity():
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    g = tp.Grid(8, 8, 8, 64, tp.ProcessingUnit.HOST)
    t = g.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8,
                           indices=trip, dtype=np.float32)
    assert t.grid is g and t.dtype == np.float32
    with pytest.raises(tp.InvalidParameterError):
        g.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 9, 8, 8, indices=trip)
    with pytest.raises(tp.InvalidParameterError):
        tp.Grid(8, 8, 8, 2).create_transform(
            tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip
        )


def test_port_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|spfft_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "spfft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                  REPO / "k2_ab.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    # the scan covers every module of the port, the pencil engines' included
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {"spfft_tpu_torch/parallel/pencil2.py", "spfft_tpu_torch/parallel/pencil2_mxu.py",
            "spfft_tpu_torch/parallel/ragged.py", "spfft_tpu_torch/parallel/mesh.py"} <= scanned
