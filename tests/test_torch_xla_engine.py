"""The port's torch.fft engine (engine="xla") against spfft_tpu.Transform(engine="xla").

The same triplets and values, made from a seed with numpy, go into both
packages. Tolerance: max abs diff <= 1e-12 * max|ref| in float64 and
2e-5 * max|ref| in float32 (pocketfft on both sides, summed in other orders
and scaled at other points: the port's inverse DFTs are unscaled, the JAX
engine's scale by 1/N and multiply back).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spfft_tpu
import spfft_tpu_torch as tp
from utils import random_sparse_triplets, storage

RTOL = {np.float64: 1e-12, np.float32: 2e-5}


def _triplets(kind, dims, r2c, rng):
    if kind == "sphere":
        return tp.create_spherical_cutoff_triplets(*dims, 0.8, hermitian_symmetry=r2c)
    trip = random_sparse_triplets(rng, *dims, stick_fraction=0.5, z_fill=0.7,
                                  centered=True, hermitian=r2c)
    return trip[rng.permutation(len(trip))]


def _values(rng, trip, dims, r2c):
    """Random values; for R2C the spectrum of a real field at the triplets."""
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    return spec[storage(t[:, 2], dz), storage(t[:, 1], dy), t[:, 0]]


def _close(got, ref, dtype):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL[dtype] * np.abs(ref).max()


def _plans(r2c, dims, trip, dtype, **kw):
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                              dtype=dtype, engine="xla")
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, dtype=dtype,
                        engine="xla", **kw)
    return ref, port


@pytest.mark.parametrize("kind", ["sphere", "random"])
@pytest.mark.parametrize("dims", [(8, 8, 8), (11, 7, 5)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("r2c", [False, True])
def test_xla_engine_matches_jax(r2c, dtype, dims, kind):
    rng = np.random.default_rng(sum(dims) + 2 * int(r2c) + (kind == "random"))
    trip = _triplets(kind, dims, r2c, rng)
    values = _values(rng, trip, dims, r2c)
    ref, port = _plans(r2c, dims, trip, dtype)
    assert port.engine == "xla" and port.num_x_active == port.params.dim_x_freq
    space_ref = ref.backward(values)
    space = port.backward(values)
    assert space.is_complex() != r2c
    _close(space, space_ref, dtype)
    for scaling in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        jscaling = spfft_tpu.ScalingType(int(scaling))
        _close(port.forward(scaling=scaling), ref.forward(scaling=jscaling), dtype)
        # an explicit (Z, Y, X) space input, the same for both
        _close(port.forward(np.asarray(space_ref), scaling),
               ref.forward(np.asarray(space_ref), jscaling), dtype)


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("r2c", [False, True])
def test_pair_api_in_the_native_layout(r2c, engine):
    """backward_pair and space_domain_data(GPU) hand out the engine's native
    buffer, in space_domain_layout order: (Z, Y, X) on xla, (Y, X, Z) on mxu,
    both held against the JAX package's xla plan (whose layout is zyx)."""
    dims = (8, 6, 5)
    rng = np.random.default_rng(5 + int(r2c))
    trip = _triplets("random", dims, r2c, rng)
    values = _values(rng, trip, dims, r2c)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                              dtype=np.float64, engine="xla")
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                        dtype=np.float64, engine=engine)
    assert port.space_domain_layout == {"xla": "zyx", "mxu": "yxz"}[engine]
    assert ref.space_domain_layout == "zyx"
    out_ref = ref.backward_pair(jnp.asarray(values.real), jnp.asarray(values.imag))
    out = port.backward_pair(values.real, values.imag)
    to_zyx = (lambda t: t) if engine == "xla" else (lambda t: t.permute(2, 0, 1))
    if r2c:
        assert torch.is_tensor(out) and not out.is_complex()
        _close(to_zyx(out), out_ref, np.float64)
    else:
        assert isinstance(out, tuple) and len(out) == 2
        for part, part_ref in zip(out, out_ref):
            _close(to_zyx(part), part_ref, np.float64)
    native = port.space_domain_data(tp.ProcessingUnit.GPU)
    assert native is out
    host = port.space_domain_data()
    assert isinstance(host, np.ndarray) and host.shape == (5, 6, 8)
    _close(host, ref.space_domain_data(), np.float64)
    got = port.forward_pair(tp.ScalingType.FULL)
    want = ref.forward_pair(spfft_tpu.ScalingType.FULL)
    for part, part_ref in zip(got, want):
        _close(part, part_ref, np.float64)


def test_auto_engine_resolves_as_jax():
    """"auto" is "xla" on a CPU plan, as in the JAX package
    (spfft_tpu/transform.py:207-208; "mxu" on the card, where chip_smoke.py's
    plans take it)."""
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    port = tp.Transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)
    assert port.engine == ref._engine == "xla"
    assert port.space_domain_layout == ref.space_domain_layout == "zyx"
    assert set(port.describe()) == {"pipeline", "ir"}


@pytest.mark.parametrize("fuse", [True, False])
def test_clone_keeps_engine_and_fusion(fuse, monkeypatch):
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    monkeypatch.setenv("SPFFT_TPU_FUSE", "1" if fuse else "0")
    t = tp.Transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)
    # the environment the clone is made in does not change its fusion
    monkeypatch.setenv("SPFFT_TPU_FUSE", "0" if fuse else "1")
    c = t.clone()
    assert (c.engine, c.fused) == ("xla", fuse)
    assert c.describe() == t.describe()
    assert c.describe()["ir"]["requested"] == "env"
    values = np.random.default_rng(3).standard_normal(len(trip)) + 0j
    assert torch.equal(c.backward(values), t.backward(values))


def test_grid_passes_engine_precision_and_fuse():
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    g = tp.Grid(8, 8, 8, 64, tp.ProcessingUnit.HOST)
    t = g.create_transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip, engine="mxu",
                           precision="high", fuse=False, dtype=np.float32)
    assert (t.engine, t.precision, t.fused, t.dtype) == ("mxu", "high", False, np.float32)
    t = g.create_transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)
    assert (t.engine, t.fused) == ("xla", True)


def test_transform_float_is_float32():
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    t = tp.TransformFloat(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)
    assert t.dtype == np.float32
    v = np.random.default_rng(1).standard_normal(len(trip)) + 0j
    assert t.backward(v).dtype == torch.complex64
