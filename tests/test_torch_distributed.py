"""The port's DistributedTransform (the torch.fft mesh engine) against the
JAX package's DistributedTransform(engine="xla").

The same per-shard triplets and values, made from a seed with numpy, go into
both packages; JAX meshes are ``spfft_tpu.make_fft_mesh(P)`` over the
conftest's virtual CPU devices, the port's ``make_fft_mesh(P, device="cpu")``.
Tolerances, max abs diff over max |JAX|: 1e-12 in float64, 1e-5 in float32;
the ``*_FLOAT`` wires 1e-6 and the ``*_BF16`` wires 3e-2, each against JAX's
same discipline.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.parallel import policy as jax_policy
from utils import storage

DIMS = (10, 8, 9)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
WIRE_TOL = {tp.ExchangeType.BUFFERED_FLOAT: 1e-6, tp.ExchangeType.COMPACT_BUFFERED_FLOAT: 1e-6,
            tp.ExchangeType.BUFFERED_BF16: 3e-2, tp.ExchangeType.COMPACT_BUFFERED_BF16: 3e-2}


def problem(r2c, P, seed, dims=DIMS, weights=None, radius=0.85):
    """Per-shard triplets (the port's distribute_triplets) and values; R2C
    values are the spectrum of a real field, so that the result is real."""
    rng = np.random.default_rng(seed)
    trip = tp.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=r2c)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, P, dims[1], weights=weights)]
    if r2c:
        spec = np.fft.fftn(rng.standard_normal(dims[::-1]))
        vals = [spec[storage(t[:, 2], dims[2]), storage(t[:, 1], dims[1]), t[:, 0]] for t in per]
    else:
        vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    return per, vals


def jax_default(per, lz, dtype, r2c, dims=DIMS):
    """The JAX package's DEFAULT for this layout where the one-shot ragged
    exchange exists (its TPU answer): the port's all_to_all_single always
    takes split sizes. On the CPU the JAX package costs UNBUFFERED as its
    P-1-round chain instead, so its plans' own DEFAULT can differ."""
    params = spfft_tpu.parameters.make_distributed_parameters(int(r2c), *dims, per, lz)
    return tp.ExchangeType(int(jax_policy.resolve_default_exchange(
        params.num_sticks_per_shard, params.local_z_lengths, one_shot_supported=True,
        wire_scalar_bytes=np.dtype(dtype).itemsize)))


def jax_plan(r2c, P, per, dtype, exchange=tp.ExchangeType.DEFAULT, lz=None, dims=DIMS):
    return spfft_tpu.DistributedTransform(
        spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, [t.copy() for t in per],
        mesh=spfft_tpu.make_fft_mesh(P), local_z_lengths=lz, dtype=dtype, engine="xla",
        exchange_type=spfft_tpu.ExchangeType(int(exchange)))


def port_plan(r2c, P, per, dtype, exchange=tp.ExchangeType.DEFAULT, lz=None, dims=DIMS,
              engine="xla", **kw):
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), *dims, per,
                                   mesh=tp.make_fft_mesh(P, device="cpu"), local_z_lengths=lz,
                                   dtype=dtype, engine=engine, exchange_type=exchange, **kw)


def close(got, ref, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def check_against(ref, port, vals, tol):
    """Backward (global space), forward at NONE on the given space and FULL
    on the retained one, per-shard value lists, against the reference plan."""
    space_ref = ref.backward(vals)
    space = port.backward(vals)
    close(space, space_ref, tol)
    for s in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        want = ref.forward(space_ref, spfft_tpu.ScalingType(int(s)))
        got = port.forward(space_ref if s == tp.ScalingType.NONE else None, s)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)


@pytest.mark.parametrize("exchange", list(tp.ExchangeType), ids=lambda e: e.name)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_every_exchange_matches_jax(r2c, exchange):
    """P = 4, float64, each discipline; a skewed layout and ragged slabs."""
    per, vals = problem(r2c, 4, 11 + int(exchange), weights=(3, 1, 1, 1))
    lz = (3, 2, 2, 2)
    port = port_plan(r2c, 4, per, np.float64, exchange, lz)
    resolved = exchange
    if exchange == tp.ExchangeType.DEFAULT:
        resolved = jax_default(per, lz, np.float64, r2c)
    assert port.exchange_type == resolved
    ref = jax_plan(r2c, 4, per, np.float64, resolved, lz)
    check_against(ref, port, vals, WIRE_TOL.get(exchange, TOL[np.float64]))
    assert port.exchange_wire_bytes() == ref.exchange_wire_bytes()
    assert port.exchange_rounds() == 1


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_shard_counts_match_jax(r2c, P, dtype):
    per, vals = problem(r2c, P, 3 * P + int(r2c))
    port = port_plan(r2c, P, per, dtype)
    assert port.exchange_type == jax_default(per, None, dtype, r2c)
    ref = jax_plan(r2c, P, per, dtype, port.exchange_type)
    check_against(ref, port, vals, TOL[dtype])
    assert port.exchange_wire_bytes() == ref.exchange_wire_bytes()
    for r in range(P):
        assert port.local_z_length(r) == ref.local_z_length(r)
        assert port.local_z_offset(r) == ref.local_z_offset(r)
        assert port.local_slice_size(r) == ref.local_slice_size(r)
        assert port.num_local_elements(r) == ref.num_local_elements(r)
    assert port.num_global_elements == ref.num_global_elements
    assert port.global_size == ref.global_size


def test_accessors_and_retained_data():
    per, vals = problem(False, 4, 5)
    port = port_plan(False, 4, per, np.float64, lz=(3, 2, 2, 2))
    space = port.backward(vals)
    np.testing.assert_array_equal(port.space_domain_data(), space.numpy())
    native = port.space_domain_data(tp.ProcessingUnit.GPU)
    assert native[0].shape == (DIMS[1], DIMS[0], 4, 3) and port.space_domain_layout == "yxz"
    for r in range(4):
        o, l = port.local_z_offset(r), port.local_z_length(r)
        np.testing.assert_array_equal(port.space_domain_data_local(r), space[o:o + l].numpy())
    pair = port.forward_pair(tp.ScalingType.FULL)
    assert pair[0].shape == (1 * 4, port._exec._V)
    back = port._exec.unpad_values(pair)
    for b, v in zip(back, vals):
        close(b, v, 1e-12)
    card = port.describe()
    assert card["exchange"]["type"] == port.exchange_type.name
    assert card["exchange"]["requested"] == "DEFAULT" and "policy" in card["exchange"]
    assert card["exchange"]["transport"] == "device gather"


def test_wrong_input_raises():
    per, vals = problem(False, 2, 1)
    port = port_plan(False, 2, per, np.float64)
    with pytest.raises(tp.InvalidParameterError):
        port.backward(vals[:1])
    with pytest.raises(tp.InvalidParameterError):
        port.backward([vals[0], vals[1][:-1]])
    with pytest.raises(tp.InvalidParameterError):
        port.forward()
    with pytest.raises(tp.InvalidParameterError):
        tp.DistributedTransform(tp.ProcessingUnit.GPU, 0, *DIMS, per,
                                mesh=tp.make_fft_mesh(2, device="cpu"))
    with pytest.raises(tp.InvalidParameterError):
        port_plan(False, 2, per, np.float64, engine="nope")
