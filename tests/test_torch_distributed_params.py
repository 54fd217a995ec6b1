"""The port's distributed plan metadata, stick distribution and DEFAULT
exchange policy against the JAX package's (spfft_tpu/parameters.py,
spfft_tpu/parallel/policy.py), on the same triplets."""
import dataclasses

import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import parameters as jparams
from spfft_tpu.parallel import policy as jpolicy
from spfft_tpu.parallel import ragged as jragged
from spfft_tpu_torch import parameters as tparams
from spfft_tpu_torch.parallel import policy as tpolicy
from spfft_tpu_torch.parallel import ragged as tragged
from test_torch_distributed import DIMS as PLAN_DIMS
from test_torch_distributed import jax_plan, port_plan, problem

DIMS = (12, 10, 9)
LAYOUTS = {"balanced": None, "weighted": (2, 1, 1, 1), "zero_weight": (1, 0, 2, 1)}


def _fields_equal(a, b):
    for f in dataclasses.fields(tparams.DistributedParameters):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "stick_xy_per_shard":
            assert len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        elif f.name == "transform_type":
            assert int(x) == int(y)
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


@pytest.mark.parametrize("weights", list(LAYOUTS.values()), ids=list(LAYOUTS))
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_distribute_triplets_and_parameters_match_jax(r2c, weights):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8, hermitian_symmetry=r2c)
    trip = trip[np.random.default_rng(3).permutation(len(trip))]
    got = tp.distribute_triplets(trip, 4, DIMS[1], weights=weights)
    want = jparams.distribute_triplets(trip, 4, DIMS[1], weights=weights)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    if weights is not None and 0 in weights:
        assert got[weights.index(0)].size == 0
    np.testing.assert_array_equal(tparams.stick_keys(trip, DIMS[1]),
                                  jparams.stick_keys(trip, DIMS[1]))
    for lz in (None, (4, 2, 2, 1), (0, 3, 3, 3)):
        a = tparams.make_distributed_parameters(int(r2c), *DIMS, got, lz)
        b = jparams.make_distributed_parameters(int(r2c), *DIMS, want, lz)
        _fields_equal(a, b)
        np.testing.assert_array_equal(a.pack_z_map(), b.pack_z_map())
        np.testing.assert_array_equal(a.unpack_z_map(), b.unpack_z_map())
        assert (a.max_num_sticks, a.max_num_values, a.max_local_z_length, a.dim_x_freq) == (
            b.max_num_sticks, b.max_num_values, b.max_local_z_length, b.dim_x_freq)
        _fields_equal(tparams.from_jax_distributed_params(vars(b)), b)


def test_mismatched_parameters_raise():
    per = tp.distribute_triplets(tp.create_spherical_cutoff_triplets(*DIMS, 0.8), 4, DIMS[1])
    for lz in ((3, 3, 3), (3, 3, 3, 1), (5, 5, -1, 0)):
        with pytest.raises(tp.MPIParameterMismatchError):
            tparams.make_distributed_parameters(0, *DIMS, per, lz)
    dup = [per[0], np.concatenate([per[1], per[0][:1]])]
    with pytest.raises(tp.DuplicateIndicesError):
        tparams.make_distributed_parameters(0, *DIMS, dup)
    with pytest.raises(tp.InvalidParameterError):
        tp.distribute_triplets(per[0], 2, DIMS[1], weights=(0, 0))
    with pytest.raises(tp.InvalidParameterError):
        tparams.make_distributed_parameters(0, *DIMS, [])


@pytest.mark.parametrize("weights", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_policy_matches_jax(weights):
    per = tp.distribute_triplets(tp.create_spherical_cutoff_triplets(*DIMS, 0.8), 4, DIMS[1],
                                 weights=weights)
    p = tparams.make_distributed_parameters(0, *DIMS, per, (3, 2, 2, 2))
    args = (p.num_sticks_per_shard, p.local_z_lengths)
    for width in (2, 4, 8):
        kw = {"one_shot_supported": True, "wire_scalar_bytes": width}
        assert int(tpolicy.resolve_default_exchange(p.num_sticks_per_shard)) == int(
            jpolicy.resolve_default_exchange(*args, **kw))
    assert {int(d): v for d, v in tpolicy.discipline_volumes(*args).items()} == {
        int(d): v for d, v in jpolicy.discipline_volumes(*args).items()}


@pytest.mark.parametrize("kb", ["0", "1", "128", "100000"])
@pytest.mark.parametrize("weights", [None, (3, 1, 1, 1), (1, 0, 2, 1)],
                         ids=["balanced", "skewed", "zero_weight"])
@pytest.mark.parametrize("shards", [2, 4])
def test_default_rule_is_the_jax_cost_model_at_any_round_cost(monkeypatch, shards, weights, kb):
    """With the one-shot exchange supported, the JAX cost model's minimum
    does not move with SPFFT_TPU_EXCH_ROUND_COST_KB: the port's rule is it."""
    weights = None if weights is None else weights[:shards]
    per = tp.distribute_triplets(tp.create_spherical_cutoff_triplets(*DIMS, 0.8), shards,
                                 DIMS[1], weights=weights)
    p = tparams.make_distributed_parameters(0, *DIMS, per)
    monkeypatch.setenv("SPFFT_TPU_EXCH_ROUND_COST_KB", kb)
    want = jpolicy.resolve_default_exchange(p.num_sticks_per_shard, p.local_z_lengths,
                                            one_shot_supported=True)
    assert int(tpolicy.resolve_default_exchange(p.num_sticks_per_shard)) == int(want)


@pytest.mark.parametrize("weights", [None, (4, 1, 1, 1)], ids=["balanced", "skewed"])
def test_wire_bytes_match_jax(weights):
    """exchange_wire_bytes of every explicit discipline, and the resolved
    DEFAULT: the JAX package's answer where its one-shot exchange exists."""
    per, _ = problem(False, 4, 1, weights=weights)
    lz = (3, 2, 2, 2)
    for exchange in list(tp.ExchangeType)[1:]:
        for dtype in (np.float64, np.float32):
            port = port_plan(False, 4, per, dtype, exchange, lz)
            ref = jax_plan(False, 4, per, dtype, exchange, lz)
            assert port.exchange_wire_bytes() == ref.exchange_wire_bytes(), exchange.name
    port = port_plan(False, 4, per, np.float64, lz=lz)
    params = jparams.make_distributed_parameters(0, *PLAN_DIMS, per, lz)
    want = jpolicy.resolve_default_exchange(params.num_sticks_per_shard, params.local_z_lengths,
                                            one_shot_supported=True, wire_scalar_bytes=8)
    assert int(port.exchange_type) == int(want)
    assert port.describe()["exchange"]["policy"][port.exchange_type.name]["wire_bytes"] == \
        port.exchange_wire_bytes()


def test_plan_from_jax_parameters_gives_the_same_results():
    per, vals = problem(True, 4, 9, weights=(1, 2, 1, 1))
    ref = jax_plan(True, 4, per, np.float64, lz=(2, 3, 2, 2))
    carried = tparams.from_jax_distributed_params(vars(ref._params))
    mesh = tp.make_fft_mesh(4, device="cpu")
    a = tp.DistributedTransform.from_parameters(tp.ProcessingUnit.HOST, carried, mesh=mesh)
    b = port_plan(True, 4, per, np.float64, lz=(2, 3, 2, 2))
    np.testing.assert_array_equal(a.backward(vals).numpy(), b.backward(vals).numpy())
    for x, y in zip(a.forward(scaling=tp.ScalingType.FULL), b.forward(scaling=tp.ScalingType.FULL)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_value_order_map_matches_jax():
    rng = np.random.default_rng(4)
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.7)
    req = trip[rng.permutation(len(trip))]
    np.testing.assert_array_equal(tragged.value_order_map(trip, req),
                                  jragged.value_order_map(trip, req))
    assert tragged.value_order_map(trip, req[1:]) is None


def test_policy_and_overlap_take_only_their_defaults(monkeypatch):
    monkeypatch.delenv("SPFFT_TPU_POLICY", raising=False)
    assert tpolicy.resolve_policy() == tpolicy.resolve_policy("default") == "default"
    # "tuned" is ported, and the knob reads as the JAX package's
    assert tpolicy.resolve_policy("tuned") == "tuned"
    monkeypatch.setenv("SPFFT_TPU_POLICY", "tuned")
    assert tpolicy.resolve_policy() == spfft_tpu.parallel.policy.resolve_policy() == "tuned"
    monkeypatch.delenv("SPFFT_TPU_POLICY")
    with pytest.raises(tp.InvalidParameterError):
        tpolicy.resolve_policy("fastest")
    # the overlap count reads as the JAX package's: the argument, else the
    # knob, else 1; below 1 raises
    monkeypatch.delenv(tpolicy.OVERLAP_ENV, raising=False)
    assert tpolicy.resolve_overlap_chunks() == tpolicy.resolve_overlap_chunks(1) == 1
    for n in (2, 7):
        assert tpolicy.resolve_overlap_chunks(n) == spfft_tpu.parallel.policy.resolve_overlap_chunks(n) == n
    monkeypatch.setenv(tpolicy.OVERLAP_ENV, "3")
    assert tpolicy.resolve_overlap_chunks() == spfft_tpu.parallel.policy.resolve_overlap_chunks() == 3
    assert tpolicy.resolve_overlap_chunks(2) == 2
    monkeypatch.delenv(tpolicy.OVERLAP_ENV)
    with pytest.raises(tp.InvalidParameterError):
        tpolicy.resolve_overlap_chunks(0)
    assert spfft_tpu.parallel.policy.resolve_overlap_chunks(1) == tpolicy.resolve_overlap_chunks(1)


def test_chunk_ranges_match_jax():
    from spfft_tpu.parallel.execution import chunk_ranges as jax_chunks
    from spfft_tpu_torch.parallel.execution import chunk_ranges

    for n, c in ((10, 3), (7, 7), (5, 9), (1, 1), (64, 4)):
        assert chunk_ranges(n, c) == jax_chunks(n, c)
