"""Engine parity fuzz for the port: the twin of ``tests/test_engine_parity_fuzz.py``.

The same cases, seeds, dims, sparsity patterns, value orders and transform
types as the JAX package's fuzz (8 local, 3 distributed, 4 discipline and 2
pencil cases). Each case holds the port's ``mxu`` and ``xla`` engines
against each other at the float64 bar, both against the JAX package's
``engine="xla"`` on the same triplets and values (the JAX MXU engine cannot
be imported on this jax), and the port's mesh plans against its local
result.

Seeding is deterministic and reproducible from the environment: every
case's seed is ``SPFFT_TPU_FUZZ_SEED`` (default 0) + a per-test base + the
case index, printed at the top of each test, so that a failure replays with
``SPFFT_TPU_FUZZ_SEED=<offset> pytest <nodeid>``.
"""
import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.parameters import distribute_triplets
from spfft_tpu_torch import knobs
from utils import assert_close, random_sparse_triplets

CASES = list(range(8))

FUZZ_SEED = knobs.get_int("SPFFT_TPU_FUZZ_SEED")


def fuzz_rng(base: int, case: int) -> np.random.Generator:
    """Per-case generator seeded ``FUZZ_SEED + base + case``; prints the
    effective seed so a failing test's captured stdout names it."""
    seed = FUZZ_SEED + base + case
    print(f"fuzz seed = {seed} (SPFFT_TPU_FUZZ_SEED={FUZZ_SEED} + {base} + {case})")
    return np.random.default_rng(seed)


def _jax_local(ttype, dims, trip, values):
    """The JAX package's ``engine="xla"`` plan: (backward, FULL forward)."""
    t = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, spfft_tpu.TransformType(int(ttype)),
                            *dims, indices=trip, engine="xla")
    return t.backward(values), t.forward(scaling=spfft_tpu.ScalingType.FULL)


def _port_local(ttype, dims, trip, values, engine):
    t = tp.Transform(tp.ProcessingUnit.HOST, ttype, *dims, indices=trip, engine=engine)
    return t.backward(values), t.forward(scaling=tp.ScalingType.FULL)


def _per_shard_values(trip, values, per_shard):
    lut = {tuple(t): v for t, v in zip(map(tuple, trip), values)}
    return [np.asarray([lut[tuple(t)] for t in s]) for s in per_shard]


@pytest.mark.parametrize("case", CASES)
def test_local_engine_parity(case):
    rng = fuzz_rng(1000, case)
    dims = tuple(int(rng.integers(3, 20)) for _ in range(3))
    dx, dy, dz = dims
    r2c = bool(case % 2)
    trip = random_sparse_triplets(
        rng, dx, dy, dz,
        stick_fraction=float(rng.uniform(0.2, 0.9)),
        z_fill=float(rng.uniform(0.3, 1.0)),
        centered=bool(rng.integers(0, 2)),
        hermitian=r2c,
    )
    ttype = tp.TransformType.R2C if r2c else tp.TransformType.C2C
    n = len(trip)
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    jax_space, jax_back = _jax_local(ttype, dims, trip, values)
    outs, rounds = [], []
    for engine in ("xla", "mxu"):
        space, back = _port_local(ttype, dims, trip, values, engine)
        assert_close(space, jax_space)
        assert_close(back, jax_back)
        outs.append(space)
        rounds.append(back)
    assert_close(outs[1], outs[0])
    assert_close(rounds[1], rounds[0])


@pytest.mark.parametrize("case", [0, 1, 2])
def test_distributed_engine_parity(case):
    rng = fuzz_rng(2000, case)
    dims = tuple(int(rng.integers(4, 16)) for _ in range(3))
    dx, dy, dz = dims
    shards = int(rng.choice([2, 3, 4]))
    trip = random_sparse_triplets(rng, dx, dy, dz, 0.6)
    n = len(trip)
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    per_shard = distribute_triplets(trip, shards, dy)
    vps = _per_shard_values(trip, values, per_shard)

    local, _ = _port_local(tp.TransformType.C2C, dims, trip, values, "auto")
    assert_close(local, _jax_local(tp.TransformType.C2C, dims, trip, values)[0])

    for engine in ("xla", "mxu"):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, dx, dy, dz,
                                    [np.asarray(p) for p in per_shard],
                                    mesh=tp.make_fft_mesh(shards, device="cpu"), engine=engine)
        assert_close(t.backward(vps), local)
        back = t.forward(scaling=tp.ScalingType.FULL)
        for r, vals in enumerate(vps):
            assert_close(back[r], vals)


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_distributed_discipline_fuzz(case):
    """Random plans x random exchange disciplines (with the float wire
    variants) x both engines x C2C/R2C against the local result."""
    rng = fuzz_rng(3000, case)
    dims = tuple(int(rng.integers(4, 14)) for _ in range(3))
    dx, dy, dz = dims
    shards = int(rng.choice([2, 4]))
    r2c = bool(case % 2)
    trip = random_sparse_triplets(rng, dx, dy, dz, float(rng.uniform(0.3, 0.8)), hermitian=r2c)
    ttype = tp.TransformType.R2C if r2c else tp.TransformType.C2C
    n = len(trip)
    if r2c:
        real = rng.standard_normal((dz, dy, dx))
        freq = np.fft.fftn(real) / (dx * dy * dz)
        values = freq[trip[:, 2], trip[:, 1], trip[:, 0]]
    else:
        values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    per_shard = distribute_triplets(trip, shards, dy)
    vps = _per_shard_values(trip, values, per_shard)

    local, _ = _port_local(ttype, dims, trip, values, "auto")
    assert_close(local, _jax_local(ttype, dims, trip, values)[0])

    exchange = tp.ExchangeType(int(rng.choice([
        spfft_tpu.ExchangeType.BUFFERED,
        spfft_tpu.ExchangeType.BUFFERED_FLOAT,
        spfft_tpu.ExchangeType.COMPACT_BUFFERED,
        spfft_tpu.ExchangeType.COMPACT_BUFFERED_FLOAT,
        spfft_tpu.ExchangeType.UNBUFFERED,
    ])))
    # float-wire exchanges round the payload to f32: compare at that bar
    tol = (dict(rtol=2e-4, atol=2e-4)
           if exchange in (tp.ExchangeType.BUFFERED_FLOAT, tp.ExchangeType.COMPACT_BUFFERED_FLOAT)
           else dict(rtol=1e-6, atol=1e-8))
    for engine in ("xla", "mxu"):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, ttype, dx, dy, dz,
                                    [np.asarray(p).copy() for p in per_shard],
                                    mesh=tp.make_fft_mesh(shards, device="cpu"), engine=engine,
                                    exchange_type=exchange)
        out = t.backward([v.copy() for v in vps])
        np.testing.assert_allclose(np.asarray(out), np.asarray(local), **tol)
        back = t.forward(scaling=tp.ScalingType.FULL)
        for r, vals in enumerate(vps):
            np.testing.assert_allclose(np.asarray(back[r]), vals, **tol)


@pytest.mark.parametrize("case", [0, 1])
def test_pencil_mesh_fuzz(case):
    """Random plans on 2-D pencil meshes (both engines, a random exchange)
    against the local result."""
    rng = fuzz_rng(4000, case)
    p1, p2 = (2, 2) if case == 0 else (2, 4)
    # pencil needs dim_z >= p1 and dim_y >= p2 slabs with content
    dx = int(rng.integers(4, 10))
    dy = int(rng.integers(p2 + 2, 14))
    dz = int(rng.integers(p1 + 2, 14))
    trip = random_sparse_triplets(rng, dx, dy, dz, float(rng.uniform(0.4, 0.9)))
    n = len(trip)
    values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    per_shard = distribute_triplets(trip, p1 * p2, dy)
    vps = _per_shard_values(trip, values, per_shard)

    dims = (dx, dy, dz)
    local, _ = _port_local(tp.TransformType.C2C, dims, trip, values, "auto")
    assert_close(local, _jax_local(tp.TransformType.C2C, dims, trip, values)[0])

    exchange = tp.ExchangeType(int(rng.choice([spfft_tpu.ExchangeType.BUFFERED,
                                               spfft_tpu.ExchangeType.COMPACT_BUFFERED])))
    for engine in ("xla", "mxu"):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, dx, dy, dz,
                                    [np.asarray(p).copy() for p in per_shard],
                                    mesh=tp.make_fft_mesh2(p1, p2, device="cpu"), engine=engine,
                                    exchange_type=exchange)
        assert t.engine == ("pencil2" if engine == "xla" else "pencil2-mxu")
        out = t.backward([v.copy() for v in vps])
        assert_close(out, local)
        back = t.forward(scaling=tp.ScalingType.FULL)
        for r, vals in enumerate(vps):
            assert_close(back[r], vals)
