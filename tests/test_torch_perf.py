"""The port's perf layer (spfft_tpu_torch.obs.perf and the engines'
``stage_accounting()``) against the JAX package's (spfft_tpu.obs.perf).

The analytic flop and byte rows of one pair must equal the JAX package's
exactly (integers) for the local and slab ``engine="xla"`` plans on the same
triplets. The port's accelerator engine (``"mxu"``) cannot be held against
the JAX package's, which cannot be imported on this jax, so its rows are held
against ``spfft_tpu.obs.perf.pipeline_head_rows`` and ``pipeline_tail_rows``
on the same parameters. A perf report built from the same seconds equals the
JAX package's in every field but the run ID and passes its validator.
"""
import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.obs import perf as jperf
from spfft_tpu_torch import obs
from spfft_tpu_torch.obs import perf

DIMS = (8, 8, 9)


def problem(r2c, shards, radius=0.8):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, radius, hermitian_symmetry=r2c)
    return [np.asarray(t) for t in tp.distribute_triplets(trip, shards, DIMS[1])]


def plans(r2c, shards, per, exchange="BUFFERED", engine="xla", dtype=np.float64):
    """The same plan in both packages (the JAX one on ``engine="xla"``)."""
    out = []
    for pkg in (spfft_tpu, tp):
        if shards == 1:
            out.append(pkg.Transform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS, indices=per[0],
                                     dtype=dtype, engine="xla" if pkg is spfft_tpu else engine))
            continue
        mesh = pkg.make_fft_mesh(shards) if pkg is spfft_tpu else pkg.make_fft_mesh(
            shards, device="cpu")
        out.append(pkg.DistributedTransform(
            pkg.ProcessingUnit.HOST, int(r2c), *DIMS, [np.array(t) for t in per], mesh=mesh,
            dtype=dtype, engine="xla" if pkg is spfft_tpu else engine,
            exchange_type=pkg.ExchangeType[exchange]))
    return out


@pytest.mark.parametrize("r2c", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_local_xla_rows_equal(r2c, dtype):
    jt, pt = plans(r2c, 1, problem(r2c, 1), dtype=dtype)
    assert pt._exec.stage_accounting() == jt._exec.stage_accounting()


def test_local_rows_without_the_zero_stick():
    """An R2C plan whose sticks miss (0, 0) has no stick-symmetry row."""
    trip = problem(True, 1)[0]
    trip = trip[(trip[:, 0] != 0) | (trip[:, 1] != 0)]
    jt, pt = plans(True, 1, [trip])
    rows = pt._exec.stage_accounting()
    assert rows == jt._exec.stage_accounting()
    assert "stick symmetry" not in {r["stage"] for r in rows}


@pytest.mark.parametrize("r2c", [False, True])
@pytest.mark.parametrize("exchange", ["BUFFERED", "UNBUFFERED", "COMPACT_BUFFERED",
                                      "BUFFERED_FLOAT"])
def test_slab_xla_rows_equal(r2c, exchange):
    jt, pt = plans(r2c, 4, problem(r2c, 4), exchange=exchange)
    assert pt._exec.stage_accounting() == jt._exec.stage_accounting()


@pytest.mark.parametrize("r2c,radius,knobs,y_plan", [
    (False, 0.6, {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}, "dense"),
    (True, 0.6, {"SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}, "dense"),
    (False, 0.3, {"SPFFT_TPU_SPARSE_Y": "1", "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}, "per-slot"),
    (False, 0.6, {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "2"}, "blocked"),
    (True, 0.6, {"SPFFT_TPU_SPARSE_Y_BLOCKS": "2"}, "blocked"),
])
def test_mxu_rows_are_the_shared_head_and_tail(monkeypatch, r2c, radius, knobs, y_plan):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    trip = tp.create_spherical_cutoff_triplets(16, 16, 16, radius, hermitian_symmetry=r2c)
    t = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), 16, 16, 16, indices=trip,
                     dtype=np.float32, engine="mxu")
    ex, p = t._exec, t.params
    assert ex.y_plan == y_plan
    Z, Y, X, A, c = p.dim_z, p.dim_y, p.dim_x, ex.num_x_active, 8
    scope = {"dense": "y transform", "per-slot": "y transform sparse",
             "blocked": "y transform blocked"}[y_plan]
    want = jperf.pipeline_head_rows(p.num_values, p.num_sticks, Z, c,
                                    stick_symmetry=r2c and ex._zero_stick_id is not None)
    if y_plan == "dense":
        want += [{"stage": s, "flops": 0, "bytes": (p.num_sticks * Z + Z * Y * A) * c}
                 for s in ("expand", "pack")]
    want += jperf.pipeline_tail_rows(Z, Y, X, Z * A, c, plane_symmetry=r2c, y_scope=scope)
    assert ex.stage_accounting() == want


@pytest.mark.parametrize("r2c", [False, True])
@pytest.mark.parametrize("exchange", ["BUFFERED", "UNBUFFERED"])
def test_slab_mxu_rows_are_the_shared_head_and_tail(r2c, exchange):
    _, t = plans(r2c, 4, problem(r2c, 4), exchange=exchange, engine="mxu",
                 dtype=np.float32)
    ex, p = t._exec, t.params
    Z, Y, X, Xf, A, c = p.dim_z, p.dim_y, p.dim_x, p.dim_x_freq, ex.num_x_active, 8
    rows = ex.stage_accounting()
    head = jperf.pipeline_head_rows(int(p.num_values_per_shard.sum()),
                                    int(p.num_sticks_per_shard.sum()), Z, c,
                                    stick_symmetry=r2c and p.zero_stick_shard >= 0)
    tail = jperf.pipeline_tail_rows(Z, Y, X, Z * A, c, plane_symmetry=r2c,
                                    y_scope=ex._y_stage_scope())
    assert rows[:len(head)] == head and rows[len(rows) - len(tail):] == tail
    middle = rows[len(head):len(rows) - len(tail)]
    assert middle[-1] == {"stage": "exchange", "flops": 0,
                          "bytes": 2 * t.exchange_wire_bytes()}
    assert [r["stage"] for r in middle[:-1]] == (
        ["pack", "unpack"] if exchange == "BUFFERED" else ["unpack"])
    if exchange == "UNBUFFERED":
        assert middle[0]["bytes"] == Z * Y * Xf * c


@pytest.mark.parametrize("r2c,shards", [(False, 1), (True, 1), (False, 4), (True, 4)])
def test_perf_report_equals_the_jax_packages(r2c, shards):
    jt, pt = plans(r2c, shards, problem(r2c, shards))
    want = jperf.perf_report(jt, 2.5e-3, repeats=3)
    got = perf.perf_report(pt, 2.5e-3, repeats=3)
    assert jperf.validate_perf_report(got) == [] == perf.validate_perf_report(got)
    assert got.pop("run_id") == pt.report()["run_id"]
    want.pop("run_id")
    assert got == want
    assert abs(sum(r["seconds"] for r in got["stages"]) - 2.5e-3) < 1e-15
    snap = obs.snapshot()
    assert any(k.startswith("perf_pair_seconds") for k in snap["histograms"])


def test_unmodeled_stage_raises_typed(monkeypatch):
    _, pt = plans(False, 1, problem(False, 1))
    monkeypatch.setattr(pt._exec, "stage_accounting",
                        lambda: [{"stage": "teleport", "flops": 1, "bytes": 0}])
    with pytest.raises(tp.InvalidParameterError, match="teleport"):
        perf.perf_report(pt, 1e-3)


@pytest.mark.parametrize("r2c,shards", [(False, 1), (True, 1), (False, 4)])
def test_measure_pair_seconds(r2c, shards):
    _, pt = plans(r2c, shards, problem(r2c, shards))
    m = perf.measure_pair_seconds(pt, chain=2, repeats=2, warmup=1)
    assert set(m) == {"seconds_per_pair", "rep_seconds", "chain", "repeats",
                      "roundtrip_residual"}
    assert len(m["rep_seconds"]) == 2 and m["seconds_per_pair"] == min(m["rep_seconds"])
    if r2c:
        assert m["roundtrip_residual"] is None
    else:  # the C2C chain is the identity
        assert m["roundtrip_residual"] < 1e-12
