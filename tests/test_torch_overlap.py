"""The port's OVERLAPPED exchange against the JAX package's, a twin of every
test function of tests/test_overlap.py.

The same seeded triplets and values (the JAX test's ``fuzz_rng`` bases) go
through the JAX package's ``engine="xla"`` mesh plans, overlapped and bulk
(its MXU engine does not import on this jax), and through both port engines
at chunk counts {1, 2, 7, P}. Bars: against JAX, ``assert_close``'s dtype
bar; against the port's own ``overlap=1`` twin ``rtol=1e-6, atol=1e-8`` as
in the JAX test, and bitwise where the port gets it (the ``torch.fft``
engine on the CPU and every pencil plan: the chunks run the same per-row
arithmetic; :func:`_twin` says where float32 differs). Also the
knob surface: clamps, the env knob, the plan card, ``Grid`` threading, the
perf model's exposed-time rows, the tuner owning the count and the
candidates, and the stream schedule's issue order.
"""
import os

import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu.parameters import distribute_triplets
from spfft_tpu_torch import ir, tuning
from spfft_tpu_torch.obs import perf
from utils import assert_close, random_sparse_triplets

FUZZ_SEED = int(os.environ.get("SPFFT_TPU_FUZZ_SEED", "0"))


def fuzz_rng(base: int, case: int) -> np.random.Generator:
    seed = FUZZ_SEED + base + case
    print(f"fuzz seed = {seed} (SPFFT_TPU_FUZZ_SEED={FUZZ_SEED} + {base} + {case})")
    return np.random.default_rng(seed)


def _case_plan(rng, r2c, dtype, p_y=None):
    """The JAX test's case: random dims, triplets and values (R2C: the
    spectrum of a real field)."""
    dx = int(rng.integers(5, 12))
    dy = int(rng.integers(6, 12) if p_y is None else rng.integers(p_y + 2, 12))
    dz = int(rng.integers(6, 13))
    trip = random_sparse_triplets(rng, dx, dy, dz, float(rng.uniform(0.4, 0.9)), hermitian=r2c)
    n = len(trip)
    if r2c:
        real = rng.standard_normal((dz, dy, dx))
        freq = np.fft.fftn(real) / (dx * dy * dz)
        values = freq[trip[:, 2], trip[:, 1], trip[:, 0]]
    else:
        values = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return (dx, dy, dz), trip, values.astype(np.complex64 if dtype == np.float32
                                             else np.complex128)


def _shard(trip, values, shards, dy, **kw):
    per_shard = distribute_triplets(trip, shards, dy, **kw)
    lut = {tuple(t): v for t, v in zip(map(tuple, trip), values)}
    return per_shard, [np.asarray([lut[tuple(t)] for t in s]) for s in per_shard]


def _roundtrip(t, vps):
    out = t.backward([v.copy() for v in vps])
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    back = t.forward(scaling=spfft_tpu.ScalingType.FULL)
    return out.copy(), np.concatenate([b.numpy() if torch.is_tensor(b) else np.asarray(b)
                                       for b in back])


def _twin(got, ref, bitwise):
    """The overlapped result against its overlap=1 twin: bitwise, or the
    JAX test's ``rtol=1e-6, atol=1e-8``. In float32 the matrix-product
    engine's CPU plain version (a PyTorch batched matmul) rounds by its
    blocking, which follows M, so there the absolute part is 1e-6 of the
    largest value (float32's rounding of the sums, about 1.5e-7 of it)."""
    for g, r in zip(got, ref):
        if bitwise:
            assert np.array_equal(g, r)
        else:
            single = np.abs(r).dtype == np.float32
            atol = 1e-6 * float(np.abs(r).max()) if single else 1e-8
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=atol)


# ---- parity fuzz: overlapped vs unchunked, the port vs JAX ------------------------------


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_slab_overlap_parity(engine, case):
    """Chunk counts {2, 7, P} x {C2C, R2C} x {f32, f64} x padded/_FLOAT wire
    against the overlap=1 twin, the JAX package's xla plan of the same
    overlap and the local oracle, per port engine."""
    rng = fuzz_rng(7000, case)
    r2c = bool(case % 2)
    dtype = np.float64 if case // 2 % 2 else np.float32
    exchange = (spfft_tpu.ExchangeType.BUFFERED_FLOAT if dtype == np.float64 and case % 2 == 0
                else spfft_tpu.ExchangeType.BUFFERED)
    dims, trip, values = _case_plan(rng, r2c, dtype)
    dx, dy, dz = dims
    shards = int(rng.choice([2, 4]))
    per_shard, vps = _shard(trip, values, shards, dy)
    tol = dict(dtype=np.float32) if dtype == np.float32 else {}
    local = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), dx, dy, dz, indices=trip,
                                dtype=dtype).backward(values)

    ref = None
    for overlap in (1, 2, 7, shards):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), dx, dy, dz,
                                    [p.copy() for p in per_shard],
                                    mesh=tp.make_fft_mesh(shards, device="cpu"), dtype=dtype,
                                    engine=engine, exchange_type=int(exchange), overlap=overlap)
        assert t.overlap_chunks == (1 if overlap == 1 else min(overlap, t.params.max_num_sticks))
        assert t.exchange_rounds() == t.overlap_chunks
        out, back = _roundtrip(t, vps)
        assert_close(out, local, **tol)
        if overlap in (1, 2):  # the JAX package's plan of the same overlap
            jt = spfft_tpu.DistributedTransform(
                spfft_tpu.ProcessingUnit.HOST, int(r2c), dx, dy, dz,
                [p.copy() for p in per_shard], mesh=spfft_tpu.make_fft_mesh(shards),
                dtype=dtype, engine="xla", exchange_type=exchange, overlap=overlap)
            assert jt.overlap_chunks == t.overlap_chunks
            jout, jback = _roundtrip(jt, vps)
            assert_close(out, jout, **tol)
            assert_close(back, jback, **tol)
        if ref is None:
            ref = (out, back)
        else:
            _twin((out, back), ref, bitwise=engine == "xla")


@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("case", [0, 1])
def test_pencil_overlap_parity(engine, case):
    """Chunked pencil pipelines (exchange A against y, exchange B against x)
    against the bulk twin, the JAX package's xla pencil plan and the local
    oracle."""
    rng = fuzz_rng(8000, 2 * case + (engine == "mxu"))
    r2c = bool(case % 2)
    dtype = np.float32 if case % 2 else np.float64
    p1, p2 = 2, 2
    dims, trip, values = _case_plan(rng, r2c, dtype, p_y=p1)
    dx, dy, dz = dims
    per_shard, vps = _shard(trip, values, p1 * p2, dy)
    tol = dict(dtype=np.float32) if dtype == np.float32 else {}
    local = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), dx, dy, dz, indices=trip,
                                dtype=dtype).backward(values)

    ref = None
    for overlap in (1, 2, 7):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), dx, dy, dz,
                                    [p.copy() for p in per_shard],
                                    mesh=tp.make_fft_mesh2(p1, p2, device="cpu"), dtype=dtype,
                                    engine=engine, exchange_type=tp.ExchangeType.BUFFERED,
                                    overlap=overlap)
        out, back = _roundtrip(t, vps)
        assert_close(out, local, **tol)
        if overlap == 2:
            jt = spfft_tpu.DistributedTransform(
                spfft_tpu.ProcessingUnit.HOST, int(r2c), dx, dy, dz,
                [p.copy() for p in per_shard], mesh=spfft_tpu.make_fft_mesh2(p1, p2),
                dtype=dtype, engine="xla", exchange_type=spfft_tpu.ExchangeType.BUFFERED,
                overlap=overlap)
            assert jt.overlap_chunks == t.overlap_chunks
            jout, jback = _roundtrip(jt, vps)
            assert_close(out, jout, **tol)
            assert_close(back, jback, **tol)
        if ref is None:
            ref = (out, back)
        else:
            assert 1 < t.overlap_chunks <= -(-dz // p2)
            assert t.exchange_rounds() == 2 * t.overlap_chunks
            _twin((out, back), ref, bitwise=True)


# ---- knob behaviour ------------------------------------------------------------------


def _small_dist(pkg=tp, overlap=None, exchange=None, mesh=None, policy=None, **kw):
    trip = spfft_tpu.create_spherical_cutoff_triplets(8, 8, 8, 0.9)
    exchange = pkg.ExchangeType.BUFFERED if exchange is None else exchange
    if mesh is None:
        mesh = tp.make_fft_mesh(4, device="cpu") if pkg is tp else spfft_tpu.make_fft_mesh(4)
    return pkg.DistributedTransform(pkg.ProcessingUnit.HOST, pkg.TransformType.C2C, 8, 8, 8,
                                    np.asarray(trip).copy(), mesh=mesh, dtype=np.float32,
                                    engine="xla", exchange_type=exchange, overlap=overlap,
                                    policy=policy, **kw)


def test_ragged_disciplines_ignore_overlap():
    """COMPACT/UNBUFFERED clamp the knob to 1, as in the JAX package."""
    for exchange in (tp.ExchangeType.COMPACT_BUFFERED, tp.ExchangeType.UNBUFFERED):
        t = _small_dist(overlap=6, exchange=exchange)
        j = _small_dist(spfft_tpu, overlap=6, exchange=spfft_tpu.ExchangeType(int(exchange)))
        assert t.overlap_chunks == 1 == j.overlap_chunks
        assert "chunked" not in t._exec.exchange_transport()
        assert t.exchange_rounds() == 1


def test_overlap_clamps_to_chunkable_extent():
    t = _small_dist(overlap=10_000)
    j = _small_dist(spfft_tpu, overlap=10_000)
    assert 1 < t.overlap_chunks == t._exec._S == j.overlap_chunks
    assert t.exchange_rounds() == t.overlap_chunks == j.exchange_rounds()
    # shards stacked on one device: the chunks are gathers, not collectives
    assert t._exec.exchange_transport() == "chunked device gather"
    assert j._exec.exchange_transport() == "chunked all_to_all"
    one = tp.DistributedTransform(tp.ProcessingUnit.HOST, 0, 8, 8, 8,
                                  spfft_tpu.create_spherical_cutoff_triplets(8, 8, 8, 0.9),
                                  mesh=tp.make_fft_mesh(1, device="cpu"), overlap=4,
                                  exchange_type=tp.ExchangeType.BUFFERED)
    assert one.overlap_chunks == 1  # one shard: no exchange to chunk


def test_overlap_env_knob(monkeypatch):
    from spfft_tpu_torch.parallel.policy import OVERLAP_ENV

    assert OVERLAP_ENV == spfft_tpu.parallel.policy.OVERLAP_ENV
    monkeypatch.setenv(OVERLAP_ENV, "3")
    assert _small_dist().overlap_chunks == 3 == _small_dist(spfft_tpu).overlap_chunks
    assert _small_dist(overlap=2).overlap_chunks == 2  # the argument wins
    monkeypatch.setenv(OVERLAP_ENV, "banana")
    with pytest.raises(tp.InvalidParameterError):
        _small_dist()
    monkeypatch.delenv(OVERLAP_ENV)
    with pytest.raises(tp.InvalidParameterError):
        _small_dist(overlap=0)


def test_plan_card_records_overlap_provenance():
    t = _small_dist(overlap=4)
    card = t.report()
    assert tp.obs.validate_plan_card(card) == [] == spfft_tpu.obs.validate_plan_card(card)
    assert card["exchange"]["overlap_chunks"] == t.overlap_chunks == 4
    assert card["exchange"]["transport"] == "chunked device gather"
    assert card["exchange"]["rounds"] == 4
    assert card["execution"]["overlap_chunks"] == t.overlap_chunks
    policy = card["exchange_policy"]
    assert policy["chosen"] == f"BUFFERED/ov{t.overlap_chunks}"
    chosen = [a for a in policy["alternatives"] if a["chosen"]]
    assert len(chosen) == 1
    assert chosen[0]["discipline"] == policy["chosen"]
    assert chosen[0]["rounds"] == t.overlap_chunks
    # the overlapped row costs the same exact wire bytes as its padded base
    base = next(a for a in policy["alternatives"] if a["discipline"] == "BUFFERED")
    assert chosen[0]["wire_bytes"] == base["wire_bytes"] == t.exchange_wire_bytes()
    jcard = _small_dist(spfft_tpu, overlap=4).report()
    assert jcard["exchange_policy"]["chosen"] == policy["chosen"]
    assert jcard["exchange"]["wire_bytes"] == card["exchange"]["wire_bytes"]


def test_grid_create_transform_threads_overlap():
    grid = tp.Grid(8, 8, 8, 64, tp.ProcessingUnit.HOST, mesh=tp.make_fft_mesh(4, device="cpu"),
                   exchange_type=tp.ExchangeType.BUFFERED)
    trip = spfft_tpu.create_spherical_cutoff_triplets(8, 8, 8, 0.9)
    t = grid.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8,
                              indices=trip, overlap=2)
    assert t.overlap_chunks == 2
    local_grid = tp.Grid(8, 8, 8, 64, tp.ProcessingUnit.HOST)
    with pytest.raises(tp.InvalidParameterError):
        local_grid.create_transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8,
                                    indices=trip, overlap=2)


# ---- perf accounting: exposed-time attribution ------------------------------------------


def test_perf_scores_overlap_on_exposed_time():
    """The overlapped report keeps the exact wire bytes but attributes less
    time to the exchange; the port's rows equal the JAX package's."""
    reports, jreports = {}, {}
    for overlap in (1, 4):
        reports[overlap] = perf.perf_report(_small_dist(overlap=overlap), 1e-3, repeats=1)
        jreports[overlap] = spfft_tpu.obs.perf.perf_report(_small_dist(spfft_tpu, overlap=overlap),
                                                           1e-3, repeats=1)
    for rep in reports.values():
        assert perf.validate_perf_report(rep) == []
    r1, r4 = reports[1], reports[4]
    names4 = {r["stage"] for r in r4["stages"]}
    assert "exchange overlapped" in names4 and "exchange" not in names4

    def wire(rep):
        return sum(r["bytes"] for r in rep["stages"] if r["stage"] in perf.EXCHANGE_STAGES)

    assert wire(r1) == wire(r4) == r1["wire_bytes_per_pair"]
    assert r4["overlap_chunks"] > 1 and r1["overlap_chunks"] == 1
    assert r4["exchange_fraction"] < r1["exchange_fraction"]
    (row,) = [r for r in r4["stages"] if r["stage"] == "exchange overlapped"]
    assert row["overlap"] == {"chunks": r4["overlap_chunks"], "hides": "z transform"}
    assert sum(r["seconds"] for r in r4["stages"]) == pytest.approx(1e-3)
    for ov in (1, 4):  # the same model rows and exposed weights as the JAX package
        want = {r["stage"]: r for r in jreports[ov]["stages"]}
        for r in reports[ov]["stages"]:
            assert r["bytes"] == want[r["stage"]]["bytes"], r["stage"]
            assert r.get("overlap") == want[r["stage"]].get("overlap")


def test_pencil_perf_overlap_rows():
    trip = spfft_tpu.create_spherical_cutoff_triplets(8, 8, 8, 0.9)
    fr = {}
    for overlap in (1, 2):
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8,
                                    np.asarray(trip).copy(),
                                    mesh=tp.make_fft_mesh2(2, 4, device="cpu"),
                                    dtype=np.float32, engine="xla",
                                    exchange_type=tp.ExchangeType.BUFFERED, overlap=overlap)
        rep = perf.perf_report(t, 1e-3, repeats=1)
        assert perf.validate_perf_report(rep) == []
        fr[overlap] = rep["exchange_fraction"]
        names = {r["stage"] for r in rep["stages"]}
        if overlap > 1:
            assert {"exchange A overlapped", "exchange B overlapped"} <= names
            rows = {r["stage"]: r for r in rep["stages"] if "overlapped" in r["stage"]}
            assert rows["exchange A overlapped"]["overlap"]["hides"] == "y transform"
            assert rows["exchange B overlapped"]["overlap"]["hides"] == "x transform"
            assert t.exchange_rounds() == 2 * t.overlap_chunks
        else:
            assert {"exchange A", "exchange B"} <= names
    assert fr[2] < fr[1]


# ---- tuner ownership ----------------------------------------------------------------------


def test_tuned_policy_owns_overlap_knob(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom.json"))
    monkeypatch.setenv(tuning.TUNE_CPU_ENV, "1")
    monkeypatch.setenv(tuning.TUNE_REPEATS_ENV, "1")
    tuning.clear_memory()
    try:
        t = _small_dist(exchange=tp.ExchangeType.DEFAULT, policy="tuned")
        rec = t._tuning
        labels = [r["label"] for r in rec["trials"]]
        assert {"BUFFERED/ov2", "BUFFERED/ov4"} <= set(labels), labels
        assert "overlap" in rec["choice"]
        assert t.overlap_chunks == rec["choice"]["overlap"]
        card = t.report()
        assert any("/ov" in r["label"] for r in card["tuning"]["trials"])
        # a wisdom hit reproduces the discipline and the chunk count, no trial
        t2 = _small_dist(exchange=tp.ExchangeType.DEFAULT, policy="tuned")
        assert t2._tuning["hit"] is True
        assert t2.overlap_chunks == t.overlap_chunks
        assert t2.exchange_type == t.exchange_type
        # an explicit overlap pin removes the axis from the trials
        tuning.clear_memory()
        monkeypatch.setenv(tuning.WISDOM_ENV, str(tmp_path / "wisdom2.json"))
        t3 = _small_dist(exchange=tp.ExchangeType.DEFAULT, policy="tuned", overlap=2)
        assert not any("/ov" in r["label"] for r in t3._tuning["trials"])
        assert t3._tuning["key"]["overlap"] == 2 if "key" in t3._tuning else True
    finally:
        tuning.clear_memory()


def test_overlap_candidates_shape(monkeypatch):
    from spfft_tpu_torch.tuning.candidates import OVERLAP_CANDIDATE_CHUNKS, exchange_candidates

    monkeypatch.delenv("SPFFT_TPU_EXCH_ROUND_COST_KB", raising=False)
    assert OVERLAP_CANDIDATE_CHUNKS == spfft_tpu.tuning.candidates.OVERLAP_CANDIDATE_CHUNKS
    cands = exchange_candidates([4, 4], [4, 4])
    ov_rows = [c for c in cands if "/ov" in c["label"]]
    assert {c["overlap"] for c in ov_rows} == set(OVERLAP_CANDIDATE_CHUNKS)
    assert all(c["exchange_type"] == "BUFFERED" for c in ov_rows)
    # the model ranks overlapped rows behind plain BUFFERED (more rounds, the
    # same bytes): the measurement decides whether hiding wins
    base = next(c for c in cands if c["label"] == "BUFFERED")
    assert all(c["model_cost_bytes"] > base["model_cost_bytes"] for c in ov_rows)
    assert cands == spfft_tpu.tuning.candidates.exchange_candidates(
        [4, 4], [4, 4], one_shot_supported=True)
    pinned = exchange_candidates([4, 4], [4, 4], overlap=3)
    assert not any("/ov" in c["label"] for c in pinned)
    assert all(c["overlap"] == 3 for c in pinned)
    assert any("/ov" in c["label"] for c in exchange_candidates(pencil2=True))


# ---- the stream schedule ------------------------------------------------------------------


def test_schedule_issues_each_chunk_exchange_ahead_of_the_compute_it_hides_behind():
    """The issue order of the stream schedule (ir.compile.schedule): each
    chunk's exchange as soon as its producer, so that the side stream holds
    chunk k's exchange while the compute stream runs chunk k+1's DFT stage;
    a graph without overlapped nodes keeps the topological order."""
    t = _small_dist(overlap=3)
    graphs = t._exec._ir.graphs
    back = [n.name for n in ir.compile.schedule(graphs["backward"])]
    zs = [back.index(f"z transform@{k}") for k in range(3)]
    xs = [back.index(f"exchange overlapped@{k}") for k in range(3)]
    assert zs[0] < xs[0] < zs[1] < xs[1] < zs[2] < xs[2] < back.index("unpack")
    fwd = [n.name for n in ir.compile.schedule(graphs["forward"][tp.ScalingType.NONE])]
    assert max(fwd.index(f"exchange overlapped@{k}") for k in range(3)) < fwd.index(
        "z transform@0")
    bulk = _small_dist(overlap=1)._exec._ir.graphs["backward"]
    assert ir.compile.schedule(bulk) == bulk.toposort()
    # a staged plan on the CPU runs the same order on one thread: bitwise
    staged = _small_dist(overlap=3, fuse=False)
    vals = [np.ones(n, np.complex64) for n in staged.params.num_values_per_shard]
    assert torch.equal(staged.backward(vals), t.backward(vals))


def test_overlapped_plans_batch_and_take_the_legacy_rung_alike():
    """A batch through an overlapped plan's batched program equals its single
    calls, and the legacy path (``ir_lower_failed``: the one-collective
    exchange's stage bodies in order, no graph) gives the overlapped plan's
    numbers, on both mesh kinds: bitwise on the pencil mesh, to the twin's
    bar on the slab mesh, whose z stage changes M (:func:`_twin`)."""
    trip = spfft_tpu.create_spherical_cutoff_triplets(8, 8, 8, 0.9)
    rng = np.random.default_rng(3)
    for mesh in (tp.make_fft_mesh(4, device="cpu"), tp.make_fft_mesh2(2, 2, device="cpu")):
        make = lambda: tp.DistributedTransform(
            tp.ProcessingUnit.HOST, 0, 8, 8, 8, np.asarray(trip).copy(), mesh=mesh,
            engine="mxu", exchange_type=tp.ExchangeType.BUFFERED, overlap=3)
        t = make()
        vals = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
                for n in t.params.num_values_per_shard]
        batch = [[v * (b + 1) for v in vals] for b in range(2)]
        singles = [t.backward(v) for v in batch]
        assert all(torch.equal(a, b) for a, b in zip(t.backward_batch(batch), singles))
        with tp.faults.inject("ir.lower=" + "rai" + "se"):
            leg = make()
        assert leg.describe()["ir"]["path"] == "legacy"
        assert [d["event"] for d in leg.report()["degradations"]] == ["ir_lower_failed"]
        pencil = mesh.shape is not None
        _twin(_roundtrip(leg, vals), _roundtrip(t, vals), bitwise=pencil)


def test_a_failed_wait_on_a_chunk_collective_is_an_mpi_error():
    """The asynchronous form keeps the MPIError wrapping on ``wait()``."""
    from spfft_tpu_torch.parallel import ragged

    class Broken:
        def wait(self):
            raise RuntimeError("NCCL communicator aborted")

    pending = ragged.Pending(torch.zeros(6), 3, torch.float64, [Broken()])
    with pytest.raises(tp.MPIError, match="aborted"):
        ragged.received(pending)
    done = ragged.Pending(torch.arange(6.0, dtype=torch.float32), 3, torch.float64, [])
    assert ragged.received(done).dtype == torch.float64 and ragged.received(done).shape == (2, 3)


@pytest.mark.parametrize("wire", ["BUFFERED", "BUFFERED_FLOAT", "BUFFERED_BF16"])
@pytest.mark.parametrize("mesh_kind", ["slab", "pencil"])
def test_every_padded_wire_chunks_on_both_engines(mesh_kind, wire):
    """Every padded wire format chunks, slab (min(C, S_max)) and pencil
    (min(C, Lz)) on both engines, and gives its overlap=1 twin's numbers:
    bitwise but on the slab ``mxu`` engine, whose CPU z stage rounds by M
    (there within the wire's bar: 1e-12, or the bfloat16 wire's 3e-2)."""
    trip = spfft_tpu.create_spherical_cutoff_triplets(8, 9, 10, 0.9)
    rng = np.random.default_rng(5)
    for engine in ("xla", "mxu"):
        mesh = (tp.make_fft_mesh(4, device="cpu") if mesh_kind == "slab"
                else tp.make_fft_mesh2(2, 2, device="cpu"))
        make = lambda ov: tp.DistributedTransform(
            tp.ProcessingUnit.HOST, 0, 8, 9, 10, np.asarray(trip).copy(), mesh=mesh,
            engine=engine, dtype=np.float64, exchange_type=tp.ExchangeType[wire], overlap=ov)
        bulk = make(1)
        extent = bulk.params.max_num_sticks if mesh_kind == "slab" else bulk._exec._Lz
        vals = [rng.standard_normal(n) + 1j * rng.standard_normal(n)
                for n in bulk.params.num_values_per_shard]
        ref = _roundtrip(bulk, vals)
        for ov in (2, 3, 50):
            t = make(ov)
            assert t.overlap_chunks == min(ov, extent)
            got = _roundtrip(t, vals)
            if engine == "mxu" and mesh_kind == "slab":
                bar = 3e-2 if wire.endswith("BF16") else 1e-12
                for g, r in zip(got, ref):
                    assert np.abs(g - r).max() <= bar * np.abs(r).max()
            else:
                _twin(got, ref, bitwise=True)
