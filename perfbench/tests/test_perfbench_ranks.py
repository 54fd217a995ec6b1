"""The rank path (:mod:`perfbench.ranks`, :mod:`perfbench.shards`) on the CPU:
2- and 4-rank gloo worlds run a cell over ranks through ``ranks.execute`` at
12×16×10, each spawn on its own free port and with its own deadline (the
launcher's, which stops every worker). A sound run is correct; a rank that
drops a band's result leaves it missing; a rank that alters one value of its
share by a thousandth is not correct; what rank 0 assembles equals a
one-process ``DistributedTransform`` of the same shards bitwise. Then the
exchange's byte count against a count by brute force, and the exchange's
readers on traces with and without NCCL's kernels.
"""
import copy
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spfft_tpu_torch as sp
from perfbench import inputs, ranks, shards, spec, trace

BENCH = spec.load_benchmark()
CELL = "c2c-256-s15-slab4.bands-ahead"
BANDS = 6
SEED = 2**31 + 17
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def small_cell(world):
    cell = copy.deepcopy(spec.cell(CELL, BENCH))
    cell.config.update(grid=[12, 16, 10], bands=BANDS, ranks=world)
    cell.traffic["profile_pairs"] = 4
    return cell


def run(world, hook=None, keep=None):
    return ranks.execute(small_cell(world), SEED, 0.2, False, "cpu", hook=hook, keep=keep)


def drop_a_band(rank):
    """Rank 1's forward of band 1 hands back no result, every sweep."""
    if rank != 1:
        return
    real, calls = sp.DistributedTransform.forward_pair, [0]

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        out = real(self, scaling)
        calls[0] += 1
        return None if calls[0] % BANDS == 2 else out
    sp.DistributedTransform.forward_pair = forward_pair


def alter_a_value(rank):
    """Rank 1's first value of each forward off by a thousandth of the largest."""
    if rank != 1:
        return
    real = sp.DistributedTransform.forward_pair

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        re, im = real(self, scaling)
        re = re.clone()
        re.view(-1)[0] += 1e-3 * float(re.abs().max())
        return re, im
    sp.DistributedTransform.forward_pair = forward_pair


@pytest.mark.parametrize("world", [2, 4])
def test_a_sound_run_over_ranks_is_correct(world):
    out = run(world)
    assert out["correct"] and out["failed"] == 0, out["check"]
    assert out["device"]["count"] == world and len(out["ranks"]["window_s"]) == world
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"} and list(out)[-1] == "check"
    # the rate is over the longest rank's window
    rate = out["attempted"] / max(out["ranks"]["window_s"])
    assert out["metrics"]["pairs_per_s"]["value"] <= rate * (1 + 1e-9)


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_that_drops_a_band_s_result_leaves_it_missing(world):
    out = run(world, drop_a_band)
    assert out["check"]["missing"]["value"] == 1 and not out["correct"]
    assert out["failed"] == 1


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_that_alters_one_value_of_its_share_is_not_correct(world):
    out = run(world, alter_a_value)
    assert not out["correct"] and out["check"]["missing"]["value"] == 0
    assert out["check"]["fwd_err"]["value"] > out["check"]["fwd_err"]["limit"]


@pytest.mark.parametrize("world", [2, 4])
def test_the_assembly_equals_one_process_bitwise(world):
    keep = []
    assert run(world, keep=keep)["correct"]
    got = keep[0]
    cfg = small_cell(world).config
    dims = inputs.dims(cfg)
    trip = inputs.triplets(cfg, "cpu")
    per_shard = sp.distribute_triplets(trip.numpy(), world, dims[1])
    plan = sp.DistributedTransform(sp.ProcessingUnit.HOST, sp.TransformType.C2C, *dims,
                                   indices=per_shard, mesh=sp.make_fft_mesh(world, device="cpu"),
                                   dtype=np.float32, precision=cfg["precision"])
    lengths = [plan.local_z_length(s) for s in range(world)]
    v_max, l_max = plan.params.max_num_values, max(lengths)
    rows = [shards.shard_rows(trip, torch.as_tensor(t), dims) for t in per_shard]
    values = inputs.band_values(cfg, trip, SEED, "cpu")
    stacked = torch.stack([shards.local_values(values, r, v_max) for r in rows], dim=2)
    pot = inputs.potential(cfg, plan.space_domain_layout, SEED, "cpu")
    pot = torch.cat([shards.local_potential(pot, plan.local_z_offset(s), lengths[s], l_max)
                     for s in range(world)], dim=2)
    sampled = inputs.sampled_bands(SEED, BANDS, cfg["check"]["sampled_spaces"])
    assert sorted(got["spaces"]) == sampled
    for b in range(BANDS):
        space = plan.backward_pair(stacked[b, 0], stacked[b, 1])
        for part in space:
            part.mul_(pot)
        re, im = plan.forward_pair(sp.ScalingType.FULL)
        want = torch.zeros((2, trip.shape[0]))
        for s, r in enumerate(rows):
            want[0, r], want[1, r] = re[s, :r.numel()], im[s, :r.numel()]
        assert np.array_equal(got["results"][b], want.numpy()), b
        if b in sampled:  # (planes, Y, X, Z) from the stacked (Y, X, P, L_max) slabs
            slabs = [torch.stack([p[:, :, s, :lengths[s]] for p in space]) for s in range(world)]
            assert np.array_equal(got["spaces"][b], torch.cat(slabs, dim=-1).numpy()), b


def test_shard_rows_and_local_share():
    cfg = small_cell(4).config
    dims = inputs.dims(cfg)
    trip = inputs.triplets(cfg, "cpu")
    per_shard = sp.distribute_triplets(trip.numpy(), 4, dims[1])
    rows = [shards.shard_rows(trip, torch.as_tensor(t), dims) for t in per_shard]
    assert sorted(torch.cat(rows).tolist()) == list(range(trip.shape[0]))
    for r, t in zip(rows, per_shard):
        assert torch.equal(trip[r], torch.as_tensor(t))
    values = inputs.band_values(cfg, trip, 5, "cpu")
    mine = shards.local_values(values, rows[3], 80)
    assert mine.shape == (BANDS, 2, 80) and torch.equal(mine[:, :, :rows[3].numel()],
                                                        values[:, :, rows[3]])
    assert not mine[:, :, rows[3].numel():].any()
    holder = next(s for s, r in enumerate(rows) if 0 in r.tolist())
    with pytest.raises(ValueError):  # the global triplets without the first
        shards.shard_rows(trip[1:], torch.as_tensor(per_shard[holder]), dims)


def brute_force_bytes(shard_trip, dims, length):
    sticks = {(int(x) % dims[0], int(y) % dims[1]) for x, y, _ in shard_trip}
    return sum(2 * 8 * (dims[2] - length) for _ in sticks)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("grid", [(12, 16, 10), (16, 16, 16)])
def test_the_exchange_byte_count_against_brute_force(grid, world):
    cfg = {"grid": list(grid), "transform": "c2c", "sphere_fraction": 0.15, "bands": 1}
    trip = inputs.triplets(cfg, "cpu")
    per_shard = sp.distribute_triplets(trip.numpy(), world, grid[1])
    params = sp.make_distributed_parameters(sp.TransformType.C2C, *grid, per_shard)
    for s in range(world):
        length = int(params.local_z_lengths[s])
        got = shards.exchange_bytes_per_pair(per_shard[s], grid, length)
        assert got == brute_force_bytes(per_shard[s], grid, length) > 0
        assert got == 2 * 8 * int(params.num_sticks_per_shard[s]) * (grid[2] - length)


def read(name, profile, nbytes=None):
    return spec.reader(name)(SimpleNamespace(profile=profile, window={}, exchange_bytes=nbytes))


@pytest.mark.parametrize("fixture", ["trace_c2c-256-s15_4pairs.json",
                                     "trace_c2c-256-s15_4pairs_spans.json"])
def test_no_exchange_kernel_reads_nothing_and_moves_nothing(fixture):
    events = json.loads((FIXTURES / fixture).read_text())["traceEvents"]
    profile = trace.Profile(events, 4, spec.kernel_families())
    assert profile.count("exchange") == 0
    assert read("exchange_ms_per_pair", profile, 1 << 20) is None
    assert read("exchange_roofline", profile, 1 << 20) is None
    # the one-card cells' plain tensor code is what it was without the family
    families = {k: v for k, v in spec.kernel_families().items() if k != "exchange"}
    before = trace.Profile(events, 4, families)
    assert read("torch_ops_ms_per_pair", profile) == read("torch_ops_ms_per_pair", before)


def test_the_exchange_readers_on_nccl_kernels():
    """A stretch of two pairs: two NCCL kernels of 40 µs and one K1 kernel."""
    def kernel(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH, "ts": 0.0,
               "dur": 1000.0},
              kernel("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 10.0, 40.0, 1),
              kernel("void (anonymous namespace)::tc::tc_kernel<Tf32x3, 4>(Args)", 60.0, 300.0, 2),
              kernel("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)", 400.0, 40.0, 3)]
    profile = trace.Profile(events, 2, spec.kernel_families())
    assert profile.count("exchange") == 2 and profile.count("k1") == 1
    assert read("exchange_ms_per_pair", profile) == pytest.approx(0.04)
    assert read("torch_ops_ms_per_pair", profile) is None  # NCCL's kernels are not plain code
    nbytes = 9_000_000  # 0.04 ms a pair at 450 GB/s moves 18 MB: half of it
    assert read("exchange_roofline", profile, nbytes) == pytest.approx(50.0)
    assert read("exchange_roofline", profile) is None  # no byte count: nothing to read


class Done:
    def wait(self):
        return True


@pytest.mark.parametrize("rank0_says", [None, "close"])
def test_the_window_closes_one_block_after_rank_0_s_forecast(monkeypatch, rank0_says):
    """Rank 0's verdict after a block says whether the next block is the last
    (at the window's mean block time, would it end at or past the window's
    length); every rank reads it after that next block. A rank whose own
    clock says otherwise follows rank 0's verdict, which the broadcast writes."""
    import torch.distributed as dist

    def broadcast(flag, src, group, async_op):
        assert src == 0 and group == "control" and async_op
        if rank0_says is not None:
            flag.fill_(1)
        return Done()
    monkeypatch.setattr(dist, "broadcast", broadcast)
    sweep = ranks.RankSweep.__new__(ranks.RankSweep)
    sweep.control, sweep.blocks, sweep.verdict = "control", 0, None
    for _ in range(2):  # two windows of one sweep: the second starts afresh
        closed = [sweep.over(0.25 * b, 1.0) for b in range(1, 5)]
        if rank0_says is None:  # block 3's forecast, 0.75 * 4 / 3, reaches 1.0: block 4 closes
            assert closed == [False, False, False, True]
        else:  # rank 0 says "the next is the last" after every block, whatever this rank's clock
            assert closed == [False, True, False, True]
        assert sweep.blocks == 0 and sweep.verdict is None
