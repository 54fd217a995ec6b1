"""The port's timing tree (spfft_tpu_torch.timing) against the JAX package's
(spfft_tpu.timing).

The same sequence of calls, on the same triplets and values made from a seed
with numpy, goes through ``engine="xla"`` plans of both packages, local and on
a 4-shard CPU mesh (the JAX package's over the conftest's virtual CPU
devices), and must give the same tree: labels, nesting and counts. The
statistics of a tree fed the same timings (a fake clock in both modules) and
its JSON are equal exactly.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu import timing as jtiming
from spfft_tpu_torch import timing as ttiming

DIMS = (8, 8, 9)
CASES = [(r2c, shards) for shards in (1, 4) for r2c in (False, True)]


@pytest.fixture(autouse=True)
def _restore():
    yield
    for timing in (jtiming, ttiming):
        timing.disable()
        timing.clear()


def make_plan(pkg, r2c, shards, per, dtype=np.float64):
    """An ``engine="xla"`` plan of ``pkg`` over ``per`` (per-shard triplets)."""
    if shards == 1:
        return pkg.Transform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS, indices=per[0],
                             dtype=dtype, engine="xla")
    mesh = pkg.make_fft_mesh(shards) if pkg is spfft_tpu else pkg.make_fft_mesh(shards,
                                                                                 device="cpu")
    return pkg.DistributedTransform(pkg.ProcessingUnit.HOST, int(r2c), *DIMS,
                                    [np.array(t) for t in per], mesh=mesh, dtype=dtype,
                                    engine="xla", exchange_type=pkg.ExchangeType.BUFFERED)


def problem(r2c, shards, seed=3):
    rng = np.random.default_rng(seed)
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8, hermitian_symmetry=r2c)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, shards, DIMS[1])]
    vals = [rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)) for t in per]
    space = rng.standard_normal(DIMS[::-1])
    if not r2c:
        space = space + 1j * rng.standard_normal(DIMS[::-1])
    return per, (vals[0] if shards == 1 else vals), space


def drive(pkg, t, vals, space):
    """The call sequence: backward, forward of the retained space and of a
    host array, a multi-transform batch, a batch of two of each direction."""
    t.backward(vals)
    t.forward(scaling=pkg.ScalingType.FULL)
    t.forward(space, pkg.ScalingType.NONE)
    pkg.multi_transform_backward([t], [vals])
    pkg.multi_transform_forward([t], None, pkg.ScalingType.FULL)
    t.backward_batch([vals, vals])
    t.forward_batch([space, space])


def shape(result):
    """(label, count, children) of every node below ``result``."""
    return [(s.label, s.count, shape(s)) for s in result.sub]


@pytest.mark.parametrize("r2c,shards", CASES)
def test_same_calls_give_the_same_tree(r2c, shards):
    per, vals, space = problem(r2c, shards)
    trees = []
    for pkg, timing in ((spfft_tpu, jtiming), (tp, ttiming)):
        timing.clear()
        timing.enable()
        drive(pkg, make_plan(pkg, r2c, shards, per), vals, space)
        trees.append(shape(timing.process()))
        timing.disable()
    assert trees[0] == trees[1]
    labels = {n[0] for n in trees[1]}
    assert {"backward", "forward", "multi backward", "multi forward"} <= labels
    assert ("Execution init" in labels) == (shards == 1)


def test_statistics_and_json_equal_on_the_same_timings(monkeypatch):
    """Fed the same clock, both trees report the same statistics and JSON."""
    ticks = [0.0, 0.5, 0.75, 2.0, 2.0, 2.25, 2.5, 4.0, 4.5, 4.875, 5.0, 5.5, 6.0, 6.125]
    results = []
    for timing in (jtiming, ttiming):
        clock = iter(ticks)
        monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
        timer = timing.Timer()
        for _ in range(2):
            timer.start("outer")
            timer.start("inner")
            timer.stop("inner")
            timer.start("other")
            timer.stop("other")
            timer.stop("outer")
        timer.start("last")
        timer.stop("last")
        results.append(timer.process())
    assert results[0].to_dict() == results[1].to_dict()
    assert results[0].json() == results[1].json()
    assert str(results[0]) == str(results[1])
    assert results[1].find("inner").count == 2


def test_scope_misuse_raises_typed():
    timer = ttiming.Timer()
    with pytest.raises(tp.InvalidParameterError):
        timer.stop("nothing open")
    timer.start("a")
    with pytest.raises(tp.InvalidParameterError):
        timer.stop("b")


def test_disabled_scope_is_one_shared_object():
    ttiming.disable()
    assert ttiming.scoped("backward") is ttiming.scoped("dispatch")
    with ttiming.scoped("backward"):
        pass
    assert ttiming.process().sub == []


def test_start_stop_stay_balanced_across_a_toggle():
    ttiming.start("a")  # disabled: nothing opens
    ttiming.enable()
    ttiming.stop("a")   # no scope to close: the tree stays empty
    ttiming.start("b")
    ttiming.stop("b")
    assert [s.label for s in ttiming.process().sub] == ["b"]


def test_trace_annotation_is_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttiming.trace_annotation("z transform"):
            torch.ones(4).sum()
    assert "z transform" in {e.name for e in prof.events()}


def test_trace_annotation_without_a_profiler_is_the_shared_no_op():
    ttiming.disable()
    assert ttiming.trace_annotation("z transform") is ttiming.trace_annotation("exchange")
    assert ttiming.trace_annotation("z transform") is ttiming.scoped("backward")
