"""Batch fusion (SPFFT_TPU_BATCH_FUSE): B requests of one plan as one program.

The batched results must equal the per-request loop bitwise (the same
bodies run per request) and the JAX package's ``backward_batch`` /
``forward_batch`` on its xla engine within the dtype's bar (1e-12 relative
in float64, 2e-5 in float32). The IR's dispatch counter shows one batched
dispatch per batch and direction.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
import spfft_tpu_torch.ir as tir

RTOL = {np.float64: 1e-12, np.float32: 2e-5}
DIMS = (12, 10, 8)


def _plan(engine, r2c, dtype=np.float64, fuse=None, module=tp):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.7, hermitian_symmetry=r2c)
    return module.Transform(module.ProcessingUnit.HOST, int(r2c), *DIMS, indices=trip,
                            dtype=dtype, engine=engine, fuse=fuse), trip


def _batch(rng, trip, r2c, b):
    if not r2c:
        return [rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
                for _ in range(b)]
    dx, dy, dz = DIMS
    t = np.asarray(trip)
    st = lambda i, d: np.where(i < 0, i + d, i)
    out = []
    for _ in range(b):
        spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
        out.append(spec[st(t[:, 2], dz), st(t[:, 1], dy), t[:, 0]])
    return out


def _close(got, ref, dtype):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("engine", ["xla", "mxu"])
@pytest.mark.parametrize("r2c", [False, True])
def test_batch_equals_loop_and_jax(r2c, engine, dtype):
    t, trip = _plan(engine, r2c, dtype)
    loop, _ = _plan(engine, r2c, dtype)
    values = _batch(np.random.default_rng(int(r2c)), trip, r2c, 3)
    tir.dispatches.clear()
    spaces = t.backward_batch(values)
    assert dict(tir.dispatches) == {("batched", "backward"): 1}
    assert t._space_data is None  # the batched program leaves the retained space alone
    want = [loop.backward(v) for v in values]
    assert all(torch.equal(s, w) for s, w in zip(spaces, want))

    tir.dispatches.clear()
    freqs = t.forward_batch(spaces, tp.ScalingType.FULL)
    assert dict(tir.dispatches) == {("batched", "forward"): 1}
    assert all(torch.equal(f, loop.forward(s, tp.ScalingType.FULL)) for f, s in zip(freqs, spaces))

    ref, _ = _plan("xla", r2c, dtype, module=spfft_tpu)
    ref_spaces = ref.backward_batch(values)
    for s, r in zip(spaces, ref_spaces):
        _close(s, r, dtype)
    for f, r in zip(freqs, ref.forward_batch(ref_spaces, spfft_tpu.ScalingType.FULL)):
        _close(f, r, dtype)


def test_count_marks_a_padding_tail():
    t, trip = _plan("xla", False)
    values = _batch(np.random.default_rng(4), trip, False, 4)
    got = t.backward_batch(values, count=2)
    assert len(got) == 2
    assert all(torch.equal(g, t.clone().backward(v)) for g, v in zip(got, values[:2]))
    freqs = t.forward_batch(got + got, count=1)
    assert len(freqs) == 1
    assert t.backward_batch([]) == [] and t.forward_batch([]) == []


@pytest.mark.parametrize("count", [0, 5, -1])
def test_invalid_count_raises(count):
    t, trip = _plan("xla", False)
    values = _batch(np.random.default_rng(5), trip, False, 4)
    with pytest.raises(tp.InvalidParameterError):
        t.backward_batch(values, count=count)
    with pytest.raises(tp.InvalidParameterError):
        t.forward_batch([np.zeros((8, 10, 12))] * 4, count=count)


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_knob_off_loops(engine, monkeypatch):
    t, trip = _plan(engine, False)
    values = _batch(np.random.default_rng(6), trip, False, 2)
    want = t.clone().backward_batch(values)
    monkeypatch.setenv("SPFFT_TPU_BATCH_FUSE", "0")
    assert not t._exec._ir.batch_available()
    tir.dispatches.clear()
    got = t.backward_batch(values)
    assert dict(tir.dispatches) == {("fused", "backward"): 2}
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert t.backward_batch(values, fallback=False) is None
    assert t.forward_batch(got, fallback=False) is None


def test_bad_knob_raises(monkeypatch):
    t, trip = _plan("xla", False)
    monkeypatch.setenv("SPFFT_TPU_BATCH_FUSE", "2")
    with pytest.raises(tp.InvalidParameterError):
        t.backward_batch(_batch(np.random.default_rng(7), trip, False, 2))


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_staged_plans_have_no_batch_axis(engine):
    t, trip = _plan(engine, True, fuse=False)
    assert not t._exec._ir.batch_available()
    values = _batch(np.random.default_rng(8), trip, True, 2)
    assert t.backward_batch(values, fallback=False) is None
    tir.dispatches.clear()
    got = t.backward_batch(values)
    assert set(tir.dispatches) == {("staged", "backward")}
    fused, _ = _plan(engine, True)
    assert all(torch.equal(g, w) for g, w in zip(got, fused.backward_batch(values)))
