"""spfft_tpu_torch.multi_transform against spfft_tpu.multi_transform (engine="xla").

The local cases of tests/test_multi_transform.py: the same transforms in both
packages, the same values from a seed, and each batch entry equal to the JAX
package's (1e-12 relative, float64) and to its own single-transform result.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu_torch import multi_transform as mt

RTOL = 1e-12


def _make(dim, ttype=0, module=tp, sparsity=0.8, engine="xla"):
    trip = tp.create_spherical_cutoff_triplets(dim, dim, dim, sparsity,
                                               hermitian_symmetry=ttype == 1)
    return module.Transform(module.ProcessingUnit.HOST, ttype, dim, dim, dim, indices=trip,
                            dtype=np.float64, engine=engine)


def _rand_values(t, rng):
    n = t.num_local_elements
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _close(got, want, scale=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * (scale or np.abs(want).max())


@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_five_transform_roundtrip(engine):
    rng = np.random.default_rng(3)
    ts = [_make(8, engine=engine) for _ in range(5)]
    refs = [_make(8, module=spfft_tpu) for _ in range(5)]
    values = [_rand_values(t, rng) for t in ts]
    spaces = tp.multi_transform_backward(ts, values)
    want = spfft_tpu.multi_transform_backward(refs, values)
    results = tp.multi_transform_forward(ts, None, tp.ScalingType.FULL)
    for t, v, s, w, r in zip(ts, values, spaces, want, results):
        _close(s, w)
        _close(s, _make(8, engine=engine).backward(v))
        _close(r, v)


def test_mixed_dims_and_explicit_spaces():
    rng = np.random.default_rng(4)
    ts = [_make(d) for d in (4, 8, 12)]
    refs = [_make(d, module=spfft_tpu) for d in (4, 8, 12)]
    values = [_rand_values(t, rng) for t in ts]
    spaces = tp.multi_transform_backward(ts, values)
    ref_spaces = spfft_tpu.multi_transform_backward(refs, values)
    results = tp.multi_transform_forward(ts, [s.numpy() for s in spaces], tp.ScalingType.FULL)
    want = spfft_tpu.multi_transform_forward(refs, ref_spaces, spfft_tpu.ScalingType.FULL)
    for v, r, w in zip(values, results, want):
        _close(r, w)
        _close(r, v)


def test_mixed_c2c_r2c():
    rng = np.random.default_rng(5)
    tc, tr = _make(8, 0), _make(8, 1)
    rc, rr = _make(8, 0, module=spfft_tpu), _make(8, 1, module=spfft_tpu)
    vc = _rand_values(tc, rng)
    # hermitian-consistent R2C values: the forward transform of a real field
    vr = tr.forward(rng.standard_normal((8, 8, 8)), tp.ScalingType.NONE).numpy()
    spaces = tp.multi_transform_backward([tc, tr], [vc, vr])
    want = spfft_tpu.multi_transform_backward([rc, rr], [vc, vr])
    assert spaces[0].is_complex() and not spaces[1].is_complex()
    for s, w in zip(spaces, want):
        _close(s, w)
    results = tp.multi_transform_forward([tc, tr], None, tp.ScalingType.FULL)
    _close(results[0], vc)
    _close(results[1], vr)


def test_per_transform_scaling():
    rng = np.random.default_rng(6)
    ts = [_make(8), _make(8)]
    values = [_rand_values(t, rng) for t in ts]
    tp.multi_transform_backward(ts, values)
    scaled, unscaled = tp.multi_transform_forward(ts, None, [tp.ScalingType.FULL,
                                                             tp.ScalingType.NONE])
    _close(scaled, values[0])
    _close(unscaled, np.asarray(values[1]) * 8**3)


def test_duplicate_transform_rejected():
    t = _make(4)
    v = _rand_values(t, np.random.default_rng(8))
    with pytest.raises(tp.InvalidParameterError):
        tp.multi_transform_backward([t, t], [v, v])


def test_length_mismatch_rejected():
    t = _make(4)
    with pytest.raises(tp.InvalidParameterError):
        tp.multi_transform_backward([t], [])
    with pytest.raises(tp.InvalidParameterError):
        tp.multi_transform_forward([t], None, [tp.ScalingType.FULL, tp.ScalingType.NONE])
    with pytest.raises(tp.InvalidParameterError):
        mt.dispatch_forward([t], [None], [])
    with pytest.raises(tp.InvalidParameterError):
        tp.multi_transform_forward([t], None, "full")


@pytest.mark.parametrize("case", range(4))
def test_out_of_order_finalize(case):
    """Pending split-phase results finalize in any order with the same results."""
    rng = np.random.default_rng(case)
    dims = [int(d) for d in rng.choice([4, 6, 8], size=4)]
    ts = [_make(d) for d in dims]
    vals = [_rand_values(t, rng) for t in ts]
    expect = [t.clone().backward(v) for t, v in zip(ts, vals)]
    pending = mt.dispatch_backward(ts, vals)
    got = {int(i): ts[i]._finalize_backward(pending[i]) for i in rng.permutation(len(ts))}
    for i, want in enumerate(expect):
        assert torch.equal(got[i], want)


def test_split_phase_api_matches_one_shot():
    """The public dispatch_*/finalize_* halves give what the one-shot
    functions give, and what the JAX package's halves give."""
    rng = np.random.default_rng(9)
    ts = [_make(4), _make(6)]
    refs = [_make(4, module=spfft_tpu), _make(6, module=spfft_tpu)]
    vals = [_rand_values(t, rng) for t in ts]
    expect = tp.multi_transform_backward([t.clone() for t in ts], [v.copy() for v in vals])
    spaces = mt.finalize_backward(ts, mt.dispatch_backward(ts, vals))
    from spfft_tpu import multi_transform as jmt

    ref_spaces = jmt.finalize_backward(refs, jmt.dispatch_backward(refs, vals))
    for got, want, ref in zip(spaces, expect, ref_spaces):
        assert torch.equal(got, want)
        _close(got, ref)
    scalings = [tp.ScalingType.FULL] * len(ts)
    freqs = mt.finalize_forward(ts, mt.dispatch_forward(ts, [None] * len(ts), scalings))
    for got, want in zip(freqs, vals):
        _close(got, want)
