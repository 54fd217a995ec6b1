"""The sparse-y y plans (per-slot, blocked) of spfft_tpu_torch against the JAX
package: the planners line for line against ``spfft_tpu.ops.fft``, the knobs
against ``spfft_tpu.knobs``, the two new stage contractions against
``torch.einsum``, and ``Transform`` in every y plan against
``spfft_tpu.Transform(engine="xla")``.

Tolerance of the end-to-end parity: max abs diff <= 1e-10 * max|ref| in
float64 and 2e-5 * max|ref| in float32, the bars of test_torch_transform.py
(the port's matrix-product DFT and pocketfft sum in different orders).
"""
import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import knobs as jknobs
from spfft_tpu.ops import fft as jfft
import spfft_tpu_torch as tp
from spfft_tpu_torch import knobs as tknobs
from spfft_tpu_torch.ops import fft as tfft
from spfft_tpu_torch.parameters import make_local_parameters
from utils import center_triplets, random_sparse_triplets, storage

RTOL = {np.float64: 1e-10, np.float32: 2e-5}
KNOBS = ("SPFFT_TPU_SPARSE_Y", "SPFFT_TPU_SPARSE_Y_BLOCKS", "SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC",
         "SPFFT_TPU_XPAD")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _set(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(f"SPFFT_TPU_{k.upper()}", str(v))


def _layout(kind, seed):
    """(stick x, stick y, dims) of a random or a spherical layout."""
    if kind == "sphere":
        dims = (16, 24, 8)
        trip = tp.create_spherical_cutoff_triplets(*dims, 0.6)
    elif kind == "small-sphere":
        dims = (16, 24, 8)
        trip = tp.create_spherical_cutoff_triplets(*dims, 0.3)
    else:
        dims = (20, 16, 6)
        trip = random_sparse_triplets(np.random.default_rng(seed), *dims, stick_fraction=0.3,
                                      centered=True)
    p = make_local_parameters(tp.TransformType.C2C, *dims, np.asarray(trip))
    return np.asarray(p.stick_x, np.int64), np.asarray(p.stick_y, np.int64), p


def _slots(sx):
    ux = np.unique(sx)
    return ux, np.searchsorted(ux, sx)


def _same_pairs(a, b):
    for pa, pb in zip(a, b):
        assert pa.shape == pb.shape and pa.dtype == pb.dtype
        np.testing.assert_array_equal(pa, pb)


LAYOUTS = [("sphere", 0), ("small-sphere", 0), ("random", 1), ("random", 2)]


@pytest.mark.parametrize("layout,seed", LAYOUTS)
@pytest.mark.parametrize("mode", ["auto", "0", "1"])
@pytest.mark.parametrize("xpad", [None, 4])
def test_plan_sparse_y_matches_jax(layout, seed, mode, xpad, monkeypatch):
    _set(monkeypatch, sparse_y=mode)
    if xpad:
        _set(monkeypatch, xpad=xpad)
    sx, sy, p = _layout(layout, seed)
    ux, xslot = _slots(sx)
    A = tfft.compact_x_extent(ux.size, p.dim_x_freq)
    assert A == jfft.compact_x_extent(ux.size, p.dim_x_freq)
    want = jfft.plan_sparse_y(xslot, sy, A, p.dim_y, np.float64)
    got = tfft.plan_sparse_y(xslot, sy, A, p.dim_y, np.float64)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        _same_pairs(got[2], want[2])
        _same_pairs(got[3], want[3])


@pytest.mark.parametrize("layout,seed", LAYOUTS)
@pytest.mark.parametrize("blocks", ["auto", "0", "1", "2", "3", "7"])
@pytest.mark.parametrize("dense_slots", [(), (0,)])
def test_plan_sparse_y_blocked_matches_jax(layout, seed, blocks, dense_slots, monkeypatch):
    _set(monkeypatch, sparse_y_blocks=blocks)
    sx, sy, p = _layout(layout, seed)
    ux, xslot = _slots(sx)
    A = tfft.compact_x_extent(ux.size, p.dim_x_freq)
    args = (xslot, sy, p.dim_y, np.float32, p.num_sticks, A * p.dim_y)
    want = jfft.plan_sparse_y_blocked(*args, dense_slots=dense_slots)
    got = tfft.plan_sparse_y_blocked(*args, dense_slots=dense_slots)
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got["slot_perm"], want["slot_perm"])
    np.testing.assert_array_equal(got["row_of_stick"], want["row_of_stick"])
    assert got["row_of_stick"].dtype == want["row_of_stick"].dtype
    assert got["dense_flat"] == want["dense_flat"]
    assert len(got["buckets"]) == len(want["buckets"])
    for (gi, gb, gf), (wi, wb, wf) in zip(got["buckets"], want["buckets"]):
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        _same_pairs(gb, wb)
        _same_pairs(gf, wf)


@pytest.mark.parametrize("frac", ["0.3", "0.8", "1.5"])
def test_blocked_engagement_follows_the_fraction(frac, monkeypatch):
    _set(monkeypatch, sparse_y_blocked_frac=frac)
    sx, sy, p = _layout("sphere", 0)
    ux, xslot = _slots(sx)
    A = tfft.compact_x_extent(ux.size, p.dim_x_freq)
    args = (xslot, sy, p.dim_y, np.float32, p.num_sticks, A * p.dim_y)
    assert (tfft.plan_sparse_y_blocked(*args) is None) == (jfft.plan_sparse_y_blocked(*args) is None)
    assert tfft.sparse_y_blocked_frac() == jfft.sparse_y_blocked_frac() == float(frac)


@pytest.mark.parametrize("name,value", [
    ("SPFFT_TPU_SPARSE_Y", "2"), ("SPFFT_TPU_SPARSE_Y", "on"),
    ("SPFFT_TPU_SPARSE_Y_BLOCKS", "-1"), ("SPFFT_TPU_SPARSE_Y_BLOCKS", "four"),
    ("SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC", "most"), ("SPFFT_TPU_XPAD", "eight"),
])
def test_bad_knob_values_raise_in_both_packages(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    with pytest.raises(tp.InvalidParameterError):
        tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 8, 8, 8, indices=trip,
                     engine="mxu")
    sx, sy, p = _layout("sphere", 0)
    ux, xslot = _slots(sx)
    with pytest.raises(spfft_tpu.InvalidParameterError):
        if name == "SPFFT_TPU_SPARSE_Y_BLOCKS":
            jfft.plan_sparse_y_blocked(xslot, sy, p.dim_y, np.float32, p.num_sticks, 1)
        else:
            _jax_knob(name)


def _jax_knob(name):
    getter = {"SPFFT_TPU_SPARSE_Y": jknobs.get_str, "SPFFT_TPU_SPARSE_Y_BLOCKED_FRAC":
              jknobs.get_float, "SPFFT_TPU_XPAD": jknobs.get_int}[name]
    return getter(name)


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("value", [None, "", "0", "1", "3", "0.5"])
def test_knob_values_read_as_in_jax(name, value, monkeypatch):
    if value is not None:
        monkeypatch.setenv(name, value)
    kind = tknobs.REGISTRY[name].kind
    getters = {"str": (tknobs.get_str, jknobs.get_str), "int": (tknobs.get_int, jknobs.get_int),
               "float": (tknobs.get_float, jknobs.get_float)}[kind]
    results = []
    for get in getters:
        try:
            results.append(get(name))
        except (tp.InvalidParameterError, spfft_tpu.InvalidParameterError):
            results.append("raises")
    assert results[0] == results[1]


def _describe_jax(sx, sy, p, r2c):
    """The JAX engine's sparse-y decision, from its planners, as its
    describe() reports it."""
    ux, xslot = _slots(sx)
    A = jfft.compact_x_extent(ux.size, p.dim_x_freq)
    per_slot = None if r2c else jfft.plan_sparse_y(xslot, sy, A, p.dim_y, np.float32)
    blk = None
    if per_slot is None:
        dense = (0,) if r2c and int(ux[0]) == 0 else ()
        blk = jfft.plan_sparse_y_blocked(xslot, sy, p.dim_y, np.float32, p.num_sticks,
                                         A * p.dim_y, dense_slots=dense)
    return jfft.describe_sparse_y(per_slot is not None, None if blk is None else blk["buckets"],
                                  per_slot[0] if per_slot else 0)


@pytest.mark.parametrize("radius,r2c,env", [
    (0.3, False, {}), (0.6, False, {}), (0.6, True, {}), (0.6, False, {"sparse_y_blocks": "0"}),
    (0.6, True, {"sparse_y_blocks": "2"}), (0.6, False, {"sparse_y_blocked_frac": "0.5"}),
])
def test_describe_sparse_y_matches_jax(radius, r2c, env, monkeypatch):
    _set(monkeypatch, **env)
    dims = (16, 24, 8)
    trip = tp.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=r2c)
    t = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, dtype=np.float32,
                     engine="mxu")
    p = t.params
    card = t.describe()
    assert card["sparse_y"] == _describe_jax(np.asarray(p.stick_x, np.int64),
                                             np.asarray(p.stick_y, np.int64), p, r2c)
    assert card["matmul_precision"] == "HIGHEST" and card["num_x_active"] == t.num_x_active
    assert card["dim_x_freq"] == p.dim_x_freq


# ---- the two new stage contractions --------------------------------------------


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape))


def test_slots_out_writes_grid_columns_through_out():
    rng = np.random.default_rng(5)
    ag, syg, Y, Z, A, col = 3, 5, 7, 4, 8, 2
    xr, xi, wr, wi = (_rand(rng, ag, syg, Z), _rand(rng, ag, syg, Z), _rand(rng, ag, syg, Y),
                      _rand(rng, ag, syg, Y))
    gre, gim = _rand(rng, Y, A, Z), _rand(rng, Y, A, Z)
    before = (gre.clone(), gim.clone())
    out = (gre[:, col:col + ag], gim[:, col:col + ag])
    yr, yi = tfft.complex_matmul(xr, xi, wr, wi, "ajz,ajk->kaz", out=out)
    assert yr.data_ptr() == out[0].data_ptr()
    want = torch.einsum("ajz,ajk->kaz", torch.complex(xr, xi), torch.complex(wr, wi))
    torch.testing.assert_close(torch.complex(gre[:, col:col + ag], gim[:, col:col + ag]), want,
                               rtol=1e-12, atol=1e-12)
    rest = torch.ones(A, dtype=torch.bool)
    rest[col:col + ag] = False
    assert torch.equal(gre[:, rest], before[0][:, rest]) and torch.equal(gim[:, rest], before[1][:, rest])
    # without out: a new (Y, ag, Z) result
    nr, ni = tfft.complex_matmul(xr, xi, wr, wi, "ajz,ajk->kaz")
    torch.testing.assert_close(torch.complex(nr, ni), want, rtol=1e-12, atol=1e-12)


def test_slots_in_reads_grid_columns_into_a_flat_slice():
    rng = np.random.default_rng(6)
    ag, syg, Y, Z, A, col = 2, 6, 9, 5, 7, 3
    gre, gim = _rand(rng, Y, A, Z), _rand(rng, Y, A, Z)
    wr, wi = _rand(rng, ag, syg, Y), _rand(rng, ag, syg, Y)
    flat = (torch.zeros(20, Z, dtype=torch.float64), torch.zeros(20, Z, dtype=torch.float64))
    out = tuple(f[4:4 + ag * syg].view(ag, syg, Z) for f in flat)
    tfft.complex_matmul(gre[:, col:col + ag], gim[:, col:col + ag], wr, wi, "yaz,ajy->ajz", out=out)
    want = torch.einsum("yaz,ajy->ajz", torch.complex(gre[:, col:col + ag], gim[:, col:col + ag]),
                        torch.complex(wr, wi))
    got = torch.complex(flat[0], flat[1])
    torch.testing.assert_close(got[4:4 + ag * syg].view(ag, syg, Z), want, rtol=1e-12, atol=1e-12)
    assert not got[:4].any() and not got[4 + ag * syg:].any()


@pytest.mark.parametrize("spec,xshape,wshape", [
    ("ajz,ajk->kaz", (3, 5, 4), (3, 5, 7)), ("yaz,ajy->ajz", (7, 3, 4), (3, 5, 7)),
])
@pytest.mark.parametrize("form", ["complex", "real_out"])
def test_new_specs_match_einsum(spec, xshape, wshape, form):
    rng = np.random.default_rng(len(spec) + sum(xshape))
    x = rng.standard_normal(xshape) + 1j * rng.standard_normal(xshape)
    w = rng.standard_normal(wshape) + 1j * rng.standard_normal(wshape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    want = np.einsum(spec, x, w)
    if form == "real_out":
        got = tfft.real_out_matmul(t(x.real), t(x.imag), t(w.real), t(w.imag), spec).numpy()
        want = want.real
    else:
        yr, yi = tfft.complex_matmul(t(x.real), t(x.imag), t(w.real), t(w.imag), spec)
        got = yr.numpy() + 1j * yi.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_out_of_the_wrong_shape_raises():
    x = torch.zeros(3, 5, 4, dtype=torch.float64)
    w = torch.zeros(3, 5, 7, dtype=torch.float64)
    with pytest.raises(tp.InvalidParameterError):
        tfft.complex_matmul(x, x, w, w, "ajz,ajk->kaz", out=(torch.zeros(7, 3, 5), torch.zeros(7, 3, 5)))


# ---- Transform in every y plan against the JAX package's xla engine -----------


def _values(rng, trip, dims, r2c):
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    return spec[storage(t[:, 2], dz), storage(t[:, 1], dy), t[:, 0]]


def _columns(rng, dims, xs, counts, r2c):
    """Whole z-sticks at ``counts[i]`` random y of each x in ``xs``, centred:
    a layout with fewer x rows than the padded active extent."""
    dx, dy, dz = dims
    trip = [(x, y, z) for x, n in zip(xs, counts) for y in rng.choice(dy, size=n, replace=False)
            for z in range(dz)]
    return center_triplets(np.asarray(trip, np.int64), dx, dy, dz, hermitian=r2c)


# 11 x rows of at most 6 sticks (A = 16 of 24: per-slot, 5 padding slots);
# 13 x rows of up to 15 sticks (A = 16 of 24); R2C: 9 of 13 (A = 13)
PADDED_C2C_SLOT = (list(range(0, 22, 2)), [1, 2, 3, 4, 5, 6] * 2)
PADDED_C2C = (list(range(13)), list(range(1, 16))[:13])
PADDED_R2C = ([0, 1, 2, 4, 5, 7, 8, 10, 11], list(range(2, 11)))

# (name, dims, radius or (xs, counts), r2c, env, plan, number of buckets or None)
PLANS = [
    ("per-slot", (16, 24, 8), 0.3, False, {}, "per-slot", None),
    ("per-slot padded", (24, 24, 6), PADDED_C2C_SLOT, False, {}, "per-slot", None),
    ("blocked G=1", (16, 24, 8), 0.6, False, {"sparse_y_blocks": "1"}, "blocked", 1),
    ("blocked G=2", (16, 24, 8), 0.6, False, {"sparse_y_blocks": "2"}, "blocked", 2),
    ("blocked G=3 padded", (24, 16, 6), PADDED_C2C, False,
     {"sparse_y_blocks": "3", "sparse_y": "0"}, "blocked", 3),
    ("blocked auto", (16, 24, 8), 0.6, False, {}, "blocked", 4),
    ("r2c blocked G=1", (16, 24, 8), 0.6, True, {"sparse_y_blocks": "1"}, "blocked", 2),
    ("r2c blocked G=2", (16, 24, 8), 0.6, True, {"sparse_y_blocks": "2"}, "blocked", 3),
    ("r2c blocked G=3 padded", (24, 16, 6), PADDED_R2C, True, {"sparse_y_blocks": "3"},
     "blocked", 4),
    ("dense", (16, 24, 8), 0.6, False, {"sparse_y_blocks": "0"}, "dense", None),
    ("r2c dense", (16, 24, 8), 0.6, True, {"sparse_y_blocks": "0"}, "dense", None),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,dims,radius,r2c,env,plan,buckets", PLANS, ids=[p[0] for p in PLANS])
def test_transform_parity_in_every_y_plan(name, dims, radius, r2c, env, plan, buckets, dtype,
                                          monkeypatch):
    _set(monkeypatch, **env)
    rng = np.random.default_rng(len(name))
    if isinstance(radius, tuple):
        trip = _columns(rng, dims, *radius, r2c)
        trip = trip[rng.permutation(len(trip))]
    else:
        trip = tp.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=r2c)
    values = _values(rng, trip, dims, r2c)
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, dtype=dtype,
                        engine="mxu")
    ex = port._exec
    assert ex.y_plan == plan
    if buckets is not None:
        assert len(ex.buckets) == buckets
    if "padded" in name:  # slots past the active x rows: no bucket or stick writes them
        assert len(np.unique(port.params.stick_x)) < port.num_x_active
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                              dtype=dtype, engine="xla")
    bar = RTOL[dtype]
    space, space_ref = port.backward(values).numpy(), np.asarray(ref.backward(values))
    assert np.abs(space - space_ref).max() <= bar * np.abs(space_ref).max()
    for scaling in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        got = port.forward(scaling=scaling).numpy()
        want = np.asarray(ref.forward(scaling=spfft_tpu.ScalingType(int(scaling))))
        assert np.abs(got - want).max() <= bar * np.abs(want).max()
    # a second backward starts from a zeroed table and grid
    again = port.backward(values).numpy()
    assert np.abs(again - space_ref).max() <= bar * np.abs(space_ref).max()
