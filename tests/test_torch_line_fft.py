"""The line FFT (``ops/line_fft.py``) on the CPU: its plain version against
the dense DFT matrices of ``ops/fft.py``, and the rule by which the local
engine runs its z and x stages on it.

The plain version repeats the kernel's radix passes and twiddle table in
torch ops (the card test, ``test_torch_line_fft_card.py``, holds the kernel
to it bitwise). Against the float64 matrices it must agree to 1e-6 of the
largest value: a float32 FFT's rounding grows with log2 N, about 1e-7 a
value at these lengths.

The engine: a float32 ``"highest"`` local plan at a grid whose Z and X are
powers of two in the kernel's range runs its z and x stages on the line FFT
in every y plan, and matches the JAX package (``engine="xla"``) at the bar
of ``test_torch_sparse_y.py``. Every plan outside the rule (``"high"``,
``"default"``, the bf16 twiddles, float64, a length out of range, the mesh
engines) never calls it and runs each of those stages as the same K1
product as before, bitwise.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu_torch as tp
from spfft_tpu_torch.obs import hlo
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as offt
from spfft_tpu_torch.ops import line_fft as lf
from test_torch_distributed import port_plan as slab_plan
from test_torch_distributed import problem
from test_torch_pencil2 import port_plan as pencil_plan
from utils import storage

LENGTHS = [64, 128, 256, 512, 1024]
RTOL = 1e-6
PAIR_RTOL = 2e-5  # test_torch_sparse_y.py's float32 bar against the JAX package
KNOBS = ("SPFFT_TPU_SPARSE_Y", "SPFFT_TPU_SPARSE_Y_BLOCKS", "SPFFT_TPU_TWIDDLE_BF16")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _c(pair):
    return pair[0].numpy().astype(np.float64) + 1j * pair[1].numpy().astype(np.float64)


def _slots(rng, n, r2c, pad):
    """A bucket-major slot order: the x of a sphere (the half spectrum's for
    R2C) shuffled, then ``pad`` padding slots."""
    xs = np.arange(n // 2 - 3) if r2c else (np.arange(-(n // 4), n // 4 + 1) % n)
    return rng.permutation(xs), xs.size + pad


# ---- the op against ops/fft.py's matrices ------------------------------------------------


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("direction", ["backward", "forward FULL", "forward NONE"])
def test_rows_match_the_c2c_matrix(n, direction):
    rng = np.random.default_rng(n)
    sign = 1 if direction == "backward" else -1
    total = n * 6 * 5  # Nx Ny Nz of a plan with Z = n
    scale = 1.0 / total if direction == "forward FULL" else 1.0
    wide = torch.from_numpy(rng.standard_normal((2, 11, n + 5)).astype(np.float32))
    xr, xi = wide[0, :, 2:2 + n], wide[1, :, 2:2 + n]  # rows n + 5 apart, as a table's window
    got = lf.rows(xr, xi, lf.Lines(n, "cpu"), sign, scale)
    want = _c((xr, xi)) @ offt.c2c_matrix(n, sign, scale=scale)
    assert got[0].is_contiguous() and _rel(_c(got), want) <= RTOL


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
def test_x_stages_match_the_x_stage_matrices(n, r2c):
    rng = np.random.default_rng(n + r2c)
    ux, A = _slots(rng, n, r2c, pad=5)
    lines = lf.Lines(n, "cpu", ux, A)
    wx_b, wx_f = offt.x_stage_matrices(n, ux, A, r2c, np.float64)
    Y, Z = 3, 4
    # the grid as a window of a wider slot axis, the space of a wider z axis
    grid = torch.from_numpy(rng.standard_normal((2, Y, A + 3, Z)).astype(np.float32))
    gre, gim = grid[0, :, 2:A + 2], grid[1, :, 2:A + 2]
    g = _c((gre, gim))
    got = lf.to_space(gre, gim, lines, real_out=r2c)
    if r2c:  # f = Fr A - Fi B
        want = (np.einsum("yaz,ax->yxz", g.real, wx_b[0])
                - np.einsum("yaz,ax->yxz", g.imag, wx_b[1]))
        assert got.shape == (Y, n, Z) and _rel(got.numpy(), want) <= RTOL
    else:
        want = np.einsum("yaz,ax->yxz", g, wx_b[0] + 1j * wx_b[1])
        assert _rel(_c(got), want) <= RTOL
    space = torch.from_numpy(rng.standard_normal((2, Y, n, Z + 2)).astype(np.float32))
    sre, sim = space[0, :, :, 1:Z + 1], (None if r2c else space[1, :, :, 1:Z + 1])
    s = sre.numpy().astype(np.float64) if r2c else _c((sre, sim))
    got = lf.from_space(sre, sim, lines)
    want = np.einsum("yxz,xa->yaz", s, wx_f[0] + 1j * wx_f[1])
    assert got[0].shape == (Y, A, Z) and _rel(_c(got), want) <= RTOL
    assert not got[0][:, ux.size:].any() and not got[1][:, ux.size:].any()  # padding slots


def test_the_table_is_rounded_once_from_float64():
    n = 512
    theta = 2 * np.pi * np.arange(n) / n
    table = lf.twiddle_table(n)
    assert table.dtype == np.float32
    np.testing.assert_array_equal(table[:, 0], np.cos(theta).astype(np.float32))
    np.testing.assert_array_equal(table[:, 1], np.sin(theta).astype(np.float32))
    assert lf.radices(512) == (8, 8, 8) and lf.radices(256) == (8, 8, 4)
    assert lf.radices(128) == (8, 8, 2) and lf.radices(1024) == (8, 8, 8, 2)


@pytest.mark.parametrize("n", [32, 96, 2048, 100])
def test_lengths_out_of_range_are_refused(n):
    assert not lf.supports(n)
    with pytest.raises(tp.InvalidParameterError):
        lf.Lines(n, "cpu")


def test_refused_operands():
    lines = lf.Lines(64, "cpu")
    x = torch.zeros((3, 64))
    with pytest.raises(tp.InvalidParameterError):
        lf.rows(x.double(), x.double(), lines, 1)
    with pytest.raises(tp.InvalidParameterError):
        lf.rows(x, x, lines, 2)
    with pytest.raises(tp.InvalidParameterError):
        lf.rows(torch.zeros((3, 32)), torch.zeros((3, 32)), lines, 1)
    with pytest.raises(tp.InvalidParameterError):
        lf.to_space(x[None], x[None], lines, real_out=False)  # no slot maps


# ---- the rule in the local engine ----------------------------------------------------------

GRID = (64, 16, 64)
# (name, r2c, radius, knobs, y plan)
Y_PLANS = [
    ("c2c dense", False, 0.6, {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"},
     "dense"),
    ("c2c per-slot", False, 0.3, {"SPFFT_TPU_SPARSE_Y": "1"}, "per-slot"),
    ("c2c blocked", False, 0.6, {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "2"},
     "blocked"),
    ("r2c dense", True, 0.6, {"SPFFT_TPU_SPARSE_Y_BLOCKS": "0"}, "dense"),
    ("r2c blocked", True, 0.6, {"SPFFT_TPU_SPARSE_Y_BLOCKS": "2"}, "blocked"),
]


def _values(rng, trip, dims, r2c):
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    return spec[storage(t[:, 2], dz), storage(t[:, 1], dy), t[:, 0]]


def _local(r2c, dims=GRID, dtype=np.float32, precision="highest", radius=0.6):
    trip = tp.create_spherical_cutoff_triplets(*dims, radius, hermitian_symmetry=r2c)
    t = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, dtype=dtype,
                     engine="mxu", precision=precision)
    return t, trip


def _kernels(fn):
    """The K1 and line FFT runs of ``fn()``, as the compiled card counts them."""
    with hlo.recording() as rec:
        fn()
    ops = [op for op, _, _ in rec.ops]
    return ops.count(hlo.K1), ops.count(hlo.FFT)


@pytest.mark.parametrize("name,r2c,radius,env,y_plan", Y_PLANS, ids=[p[0] for p in Y_PLANS])
def test_the_local_highest_plans_engage_the_line_fft_and_match_jax(name, r2c, radius, env,
                                                                  y_plan, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, trip = _local(r2c, radius=radius)
    ex = port._exec
    assert ex.y_plan == y_plan
    d = port.describe()
    assert d["z_stage"] == d["x_stage"] == "fft" and d["k1_form"] == "highest"
    assert not hasattr(ex, "_wz_b") and not hasattr(ex, "_wx_b")  # no dense z, x matrices
    values = _values(np.random.default_rng(len(name)), trip, GRID, r2c)
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *GRID, indices=trip,
                              dtype=np.float32, engine="xla")
    space_ref = np.asarray(ref.backward(values))
    k1_runs, fft_runs = _kernels(lambda: port.backward(values))
    y_runs = {"dense": 1, "per-slot": 1, "blocked": len(ex.buckets or ())}[y_plan]
    assert (k1_runs, fft_runs) == (y_runs, 2)  # z and x on the line FFT, y on K1
    assert _rel(port.backward(values).numpy(), space_ref) <= PAIR_RTOL
    for scaling in (tp.ScalingType.NONE, tp.ScalingType.FULL):
        want = np.asarray(ref.forward(scaling=spfft_tpu.ScalingType(int(scaling))))
        k1_runs, fft_runs = _kernels(lambda: port.forward(scaling=scaling))
        assert (k1_runs, fft_runs) == (y_runs, 2)
        assert _rel(port.forward(scaling=scaling).numpy(), want) <= PAIR_RTOL


@pytest.mark.parametrize("dims,z,x", [((64, 12, 20), "k1", "fft"), ((20, 12, 128), "fft", "k1"),
                                      ((2048, 2, 8), "k1", "k1")])
def test_each_stage_engages_by_its_own_length(dims, z, x):
    port, _ = _local(False, dims=dims, radius=0.9)
    d = port.describe()
    assert (d["z_stage"], d["x_stage"]) == (z, x)


def _stage_inputs(ex, rng):
    p = ex.params
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(ex.real_dtype))
    Y, A, X, Z = p.dim_y, ex.num_x_active, p.dim_x, p.dim_z
    return ((rnd(ex._table_rows, Z), rnd(ex._table_rows, Z)), (rnd(Y, A, Z), rnd(Y, A, Z)),
            (rnd(Y, X, Z), None if ex.is_r2c else rnd(Y, X, Z)))


# (name, dtype, precision, knobs): every local plan the rule leaves on K1
OUTSIDE = [
    ("high", np.float32, "high", {}),
    ("default", np.float32, "default", {}),
    ("bf16 twiddle", np.float32, "highest", {"SPFFT_TPU_TWIDDLE_BF16": "1"}),
    ("float64", np.float64, "highest", {}),
]


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("name,dtype,precision,env", OUTSIDE, ids=[o[0] for o in OUTSIDE])
def test_plans_outside_the_rule_keep_k1_bitwise(name, dtype, precision, env, r2c, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, trip = _local(r2c, dtype=dtype, precision=precision)
    ex = port._exec
    d = port.describe()
    assert d["z_stage"] == d["x_stage"] == "k1"
    rt, form = ex.real_dtype, ex.k1_precision
    # the stage matrices as the plan made them before the line FFT existed
    wz_b, _, _, wz_f = offt.zy_stage_matrices(GRID[2], GRID[1], ex.params.total_size, rt)
    wx_b, wx_f = offt.x_stage_matrices(GRID[0], ex._slot_x, ex.num_x_active, r2c, rt)
    for got, want in ((ex._wz_b, wz_b), (ex._wz_f[tp.ScalingType.FULL], wz_f[tp.ScalingType.FULL]),
                      (ex._wx_b, wx_b), (ex._wx_f, wx_f)):
        assert got.precision == form
        for g, w in zip(got.pair, want):
            np.testing.assert_array_equal(g.numpy(), w)
    sticks, grid, space = _stage_inputs(ex, np.random.default_rng(3))
    const = lambda w: k1.Constant(*(torch.from_numpy(np.ascontiguousarray(q)) for q in w), form)
    def mm(x, w, spec, **kw):
        c = const(w)
        return offt.contract(spec, *x, *c.pair, constant=c, precision=form, **kw)

    checks = [(ex._st_z_backward(*sticks), mm(sticks, wz_b, "sz,zk->sk")),
              (ex._st_z_forward(*sticks, tp.ScalingType.FULL),
               mm(sticks, wz_f[tp.ScalingType.FULL], "sz,zk->sk"))]
    if r2c:
        checks.append(((ex._st_x_backward(*grid), None),
                       mm(grid, wx_b, "kxz,xl->klz", want_imag=False)))
        checks.append((ex._st_x_forward(*space), mm(space, wx_f, "yxz,xk->ykz")))
    else:
        checks.append((ex._st_x_backward(*grid), mm(grid, wx_b, "kxz,xl->klz")))
        checks.append((ex._st_x_forward(*space), mm(space, wx_f, "yxz,xk->ykz")))
    for got, want in checks:
        for g, w in zip(got, want):
            if w is not None:
                assert torch.equal(g, w)
    values = _values(np.random.default_rng(1), trip, GRID, r2c)
    y_runs = len(ex.buckets) if ex.y_plan == "blocked" else 1
    assert _kernels(lambda: port.backward(values)) == (2 + y_runs, 0)


@pytest.mark.parametrize("mesh", ["slab", "pencil"])
def test_the_mesh_engines_keep_k1(mesh, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a mesh engine called the line FFT")

    for fn in ("rows", "to_space", "from_space"):
        monkeypatch.setattr(lf, fn, refuse)
    dims = (64, 16, 64)
    per, vals = problem(False, 4, 5, dims=dims, radius=0.6)
    if mesh == "slab":
        t = slab_plan(False, 4, per, np.float32, dims=dims, engine="mxu")
    else:
        t = pencil_plan(False, 2, 2, per, np.float32, dims=dims, engine="mxu")
    d = t.describe()  # the slab engine's card has the local engine's fields
    assert d.get("z_stage", "k1") == d.get("x_stage", "k1") == "k1"
    assert d["k1_form"] == "highest"
    k1_runs, fft_runs = _kernels(lambda: t.backward(vals))
    assert fft_runs == 0 and k1_runs >= 3
