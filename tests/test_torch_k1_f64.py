"""K1's float64 path (DMMA, Gauss's three products) as far as the CPU can check
it: the plan-time layout of the constant operand read back by the kernel's
addressing rule, the launch arguments the wrapper derives from each stage
form, and the kernel's arithmetic in PyTorch against the JAX package's
``complex_matmul`` and over whole plans. The kernel itself runs only on the
card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spfft_tpu
import spfft_tpu_torch as tp
import spfft_tpu_torch.errors as terr
from spfft_tpu.ops import fft as jfft
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as tfft

# Gauss's arithmetic against the JAX package's, both float64: the two sum in
# different orders, a few ulps of the largest output at K <= 64
GAUSS_RTOL = 1e-13
PLAN_RTOL = 1e-10  # the float64 bar of test_torch_transform.py


def _rand(g, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64)


def _read_back(tiles, k, q):
    """The (batch, planes, K, Q) constant the kernel reads from ``tiles``:
    per (Q tile, K tile, plane, n tile j, k step s), lane 4 g + t holds
    V[32 kt + 8 s + 2 t + c, 64 qt + 8 j + g] for c = 0, 1."""
    b, qt, kt, npl, nj, steps, lanes, cs = tiles.shape
    assert (nj, steps, lanes, cs) == (8, 4, 32, 2) and tiles.is_contiguous()
    out = torch.full((b, npl, kt * 32, qt * 64), float("nan"), dtype=tiles.dtype)
    lane = torch.arange(32)
    for j in range(nj):
        for s in range(steps):
            for c in range(cs):
                rows = (torch.arange(kt)[:, None] * 32 + 8 * s + 2 * (lane[None] % 4) + c)
                cols = (torch.arange(qt)[:, None] * 64 + 8 * j + lane[None] // 4)
                v = tiles[:, :, :, :, j, s, :, c]  # (b, qt, kt, npl, 32)
                for a in range(qt):
                    for e in range(kt):
                        out[:, :, rows[e], cols[a]] = v[:, a, e]
    assert not torch.isnan(out).any()
    return out[:, :, :k, :q], out


@pytest.mark.parametrize("shape", [(40, 70), (3, 40, 70), (16, 64), (1, 256, 256), (5, 9, 130)])
@pytest.mark.parametrize("imag", [True, False])
def test_f64_constant_reads_back(shape, imag):
    g = torch.Generator().manual_seed(sum(shape))
    vr = _rand(g, *shape)
    vi = _rand(g, *shape) if imag else None
    tiles = k1.tile_constant_f64(vr, vi)
    k, q = shape[-2:]
    got, padded = _read_back(tiles, k, q)
    want = [vr, vi] if imag else [vr]
    for plane, w in enumerate(want):
        assert torch.equal(got[:, plane], w if w.dim() == 3 else w[None])
    assert tiles.shape[0] == (shape[0] if len(shape) == 3 else 1)
    # zero padding past K and Q
    assert padded[:, :, k:].abs().sum() == 0 and padded[:, :, :, q:].abs().sum() == 0


def test_f64_constant_of_strided_views():
    g = torch.Generator().manual_seed(3)
    w = _rand(g, 50, 30)
    got, _ = _read_back(k1.tile_constant_f64(w.mT, w.mT * 2), 30, 50)
    assert torch.equal(got[0, 0], w.mT) and torch.equal(got[0, 1], w.mT * 2)


# ---- the launch arguments the wrapper derives (no card: a recording stand-in) ----


class _Recorder:
    def __init__(self):
        self.args = None

    def spfft_complex_matmul_f64(self, *args):
        self.args = args
        return 0


_ARG_NAMES = ("dr", "di", "d_sb", "d_sp", "d_sk", "kmajor", "vec", "v", "v_sb", "v_im",
              "o_r", "o_i", "o_sb", "o_sp", "o_sq", "batch", "P", "Q", "K", "stream")


def _launch_args(spec, xshape, wshape, real_in=False, want_imag=True, offset=0):
    g = torch.Generator().manual_seed(1)
    data = lambda: _rand(g, int(np.prod(xshape)) + offset)[offset:].view(xshape)
    w = k1.Constant(_rand(g, *wshape), _rand(g, *wshape))
    w.tiles = k1.tile_constant_f64(w.re, w.im)  # as a CUDA plan holds them
    xr, xi = data(), None if real_in else data()
    (ar, ai, br, bi), _ = tfft.operands(spec, xr, xi, w.re, w.im)
    batch, m, n = ar.shape[0], ar.shape[1], br.shape[2]
    cr = torch.empty(batch, m, n, dtype=torch.float64)
    ci = torch.empty_like(cr) if want_imag else None
    rec = _Recorder()
    assert k1._launch_f64(rec.spfft_complex_matmul_f64, ar, ai, br, bi, cr, ci, w, 0) == 0
    args = dict(zip(_ARG_NAMES, rec.args))
    assert args["v"] == w.tiles.data_ptr() and args["dr"] == xr.data_ptr()
    assert args["v_sb"] == (0 if w.tiles.shape[0] == 1 else w.tiles.stride(0) * 8)
    return args, cr


def test_launch_z_stage_takes_data_as_d_k_major():
    args, cr = _launch_args("sz,zk->sk", (300, 40), (40, 100))
    assert (args["kmajor"], args["vec"], args["v_im"], args["batch"]) == (1, 1, 1, 1)
    assert (args["P"], args["Q"], args["K"]) == (300, 100, 40)
    assert (args["d_sp"], args["d_sk"]) == (40, 1)
    assert (args["o_sp"], args["o_sq"]) == (cr.stride(1), 1)


@pytest.mark.parametrize("spec,xshape,wshape,batch", [
    ("yxz,yk->kxz", (40, 3, 20), (40, 40), 1),
    ("kxz,xl->klz", (6, 40, 20), (40, 176), 6),
    ("yxz,xk->ykz", (6, 40, 20), (40, 88), 6),
])
def test_launch_y_and_x_stages_take_c_transposed(spec, xshape, wshape, batch):
    args, cr = _launch_args(spec, xshape, wshape)
    assert (args["kmajor"], args["vec"], args["batch"], args["Q"]) == (0, 1, batch, wshape[1])
    assert (args["d_sp"], args["o_sp"], args["o_sq"]) == (1, 1, cr.stride(1))
    assert args["K"] == wshape[0] and args["P"] == cr.shape[2]


def test_launch_bucket_stages_take_a_constant_per_batch_entry():
    # "ajz,ajk->kaz": one (Syg, Y) matrix per bucket slot, data (Ag, Syg, Z)
    args, cr = _launch_args("ajz,ajk->kaz", (5, 12, 20), (5, 12, 40))
    assert (args["batch"], args["P"], args["Q"], args["K"], args["kmajor"]) == (5, 20, 40, 12, 0)
    assert args["v_sb"] > 0 and args["d_sb"] == 12 * 20


def test_launch_real_forms_and_unaligned_data():
    args, _ = _launch_args("yxz,xk->ykz", (6, 40, 20), (40, 88), real_in=True)
    assert args["di"] is None and args["v_im"] == 1
    args, _ = _launch_args("kxz,xl->klz", (6, 40, 20), (40, 64), want_imag=False)
    assert args["o_i"] is None and args["di"] is not None
    # data off a 16-byte boundary, or rows of an odd length, go 8 bytes a copy
    args, _ = _launch_args("sz,zk->sk", (30, 40), (40, 100), offset=1)
    assert args["dr"] % 16 == 8 and (args["kmajor"], args["vec"]) == (1, 0)
    args, _ = _launch_args("sz,zk->sk", (30, 41), (41, 100))
    assert (args["d_sp"], args["vec"]) == (41, 0)


def test_launch_rejects_a_constant_of_another_operand():
    w = k1.Constant(torch.zeros(8, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64))
    w.tiles = k1.tile_constant_f64(w.re, w.im)
    x = torch.zeros(1, 5, 8, dtype=torch.float64)
    with pytest.raises(terr.InvalidParameterError):
        k1._launch_f64(_Recorder().spfft_complex_matmul_f64, x, x,
                       torch.zeros(1, 8, 8, dtype=torch.float64), None,
                       torch.empty(1, 5, 8, dtype=torch.float64), None, w, 0)


def test_launch_without_a_constant_prepares_the_shared_side():
    g = torch.Generator().manual_seed(5)
    w = _rand(g, 24, 40)
    ar, ai = w.mT.expand(3, -1, -1), (2 * w).mT.expand(3, -1, -1)
    br, bi = _rand(g, 3, 24, 70), _rand(g, 3, 24, 70)
    rec = _Recorder()
    cr = torch.empty(3, 40, 70, dtype=torch.float64)
    k1._launch_f64(rec.spfft_complex_matmul_f64, ar, ai, br, bi, cr, torch.empty_like(cr),
                   None, 0)
    args = dict(zip(_ARG_NAMES, rec.args))
    assert (args["P"], args["Q"], args["K"], args["v_sb"]) == (70, 40, 24, 0)


@pytest.mark.parametrize("batch,m,k,n,ok", [
    (1, 22368, 256, 256, True), (256, 256, 176, 256, True), (100000, 64, 8, 64, True),
    (1, 1, 0, 1, True), (0, 4, 4, 4, False), (1, 4, -1, 4, False),
    (2**20, 2**12, 4, 2**12, False),
])
def test_supports_the_float64_grid(batch, m, k, n, ok):
    assert k1.supports(batch, m, k, n, torch.float64) == ok


# ---- Gauss's arithmetic -----------------------------------------------------------------

SPECS = [
    ("sz,zk->sk", (30, 24), (24, 24)),
    ("yxz,yk->kxz", (16, 5, 12), (16, 16)),
    ("kxz,xl->klz", (6, 9, 12), (9, 20)),
    ("yxz,xk->ykz", (6, 20, 12), (20, 9)),
    ("ajz,ajk->kaz", (5, 7, 12), (5, 7, 16)),
    ("yaz,ajy->ajz", (16, 5, 12), (5, 7, 16)),
]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("spec,xshape,wshape", SPECS, ids=[s[0] for s in SPECS])
def test_gauss_arithmetic_matches_jax_at_every_engine_spec(spec, xshape, wshape, monkeypatch):
    rng = np.random.default_rng(len(spec) + len(xshape))
    xr, xi = rng.standard_normal(xshape), rng.standard_normal(xshape)
    wr, wi = rng.standard_normal(wshape), rng.standard_normal(wshape)
    yr, yi = jfft.complex_matmul(*(jnp.asarray(a) for a in (xr, xi, wr, wi)), spec)
    monkeypatch.setattr(k1, "complex_matmul_plain", k1.complex_matmul_gauss)
    cr, ci = tfft.complex_matmul(*(torch.from_numpy(a) for a in (xr, xi, wr, wi)), spec)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    assert cr.dtype == torch.float64
    assert _rel(cr.numpy() + 1j * ci.numpy(), want) <= GAUSS_RTOL


@pytest.mark.parametrize("form", ["real_in", "real_out"])
def test_gauss_arithmetic_matches_jax_on_the_real_forms(form, monkeypatch):
    rng = np.random.default_rng(11)
    xr, xi = rng.standard_normal((6, 20, 12)), rng.standard_normal((6, 20, 12))
    wr, wi = rng.standard_normal((20, 9)), rng.standard_normal((20, 9))
    monkeypatch.setattr(k1, "complex_matmul_plain", k1.complex_matmul_gauss)
    t = torch.from_numpy
    if form == "real_in":
        yr, yi = jfft.real_in_matmul(jnp.asarray(xr), jnp.asarray(wr), jnp.asarray(wi),
                                     "yxz,xk->ykz")
        cr, ci = tfft.real_in_matmul(t(xr), t(wr), t(wi), "yxz,xk->ykz")
        assert _rel(cr.numpy() + 1j * ci.numpy(), np.asarray(yr) + 1j * np.asarray(yi)) \
            <= GAUSS_RTOL
    else:
        y = jfft.real_out_matmul(*(jnp.asarray(a) for a in (xr, xi, wr, wi)), "yxz,xk->ykz")
        cr = tfft.real_out_matmul(t(xr), t(xi), t(wr), t(wi), "yxz,xk->ykz")
        assert _rel(cr.numpy(), np.asarray(y)) <= GAUSS_RTOL


@pytest.mark.parametrize("want_imag,parts", [(True, "ri"), (False, "ri"), (True, "r-"),
                                             (True, "-i")])
def test_gauss_is_the_four_product_form_where_a_part_is_missing(want_imag, parts):
    g = torch.Generator().manual_seed(9)
    ar, ai, br, bi = _rand(g, 2, 7, 5), _rand(g, 2, 7, 5), _rand(g, 2, 5, 6), _rand(g, 2, 5, 6)
    ai = ai if parts[0] == "r" else None
    bi = bi if parts[1] == "i" else None
    got = k1.complex_matmul_gauss(ar, ai, br, bi, want_imag)
    want = k1.complex_matmul_plain(ar, ai, br, bi, want_imag)
    full = ai is not None and bi is not None and want_imag
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        elif full:  # three products: within rounding of the four-product form
            assert (a - b).abs().max() <= 1e-14 * b.abs().max()
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("r2c", [False, True])
def test_float64_blocked_plans_with_the_kernels_arithmetic(r2c, monkeypatch):
    """A float64 plan on the matrix-product engine with every K1 product in
    the DMMA kernel's arithmetic, against the JAX package's ``xla`` engine."""
    monkeypatch.setenv("SPFFT_TPU_SPARSE_Y_BLOCKS", "2")
    monkeypatch.setattr(k1, "complex_matmul_plain", k1.complex_matmul_gauss)
    dims = (16, 24, 8)
    rng = np.random.default_rng(21 + r2c)
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.6, hermitian_symmetry=r2c)
    if r2c:
        spec = np.fft.fftn(rng.standard_normal(dims[::-1]))
        t3 = np.asarray(trip)
        values = spec[t3[:, 2] % dims[2], t3[:, 1] % dims[1], t3[:, 0]]
    else:
        values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                        dtype=np.float64, engine="mxu")
    assert port._exec.y_plan == "blocked" and len(port._exec.buckets) == 2 + r2c
    ref = spfft_tpu.Transform(spfft_tpu.ProcessingUnit.HOST, int(r2c), *dims, indices=trip,
                              dtype=np.float64, engine="xla")
    space, want = port.backward(values).numpy(), np.asarray(ref.backward(values))
    assert _rel(space, want) <= PLAN_RTOL
    got = port.forward(scaling=tp.ScalingType.FULL).numpy()
    back = np.asarray(ref.forward(scaling=spfft_tpu.ScalingType.FULL))
    assert _rel(got, back) <= PLAN_RTOL
