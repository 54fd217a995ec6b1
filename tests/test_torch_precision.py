"""K1's "high" (bf16x3) and "default" (bf16x1) precisions as far as the CPU can
check them: the BF16 split and the two arithmetics against an independent
numpy/ml_dtypes emulation, the plan-time BF16 tile layout read back by
wgmma's addressing rule, the launch arguments the wrapper derives, and
``Transform(precision=...)`` against the JAX package. The kernels themselves
run only on the card (chip_smoke.py); on the CPU every precision takes the
exact plain products, as JAX's CPU backend does."""
import ml_dtypes
import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu.ops import fft as jfft
import spfft_tpu_torch as tp
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as tfft

# The emulation sums the same exact products in float64, the port in float32:
# they differ by float32 rounding of sums of up to 96 terms.
EMULATION_RTOL = 1e-5
SPLIT_RTOL = 2.0 ** -16  # |hi + lo - x| / |x|: two roundings to 8 significant bits
RTOL_F32 = 2e-5  # the bar of test_torch_transform.py


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
    return x.astype(np.float32)


def _bf16(a):
    """numpy float32 -> the nearest bfloat16 (ml_dtypes, ties to even), as float32."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_split_bf16_is_ml_dtypes_rounding(seed):
    x = _values(seed)
    hi, lo = k1.split_bf16(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), _bf16(x))
    np.testing.assert_array_equal(lo.numpy(), _bf16(x - _bf16(x)))
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0xFFFF).eq(0).all()


@pytest.mark.parametrize("seed", range(4))
def test_split_bf16_rebuilds_within_2_pow_minus_16(seed):
    x = _values(seed).astype(np.float64)
    hi, lo = (t.double().numpy() for t in k1.split_bf16(torch.from_numpy(x.astype(np.float32))))
    assert (np.abs(hi + lo - x) <= SPLIT_RTOL * np.abs(x)).all()
    assert (np.abs(hi - x) <= 2.0 ** -8 * np.abs(x)).all()  # hi alone: half a BF16 ulp


def test_round_bf16_ties_to_even():
    ulp = 2.0 ** -7
    x = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 0.0, float("inf")])
    assert k1.round_bf16(x).tolist() == [1.0, 1 + 2 * ulp, -1.0, 0.0, float("inf")]


def _emulate(precision, ar, ai, br, bi, want_imag):
    """The precision's products in numpy: ml_dtypes parts, exact products and
    sums in float64."""
    split = lambda t: None if t is None else (_bf16(t), _bf16(t - _bf16(t)))
    if precision == "high":
        dot = lambda a, b: a[1].astype(np.float64) @ b[0] + a[0].astype(np.float64) @ b[1] \
            + a[0].astype(np.float64) @ b[0]
    else:
        dot = lambda a, b: a[0].astype(np.float64) @ b[0]
    a, b, c, d = (split(t) for t in (ar, ai, br, bi))
    cr = dot(a, c) - (dot(b, d) if b is not None and d is not None else 0)
    if not want_imag:
        return cr, None
    ci = (dot(a, d) if d is not None else 0) + (dot(b, c) if b is not None else 0)
    return cr, ci + np.zeros_like(cr)


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("form", ["complex", "real_in", "real_out", "batched"])
def test_bf16_arithmetic_matches_numpy_emulation(precision, form):
    rng = np.random.default_rng(len(form) + len(precision))
    batch = 3 if form == "batched" else 1
    r = lambda *s: rng.standard_normal((batch, *s)).astype(np.float32)
    ar, ai, br, bi = r(40, 96), r(40, 96), r(96, 50), r(96, 50)
    if form == "real_in":
        ai = None
    want_imag = form != "real_out"
    t = lambda a: None if a is None else torch.from_numpy(a)
    fn = k1.complex_matmul_bf16x3 if precision == "high" else k1.complex_matmul_bf16x1
    got = fn(t(ar), t(ai), t(br), t(bi), want_imag)
    want = _emulate(precision, ar, ai, br, bi, want_imag)
    assert (got[1] is None) == (not want_imag)
    for g, w in zip(got, want):
        if w is not None:
            assert np.abs(g.numpy() - w).max() <= EMULATION_RTOL * np.abs(w).max()
    # and how far each precision lies from the exact product
    exact = ar.astype(np.float64) @ br - (ai.astype(np.float64) @ bi if ai is not None else 0)
    dev = np.abs(got[0].numpy() - exact).max() / np.abs(exact).max()
    assert dev <= (1e-4 if precision == "high" else 2e-2)


def _read_tiles(tiles, k, q):
    """Reads prepared tiles back as wgmma does: tile row n at 128 n bytes
    (groups of 8 rows 1024 bytes apart), value kk of the row at kk * itemsize
    bytes, 16-byte chunks swizzled by address bits 7-9. Returns the planes
    (batch, planes, K, Q) of V, and all of the padded planes."""
    b, qt, kt, npl, bn, tk = tiles.shape
    item = tiles.element_size()
    flat = tiles.float().numpy().reshape(b, qt, kt, npl, bn * tk)
    addr = np.arange(bn)[:, None] * 128 + np.arange(tk)[None, :] * item
    addr = addr ^ (((addr >> 7) & 7) << 4)
    vals = flat[..., addr // item]  # (b, qt, kt, npl, bn, tk) logical
    planes = vals.transpose(0, 3, 1, 4, 2, 5).reshape(b, npl, qt * bn, kt * tk)
    return planes[:, :, :q, :k].transpose(0, 1, 3, 2), planes


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("k,q,imag,batch", [(256, 256, True, 1), (176, 256, True, 1),
                                            (256, 176, True, 1), (120, 256, True, 4),
                                            (70, 90, False, 1), (9, 50, True, 3)])
def test_tile_constant_bf16_reads_back_as_the_split(precision, k, q, imag, batch):
    rng = np.random.default_rng(k * q + batch)
    shape = (batch, k, q) if batch > 1 else (k, q)
    vr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) if imag else None
    tiles = k1.tile_constant(vr, vi, precision)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tiles.shape[-2:] == (k1.tile_q(q), k1.TILE_K_BF16)
    got, padded = _read_tiles(tiles, k, q)
    parts = [vr] + ([vi] if imag else [])
    if precision == "high":
        split = lambda v: (_bf16(v), _bf16(v - _bf16(v)))
    else:
        split = lambda v: (_bf16(v),)
    want = np.stack([p for v in parts for p in split(v.reshape(-1, k, q).numpy())], 1)
    np.testing.assert_array_equal(got, want)
    whole = np.zeros(padded.shape, bool)
    whole[:, :, :q, :k] = True
    assert not padded[~whole].any()  # zero padding past Q and K


def test_tile_constant_rejects_an_unknown_precision():
    with pytest.raises(tp.InvalidParameterError):
        k1.tile_constant(torch.zeros(4, 4), None, "fast")


# ---- the launch arguments at each precision (a recording stand-in, no card) ----


class _Recorder:
    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


_ARG_NAMES = ("dr", "di", "d_sb", "d_sp", "d_sk", "kmajor", "tma", "v", "v_sb", "v_im", "bn",
              "o_r", "o_i", "o_sb", "o_sp", "o_sq", "batch", "P", "Q", "K", "stream")


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("imag", [True, False])
def test_launch_bucket_form_per_precision(precision, imag):
    """The blocked y backward: a constant per batch entry, the output written
    into columns of a wider grid."""
    g = torch.Generator().manual_seed(2)
    ag, syg, Y, Z, A = 3, 24, 40, 20, 9
    wr, wi = torch.randn(ag, syg, Y, generator=g), torch.randn(ag, syg, Y, generator=g)
    w = k1.Constant(wr, wi if imag else None, precision)
    w.tiles = k1.tile_constant(w.re, w.im, precision)  # as a CUDA plan holds them
    xr, xi = torch.randn(ag, syg, Z, generator=g), torch.randn(ag, syg, Z, generator=g)
    grid = torch.empty(Y, A, Z), torch.empty(Y, A, Z)
    out = tuple(tfft.result_view("ajz,ajk->kaz", t[:, 2:2 + ag]) for t in grid)
    (ar, ai, br, bi), _ = tfft.operands("ajz,ajk->kaz", xr, xi, w.re, w.im)
    rec = _Recorder()
    assert k1._launch_tc(rec, ar, ai, br, bi, *out, w, 0, precision) == 0
    args = dict(zip(_ARG_NAMES, rec.args))
    assert args["v"] == w.tiles.data_ptr() and args["v_im"] == int(imag)
    assert args["v_sb"] == w.tiles.stride(0) * w.tiles.element_size()
    assert (args["batch"], args["P"], args["Q"], args["K"]) == (ag, Z, Y, syg)
    assert (args["kmajor"], args["tma"], args["bn"]) == (0, 1, 64)
    assert (args["o_sb"], args["o_sp"], args["o_sq"]) == (Z, 1, A * Z)
    assert args["o_r"] == grid[0][:, 2].data_ptr()


def test_launch_rejects_a_constant_of_another_precision():
    w = k1.Constant(torch.randn(8, 8), torch.randn(8, 8), "high")
    w.tiles = k1.tile_constant(w.re, w.im, "high")
    x = torch.randn(1, 5, 8)
    with pytest.raises(tp.InvalidParameterError):
        k1._launch_tc(_Recorder(), x, x, w.re[None], w.im[None], torch.empty(1, 5, 8),
                      torch.empty(1, 5, 8), w, 0, "default")


def test_wrapper_rejects_an_unknown_precision_and_a_bad_out():
    a = torch.randn(1, 5, 4)
    b = torch.randn(1, 4, 3)
    with pytest.raises(tp.InvalidParameterError):
        k1.complex_matmul(a, a, b, b, precision="fast")
    with pytest.raises(tp.InvalidParameterError):
        k1.complex_matmul(a, a, b, b, out=(torch.empty(1, 5, 3), None))
    with pytest.raises(tp.InvalidParameterError):
        k1.complex_matmul(a, a, b, b, out=(torch.empty(1, 5, 3), torch.empty(1, 3, 5).mT))


# ---- the precision names and the Transform ---------------------------------------


@pytest.mark.parametrize("name", ["highest", "high", "default", "HIGH", "Default", "HiGhEsT"])
def test_resolve_precision_matches_jax(name):
    got = tfft.resolve_precision(name)
    assert got == jfft.resolve_precision(name).name.lower()
    assert got in k1.PRECISIONS


@pytest.mark.parametrize("name", ["medium", "", "bf16", None, "float32"])
def test_resolve_precision_errors_as_jax(name):
    with pytest.raises(tp.InvalidParameterError):
        tfft.resolve_precision(name)
    with pytest.raises(spfft_tpu.InvalidParameterError):
        jfft.resolve_precision(name)


def _plan(ttype, dims, precision, dtype, module=tp, engine="mxu"):
    r2c = ttype == 1
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.6, hermitian_symmetry=r2c)
    return module.Transform(module.ProcessingUnit.HOST, ttype, *dims, indices=trip, dtype=dtype,
                            precision=precision, engine=engine), trip


def _spectrum_values(rng, trip, dims, r2c):
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    st = lambda i, d: np.where(i < 0, i + d, i)
    return spec[st(t[:, 2], dz), st(t[:, 1], dy), t[:, 0]]


@pytest.mark.parametrize("precision", ["high", "default", "HIGH"])
@pytest.mark.parametrize("ttype", [0, 1])
def test_transform_precision_on_cpu_matches_xla(precision, ttype):
    dims = (12, 16, 8)
    port, trip = _plan(ttype, dims, precision, np.float32)
    ref, _ = _plan(ttype, dims, precision, np.float32, module=spfft_tpu, engine="xla")
    assert port.precision == precision.lower()
    assert port.describe()["matmul_precision"] == precision.upper()
    values = _spectrum_values(np.random.default_rng(ttype), trip, dims, ttype == 1)
    space, space_ref = port.backward(values).numpy(), np.asarray(ref.backward(values))
    assert np.abs(space - space_ref).max() <= RTOL_F32 * np.abs(space_ref).max()
    got = port.forward(scaling=tp.ScalingType.FULL).numpy()
    want = np.asarray(ref.forward(scaling=spfft_tpu.ScalingType.FULL))
    assert np.abs(got - want).max() <= RTOL_F32 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_cpu_and_float64_ignore_the_precision(precision, dtype):
    dims = (12, 16, 8)
    values = _spectrum_values(np.random.default_rng(3), _plan(0, dims, "highest", dtype)[1], dims,
                              False)
    spaces = [_plan(0, dims, p, dtype)[0].backward(values) for p in ("highest", precision)]
    assert torch.equal(spaces[0], spaces[1])


def test_clone_carries_engine_and_precision():
    t, trip = _plan(0, (8, 8, 8), "default", np.float32, engine="mxu")
    c = t.clone()
    assert (c.engine, c.precision, c.dtype) == ("mxu", "default", np.float32)
    assert c.describe() == t.describe()
    values = np.random.default_rng(4).standard_normal(len(trip)) + 0j
    assert torch.equal(c.backward(values), t.backward(values))


# ---- the bf16-constant form ("highest-bf16", SPFFT_TPU_TWIDDLE_BF16) --------------


@pytest.mark.parametrize("k,q,imag,batch", [(256, 256, True, 1), (176, 256, False, 1),
                                            (120, 256, True, 4), (9, 50, True, 3)])
def test_tile_constant_bf16_constant_is_one_plane_a_part(k, q, imag, batch):
    """The constant's hi planes alone, float32 TF32 tiles holding its BF16
    rounding: half the bytes of the "highest" tiles of the same constant."""
    rng = np.random.default_rng(k + q + batch)
    shape = (batch, k, q) if batch > 1 else (k, q)
    vr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) if imag else None
    tiles = k1.tile_constant(vr, vi, k1.BF16_CONSTANT)
    assert tiles.dtype == torch.float32 and tiles.shape[-2:] == (k1.tile_q(q), k1.TILE_K)
    assert tiles.numel() * 2 == k1.tile_constant(vr, vi, "highest").numel()
    got, _ = _read_tiles(tiles, k, q)
    parts = [vr] + ([vi] if imag else [])
    want = np.stack([_bf16(v.reshape(-1, k, q).numpy()) for v in parts], 1)
    np.testing.assert_array_equal(got, want)


def test_bf16_constant_arithmetic_is_3xtf32_with_exact_zeros():
    """On a BF16-exact constant the lo planes are zero, so dropping their
    products (the kernel's two-product form) changes no bit of 3xTF32."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(2, 40, 64, generator=g), torch.randn(2, 40, 64, generator=g)
    b = tuple(k1.round_bf16(torch.randn(2, 64, 24, generator=g)) for _ in range(2))
    assert all(k1.split_tf32(t)[1].eq(0).all() for t in b)
    two = lambda x, y: k1._mm(x[1], y[0]) + k1._mm(x[0], y[0])
    parts = lambda t: k1.split_tf32(t)
    want = k1._four_products(two, parts(a[0]), parts(a[1]), parts(b[0]), parts(b[1]), True)
    got = k1.ARITHMETIC[k1.BF16_CONSTANT](*a, *b)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_bf16_constant_form_needs_a_bf16_constant():
    x = torch.randn(8, 8)
    with pytest.raises(tp.InvalidParameterError, match="bfloat16"):
        k1.Constant(x, None, k1.BF16_CONSTANT)
    w = k1.Constant(k1.round_bf16(x), None, k1.BF16_CONSTANT)
    assert w.precision == k1.BF16_CONSTANT
    a = torch.randn(1, 5, 8)
    with pytest.raises(tp.InvalidParameterError, match="constant"):
        k1.complex_matmul(a, None, w.re[None], None, precision=k1.BF16_CONSTANT)
    got = k1.complex_matmul(a, None, w.re[None], None, constant=w, precision=k1.BF16_CONSTANT)
    assert torch.equal(got[0], k1.complex_matmul_plain(a, None, w.re[None], None)[0])
    # not a caller's precision
    with pytest.raises(tp.InvalidParameterError):
        tfft.resolve_precision(k1.BF16_CONSTANT)


def test_launch_bucket_form_of_the_bf16_constant():
    g = torch.Generator().manual_seed(4)
    ag, syg, Y, Z, A = 3, 24, 40, 20, 9
    wr, wi = (k1.round_bf16(torch.randn(ag, syg, Y, generator=g)) for _ in range(2))
    w = k1.Constant(wr, wi, k1.BF16_CONSTANT)
    w.tiles = k1.tile_constant(w.re, w.im, k1.BF16_CONSTANT)
    xr, xi = torch.randn(ag, syg, Z, generator=g), torch.randn(ag, syg, Z, generator=g)
    grid = torch.empty(Y, A, Z), torch.empty(Y, A, Z)
    out = tuple(tfft.result_view("ajz,ajk->kaz", t[:, 2:2 + ag]) for t in grid)
    (ar, ai, br, bi), _ = tfft.operands("ajz,ajk->kaz", xr, xi, w.re, w.im)
    rec = _Recorder()
    assert k1._launch_tc(rec, ar, ai, br, bi, *out, w, 0, k1.BF16_CONSTANT) == 0
    args = dict(zip(_ARG_NAMES, rec.args))
    assert args["v"] == w.tiles.data_ptr() and args["v_im"] == 1 and args["bn"] == 64
    assert (args["batch"], args["P"], args["Q"], args["K"]) == (ag, Z, Y, syg)
    assert k1.LIBRARIES[k1.BF16_CONSTANT] == ("complex_matmul_tf32x2",
                                              "spfft_complex_matmul_tf32x2")


@pytest.mark.parametrize("dtype,precision,form", [
    (np.float32, "highest", k1.BF16_CONSTANT), (np.float32, "high", "high"),
    (np.float32, "default", "default"), (np.float64, "highest", "highest")])
def test_the_twiddle_knob_picks_the_bf16_constant_form(monkeypatch, dtype, precision, form):
    monkeypatch.setenv("SPFFT_TPU_TWIDDLE_BF16", "1")
    assert tfft.k1_form(precision, dtype) == form
    monkeypatch.delenv("SPFFT_TPU_TWIDDLE_BF16")
    assert tfft.k1_form(precision, dtype) == precision
