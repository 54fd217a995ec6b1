"""K1's float32 path (3xTF32 on the tensor cores) as far as the CPU can check it:
the TF32 split, the plan-time layout of the constant operand read back by
wgmma's addressing rule, the kernel's arithmetic emulated in PyTorch against
the JAX package, and the launch arguments the wrapper derives from each stage
form. The kernel itself runs only on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spfft_tpu_torch as sp
import spfft_tpu_torch.errors as terr
from spfft_tpu import types as jtypes
from spfft_tpu.ops import fft as jfft
from spfft_tpu.ops import pallas_fft
from spfft_tpu_torch.ops import complex_matmul as k1
from spfft_tpu_torch.ops import fft as tfft

EMULATION_RTOL = 1e-5  # 3xTF32 in float32 against float32 at HIGHEST: both ~1e-6
SPLIT_RTOL = 2.0 ** -22  # |hi + lo - x| / |x|: lo keeps 11 of the 13 bits left


def _bits(t):
    return t.contiguous().view(torch.int32)


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_split_parts_are_tf32(seed):
    hi, lo = k1.split_tf32(_values(seed))
    assert (_bits(hi) & 0x1FFF).eq(0).all()
    assert (_bits(lo) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("seed", range(4))
def test_split_rebuilds_within_2_pow_minus_22(seed):
    x = _values(seed)
    hi, lo = k1.split_tf32(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= SPLIT_RTOL * x.double().abs()).all()
    # hi alone is the nearest TF32 value: within half a TF32 ulp (2^-11 relative)
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()


def test_round_tf32_ties_away_from_zero_and_keeps_specials():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + 3 * one_ulp / 2, 0.0, -0.0,
                      float("inf"), -float("inf")], dtype=torch.float32)
    got = k1.round_tf32(x)
    assert got[:3].tolist() == [1 + one_ulp, -(1 + one_ulp), 1 + 2 * one_ulp]
    assert got[3:].tolist() == x[3:].tolist()
    assert torch.isnan(k1.round_tf32(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("q,bn", [(1, 64), (64, 64), (65, 88), (88, 88), (100, 64),
                                  (176, 88), (256, 64)])
def test_tile_q_pads_least(q, bn):
    assert k1.tile_q(q) == bn


def _read_tiles(tiles, k, q):
    """Reads the prepared tiles back as wgmma does: tile row n at 128 n bytes
    (groups of 8 rows 1024 bytes apart), the k8 slice i at 32 i bytes into the
    row, 16-byte chunks swizzled by address bits 7-9. Returns the planes
    (planes, K, Q) of V, and what the padding holds."""
    b, qt, kt, npl, bn, tk = tiles.shape
    flat = tiles.numpy().reshape(b, qt, kt, npl, bn * tk)
    n = np.arange(bn)[:, None]
    kk = np.arange(tk)[None, :]
    addr = n * 128 + kk * 4  # bytes, before the swizzle
    addr = addr ^ (((addr >> 7) & 7) << 4)
    vals = flat[..., addr // 4]  # (b, qt, kt, npl, bn, 32) logical
    planes = vals.transpose(0, 3, 1, 4, 2, 5).reshape(b, npl, qt * bn, kt * tk)
    return planes[:, :, :q, :k].transpose(0, 1, 3, 2), planes


@pytest.mark.parametrize("k,q,imag,batch", [(256, 256, True, 1), (176, 256, True, 1),
                                            (256, 176, True, 1), (88, 256, True, 1),
                                            (256, 88, True, 1), (70, 90, False, 1),
                                            (9, 50, True, 3)])
def test_tile_constant_reads_back_as_the_split(k, q, imag, batch):
    rng = np.random.default_rng(k * q)
    shape = (batch, k, q) if batch > 1 else (k, q)
    vr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) if imag else None
    tiles = k1.tile_constant(vr, vi)
    assert tiles.shape[-2:] == (k1.tile_q(q), k1.TILE_K) and tiles.is_contiguous()
    got, padded = _read_tiles(tiles, k, q)
    parts = [vr] + ([vi] if imag else [])
    want = np.stack([p.numpy() for v in parts for p in k1.split_tf32(v.reshape(-1, k, q))], 1)
    np.testing.assert_array_equal(got, want)
    whole = np.zeros(padded.shape, bool)
    whole[:, :, :q, :k] = True
    assert not padded[~whole].any()  # zero padding past Q and K


def _plan(kind, dims=(8, 9, 10)):
    trip = sp.create_spherical_cutoff_triplets(*dims, 0.8, hermitian_symmetry=kind == "r2c")
    ttype = getattr(sp.TransformType, kind.upper())
    return sp.Transform(sp.ProcessingUnit.HOST, ttype, *dims, indices=trip, dtype=np.float32,
                        engine="mxu")


STAGE_CONSTANTS = ["_wz_b", "_wy_b", "_wy_f", "_wz_f:NONE", "_wz_f:FULL", "_wx_b", "_wx_f"]


@pytest.mark.parametrize("attr", STAGE_CONSTANTS)
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_plan_constants_prepare_to_their_matrices(kind, attr, monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_SPARSE_Y", "0")  # the dense y plan: 2-D y constants
    monkeypatch.setenv("SPFFT_TPU_SPARSE_Y_BLOCKS", "0")
    ex = _plan(kind)._exec
    name, _, scaling = attr.partition(":")
    const = getattr(ex, name)
    if scaling:
        const = const[getattr(sp.ScalingType, scaling)]
    assert isinstance(const, k1.Constant) and const.tiles is None  # no tiles off the card
    k, q = const.re.shape
    got, _ = _read_tiles(k1.tile_constant(const.re, const.im), k, q)
    want = np.stack([p.numpy() for v in const.pair for p in k1.split_tf32(v)], 0)
    np.testing.assert_array_equal(got[0], want)
    rebuilt = got[0][0::2] + got[0][1::2]  # hi + lo per part
    for r, v in zip(rebuilt, const.pair):
        np.testing.assert_allclose(r, v.numpy(), rtol=SPLIT_RTOL, atol=0)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _z_form(seed=11, s=64, z=256):
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((s, z)).astype(np.float32) for _ in range(2)]
    w = jfft.matrix_pair(jfft.c2c_matrix(z, +1), np.float32)
    return x, w


def test_3xtf32_emulation_matches_jax_highest():
    (xr, xi), (wr, wi) = _z_form()
    yr, yi = jfft.complex_matmul(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr),
                                 jnp.asarray(wi), "sz,zk->sk",
                                 precision=jfft.resolve_precision("highest"))
    t = lambda a: torch.from_numpy(a)[None]
    cr, ci = k1.complex_matmul_3xtf32(t(xr), t(xi), t(wr), t(wi))
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    assert _rel(cr[0].numpy() + 1j * ci[0].numpy(), ref) <= EMULATION_RTOL


def test_3xtf32_emulation_matches_pallas_interpret():
    (xr, xi), (wr, wi) = _z_form(seed=12)
    yr, yi = pallas_fft.complex_matmul_fused(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr), jnp.asarray(wi), interpret=True
    )
    t = lambda a: torch.from_numpy(a)[None]
    cr, ci = k1.complex_matmul_3xtf32(t(xr), t(xi), t(wr), t(wi))
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    assert _rel(cr[0].numpy() + 1j * ci[0].numpy(), ref) <= EMULATION_RTOL


@pytest.mark.parametrize("form", ["real_in", "real_out"])
def test_3xtf32_emulation_real_forms_match_jax(form):
    (xr, xi), (wr, wi) = _z_form(seed=13)
    hp = jfft.resolve_precision("highest")
    t = lambda a: torch.from_numpy(a)[None]
    if form == "real_in":
        yr, yi = jfft.real_in_matmul(jnp.asarray(xr), jnp.asarray(wr), jnp.asarray(wi),
                                     "sz,zk->sk", precision=hp)
        cr, ci = k1.complex_matmul_3xtf32(t(xr), None, t(wr), t(wi))
        assert _rel(cr[0].numpy() + 1j * ci[0].numpy(), np.asarray(yr) + 1j * np.asarray(yi)) \
            <= EMULATION_RTOL
    else:
        y = jfft.real_out_matmul(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(wr),
                                 jnp.asarray(wi), "sz,zk->sk", precision=hp)
        cr, ci = k1.complex_matmul_3xtf32(t(xr), t(xi), t(wr), t(wi), want_imag=False)
        assert ci is None and _rel(cr[0].numpy(), np.asarray(y)) <= EMULATION_RTOL


# ---- the launch arguments the wrapper derives (no card: a recording stand-in) ----


class _Recorder:
    def __init__(self):
        self.args = None

    def spfft_complex_matmul_tf32x3(self, *args):
        self.args = args
        return 0


_ARG_NAMES = ("dr", "di", "d_sb", "d_sp", "d_sk", "kmajor", "tma", "v", "v_sb", "v_im", "bn",
              "o_r", "o_i", "o_sb", "o_sp", "o_sq", "batch", "P", "Q", "K", "stream")


def _launch_args(spec, xshape, wshape, real_in=False, want_imag=True, offset=0):
    g = torch.Generator().manual_seed(1)
    data = lambda: torch.randn(int(np.prod(xshape)) + offset, generator=g)[offset:].view(xshape)
    w = k1.Constant(torch.randn(wshape, generator=g), torch.randn(wshape, generator=g))
    w.tiles = k1.tile_constant(w.re, w.im)  # as a CUDA plan holds them
    (ar, ai, br, bi), _ = tfft.operands(spec, data(), None if real_in else data(), w.re, w.im)
    batch, m, n = ar.shape[0], ar.shape[1], br.shape[2]
    cr = torch.empty(batch, m, n)
    ci = torch.empty_like(cr) if want_imag else None
    rec = _Recorder()
    assert k1._launch_tc(rec.spfft_complex_matmul_tf32x3, ar, ai, br, bi, cr, ci, w, 0) == 0
    args = dict(zip(_ARG_NAMES, rec.args))
    assert args["v"] == w.tiles.data_ptr() and args["v_sb"] == 0
    return args, cr


def test_launch_z_stage_takes_data_as_d_k_major():
    args, cr = _launch_args("sz,zk->sk", (300, 40), (40, 100))
    assert (args["kmajor"], args["tma"], args["bn"], args["v_im"]) == (1, 1, 64, 1)
    assert (args["P"], args["Q"], args["K"], args["batch"]) == (300, 100, 40, 1)
    assert (args["d_sp"], args["d_sk"]) == (40, 1)
    assert (args["o_sp"], args["o_sq"]) == (cr.stride(1), 1)


@pytest.mark.parametrize("spec,xshape,wshape,batch", [
    ("yxz,yk->kxz", (40, 3, 20), (40, 40), 1),
    ("kxz,xl->klz", (6, 40, 20), (40, 176), 6),
    ("yxz,xk->ykz", (6, 40, 20), (40, 88), 6),
])
def test_launch_y_and_x_stages_take_c_transposed(spec, xshape, wshape, batch):
    args, cr = _launch_args(spec, xshape, wshape)
    assert (args["kmajor"], args["tma"], args["batch"]) == (0, 1, batch)
    assert args["bn"] == k1.tile_q(wshape[1]) and args["Q"] == wshape[1]
    assert (args["d_sp"], args["o_sp"], args["o_sq"]) == (1, 1, cr.stride(1))


def test_launch_real_forms_and_unaligned_data():
    args, _ = _launch_args("yxz,xk->ykz", (6, 40, 20), (40, 88), real_in=True)
    assert args["di"] is None and args["v_im"] == 1
    args, _ = _launch_args("kxz,xl->klz", (6, 40, 20), (40, 64), want_imag=False)
    assert args["o_i"] is None
    args, _ = _launch_args("sz,zk->sk", (30, 40), (40, 100), offset=1)  # 4-byte offset
    assert args["tma"] == 0


def test_launch_rejects_a_constant_of_another_operand():
    w = k1.Constant(torch.randn(8, 8), torch.randn(8, 8))
    w.tiles = k1.tile_constant(w.re, w.im)
    x = torch.randn(1, 5, 8)
    with pytest.raises(terr.InvalidParameterError):
        k1._launch_tc(_Recorder().spfft_complex_matmul_tf32x3, x, x, torch.randn(1, 8, 8),
                      None, torch.empty(1, 5, 8), None, w, 0)


def test_jax_scaling_types_line_up():
    # the forward-z constants are keyed by the port's ScalingType, as the
    # JAX package keys its own
    assert int(sp.ScalingType.FULL) == int(jtypes.ScalingType.FULL)
