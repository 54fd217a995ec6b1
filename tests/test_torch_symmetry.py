"""spfft_tpu_torch hermitian fill against spfft_tpu.ops.symmetry, exactly."""
import numpy as np
import pytest
import torch

from spfft_tpu.ops import symmetry as jsym
from spfft_tpu_torch.ops import symmetry as tsym


def _sparse_pair(rng, shape, zero_frac):
    re = rng.standard_normal(shape)
    im = rng.standard_normal(shape)
    zero = rng.random(shape) < zero_frac
    re[zero] = 0.0
    im[zero] = 0.0
    # one entry with only an imaginary part: "nonzero" means either part
    re.flat[-1] = 0.0
    return re, im


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 16])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("zero_frac", [0.0, 0.4, 0.8])
def test_hermitian_fill_pair_matches(n, axis, zero_frac):
    rng = np.random.default_rng(100 * n + 10 * axis + int(10 * zero_frac))
    shape = (n, 3) if axis == 0 else (3, n)
    re, im = _sparse_pair(rng, shape, zero_frac)
    jre, jim = jsym.hermitian_fill_1d_pair(re, im, axis=axis)
    tre, tim = tsym.hermitian_fill_1d_pair(torch.from_numpy(re), torch.from_numpy(im), axis=axis)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))


def test_pass_two_reads_pass_one():
    # n=6: pass 1 fills j=3..5 from j=3,2,1; pass 2 fills j=1,2 from j=5,4,
    # which pass 1 may just have written
    re = np.array([1.0, 0.0, 0.0, 0.0, 0.0, 7.0])
    im = np.array([0.0, 0.0, 2.0, 0.0, 0.0, 3.0])
    jre, jim = jsym.hermitian_fill_1d_pair(re, im, axis=0)
    tre, tim = tsym.hermitian_fill_1d_pair(torch.from_numpy(re), torch.from_numpy(im), axis=0)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))
    assert tim[4].item() == -2.0 and tim[2].item() == 2.0
