"""Public API of spfft_tpu_torch against spfft_tpu on the same calls: the grid's
local z-length limit, ``policy=`` on local plans, ``num_threads``,
``spherical_radius_for_fraction``, the ``SPFFT_*`` constants and the
version strings."""
import numpy as np
import pytest

import spfft_tpu
import spfft_tpu_torch as tp

PACKAGES = pytest.mark.parametrize("pkg", [spfft_tpu, tp], ids=["jax", "port"])
TRIP = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.7)


def _local(pkg, via_grid, grid=None, **kw):
    grid = grid if grid is not None else pkg.Grid(8, 8, 8, 64, pkg.ProcessingUnit.HOST)
    args = (pkg.ProcessingUnit.HOST, pkg.TransformType.C2C, 8, 8, 8)
    if via_grid:
        return grid.create_transform(*args, indices=TRIP, **kw)
    return pkg.Transform(*args, indices=TRIP, grid=grid, **kw)


@PACKAGES
@pytest.mark.parametrize("via_grid", [True, False])
def test_local_z_length_over_the_grid_maximum_raises(pkg, via_grid):
    grid = pkg.Grid(8, 8, 8, 64, pkg.ProcessingUnit.HOST, max_local_z_length=4)
    with pytest.raises(pkg.InvalidParameterError, match="local z length exceeds grid maximum"):
        _local(pkg, via_grid, grid, local_z_length=8)
    # unspecified (None or 0) is not checked, in either package
    for lz in (None, 0):
        assert _local(pkg, via_grid, grid, local_z_length=lz).local_z_length == 8


@PACKAGES
@pytest.mark.parametrize("via_grid", [True, False])
@pytest.mark.parametrize("policy", [None, "default"])
def test_local_plans_accept_the_default_policy(pkg, via_grid, policy):
    t = _local(pkg, via_grid, policy=policy)
    assert t.num_local_elements == len(TRIP)


@pytest.mark.parametrize("via_grid", [True, False])
def test_tuned_policy_is_not_ported(via_grid, monkeypatch):
    # once a refusal; now both packages take "tuned" (measured choices),
    # and on the CPU without SPFFT_TPU_TUNE_CPU both take the model, for the
    # same reason
    monkeypatch.delenv("SPFFT_TPU_TUNE_CPU", raising=False)
    monkeypatch.delenv("SPFFT_TPU_WISDOM", raising=False)
    jax, port = _local(spfft_tpu, via_grid, policy="tuned"), _local(tp, via_grid, policy="tuned")
    assert jax.num_local_elements == port.num_local_elements == len(TRIP)
    assert port._tuning["provenance"] == jax._tuning["provenance"] == "model"
    assert port._tuning["reason"] == jax._tuning["reason"]


@PACKAGES
def test_unknown_policy_and_local_overlap_raise(pkg):
    with pytest.raises(pkg.InvalidParameterError):
        _local(pkg, True, policy="fastest")
    with pytest.raises(pkg.InvalidParameterError):
        _local(pkg, True, overlap=2)


@pytest.mark.parametrize("policy,default", [(None, True), ("default", True), ("tuned", False)])
def test_from_parameters_checks_the_policy(policy, default, monkeypatch):
    monkeypatch.delenv("SPFFT_TPU_POLICY", raising=False)
    params = _local(tp, False).params
    made = tp.Transform.from_parameters(tp.ProcessingUnit.HOST, params, policy=policy)
    assert made.clone().num_local_elements == len(TRIP)
    assert made.report()["policy"] == ("default" if default else "tuned")
    with pytest.raises(tp.InvalidParameterError):
        tp.Transform.from_parameters(tp.ProcessingUnit.HOST, params, policy="fastest")


def test_num_threads_is_one_in_both():
    assert _local(tp, False).num_threads == _local(spfft_tpu, False).num_threads == 1


@pytest.mark.parametrize("fraction", [0.01, 0.15, 0.3, np.pi / 6, 0.9])
def test_spherical_radius_for_fraction(fraction):
    got = tp.spherical_radius_for_fraction(fraction)
    assert got == spfft_tpu.indices.spherical_radius_for_fraction(fraction)
    assert isinstance(got, float)


def test_every_spfft_constant_matches():
    names = sorted(n for n in dir(spfft_tpu) if n.startswith("SPFFT_"))
    assert names
    for name in names:
        want, got = getattr(spfft_tpu, name), getattr(tp, name)
        assert type(got).__name__ == type(want).__name__ and int(got) == int(want), name


def test_versions_match():
    assert tp.__version__ == spfft_tpu.__version__ == "0.3.0"
    assert tp.__reference_api_version__ == spfft_tpu.__reference_api_version__ == "1.0.2"
