"""The kernel build's content hash: a library is rebuilt when its ``.cu`` or
any ``csrc/`` header it includes changes, and only then."""
import shutil

import pytest

from spfft_tpu_torch import _build


def test_sources_follow_local_includes():
    names = lambda n: [p.name for p in _build.sources(n)]
    assert names("complex_matmul") == ["complex_matmul.cu", "k1_tc.cuh", "sm90.cuh"]
    for bf16 in ("complex_matmul_bf16x3", "complex_matmul_bf16x1"):
        assert names(bf16) == [f"{bf16}.cu", "k1_tc.cuh", "sm90.cuh"]
    assert names("complex_matmul_f64") == ["complex_matmul_f64.cu", "sm90.cuh"]
    assert names("row_gather") == ["row_gather.cu"]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// leaf\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_sources_are_transitive_and_skip_system_headers(csrc):
    assert sorted(p.name for p in _build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]


@pytest.mark.parametrize("edited,rebuilds", [("k.cu", True), ("a.cuh", True), ("b.cuh", True),
                                             ("unused.cuh", False)])
def test_target_changes_with_every_included_file(csrc, edited, rebuilds):
    before = _build._target("k")
    with open(csrc / edited, "a") as f:
        f.write("// edited\n")
    assert (_build._target("k") != before) == rebuilds


def test_target_is_stable_across_checkouts(csrc, tmp_path_factory, monkeypatch):
    other = tmp_path_factory.mktemp("other")
    for p in csrc.iterdir():
        shutil.copy(p, other / p.name)
    here = _build._target("k").name
    monkeypatch.setattr(_build, "CSRC", other)
    assert _build._target("k").name == here
