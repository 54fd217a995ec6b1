"""A whole run on the CPU with the timed path broken underneath: ``correct``
comes out false for each fault the cells can have, and true without one.

The run skips only the look for a card (``execute`` on ``"cpu"``, where the
port runs its plain versions) at a size a test holds; the configurations,
traffic, comparison and limits are the cells' own. One card, one process:
the cells have no exchange between chips to leave out.
"""
import copy

import pytest
import torch

import spfft_tpu_torch as sp
from perfbench import spec
from perfbench.run import execute

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name):
    cell = copy.deepcopy(spec.cell(name, BENCH))
    cell.config.update(grid=[12, 16, 10], bands=6)
    cell.traffic["profile_pairs"] = 4
    return cell


def run(name):
    return execute(small_cell(name), 2**31 + 17, 0.2, False, "cpu")


def stale_backward(monkeypatch):
    """A step that returns its state unchanged: every backward after the
    first returns the first one's space."""
    real, first = sp.Transform.backward_pair, {}

    def backward_pair(self, re, im):
        out = real(self, re, im)
        self._space_data = first.setdefault("space", out)
        return self._space_data
    monkeypatch.setattr(sp.Transform, "backward_pair", backward_pair)


def half_forward(monkeypatch):
    """Half of the work left out: the forward's second half of the values
    never written."""
    real = sp.Transform.forward_pair

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        re, im = real(self, scaling)
        n = re.numel() // 2
        re, im = re.clone(), im.clone()
        re[n:], im[n:] = 0.0, 0.0
        return re, im
    monkeypatch.setattr(sp.Transform, "forward_pair", forward_pair)


def identity_forward(monkeypatch):
    """A forward short-circuited: it hands back the values the backward was
    given (right only where the pair is the identity, which ``V`` breaks)."""
    real = sp.Transform.backward_pair

    def backward_pair(self, re, im):
        self._given = (re.clone(), im.clone())
        return real(self, re, im)

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        return self._given
    monkeypatch.setattr(sp.Transform, "backward_pair", backward_pair)
    monkeypatch.setattr(sp.Transform, "forward_pair", forward_pair)


def skipped_bands(monkeypatch):
    """Half of the bands left out: every other call does nothing."""
    real_b, real_f, calls = sp.Transform.backward_pair, sp.Transform.forward_pair, [0]

    def backward_pair(self, re, im):
        calls[0] += 1
        return real_b(self, re, im) if calls[0] % 2 else self._space_data

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        return real_f(self, scaling) if calls[0] % 2 else None
    monkeypatch.setattr(sp.Transform, "backward_pair", backward_pair)
    monkeypatch.setattr(sp.Transform, "forward_pair", forward_pair)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: one value of each forward
    off by a thousandth of the largest."""
    real = sp.Transform.forward_pair

    def forward_pair(self, scaling=sp.ScalingType.NONE):
        re, im = real(self, scaling)
        re = re.clone()
        re[re.numel() // 3] += 1e-3 * float(torch.abs(re).max())
        return re, im
    monkeypatch.setattr(sp.Transform, "forward_pair", forward_pair)


def altered_space(monkeypatch):
    """An answer altered where it is produced: one point of each backward's
    space off by a thousandth of the largest."""
    real = sp.Transform.backward_pair

    def backward_pair(self, re, im):
        out = real(self, re, im)
        first = out if torch.is_tensor(out) else out[0]
        first.view(-1)[first.numel() // 2] += 1e-3 * float(first.abs().max())
        return out
    monkeypatch.setattr(sp.Transform, "backward_pair", backward_pair)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert {m["name"] for m in spec.cell(name, BENCH).end_to_end} == set(out["metrics"])


@pytest.mark.parametrize("fault", [stale_backward, half_forward, identity_forward, skipped_bands,
                                   altered_answer, altered_space])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(name)
    assert not out["correct"], out["check"]
    assert out["failed"] > 0
