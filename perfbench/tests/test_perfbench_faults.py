"""A whole run on the CPU with the timed path broken underneath: ``correct``
comes out false for each fault the cells can have, and true without one.

The run skips only the look for a card (``execute`` on ``"cpu"``, where the
port runs its plain versions) at a size a test holds; the configurations,
traffic, comparison and limits are the cells' own. A cell over ranks runs
its ranks as processes over gloo (:mod:`perfbench.ranks`): each fault is
planted in every rank's process, and such a cell has one fault more, the
exchange between the ranks left out.
"""
import copy
import functools

import pytest
import torch

import spfft_tpu_torch as sp
from perfbench import ranks, spec
from perfbench.run import execute

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
RANK_CELLS = [w["name"] for w in BENCH["workloads"] if "ranks" in spec.cell(w["name"], BENCH).config]
# the pair path of the local plan and of the group plan: the same calls
PLANS = (sp.Transform, sp.DistributedTransform)


def small_cell(name):
    cell = copy.deepcopy(spec.cell(name, BENCH))
    cell.config.update(grid=[12, 16, 10], bands=6)
    cell.traffic["profile_pairs"] = 4
    return cell


def run(name, fault=None):
    cell = small_cell(name)
    if "ranks" in cell.config:
        hook = None if fault is None else functools.partial(in_every_rank, fault)
        return ranks.execute(cell, 2**31 + 17, 0.2, False, "cpu", hook=hook)
    return execute(cell, 2**31 + 17, 0.2, False, "cpu")


def in_every_rank(fault, rank):
    """``fault`` planted in a rank's process (the worker's ``hook``)."""
    fault(pytest.MonkeyPatch())


def stale_backward(monkeypatch):
    """A step that returns its state unchanged: every backward after the
    first returns the first one's space."""
    for plan in PLANS:
        real, first = plan.backward_pair, {}

        def backward_pair(self, re, im, real=real, first=first):
            out = real(self, re, im)
            self._space_data = first.setdefault("space", out)
            return self._space_data
        monkeypatch.setattr(plan, "backward_pair", backward_pair)


def half_forward(monkeypatch):
    """Half of the work left out: the forward's second half of the values
    never written."""
    for plan in PLANS:
        real = plan.forward_pair

        def forward_pair(self, scaling=sp.ScalingType.NONE, real=real):
            re, im = real(self, scaling)
            n = re.numel() // 2
            re, im = re.clone(), im.clone()
            re.view(-1)[n:], im.view(-1)[n:] = 0.0, 0.0
            return re, im
        monkeypatch.setattr(plan, "forward_pair", forward_pair)


def identity_forward(monkeypatch):
    """A forward short-circuited: it hands back the values the backward was
    given (right only where the pair is the identity, which ``V`` breaks)."""
    for plan in PLANS:
        real = plan.backward_pair

        def backward_pair(self, re, im, real=real):
            self._given = (re.clone(), im.clone())
            return real(self, re, im)

        def forward_pair(self, scaling=sp.ScalingType.NONE):
            return self._given
        monkeypatch.setattr(plan, "backward_pair", backward_pair)
        monkeypatch.setattr(plan, "forward_pair", forward_pair)


def skipped_bands(monkeypatch):
    """Half of the bands left out: every other call does nothing."""
    for plan in PLANS:
        real_b, real_f, calls = plan.backward_pair, plan.forward_pair, [0]

        def backward_pair(self, re, im, real_b=real_b, calls=calls):
            calls[0] += 1
            return real_b(self, re, im) if calls[0] % 2 else self._space_data

        def forward_pair(self, scaling=sp.ScalingType.NONE, real_f=real_f, calls=calls):
            return real_f(self, scaling) if calls[0] % 2 else None
        monkeypatch.setattr(plan, "backward_pair", backward_pair)
        monkeypatch.setattr(plan, "forward_pair", forward_pair)


def altered_answer(monkeypatch):
    """An answer altered where it is produced: one value of each forward
    off by a thousandth of the largest."""
    for plan in PLANS:
        real = plan.forward_pair

        def forward_pair(self, scaling=sp.ScalingType.NONE, real=real):
            re, im = real(self, scaling)
            re = re.clone()
            re.view(-1)[re.numel() // 3] += 1e-3 * float(torch.abs(re).max())
            return re, im
        monkeypatch.setattr(plan, "forward_pair", forward_pair)


def altered_space(monkeypatch):
    """An answer altered where it is produced: one point of each backward's
    space off by a thousandth of the largest."""
    for plan in PLANS:
        real = plan.backward_pair

        def backward_pair(self, re, im, real=real):
            out = real(self, re, im)
            first = out if torch.is_tensor(out) else out[0]
            first.view(-1)[first.numel() // 2] += 1e-3 * float(first.abs().max())
            return out
        monkeypatch.setattr(plan, "backward_pair", backward_pair)


def no_exchange(monkeypatch):
    """The exchange between the ranks left out: every all-to-all receives
    nothing (zeros) and sends nothing."""
    import torch.distributed as dist

    class Done:
        def wait(self, *args, **kwargs):
            return True

    def all_to_all_single(output, input, *args, async_op=False, **kwargs):
        output.zero_()
        return Done() if async_op else None
    monkeypatch.setattr(dist, "all_to_all_single", all_to_all_single)


FAULTS = [stale_backward, half_forward, identity_forward, skipped_bands, altered_answer,
          altered_space]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"
    assert {m["name"] for m in spec.cell(name, BENCH).end_to_end} == set(out["metrics"])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    if name in RANK_CELLS:
        out = run(name, fault)
    else:
        fault(monkeypatch)
        out = run(name)
    assert not out["correct"], out["check"]
    assert out["failed"] > 0


@pytest.mark.parametrize("name", RANK_CELLS)
def test_the_exchange_left_out_makes_the_run_incorrect(name):
    out = run(name, no_exchange)
    assert not out["correct"], out["check"]
    assert out["failed"] > 0
