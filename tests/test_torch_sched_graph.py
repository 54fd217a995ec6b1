"""A refused ``TaskGraph.add`` leaves no retained-buffer edge behind.

The JAX package's ``TaskGraph.add`` records a transform's last task before
it validates the task, so a refused add (an unknown dependency, a bad
direction, a duplicate id) left a record naming a task that does not exist:
the next task on the same transform, or on a new transform that happened to
reuse the collected one's ``id()``, then raised "depends on unknown task"
(the intermittent ``test_graph_rejects_cycles_and_dangling_deps``). The port
records the edge only for a task it created.
"""
import numpy as np
import pytest

import spfft_tpu_torch as tp
from spfft_tpu_torch import errors, sched

DIM = 8


def _plan():
    trip = tp.create_spherical_cutoff_triplets(DIM, DIM, DIM, 0.8)
    return tp.Transform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, DIM, DIM, DIM,
                        indices=trip)


def _values(n):
    rng = np.random.default_rng(0)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


@pytest.mark.parametrize("refused", [{"direction": "backward", "after": ["nope"]},
                                     {"direction": "sideways"},
                                     {"direction": "backward", "id": "dup"}])
def test_a_refused_add_leaves_no_edge(refused):
    g = sched.TaskGraph()
    t = _plan()
    if refused.get("id") == "dup":
        g.add("backward", id="dup", payload=_values(t.num_local_elements), transform=_plan())
    direction = refused.pop("direction")
    with pytest.raises(errors.InvalidParameterError):
        g.add(direction, transform=t, **refused)
    # the same transform's first real task depends on nothing
    a = g.add("backward", payload=_values(t.num_local_elements), transform=t)
    assert g.task(a).deps == ()
    b = g.add("forward", transform=t)
    assert g.task(b).deps == (a,)
    assert [task.id for task in g.order()] == (["dup"] if "id" in refused else []) + [a, b]
