"""Guard: the port's mesh pipelines must stay row-granular.

The twin of ``tests/test_pencil2_rowgranular.py``. On the TPU the pencil
exchanges' pack/unpack once ran as element scatters and gathers (~20 ns an
element), a pencil plan ~230x slower than the local engine while every CPU
oracle test stayed green. The port's pack, exchange and unpack are K2 row
gathers, and its decompress/compress are row-granular copy plans
(``spfft_tpu_torch/ops/compression.py``); an element-wise ``index_put_`` or
``gather`` in their place would be the same regression. These tests record
the ``pencil2-mxu`` and slab ``mxu`` programs' aten ops (one call each
direction, ``spfft_tpu_torch.obs.hlo.record_program``) at the JAX test's
sizes and assert that no gather or scatter moves data element by element.
"""
import numpy as np
import pytest

import spfft_tpu_torch as tp
from spfft_tpu.parameters import distribute_triplets
from spfft_tpu_torch.obs.hlo import element_granular_ops, hlo_op_class_counts, record_program
from utils import random_sparse_triplets

DISCIPLINES = [tp.ExchangeType.BUFFERED, tp.ExchangeType.COMPACT_BUFFERED,
               tp.ExchangeType.UNBUFFERED]


def _records(t):
    return [record_program(t, "backward")[0],
            record_program(t, "forward", tp.ScalingType.FULL)[0]]


def _pencil_plan(p1, p2, exchange):
    rng = np.random.default_rng(77)
    dx, dy, dz = 16, 16, 16
    trip = random_sparse_triplets(rng, dx, dy, dz, 0.5)
    per_shard = distribute_triplets(trip, p1 * p2, dy)
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, dx, dy, dz,
                                [np.asarray(s) for s in per_shard],
                                mesh=tp.make_fft_mesh2(p1, p2, device="cpu"),
                                exchange_type=exchange, engine="mxu")
    assert t.engine == "pencil2-mxu"
    return t


@pytest.mark.parametrize("p1,p2", [(1, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("exchange", DISCIPLINES)
def test_mxu_pencil_pipelines_have_no_element_scatters(p1, p2, exchange):
    for rec in _records(_pencil_plan(p1, p2, exchange)):
        bad = element_granular_ops(rec)
        assert not bad, ("element-granular data movement in the pencil pipeline "
                         f"({exchange}): {bad}")
        # the data moves through the port's kernels
        assert hlo_op_class_counts(rec).get("k1", 0) > 0


@pytest.mark.parametrize("exchange", [tp.ExchangeType.COMPACT_BUFFERED,
                                      tp.ExchangeType.UNBUFFERED])
def test_mxu_1d_ragged_pipelines_have_no_element_scatters(exchange):
    """The slab engine's ragged exchanges stay row-granular too."""
    rng = np.random.default_rng(78)
    dx, dy, dz = 16, 16, 16
    trip = random_sparse_triplets(rng, dx, dy, dz, 0.5)
    per_shard = distribute_triplets(trip, 4, dy)
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, dx, dy, dz,
                                [np.asarray(s) for s in per_shard],
                                mesh=tp.make_fft_mesh(4, device="cpu"), exchange_type=exchange,
                                engine="mxu")
    for rec in _records(t):
        bad = element_granular_ops(rec)
        assert not bad, f"element-granular data movement in the slab pipeline ({exchange}): {bad}"
        assert hlo_op_class_counts(rec).get("k2", 0) > 0
