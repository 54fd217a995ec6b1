"""Compiled-program statistics (``spfft_tpu_torch.obs.hlo``) on the CPU.

* The detector: an element-wise scatter or gather into more than
  ``METADATA_ELEMS`` elements counts, a row-granular one or one into a small
  operand does not (the JAX package's rule, on aten ops).
* The card: ``report(include_compiled=True)`` on local, slab and pencil
  plans carries a ``compiled`` section that both packages' schema rules
  accept, with the port's kernels as the classes ``k1`` and ``k2``, the
  same classes on a plan and its staged twin, and as element-granular ops
  decompress's ``index_copy_`` (backward) and compress's ``index_select``
  (forward) on the flat stick table and nothing else; a report leaves the
  plan's results bitwise as they were.
* Over a gloo group of two processes: a joint report gives both cards the
  section; a refusal on one process degrades both; a process that reports
  alone gives up, degrades, and leaves the group in step, so that the next
  joint report gives both cards the section.
"""
import datetime
import multiprocessing
import socket
import time

import numpy as np
import pytest
import torch

import spfft_tpu_torch as tp
from spfft_tpu.obs import plancard as jplancard
from spfft_tpu_torch import faults
from spfft_tpu_torch.obs import hlo

DIMS = (32, 32, 32)
JOIN_SECONDS = 150


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    yield
    faults.disarm()


# decompress and compress (ops/compression.py): one element op a plane over
# the flat stick table, on the H100 faster than row-granular copy plans
COMPRESSION_OPS = {"backward": "index_copy_", "forward": "index_select"}


def _only_compression(rows, direction) -> bool:
    return all(op == COMPRESSION_OPS[direction] and operand.count("x") == 1
               for op, operand, _ in rows)


def _recorded(fn):
    with hlo.recording() as rec:
        fn()
    return rec


def test_element_granular_ops_counts_a_planted_scatter():
    big = torch.zeros(16385)
    idx = torch.arange(0, 16385, 7)
    rec = _recorded(lambda: big.index_put_((idx,), torch.ones(idx.numel())))
    bad = hlo.element_granular_ops(rec)
    assert len(bad) == 1
    assert bad[0][0] == "index_put_" and bad[0][1] == "16385xf32" and bad[0][2] == 1


@pytest.mark.parametrize("case,count", [
    ("rows_index_put", 0),    # one index over a 2-D operand moves rows
    ("rows_index_select", 0),
    ("small_gather", 0),      # metadata-sized operand
    ("big_take", 1),
    ("big_gather", 1),
    ("big_index_select_1d", 1),
    ("big_scatter_add", 1),
])
def test_element_granular_rule(case, count):
    grid = torch.zeros(256, 128)
    flat = torch.arange(8192.0)
    small = torch.arange(100.0)
    rows = torch.tensor([1, 5, 9])
    calls = {
        "rows_index_put": lambda: grid.index_put_((rows,), torch.ones(3, 128)),
        "rows_index_select": lambda: grid.index_select(0, rows),
        "small_gather": lambda: small.gather(0, torch.tensor([3, 4])),
        "big_take": lambda: torch.take(flat, torch.tensor([3, 4])),
        "big_gather": lambda: grid.gather(1, torch.zeros(256, 1, dtype=torch.long)),
        "big_index_select_1d": lambda: flat.index_select(0, rows),
        "big_scatter_add": lambda: flat.scatter_add(0, rows, torch.ones(3)),
    }
    assert len(hlo.element_granular_ops(_recorded(calls[case]))) == count


def _local(kind, engine, **kw):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8, hermitian_symmetry=kind == "r2c")
    return tp.Transform(tp.ProcessingUnit.HOST, getattr(tp.TransformType, kind.upper()),
                        *DIMS, indices=trip, dtype=np.float64, engine=engine, **kw)


def _mesh_plan(layout, **kw):
    trip = tp.create_spherical_cutoff_triplets(*DIMS, 0.8)
    if layout == "pencil":
        per = tp.distribute_triplets(trip, 4, DIMS[1], layout=(2, 2), dim_x=DIMS[0])
        mesh = tp.make_fft_mesh2(2, 2, device="cpu")
    else:
        per = tp.distribute_triplets(trip, 4, DIMS[1])
        mesh = tp.make_fft_mesh(4, device="cpu")
    return tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, *DIMS,
                                   [np.asarray(t) for t in per], mesh=mesh, engine="mxu",
                                   exchange_type=tp.ExchangeType.BUFFERED, **kw)


PLANS = {
    "c2c-mxu": lambda **kw: _local("c2c", "mxu", **kw),
    "r2c-mxu": lambda **kw: _local("r2c", "mxu", **kw),
    "c2c-xla": lambda **kw: _local("c2c", "xla", **kw),
    "slab4-mxu": lambda **kw: _mesh_plan("slab", **kw),
    "pencil2x2-mxu": lambda **kw: _mesh_plan("pencil", **kw),
}


def _values(t, seed=1):
    rng = np.random.default_rng(seed)
    if isinstance(t, tp.DistributedTransform):
        return [rng.standard_normal(t.num_local_elements(r))
                + 1j * rng.standard_normal(t.num_local_elements(r)) for r in range(t.num_shards)]
    n = t.num_local_elements
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _copy(x):
    if isinstance(x, (list, tuple)):
        return [_copy(y) for y in x]
    return None if x is None else x.clone()


def _pair(t, values):
    space = _copy(t.backward(values))
    return space, _copy(t.forward(scaling=tp.ScalingType.FULL))


def _equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_compiled_card_of_each_plan(name):
    t, twin = PLANS[name](), PLANS[name](fuse=False)
    values = _values(t)
    before = _pair(t, values)
    card = t.report(include_compiled=True)
    assert tp.obs.validate_plan_card(card) == []
    assert jplancard.validate_plan_card(card) == []
    compiled = card["compiled"]
    rows = hlo.element_granular_ops(hlo.record_program(t)[0])
    assert compiled["element_granular_ops"] == len(rows) > 0
    assert _only_compression(rows, "backward"), rows
    assert compiled["compile_seconds"] > 0
    assert compiled["memory_analysis"]["argument_size_in_bytes"] > 0
    assert compiled["memory_analysis"]["output_size_in_bytes"] > 0
    assert "graph_nodes" not in compiled  # a CPU plan captures nothing
    classes = compiled["hlo_op_classes"]
    if name.endswith("mxu"):
        assert classes.get("k1", 0) > 0 and classes.get("k2", 0) > 0
    else:
        assert "k1" not in classes and "k2" not in classes
    # the staged twin runs the same program body, node by node
    assert twin.report(include_compiled=True)["compiled"]["hlo_op_classes"] == classes
    # the report leaves the plan's results as they were
    assert _equal(_pair(t, values), before)


@pytest.mark.parametrize("name", ["c2c-mxu", "slab4-mxu"])
def test_decompress_is_the_only_element_granular_op(name):
    """What the detector flags on a plan is decompress's ``index_copy_``
    into the flat stick table (the slab plans' with one dump slot more),
    one a plane, and nothing else."""
    t = PLANS[name]()
    ex = t._exec
    slots = (ex._table_rows * DIMS[2] if name == "c2c-mxu"
             else ex.num_local * ex._S * DIMS[2] + 1)
    assert slots > hlo.METADATA_ELEMS
    rows = hlo.element_granular_ops(hlo.record_program(t)[0])
    assert rows == [("index_copy_", f"{slots}xf64", 1)] * 2, rows


def test_forward_record_has_the_backward_kernels_classes():
    t = PLANS["c2c-mxu"]()
    back, _ = hlo.record_program(t, "backward")
    fwd, _ = hlo.record_program(t, "forward", tp.ScalingType.FULL)
    b, f = hlo.hlo_op_class_counts(back), hlo.hlo_op_class_counts(fwd)
    assert b["k1"] == f["k1"] and b["k2"] == f["k2"]
    rows = hlo.element_granular_ops(fwd)
    assert rows and _only_compression(rows, "forward"), rows


def test_graph_node_counts_reads_a_dot_dump():
    dot = "\n".join([
        'digraph dot {', 'subgraph cluster_1 {', 'label="graph_1" graph[style="dashed"];',
        '"graph_1_node_0"[style="bold" shape="record" label="{KERNEL',
        '| {ID | 0 (topoId: 3) | _ZN46_GLOBAL__N__309cef12_13_row_gather_cu_bd9f9dde17row_gather'
        '_kernelI4int4EEvPKT_\\<\\<\\<2,256,0\\>\\>\\>}', '}"];',
        '"graph_1_node_1"[style="bold" shape="record" label="{KERNEL',
        '| {ID | 1 (topoId: 2) | _ZN50_GLOBAL__N__17880ce3_17_complex_matmul_cu_192d5c4b2tc9tc_'
        'kernelINS0_6Tf32x3ELi64ELb1ELb1ELb1EEEvNS0_4Args\\<\\<\\<132,384,0\\>\\>\\>}', '}"];',
        '"graph_1_node_2"[style="bold" shape="record" label="{KERNEL',
        '| {ID | 2 (topoId: 1) | ncclDevKernel_SendRecv(ncclDevKernelArgsStorage\\<4096ul\\>)}',
        '}"];',
        '"graph_1_node_3"[style="bold" shape="record" label="{KERNEL',
        '| {ID | 3 (topoId: 0) | _ZN2at6native29vectorized_elementwise_kernelILi4E\\<\\<\\<8,128,0'
        '\\>\\>\\>}', '}"];',
        '"graph_1_node_4"[style="solid" shape="record" label="{MEMCPY', '| {ID | 4} }"];',
        '"graph_1_node_5"[style="bold" shape="record" label="{KERNEL',
        '| {ID | 5 (topoId: 4) | _ZN44_GLOBAL__N__1ce87a65_11_line_fft_cu_91bb56bc15line_fft_'
        'kernelILi256ELi0ELi1EEEvNS_4ArgsE\\<\\<\\<1399,512,0\\>\\>\\>}', '}"];',
        '}', '}'])
    got = hlo.graph_node_counts(dot)
    assert got["kernels"] == {"k1": 1, "k2": 1, "fft": 1, "nccl": 1, "torch": 1}
    assert got["kinds"] == {"kernel": 5, "memcpy": 1} and got["total"] == 6


# ---- over a gloo group of two processes -------------------------------------------------


def _group_plan(group):
    trip = tp.create_spherical_cutoff_triplets(16, 16, 16, 0.8)
    per = [np.asarray(t) for t in tp.distribute_triplets(trip, 2, 16)]
    mesh = tp.make_fft_mesh(1, device="cpu", group=group)
    t = tp.DistributedTransform(tp.ProcessingUnit.HOST, tp.TransformType.C2C, 16, 16, 16, per,
                                mesh=mesh, engine="mxu")
    rng = np.random.default_rng(3)
    vals = [rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)) for p in per]
    mine = [v if r in mesh.local_shards else None for r, v in enumerate(vals)]
    return t, mine


def _group_worker(rank, world, port, case, queue):
    try:
        group = tp.init_distributed(f"localhost:{port}", world, rank, backend="gloo",
                                    timeout=datetime.timedelta(seconds=30))
        t, mine = _group_plan(group)
        before = _pair(t, mine)
        row = {}
        if case == "joint":
            card = t.report(include_compiled=True)
        elif case == "refused":
            with faults.inject("hlo.stats=raise" if rank == 1 else {}):
                card = t.report(include_compiled=True)
        else:  # "alone": rank 0 reports, rank 1 does not
            hlo.AGREE_SECONDS = 2.0
            t0 = time.perf_counter()
            card = t.report(include_compiled=rank == 0)
            row["seconds"] = time.perf_counter() - t0
        row["compiled"] = card.get("compiled")
        row["events"] = [d["event"] for d in card["degradations"]]
        # the group is in step: the next pair runs and equals the first
        row["after_equal"] = _equal(_pair(t, mine), before)
        if case == "alone":  # the next joint report agrees all the same
            row["joint_compiled"] = t.report(include_compiled=True).get("compiled")
        queue.put((rank, row))
    except Exception as e:  # reported to the parent, which fails the test
        queue.put((rank, {"error": repr(e)}))
    finally:
        tp.shutdown_distributed()


def _spawn(case):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_group_worker, args=(rank, 2, port, case, queue))
             for rank in range(2)]
    for p in procs:
        p.start()
    try:
        got = [queue.get(timeout=JOIN_SECONDS) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=JOIN_SECONDS)
            if p.is_alive():
                p.kill()
    return dict(sorted(got))


@pytest.mark.parametrize("case", ["joint", "refused", "alone"])
def test_compiled_stats_over_a_process_group(case):
    got = _spawn(case)
    assert all("error" not in r for r in got.values()), got
    assert all(r["after_equal"] for r in got.values()), got
    if case == "joint":
        a, b = got[0]["compiled"], got[1]["compiled"]
        assert a is not None and b is not None
        assert a["hlo_op_classes"] == b["hlo_op_classes"]
        assert a["element_granular_ops"] == 0
        assert any(op.startswith("c10d.") for op in a["hlo_op_classes"]), a["hlo_op_classes"]
    elif case == "refused":
        for row in got.values():
            assert row["compiled"] is None and row["events"] == ["hlo_stats_unavailable"], row
    else:
        assert got[0]["compiled"] is None and got[0]["events"] == ["hlo_stats_unavailable"]
        assert got[0]["seconds"] < 30
        assert got[1]["events"] == []
        assert all(r["joint_compiled"] is not None for r in got.values()), got


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_kernel_class_recorded_where_the_card_launches(kernel):
    """A wrapper records its class where the card launches its kernel (on
    the CPU, where the plain version stands in): once for a product or a
    gather with work in it, never for an empty one, and none of the plain
    version's own ops."""
    from spfft_tpu_torch.ops.complex_matmul import complex_matmul
    from spfft_tpu_torch.ops.row_gather import row_gather

    b, src = torch.ones(1, 4, 3), torch.ones(8, 4)
    a = {rows: torch.ones(1, rows, 4) for rows in (5, 0)}
    idx = {rows: torch.zeros(rows, dtype=torch.int32) for rows in (5, 0)}

    def call(rows):
        if kernel == "k1":
            return complex_matmul(a[rows], a[rows], b, b)
        return row_gather(src, src, idx[rows])

    assert hlo.hlo_op_class_counts(_recorded(lambda: call(5))) == {kernel: 1}
    assert hlo.hlo_op_class_counts(_recorded(lambda: call(0))) == {}
    assert call(0)[0].shape[-2] == 0
