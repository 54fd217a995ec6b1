"""The port's stage-graph IR (spfft_tpu_torch.ir) against spfft_tpu.ir.

Graph validation, the fusion knobs and the xla engine's lowering are held
against the JAX package directly. The MXU engine's stage lists are the ones
``spfft_tpu/ir/lower.py:152-254`` builds, written here as literals: the JAX
MXU engine cannot be imported on this jax (ops/lanecopy.py:63). Fused and
staged runs of one plan must agree bitwise on the CPU: the same bodies run
in the same order.
"""
import numpy as np
import pytest
import torch

import spfft_tpu
import spfft_tpu.ir.compile as jcompile
import spfft_tpu.ir.graph as jgraph
import spfft_tpu.ir.lower as jlower
import spfft_tpu_torch as tp
import spfft_tpu_torch.ir as tir
from spfft_tpu.execution import LocalExecution as JaxLocalExecution
from spfft_tpu.parameters import make_local_parameters as jax_params

# ---- defective graphs raise in both packages -----------------------------------------


def _ident(x):
    return x


def _defect(mod, which):
    g = mod.StageGraph("backward")
    g.add_input("v", dtype=np.float64)
    if which == "unknown stage":
        g.add("fourier", _ident, ("v",), ("a",))
    elif which == "dangling edge":
        g.add("compression", _ident, ("w",), ("a",))
        g.set_outputs(["a"])
    elif which == "doubly produced edge":
        g.add("compression", _ident, ("v",), ("a",))
        g.add("z transform", _ident, ("v",), ("a",))
    elif which == "dtype mismatch":
        g.add("compression", _ident, ("v",), ("a",),
              out_meta={"a": mod.EdgeMeta(np.complex64, (4,))})
        g.add("z transform", _ident, ("a",), ("b",))
        g.expect_dtype("z transform", "a", np.complex128)
        g.set_outputs(["b"])
    elif which == "cycle":
        g.add("z transform", _ident, ("b",), ("a",))
        g.add("y transform", _ident, ("a",), ("b",))
        g.set_outputs(["b"])
    elif which == "unproduced output":
        g.add("compression", _ident, ("v",), ("a",))
        g.set_outputs(["c"])
    g.validate()


DEFECTS = ["unknown stage", "dangling edge", "doubly produced edge", "dtype mismatch", "cycle",
           "unproduced output"]


@pytest.mark.parametrize("which", DEFECTS)
@pytest.mark.parametrize("package", ["torch", "jax"])
def test_defective_graphs_raise(package, which):
    mod, err = ((tir, tp.InvalidParameterError) if package == "torch"
                else (jgraph, spfft_tpu.InvalidParameterError))
    with pytest.raises(err):
        _defect(mod, which)


def test_node_vocabulary_is_jax():
    assert tir.NODES == jgraph.NODES
    assert tir.IR_KEYS == jcompile.IR_KEYS


def test_a_well_formed_graph_validates():
    g = tir.StageGraph("backward")
    g.add_input("v", dtype=np.float64)
    g.add("compression", lambda v: v + 1, ("v",), ("a",), out_meta={"a": tir.EdgeMeta(np.float64)})
    g.add("z transform", lambda a: 2 * a, ("a",), ("b",))
    g.expect_dtype("z transform", "a", np.float64)
    g.set_outputs(["b"])
    g.validate()
    assert g.stage_list() == ["compression", "z transform"]
    assert tir.compose(g)(torch.tensor(1.0)).item() == 4.0


# ---- the knobs --------------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "", "0", "1", "2", "yes"])
@pytest.mark.parametrize("kwarg", [None, True, False, 0, 1, 2, "1"])
def test_resolve_fuse_matches_jax(kwarg, env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SPFFT_TPU_FUSE", env)

    def outcome(resolve, err):
        try:
            return resolve(kwarg)
        except err:
            return "raises"

    assert (outcome(tir.resolve_fuse, tp.InvalidParameterError)
            == outcome(jcompile.resolve_fuse, spfft_tpu.InvalidParameterError))


@pytest.mark.parametrize("env", [None, "", "0", "1", "2", "on"])
def test_resolve_batch_fuse_matches_jax(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SPFFT_TPU_BATCH_FUSE", env)

    def outcome(resolve, err):
        try:
            return resolve()
        except err:
            return "raises"

    assert (outcome(tir.resolve_batch_fuse, tp.InvalidParameterError)
            == outcome(jcompile.resolve_batch_fuse, spfft_tpu.InvalidParameterError))


def test_bad_fuse_env_raises_at_plan_time(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_FUSE", "2")
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    with pytest.raises(tp.InvalidParameterError):
        tp.Transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip)


# ---- lowering ------------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(8, 8, 8), (11, 7, 5)])
@pytest.mark.parametrize("r2c", [False, True])
def test_xla_stage_lists_match_jax_lowering(r2c, dims):
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.8, hermitian_symmetry=r2c)
    port = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, engine="xla")
    jexec = JaxLocalExecution(jax_params(spfft_tpu.TransformType(int(r2c)), *dims, trip),
                              np.float64)
    jg = jlower.lower_engine(jexec)
    tg = tir.lower_engine(port._exec)
    assert tg["backward"].stage_list() == jg["backward"].stage_list()
    assert tg["backward"].inputs == jg["backward"].inputs
    assert tg["backward"].outputs == jg["backward"].outputs
    assert tg["backward"].batch_inputs == jg["backward"].batch_inputs
    for s in tp.ScalingType:
        js = spfft_tpu.ScalingType(int(s))
        assert tg["forward"][s].stage_list() == jg["forward"][js].stage_list()
        assert tg["forward"][s].outputs == jg["forward"][js].outputs
    for (name, meta), (jname, jmeta) in zip(sorted(tg["backward"].meta.items()),
                                           sorted(jg["backward"].meta.items())):
        assert (name, np.dtype(meta.dtype), meta.shape) == (
            jname, np.dtype(jmeta.dtype), jmeta.shape)


C2C_FORWARD = ["x transform", "y transform", "pack", "z transform", "compression"]
# (transform, y plan) -> (backward, forward) as spfft_tpu/ir/lower.py:152-254 builds them
MXU_STAGES = {
    ("c2c", "dense"): (["compression", "z transform", "expand", "y transform", "x transform"],
                       C2C_FORWARD),
    ("r2c", "dense"): (["compression", "stick symmetry", "z transform", "expand",
                        "plane symmetry", "y transform", "x transform"], C2C_FORWARD),
    ("c2c", "per-slot"): (["compression", "z transform", "y transform sparse", "x transform"],
                          ["x transform", "y transform sparse", "z transform", "compression"]),
    ("c2c", "blocked"): (["compression", "z transform", "y transform blocked", "x transform"],
                         ["x transform", "y transform blocked", "z transform", "compression"]),
    ("r2c", "blocked"): (["compression", "stick symmetry", "z transform", "y transform blocked",
                          "x transform"],
                         ["x transform", "y transform blocked", "z transform", "compression"]),
}
# knobs that engage each y plan at 16 x 24 x 8, radius 0.6 (test_torch_sparse_y.py)
Y_PLAN_ENV = {
    "dense": {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "0"},
    "per-slot": {"SPFFT_TPU_SPARSE_Y": "1"},
    "blocked": {"SPFFT_TPU_SPARSE_Y": "0", "SPFFT_TPU_SPARSE_Y_BLOCKS": "2"},
}
PLANS = [("xla", "c2c", None), ("xla", "r2c", None)] + [
    ("mxu", kind, y_plan) for kind, y_plan in MXU_STAGES]


def _plan(engine, kind, y_plan, monkeypatch, fuse=None, dtype=np.float64):
    for k, v in Y_PLAN_ENV.get(y_plan, {}).items():
        monkeypatch.setenv(k, v)
    dims = (16, 24, 8)
    r2c = kind == "r2c"
    trip = tp.create_spherical_cutoff_triplets(*dims, 0.6, hermitian_symmetry=r2c)
    t = tp.Transform(tp.ProcessingUnit.HOST, int(r2c), *dims, indices=trip, dtype=dtype,
                     engine=engine, fuse=fuse)
    if engine == "mxu":
        assert t._exec.y_plan == y_plan
    return t, trip


@pytest.mark.parametrize("kind,y_plan", list(MXU_STAGES))
def test_mxu_stage_lists(kind, y_plan, monkeypatch):
    t, _ = _plan("mxu", kind, y_plan, monkeypatch)
    backward, forward = MXU_STAGES[kind, y_plan]
    stages = t.describe()["ir"]["stages"]
    assert stages == {"backward": backward, "forward": forward}


# ---- fused against staged ------------------------------------------------------------------


def _values(rng, trip, dims, r2c):
    if not r2c:
        return rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    dx, dy, dz = dims
    spec = np.fft.fftn(rng.standard_normal((dz, dy, dx)))
    t = np.asarray(trip)
    st = lambda i, d: np.where(i < 0, i + d, i)
    return spec[st(t[:, 2], dz), st(t[:, 1], dy), t[:, 0]]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("engine,kind,y_plan", PLANS)
def test_fused_and_staged_are_bitwise_equal(engine, kind, y_plan, dtype, monkeypatch):
    fused, trip = _plan(engine, kind, y_plan, monkeypatch, fuse=True, dtype=dtype)
    staged, _ = _plan(engine, kind, y_plan, monkeypatch, fuse=False, dtype=dtype)
    assert fused.fused and not staged.fused
    values = _values(np.random.default_rng(len(trip)), trip, (16, 24, 8), kind == "r2c")
    assert torch.equal(fused.backward(values), staged.backward(values))
    for s in tp.ScalingType:
        assert torch.equal(fused.forward(scaling=s), staged.forward(scaling=s))


@pytest.mark.parametrize("engine,kind,y_plan", PLANS)
def test_dispatch_counts(engine, kind, y_plan, monkeypatch):
    """Staged: one dispatch per node; fused: one per direction."""
    fused, trip = _plan(engine, kind, y_plan, monkeypatch, fuse=True)
    staged, _ = _plan(engine, kind, y_plan, monkeypatch, fuse=False)
    values = _values(np.random.default_rng(1), trip, (16, 24, 8), kind == "r2c")
    stages = fused.describe()["ir"]["stages"]
    for t, mode, want in ((staged, "staged", {d: len(stages[d]) for d in stages}),
                          (fused, "fused", {"backward": 1, "forward": 1})):
        tir.dispatches.clear()
        t.backward(values)
        t.forward(scaling=tp.ScalingType.FULL)
        assert dict(tir.dispatches) == {(mode, d): n for d, n in want.items()}


@pytest.mark.parametrize("fuse,env,requested", [
    (None, None, "default"), (None, "0", "env"), (True, "0", "kwarg"), (False, None, "kwarg")])
def test_describe_ir_section(fuse, env, requested, monkeypatch):
    if env is not None:
        monkeypatch.setenv("SPFFT_TPU_FUSE", env)
    trip = tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    t = tp.Transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip, fuse=fuse)
    ir = t.describe()["ir"]
    assert tuple(ir) == tir.IR_KEYS
    want_fused = fuse if fuse is not None else env != "0"
    assert (ir["fused"], ir["path"], ir["requested"]) == (
        want_fused, "fused" if want_fused else "staged", requested)
    assert ir["donation"] == {"backward": [], "forward": []}
    assert t.fused == want_fused


def test_a_distributed_engine_has_no_lowering():
    """An engine class whose name (and no base class's) has a builder has
    no lowering: it raises (the slab and pencil engines have theirs)."""
    class OverlappedPencilExecution:
        pass

    with pytest.raises(tp.InvalidParameterError):
        tir.lower_engine(OverlappedPencilExecution())


def _runs(stages):
    """A stage list with repeats of one stage in a row counted once."""
    return [s for i, s in enumerate(stages) if i == 0 or stages[i - 1] != s]


@pytest.mark.parametrize("r2c", [False, True], ids=["c2c", "r2c"])
@pytest.mark.parametrize("engine", ["xla", "mxu"])
def test_pencil_engines_lower_with_jax_stage_names(engine, r2c):
    """Both pencil engines lower: over a process group (a one-rank gloo
    group, where the plan runs fused as the JAX package's does) into the JAX
    package's pencil stage lists; stacked, each
    exchange's pack, exchange and unpack are one "exchange A"/"exchange B"
    gather. (JAX's backward lists "x transform" twice, its x stage and the
    slab assembly.)"""
    import socket

    import torch.distributed as dist

    trip = tp.create_spherical_cutoff_triplets(8, 9, 10, 0.8, hermitian_symmetry=r2c)
    ref = spfft_tpu.DistributedTransform(
        spfft_tpu.ProcessingUnit.HOST, int(r2c), 8, 9, 10, np.asarray(trip),
        mesh=spfft_tpu.make_fft_mesh2(2, 2), engine="xla")
    want = {d: _runs(v) for d, v in ref._exec._ir.describe()["stages"].items()}
    stacked = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), 8, 9, 10, trip,
                                      mesh=tp.make_fft_mesh2(2, 2, device="cpu"), engine=engine)
    got = stacked.describe()["ir"]["stages"]
    for d in ("backward", "forward"):
        assert got[d] == [s for s in want[d] if not s.startswith(("pack ", "unpack "))]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = tp.init_distributed(f"localhost:{port}", 1, 0, backend="gloo")
    try:
        t = tp.DistributedTransform(tp.ProcessingUnit.HOST, int(r2c), 8, 9, 10, trip,
                                    mesh=tp.make_fft_mesh2(2, 2, device="cpu", group=group),
                                    engine=engine)
        assert t.describe()["ir"]["stages"] == want and t.fused
        rng = np.random.default_rng(3)
        vals = [rng.standard_normal(stacked.num_local_elements(r)) + 0j for r in range(4)]
        assert torch.equal(t.backward(vals), stacked.backward(vals))
    finally:
        dist.destroy_process_group()


def test_results_stay_put(monkeypatch):
    """A result handed out is never overwritten by a later call."""
    t, trip = _plan("mxu", "c2c", "blocked", monkeypatch)
    rng = np.random.default_rng(2)
    first = t.backward(_values(rng, trip, (16, 24, 8), False))
    kept = first.clone()
    t.backward(_values(rng, trip, (16, 24, 8), False))
    assert torch.equal(first, kept)


def test_captures_hold_off_the_cyclic_collector():
    """A dropped plan is cyclic garbage (engine and programs refer to each
    other), so a collection may destroy its CUDA graphs at any allocation:
    ``no_collection`` keeps the collector off while a capture runs, and
    restores it as it was."""
    import gc
    import weakref

    trip = np.asarray(tp.create_spherical_cutoff_triplets(8, 8, 8, 0.8))
    t = tp.Transform(tp.ProcessingUnit.HOST, 0, 8, 8, 8, indices=trip, engine="mxu")
    engine = weakref.ref(t._exec)
    del t
    assert engine() is not None  # only the cyclic collector frees it
    gc.collect()
    assert engine() is None
    assert gc.isenabled()
    with tir.compile.no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with tir.compile.no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
