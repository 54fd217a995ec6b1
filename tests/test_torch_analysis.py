"""The port's static-analysis engine (``spfft_tpu_torch/analysis``) against the
JAX package's (``spfft_tpu/analysis``).

* **Parity on fixtures.** The same in-memory fixture trees go through both
  analyzers, each loaded standalone by its ``analyze.py`` (no torch, no jax);
  the port's gets them with ``spfft_tpu/`` renamed ``spfft_tpu_torch/``
  (``programs/`` its harness folder, ``tests/test_*`` the port's
  ``tests/test_torch_*``, ``docs/details.md`` ``docs/torch/details.md``).
  For every checker whose rule is unchanged the findings — code, file, line,
  message — are equal up to those names.
* **The rewritten rules.** SA004 (trace annotations and stage labels for
  ``jax.named_scope``), SA011's slow calls (device syncs, CUDA-graph capture
  and kernel builds for ``jax``/``jnp``), SA012/SA015 (the card's donation
  map and the batched body for ``donate_argnums``) and SA013 (capture for
  ``jax.jit``): a JAX-form fixture and a port-form fixture of the same
  hazard are each found once, with the same code.
* **The gate itself.** The real port tree is green through the CLI, serial
  and ``--jobs 4`` runs agree, the noqa audit is clean, and the baseline
  round-trips (write, green, doctored: exit 3, fixed: stale, exit 3).
* **The repairs the gate found**, each held where behaviour could change.
"""
from __future__ import annotations

import ast
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_ANALYZE = ROOT / "spfft_tpu_torch" / "programs" / "analyze.py"
JAX_ANALYZE = ROOT / "programs" / "analyze.py"


def _load_program(name: str, path: Path):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


port = _load_program("spfft_tpu_torch_analyze_program", PORT_ANALYZE).load_analysis()
jax_side = _load_program("spfft_tpu_analyze_program", JAX_ANALYZE).load_analysis()

# Fixture knob names and arming tokens are assembled at runtime: both gates
# scan this file (SA003 reads SPFFT_TPU_* strings near env reads, SA018 the
# site=kind grammar), and made-up fixture names must not become findings.
PFX = "SPFFT_TPU" + "_"
RAISE = "rai" + "se"
CORRUPT = "cor" + "rupt"


# ---- renaming a JAX fixture into the port's tree ------------------------------


def port_path(rel: str) -> str:
    if rel.startswith("spfft_tpu/"):
        return "spfft_tpu_torch/" + rel[len("spfft_tpu/"):]
    if rel.startswith("programs/"):
        return "spfft_tpu_torch/" + rel
    if rel.startswith("tests/test_"):
        return "tests/test_torch_" + rel[len("tests/test_"):]
    if rel == "docs/details.md":
        return "docs/torch/details.md"
    return rel


def port_text(text: str) -> str:
    """Package, harness and docs names of the JAX tree as the port's."""
    text = re.sub(r"\bspfft_tpu\b(?!_torch)", "spfft_tpu_torch", text)
    text = re.sub(r"(?<![/\w])programs/", "spfft_tpu_torch/programs/", text)
    return text.replace("docs/details.md", "docs/torch/details.md")


def port_tree(files: dict) -> dict:
    return {port_path(rel): port_text(src) for rel, src in files.items()}


def rows(findings, rename=False):
    same = lambda s: s  # noqa: E731
    path, text = (port_path, port_text) if rename else (same, same)
    return [(f.code, path(f.file), f.line, text(f.message)) for f in findings]


def run(pkg, files, code):
    return pkg.run(pkg.Tree(files=files), only=[code])


def codes(findings):
    return [f.code for f in findings]


# ---- fixtures: the JAX package's tests' trees ---------------------------------

KNOBS = (
    'def register(name, kind, default, doc=None, **kw):\n'
    '    return name\n\n'
    f'register("{PFX}GOOD", "int", 1, "a knob")\n'
)
STAGES = 'STAGES = ("z transform",)\n'
ERRORS = (
    "class GenericError(Exception):\n    pass\n\n"
    "class MyError(GenericError):\n    pass\n"
)
LOCKS = "import threading\nimport time\n\nA = threading.Lock()\nB = threading.Lock()\n"
METRICS = (
    "METRICS = (\n"
    '    ("good_total", "counter", ("tenant",), "a counter"),\n'
    '    ("depth", "gauge", (), "a gauge"),\n'
    ")\n"
)
PLANE = 'SITES = ("a.site", "b.site")\n'
METRIC_DOCS = (
    "# Details\n\n<!-- metric-table:begin -->\n"
    "| Metric | Kind |\n|---|---|\n| `good_total` | counter |\n| `ghost` | gauge |\n"
    "<!-- metric-table:end -->\n"
)


def _lower(second_inputs, outputs, builder="_lower_local_x", batch=None):
    return (
        "from .graph import StageGraph\n\n"
        f"def {builder}(e):\n"
        "    def backward():\n"
        '        g = StageGraph("backward")\n'
        '        g.add_input("values_re")\n'
        '        g.add_input("values_im")\n'
        + (f"        g.batch_inputs = {batch}\n" if batch else "")
        + '        g.add("compression", e._st_d, ("values_re", "values_im"), ("sticks",))\n'
        f'        g.add("z transform", e._st_z, {second_inputs}, ("z",))\n'
        f"        g.set_outputs({outputs})\n"
        "        return g\n"
        "    return backward()\n"
    )


PARITY = {
    # SA001-SA002: import hygiene
    "sa001-duplicate": ("SA001", {"spfft_tpu/m.py": "import os\nimport os\nos.getcwd()\n"}),
    "sa001-clean": ("SA001", {"spfft_tpu/m.py": "import os\nos.getcwd()\n"}),
    "sa001-harness": ("SA001", {"programs/p.py": "import os\nimport os\nos.getcwd()\n"}),
    "sa001-test": ("SA001", {"tests/test_x.py": "import os\nimport os\nos.getcwd()\n"}),
    "sa001-noqa": ("SA001", {"spfft_tpu/m.py": "import os\nimport os  # noqa\nos.getcwd()\n"}),
    "sa002-unused": ("SA002", {"spfft_tpu/m.py": "import os\n\nX = 1\n"}),
    "sa002-used": ("SA002", {"spfft_tpu/m.py": "import os\n\nX = os.getcwd()\n"}),
    "sa002-reexport": ("SA002", {"spfft_tpu/m.py": "import os  # noqa: F401\n\nX = 1\n"}),
    "sa002-all": ("SA002", {"spfft_tpu/m.py": 'from os import path\n__all__ = ["path"]\n'}),
    # SA003: the knob registry
    "sa003-rogue": ("SA003", {
        "spfft_tpu/knobs.py": KNOBS,
        "spfft_tpu/m.py": f"# reads {PFX}GOOD and {PFX}ROGUE\n",
    }),
    "sa003-clean": ("SA003", {
        "spfft_tpu/knobs.py": KNOBS, "spfft_tpu/m.py": f"# reads {PFX}GOOD\n",
    }),
    "sa003-dead-knob": ("SA003", {"spfft_tpu/knobs.py": KNOBS, "spfft_tpu/m.py": "X = 1\n"}),
    "sa003-harness-read": ("SA003", {
        "spfft_tpu/knobs.py": KNOBS,
        "spfft_tpu/m.py": f"# reads {PFX}GOOD\n",
        "tests/test_x.py": f'import os\nv = os.environ.get("{PFX}HARNESS")\n',
    }),
    "sa003-dead-doc": ("SA003", {
        "spfft_tpu/knobs.py": KNOBS,
        "spfft_tpu/m.py": f"# reads {PFX}GOOD\n",
        "docs/details.md": f"`{PFX}GOOD` and `{PFX}GONE`\n",
    }),
    # SA005-SA009: the other vocabularies
    "sa005-rogue": ("SA005", {
        "spfft_tpu/faults/plane.py": 'SITES = ("a.site",)\n',
        "spfft_tpu/m.py": 'faults.site("a.site")\nfaults.site("rogue")\n',
    }),
    "sa005-unthreaded": ("SA005", {
        "spfft_tpu/faults/plane.py": 'SITES = ("a.site",)\n', "spfft_tpu/m.py": "X = 1\n",
    }),
    "sa005-dynamic": ("SA005", {
        "spfft_tpu/faults/plane.py": 'SITES = ("a.site",)\n',
        "spfft_tpu/m.py": 'faults.site("a.site")\nfaults.site(name)\n',
    }),
    "sa006-rogue": ("SA006", {
        "spfft_tpu/obs/trace.py": 'EVENTS = ("ev",)\n',
        "spfft_tpu/m.py": 'trace.event("ev")\ntrace.event("rogue")\n',
    }),
    "sa006-clean": ("SA006", {
        "spfft_tpu/obs/trace.py": 'EVENTS = ("ev",)\n', "spfft_tpu/m.py": 'trace.span("ev")\n',
    }),
    "sa007-unimplemented": ("SA007", {
        "spfft_tpu/verify/checks.py": (
            'CHECKS = ("c1", "c2")\ndef f():\n    pass\n\nCHECK_FNS = {"c1": f}\n'),
    }),
    "sa007-clean": ("SA007", {
        "spfft_tpu/verify/checks.py": (
            'CHECKS = ("c1",)\ndef f():\n    pass\n\nCHECK_FNS = {"c1": f}\n'),
    }),
    "sa008-ghost": ("SA008", {
        "spfft_tpu/obs/stages.py": STAGES,
        "spfft_tpu/execution.py": 'S = "z transform"\n',
        "spfft_tpu/obs/perf.py": 'MODELED_STAGES = ("z transform", "ghost")\n',
    }),
    "sa008-clean": ("SA008", {
        "spfft_tpu/obs/stages.py": STAGES,
        "spfft_tpu/execution.py": 'S = "z transform"\n',
        "spfft_tpu/obs/perf.py": 'MODELED_STAGES = ("z transform",)\n',
    }),
    "sa009-ghost": ("SA009", {
        "spfft_tpu/obs/stages.py": STAGES,
        "spfft_tpu/obs/perf.py": 'MODELED_STAGES = ("z transform",)\n',
        "spfft_tpu/ir/graph.py": 'NODES = ("z transform", "ghost")\n',
    }),
    "sa009-batch-mirror": ("SA009", {
        "spfft_tpu/obs/stages.py": STAGES,
        "spfft_tpu/obs/perf.py": 'MODELED_STAGES = ("z transform",)\n',
        "spfft_tpu/ir/graph.py": 'NODES = ("z transform",)\n',
        "spfft_tpu/ir/compile.py": 'IR_KEYS = ("a",)\nBATCH_KEYS = ("enabled", "sizes")\n',
        "spfft_tpu/obs/plancard.py": 'IR_SECTION_KEYS = ("a",)\nBATCH_SECTION_KEYS = ("enabled",)\n',
    }),
    # SA010: typed errors
    "sa010-builtin": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "spfft_tpu/m.py": 'def f():\n    raise ValueError("untyped")\n',
    }),
    "sa010-typed": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "spfft_tpu/m.py": 'from .errors import MyError\n\ndef f():\n    raise MyError("typed")\n',
    }),
    "sa010-factory": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "spfft_tpu/m.py": (
            "def f(p):\n    raise execution_error(p)('x')\n\n"
            "def g(p):\n    raise other_factory(p)('x')\n"),
    }),
    "sa010-swallow": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "spfft_tpu/m.py": "def f():\n    try:\n        pass\n    except Exception:\n        pass\n",
    }),
    "sa010-counted": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "spfft_tpu/m.py": (
            "from .errors import MyError\n\nclass S:\n    def f(self):\n"
            "        try:\n            pass\n        except Exception as e:\n"
            "            self.counter.inc()\n            raise MyError(str(e))\n"),
    }),
    "sa010-harness-out-of-scope": ("SA010", {
        "spfft_tpu/errors.py": ERRORS,
        "programs/p.py": 'def f():\n    raise SystemExit("usage")\n',
    }),
    # SA011: lock order (the rules that do not name slow calls)
    "sa011-cycle": ("SA011", {"spfft_tpu/m.py": LOCKS + (
        "def one():\n    with A:\n        with B:\n            pass\n\n"
        "def two():\n    with B:\n        with A:\n            pass\n")}),
    "sa011-sleep": ("SA011", {"spfft_tpu/m.py": LOCKS + (
        "def slow():\n    with A:\n        time.sleep(1)\n")}),
    "sa011-self-deadlock": ("SA011", {"spfft_tpu/m.py": LOCKS + (
        "def again():\n    with A:\n        with A:\n            pass\n")}),
    "sa011-transitive": ("SA011", {"spfft_tpu/m.py": LOCKS + (
        "def inner():\n    with B:\n        pass\n\n"
        "def outer():\n    with A:\n        inner()\n\n"
        "def reverse():\n    with B:\n        with A:\n            pass\n")}),
    "sa011-exitstack": ("SA011", {"spfft_tpu/m.py": "import contextlib\n" + LOCKS + (
        "def one():\n    with contextlib.ExitStack() as es:\n"
        "        es.enter_context(A)\n        es.enter_context(B)\n\n"
        "def two():\n    with B:\n        with A:\n            pass\n")}),
    "sa011-condition-wait": ("SA011", {"spfft_tpu/m.py": (
        "import threading\n\nL = threading.Lock()\ncv = threading.Condition()\n\n"
        "def waiter():\n    with L:\n        with cv:\n            cv.wait()\n\n"
        "def alone():\n    with cv:\n        cv.wait()\n")}),
    # SA014: the knob read path
    "sa014-raw": ("SA014", {"spfft_tpu/m.py": (
        "import os\n\n"
        f'a = os.environ.get("{PFX}FOO")\n'
        f'b = os.environ["{PFX}BAR"]\n'
        f'c = os.getenv("{PFX}BAZ")\n'
        'flags = os.environ.get("PATH", "")\n')}),
    "sa014-dynamic": ("SA014", {"spfft_tpu/m.py": (
        "import os\n\ndef snap(keys):\n    return {k: os.environ.get(k) for k in keys}\n")}),
    "sa014-noqa": ("SA014", {"spfft_tpu/m.py": (
        "import os\n\ndef snap(keys):\n"
        "    return {k: os.environ.get(k) for k in keys}  # noqa: SA014\n")}),
    "sa014-registry-itself": ("SA014", {
        "spfft_tpu/knobs.py": f'import os\nv = os.environ.get("{PFX}X")\n'}),
    # SA015: batch edges (the rule SA015 shares with the JAX package)
    "sa015-batch-use-after-consume": ("SA015", {
        "spfft_tpu/ir/lower.py": _lower('("sticks", "values_im")', '["z"]',
                                        builder="_lower_pencil_x",
                                        batch='("values_re", "values_im")'),
        "spfft_tpu/ir/compile.py": "X = 1\n",
    }),
    "sa015-batch-escapes": ("SA015", {
        "spfft_tpu/ir/lower.py": _lower('("sticks",)', '["z", "values_re"]',
                                        builder="_lower_slab_x",
                                        batch='("values_re", "values_im")'),
        "spfft_tpu/ir/compile.py": "X = 1\n",
    }),
    # SA016: the metrics vocabulary
    "sa016-rogue": ("SA016", {
        "spfft_tpu/obs/metrics.py": METRICS,
        "spfft_tpu/m.py": (
            'obs.counter("good_total", tenant=t).inc()\n'
            'obs.gauge("depth").set(1)\n'
            'obs.counter("rogue_total").inc()\n'),
    }),
    "sa016-dead": ("SA016", {
        "spfft_tpu/obs/metrics.py": METRICS,
        "spfft_tpu/m.py": 'obs.counter("good_total", tenant=t).inc()\n',
    }),
    "sa016-labels-and-kind": ("SA016", {
        "spfft_tpu/obs/metrics.py": METRICS,
        "spfft_tpu/m.py": (
            'obs.histogram("good_total", engine=e).observe(1)\n'
            'obs.gauge("depth").set(1)\n'
            'obs.counter(name, tenant=t).inc()\n'),
    }),
    "sa016-starred": ("SA016", {
        "spfft_tpu/obs/metrics.py": METRICS,
        "spfft_tpu/m.py": (
            'labels = {"tenant": "a"}\n'
            'obs.counter("good_total", **labels).inc()\n'
            'obs.gauge("depth", **{"engine": "a"}).set(1)\n'),
    }),
    "sa016-docs-table": ("SA016", {
        "spfft_tpu/obs/metrics.py": METRICS,
        "spfft_tpu/m.py": 'obs.counter("good_total", tenant=t).inc()\nobs.gauge("depth").set(1)\n',
        "docs/details.md": METRIC_DOCS,
    }),
    # SA017: thread lifecycle
    "sa017-leaked": ("SA017", {"spfft_tpu/m.py": (
        "import threading\n\ndef go():\n"
        "    t = threading.Thread(target=work)\n    t.start()\n")}),
    "sa017-daemon-and-joined": ("SA017", {"spfft_tpu/m.py": (
        "import threading\n\ndef go():\n"
        "    t = threading.Thread(target=work, daemon=True)\n    t.start()\n"
        "    u = threading.Thread(target=work)\n    u.start()\n    u.join(5.0)\n")}),
    "sa017-unbound": ("SA017", {"spfft_tpu/m.py": (
        "import threading\n\ndef go():\n    threading.Thread(target=work).start()\n")}),
    "sa017-parks": ("SA017", {"spfft_tpu/m.py": (
        "import queue\nimport threading\n\ncv = threading.Condition()\nq = queue.Queue()\n\n"
        "def park(worker):\n    with cv:\n        cv.wait()\n    worker.join()\n"
        "    q.get()\n    q.get(True, 2.0)\n    return ', '.join(['a'])\n")}),
    # SA018: fault-site coverage
    "sa018-covered": ("SA018", {
        "spfft_tpu/faults/plane.py": PLANE,
        "tests/test_chaos.py": (
            f'def test_a():\n    with faults.inject("a.site={RAISE}"):\n        pass\n\n'
            'def test_b():\n    faults.arm({"b.site": {"kind": "nan"}})\n'),
    }),
    "sa018-uncovered-and-unknown": ("SA018", {
        "spfft_tpu/faults/plane.py": PLANE,
        "tests/test_chaos.py": (
            "def test_a():\n"
            f'    with faults.inject("a.site={RAISE},ghost.site={CORRUPT}:0.5"):\n'
            "        pass\n"),
    }),
    "sa018-sweep-only": ("SA018", {
        "spfft_tpu/faults/plane.py": PLANE,
        "tests/test_chaos.py": (
            "def test_sweep(site_name):\n"
            f'    with faults.inject(f"{{site_name}}={RAISE}"):\n        pass\n'),
    }),
    # SA019: blocking while traced
    "sa019-sleep-in-scope": ("SA019", {"spfft_tpu/m.py": (
        'import time\n\ndef f():\n    with timing.scoped("dispatch"):\n        time.sleep(0.1)\n')}),
    "sa019-lock-in-span": ("SA019", {"spfft_tpu/m.py": (
        "import threading\n\nL = threading.Lock()\n\ndef f():\n"
        '    with trace.span("phase", label="x"):\n        with L:\n            pass\n'
        '    with trace.operation("execute"):\n        L.acquire()\n')}),
    "sa019-nested-defs": ("SA019", {"spfft_tpu/m.py": (
        'import time\n\ndef f(cbs):\n    with timing.scoped("dispatch"):\n'
        "        def cb():\n            time.sleep(1)\n"
        "        cbs.append(lambda: time.sleep(1))\n        return cb\n")}),
}

UNCHANGED = ("SA001", "SA002", "SA003", "SA005", "SA006", "SA007", "SA008", "SA009",
             "SA010", "SA014", "SA016", "SA017", "SA018", "SA019")


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fixture_findings_equal_the_jax_analyzers(case):
    code, files = PARITY[case]
    want = rows(run(jax_side, files, code), rename=True)
    got = rows(run(port, port_tree(files), code))
    assert got == want


def test_parity_covers_every_unchanged_checker_with_a_positive_case():
    fired = {code for code, files in PARITY.values() if run(jax_side, files, code)}
    assert set(UNCHANGED) <= fired, sorted(set(UNCHANGED) - fired)


def test_registry_codes_names_and_severities_are_the_jax_packages():
    assert [(c.code, c.name, c.severity) for c in port.CHECKERS.values()] == [
        (c.code, c.name, c.severity) for c in jax_side.CHECKERS.values()]
    assert len(port.CHECKERS) == 19
    assert port.SCHEMA == "spfft_tpu_torch.analysis/1"
    assert port.BASELINE_SCHEMA == "spfft_tpu_torch.analysis.baseline/1"
    assert port.lockdep.SCHEMA == "spfft_tpu_torch.analysis.lockdep/1"


# ---- the rewritten rules: one hazard, the JAX form and the port's form -------


def _found_once(pkg, files, code, needle):
    found = run(pkg, files, code)
    assert codes(found) == [code], rows(found)
    assert needle in found[0].message, found[0].message


STAGE_ANCHOR = 'S = "z transform"\n'


def test_sa004_named_scope_and_trace_annotation_are_the_same_rule():
    jax_form = {
        "spfft_tpu/obs/stages.py": STAGES,
        "spfft_tpu/execution.py": (
            "import jax\n\ndef go(x):\n"
            '    with jax.named_scope("bogus stage"):\n        return x\n' + STAGE_ANCHOR),
    }
    port_form = {
        "spfft_tpu_torch/obs/stages.py": STAGES,
        "spfft_tpu_torch/execution.py": (
            "from . import timing\n\ndef go(x):\n"
            '    with timing.trace_annotation("bogus stage"):\n        return x\n'
            + STAGE_ANCHOR),
    }
    _found_once(jax_side, jax_form, "SA004", "bogus stage")
    _found_once(port, port_form, "SA004", "bogus stage")
    # the port also reads the lowering's node labels, f-strings resolved
    lower = (
        "def _lower_x(e):\n"
        "    def exchange(g, tag, src, dst):\n"
        '        g.add(f"pack {tag}", e._st_pack, src, dst)\n'
        "    g = StageGraph('backward')\n"
        '    g.add("z transform", e._st_z, ("a",), ("b",))\n'
        '    exchange(g, "A", ("b",), ("c",))\n'
        '    exchange(g, "Q", ("c",), ("d",))\n'
    )
    files = {"spfft_tpu_torch/obs/stages.py": 'STAGES = ("z transform", "pack A")\n',
             "spfft_tpu_torch/ir/lower.py": lower}
    _found_once(port, files, "SA004", "'pack Q'")
    files["spfft_tpu_torch/ir/lower.py"] = lower.replace('"Q"', '"A"')
    assert not run(port, files, "SA004")


SLOW_PORT_FORMS = {
    "torch.cuda.synchronize()": "device synchronization",
    "ev.synchronize()": "device synchronization",
    "x.item()": ".item()",
    "x.cpu()": ".cpu()",
    "x.numpy()": ".numpy()",
    "_build.build_all(LIBS)": "kernel build",
}


@pytest.mark.parametrize("call", sorted(SLOW_PORT_FORMS))
def test_sa011_slow_call_under_a_lock_jax_and_port_forms(call):
    jax_form = {"spfft_tpu/m.py": "import jax.numpy as jnp\n" + LOCKS + (
        "def slow(x):\n    with A:\n        return jnp.fft.fft(x)\n")}
    port_form = {"spfft_tpu_torch/m.py": "import torch\n" + LOCKS + (
        f"def slow(x, ev):\n    with A:\n        return {call}\n")}
    _found_once(jax_side, jax_form, "SA011", "jnp")
    _found_once(port, port_form, "SA011", SLOW_PORT_FORMS[call])
    # the same call outside the lock is fine
    outside = {"spfft_tpu_torch/m.py": "import torch\n" + LOCKS + (
        f"def fast(x, ev):\n    y = {call}\n    with A:\n        return y\n")}
    assert not run(port, outside, "SA011")


def test_sa011_cuda_graph_capture_under_a_lock_and_its_noqa():
    capture = "import torch\n" + LOCKS + (
        "def cap(g, body):\n    with A:\n"
        "        with torch.cuda.graph(g):{noqa}\n            body()\n")
    _found_once(port, {"spfft_tpu_torch/m.py": capture.format(noqa="")}, "SA011",
                "CUDA-graph capture")
    marked = capture.format(noqa="  # noqa: SA011")
    assert not run(port, {"spfft_tpu_torch/m.py": marked}, "SA011")


SPEC = 'class E:\n    def _ir_spec(self):\n        return {"kind": "local", "donate": (0, 1)}\n'
JAX_COMPILE = (
    "import jax\n\n"
    "def build_fused(graph, spec):\n"
    '    donate = spec.get("donate")\n'
    "    return jax.jit(graph, donate_argnums=tuple(donate))\n\n"
    "class EngineIr:\n"
    "    def describe(self):\n"
    '        donated = list(self.spec["donate"])\n'
    '        return {"donation": donated}\n'
)
PORT_COMPILE = (
    "class _Program:\n"
    "    def _capture(self, args):\n"
    "        static_in = [a.clone() for a in args]\n"
    "        return static_in\n\n"
    "def _batched(graph, fn, batch):\n"
    "    idx = [i for i, n in enumerate(graph.inputs) if n in graph.batch_inputs]\n"
    "    return idx\n\n"
    "class EngineIr:\n"
    "    def describe(self):\n"
    '        return {"fused": True, "donation": {"backward": [], "forward": []}}\n'
)


def test_sa012_use_after_donate_jax_and_port_forms():
    jax_form = {"spfft_tpu/e.py": SPEC,
                "spfft_tpu/ir/lower.py": _lower('("sticks", "values_re")', '["z"]'),
                "spfft_tpu/ir/compile.py": JAX_COMPILE}
    declared = PORT_COMPILE.replace('"backward": []', '"backward": ["values_re"]').replace(
        "static_in = [a.clone() for a in args]", "static_in = list(args)")
    port_form = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks", "values_re")', '["z"]'),
                 "spfft_tpu_torch/ir/compile.py": declared}
    _found_once(jax_side, jax_form, "SA012", "referenced after its consuming node")
    _found_once(port, port_form, "SA012", "referenced after its consuming node")
    clean = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks",)', '["z"]'),
             "spfft_tpu_torch/ir/compile.py": PORT_COMPILE}
    assert not run(port, clean, "SA012")


def test_sa012_the_card_lies_about_donation_jax_and_port_forms():
    jax_form = {"spfft_tpu/e.py": SPEC,
                "spfft_tpu/ir/lower.py": _lower('("sticks",)', '["z"]'),
                "spfft_tpu/ir/compile.py": JAX_COMPILE.replace('"donate"]', '"wrongkey"]')}
    aliasing = PORT_COMPILE.replace("static_in = [a.clone() for a in args]",
                                    "static_in = list(args)")
    port_form = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks",)', '["z"]'),
                 "spfft_tpu_torch/ir/compile.py": aliasing}
    _found_once(jax_side, jax_form, "SA012", "wrongkey")
    _found_once(port, port_form, "SA012", "does not report")
    # and a map that names an edge no program donates
    claims = PORT_COMPILE.replace('"backward": []', '"backward": ["values_re"]')
    files = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks",)', '["z"]'),
             "spfft_tpu_torch/ir/compile.py": claims}
    _found_once(port, files, "SA012", "never applied")


def test_sa013_impurity_under_jit_and_under_capture():
    jax_form = {"spfft_tpu/m.py": (
        "import jax\nimport os\n\ndef body(x):\n"
        f'    flag = os.environ.get("{PFX}X")\n    return x\n\nf = jax.jit(body)\n')}
    port_form = {"spfft_tpu_torch/m.py": (
        "import os\nimport torch\n\ndef body(x):\n"
        f'    flag = os.environ.get("{PFX}X")\n    return x\n\n'
        "def capture(g, x):\n    with torch.cuda.graph(g):\n        return body(x)\n")}
    _found_once(jax_side, jax_form, "SA013", "os.environ")
    _found_once(port, port_form, "SA013", "os.environ")
    # a counter bumped in the capture block itself, and in a stage body
    direct = {"spfft_tpu_torch/m.py": (
        "import torch\n\ndef capture(g, x, launches):\n    with torch.cuda.graph(g):\n"
        "        launches.inc()\n")}
    _found_once(port, direct, "SA013", ".inc()")
    stage = {"spfft_tpu_torch/m.py": (
        "import time\n\ndef _st_bad(x):\n    t = time.perf_counter()\n    return x + t\n")}
    _found_once(port, stage, "SA013", "time.perf_counter")
    # host-side orchestration around the replay is free to count
    host = {"spfft_tpu_torch/m.py": (
        "import torch\n\ndef run(g):\n    g.replay()\n"
        '    obs.counter("n").inc()\n\ndef body(x):\n    return x\n\n'
        "def capture(g, x):\n    with torch.cuda.graph(g):\n        return body(x)\n")}
    assert not run(port, host, "SA013")


def test_sa015_the_batched_path_mirrors_the_per_request_rule():
    batch_compile = JAX_COMPILE.replace("class EngineIr:", (
        "def build_batched(graph, spec):\n    return jax.jit(graph)\n\nclass EngineIr:"))
    jax_form = {"spfft_tpu/e.py": SPEC,
                "spfft_tpu/ir/lower.py": _lower('("sticks",)', '["z"]',
                                                batch='("values_re", "values_im")'),
                "spfft_tpu/ir/compile.py": batch_compile}
    drifted = PORT_COMPILE.replace(
        "if n in graph.batch_inputs]", "if i < 2]")
    port_form = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks",)', '["z"]',
                                                       batch='("values_re", "values_im")'),
                 "spfft_tpu_torch/ir/compile.py": drifted}
    _found_once(jax_side, jax_form, "SA015", "silently stopped donating")
    _found_once(port, port_form, "SA015", "batch_inputs")
    port_form["spfft_tpu_torch/ir/compile.py"] = PORT_COMPILE
    assert not run(port, port_form, "SA015")
    # a donated edge that is not a batch edge: the card's map, the JAX positions
    declared = PORT_COMPILE.replace('"backward": []', '"backward": ["values_im"]')
    files = {"spfft_tpu_torch/ir/lower.py": _lower('("sticks",)', '["z"]',
                                                   batch='("values_re",)'),
             "spfft_tpu_torch/ir/compile.py": declared}
    _found_once(port, files, "SA015", "not a declared batch_inputs edge")


# ---- scan roots ---------------------------------------------------------------


def test_scan_roots_are_the_ports():
    tree = port.Tree(files={
        "spfft_tpu_torch/a.py": "", "spfft_tpu_torch/ir/b.py": "",
        "spfft_tpu_torch/programs/c.py": "", "spfft_tpu_torch/examples/d.py": "",
        "spfft_tpu_torch/native/e.py": "", "tests/test_torch_f.py": "",
        "tests/test_g.py": "", "tests/utils.py": "", "spfft_tpu/h.py": "",
        "programs/i.py": "",
    })
    assert tree.py_files(("package",)) == ["spfft_tpu_torch/a.py", "spfft_tpu_torch/ir/b.py"]
    assert tree.py_files(("harness",)) == [
        "spfft_tpu_torch/examples/d.py", "spfft_tpu_torch/native/e.py",
        "spfft_tpu_torch/programs/c.py"]
    assert tree.py_files(("tests",)) == ["tests/test_torch_f.py"]


def test_analysis_and_gate_programs_import_neither_jax_nor_the_jax_package():
    paths = sorted((ROOT / "spfft_tpu_torch" / "analysis").glob("*.py")) + [
        ROOT / "spfft_tpu_torch" / "programs" / f"{n}.py"
        for n in ("analyze", "lint", "api_surface", "gen_api_docs")]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "spfft_tpu"), (path.name, name)
                if path.parent.name == "analysis":
                    assert top not in ("torch", "numpy", "spfft_tpu_torch"), (path.name, name)


def test_standalone_load_pulls_no_torch_and_no_package():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('a', {str(PORT_ANALYZE)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "a = m.load_analysis()\n"
        "assert len(a.CHECKERS) == 19\n"
        "for name in ('torch', 'jax', 'spfft_tpu', 'spfft_tpu_torch'):\n"
        "    assert name not in sys.modules, name\n"
        "print('standalone ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0 and "standalone ok" in r.stdout, r.stdout + r.stderr


# ---- the gate on the real tree, through the CLI -------------------------------


def _analyze(*args, program=PORT_ANALYZE):
    return subprocess.run([sys.executable, str(program), *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)


def test_real_port_tree_is_green():
    r = _analyze("--json", "-")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    doc = json.loads(r.stdout)
    assert not port.validate_report(doc)
    assert doc["schema"] == "spfft_tpu_torch.analysis/1"
    assert len(doc["checkers"]) == 19
    assert doc["counts"]["new"] == 0 and doc["counts"]["stale_baseline"] == 0


def test_baseline_holds_only_the_documented_waits():
    """An accepted finding would wait for a part of the JAX package that the
    port does not have yet; none is left. The overlapped exchange's stages
    run, so their SA004/SA008 entries went, and the compiled-program
    statistics reach the ``hlo.stats`` site, which a chaos test pins, so its
    SA005/SA018 entries went too."""
    entries = port.load_baseline(ROOT / "analysis_baseline_torch.json")
    assert not entries, entries


def test_parallel_run_matches_serial_on_the_real_tree():
    serial = port.run(port.Tree(root=ROOT), jobs=1)
    parallel = port.run(port.Tree(root=ROOT), jobs=4)
    assert [f.key() for f in serial] == [f.key() for f in parallel]
    assert [f.line for f in serial] == [f.line for f in parallel]


def test_noqa_audit_of_the_real_tree_is_clean():
    r = _analyze("--list-noqa", "-q")
    assert r.returncode == 0, r.stdout + r.stderr


def test_list_catalog_and_lint_shim():
    r = _analyze("--list")
    assert r.returncode == 0 and len(r.stdout.splitlines()) == 19, r.stdout
    r = _analyze(program=ROOT / "spfft_tpu_torch" / "programs" / "lint.py")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "9 checker(s)" in r.stdout


def test_usage_error_exits_2():
    r = _analyze("--only", "SA999")
    assert r.returncode == 2, r.stdout + r.stderr


def test_baseline_round_trip_through_the_cli(tmp_path):
    pkg = tmp_path / "spfft_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text('def f():\n    raise ValueError("x")\n')
    baseline = tmp_path / "analysis_baseline_torch.json"
    r = _analyze("--root", str(tmp_path), "--write-baseline")
    assert r.returncode == 0, r.stdout + r.stderr
    doc = json.loads(baseline.read_text())
    assert doc["schema"] == "spfft_tpu_torch.analysis.baseline/1"
    assert any(e.startswith("SA010:spfft_tpu_torch/bad.py") for e in doc["entries"])
    assert _analyze("--root", str(tmp_path)).returncode == 0
    # a NEW finding trips the gate and shows as new in the report
    (pkg / "bad.py").write_text(
        'def f():\n    raise ValueError("x")\n\ndef g():\n    raise TypeError("y")\n')
    r = _analyze("--root", str(tmp_path), "--json", str(tmp_path / "r.json"))
    assert r.returncode == 3, r.stdout + r.stderr
    new = [f for f in json.loads((tmp_path / "r.json").read_text())["findings"]
           if not f["baselined"]]
    assert len(new) == 1 and "TypeError" in new[0]["message"]
    # a FIXED finding leaves a stale entry, which trips the gate too
    (pkg / "bad.py").write_text("def f():\n    return 1\n")
    r = _analyze("--root", str(tmp_path))
    assert r.returncode == 3 and "stale baseline entry" in r.stdout, r.stdout
    assert _analyze("--root", str(tmp_path), "--write-baseline").returncode == 0
    assert _analyze("--root", str(tmp_path)).returncode == 0
    # the JAX package's baseline schema is not the port's
    baseline.write_text(json.dumps({"schema": "spfft_tpu.analysis.baseline/1",
                                    "entries": []}))
    assert _analyze("--root", str(tmp_path)).returncode == 2


# ---- the repairs the gate found -----------------------------------------------


def _as_package(rel: str, code: str):
    """``code`` run over one harness file as if it were package code."""
    src = (ROOT / rel).read_text()
    return run(port, {"spfft_tpu_torch/" + Path(rel).name: src}, code)


def test_loadgen_has_no_unbounded_join_or_duplicate_import():
    assert not _as_package("spfft_tpu_torch/programs/loadgen.py", "SA017")
    assert not _as_package("spfft_tpu_torch/programs/loadgen.py", "SA001")


def test_batch_keys_are_the_cards_and_the_jax_packages():
    from spfft_tpu.ir import compile as jcompile
    from spfft_tpu_torch.ir import compile as tcompile
    from spfft_tpu_torch.obs import plancard
    import numpy as np
    import spfft_tpu_torch as sp

    assert tcompile.BATCH_KEYS == plancard.BATCH_SECTION_KEYS == jcompile.BATCH_KEYS
    trip = sp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
    t = sp.Transform(sp.ProcessingUnit.HOST, sp.TransformType.C2C, 8, 8, 8,
                     indices=trip, dtype=np.float64)
    section = t._exec._ir.describe_batch()
    assert tuple(section) == tcompile.BATCH_KEYS
    assert not plancard.validate_plan_card(t.report())
