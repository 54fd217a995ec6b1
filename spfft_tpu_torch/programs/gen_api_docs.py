"""Generate the port's API reference (docs/torch/api/*.md) from its docstrings.

The port's copy of the JAX package's ``programs/gen_api_docs.py``: the
Python pages are introspected from ``spfft_tpu_torch`` so they cannot drift
from the code, the C page is rendered from the port's headers
(``spfft_tpu_torch/native/include/spfft/``) and the Fortran page from its
``bind(C)`` module. ``tests/test_torch_api_docs.py`` regenerates into a
scratch directory and diffs against the committed pages, so a stale page
fails the tests. Without an argument it also regenerates the knob, metric,
fault-site and verify-check tables of ``docs/torch/details.md`` (between
their markers).

Usage: python spfft_tpu_torch/programs/gen_api_docs.py [outdir]
       (default docs/torch/api)
"""
from __future__ import annotations

import ast
import inspect
import sys
import textwrap
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
# run by its path, this folder heads sys.path: its trace.py and profile.py
# must not stand in for the standard library's modules of those names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

from spfft_tpu_torch.programs.api_surface import (  # noqa: E402
    F90_PATH,
    INCLUDE,
    c_prototypes,
    fortran_functions,
)

PACKAGE_DIR = ROOT / "spfft_tpu_torch"
DETAILS = ROOT / "docs" / "torch" / "details.md"
GENERATOR = "spfft_tpu_torch/programs/gen_api_docs.py"


def doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def class_page(title: str, intro: str, classes, functions=()) -> str:
    out = [f"# {title}", "", intro.strip(), ""]
    for cls in classes:
        out += [f"## class `{cls.__name__}`", "", doc(cls), ""]
        init = cls.__dict__.get("__init__")
        if init is not None:
            out += [f"### `{cls.__name__}{sig(init)}`", ""]
            init_doc = doc(init)
            if init_doc and not init_doc.startswith("Initialize self"):
                out += [init_doc, ""]
        members = []
        for name, member in sorted(vars(cls).items()):
            if name.startswith("_"):
                continue
            members.append((name, member))
        props = [(n, m) for n, m in members if isinstance(m, property)]
        methods = [(n, m) for n, m in members if inspect.isfunction(m)]
        if props:
            out += ["### Properties", ""]
            for name, p in props:
                line = f"- **`{name}`**"
                if doc(p):
                    line += f" — {doc(p).splitlines()[0]}"
                out.append(line)
            out.append("")
        if methods:
            out += ["### Methods", ""]
            for name, m in methods:
                out += [f"#### `{name}{sig(m)}`", ""]
                if doc(m):
                    out += [doc(m), ""]
    for fn in functions:
        out += [f"## `{fn.__name__}{sig(fn)}`", ""]
        if doc(fn):
            out += [doc(fn), ""]
    return "\n".join(out).rstrip() + "\n"


def enum_page() -> str:
    import spfft_tpu_torch as sp

    enums = [
        sp.TransformType,
        sp.ProcessingUnit,
        sp.IndexFormat,
        sp.ScalingType,
        sp.ExecType,
        sp.ExchangeType,
    ]
    out = [
        "# Types",
        "",
        "Enum surface, ABI-compatible with the reference C enums"
        " (`SPFFT_*` integer aliases are exported at package level"
        " for ported code).",
        "",
    ]
    for e in enums:
        out += [f"## `{e.__name__}`", "", doc(e), "", "| name | value |", "|---|---|"]
        for member in e:
            out.append(f"| `{member.name}` | {int(member.value)} |")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def errors_page() -> str:
    import spfft_tpu_torch.errors as err

    out = [
        "# Errors",
        "",
        doc(err) or "Exception hierarchy and C error codes.",
        "",
        "## Error codes (`ErrorCode`)",
        "",
        "| name | value |",
        "|---|---|",
    ]
    for member in err.ErrorCode:
        out.append(f"| `{member.name}` | {int(member.value)} |")
    out += ["", "## Exceptions", ""]
    for name, cls in sorted(vars(err).items()):
        if inspect.isclass(cls) and issubclass(cls, Exception):
            bases = ", ".join(b.__name__ for b in cls.__bases__)
            first = doc(cls).splitlines()[0] if doc(cls) else ""
            out.append(f"- **`{name}`**({bases}) — {first}")
    return "\n".join(out).rstrip() + "\n"


def c_api_page() -> str:
    headers = ["errors.h", "types.h", "grid.h", "transform.h", "multi_transform.h"]
    out = [
        "# C API",
        "",
        "Opaque-handle C interface of `libspfft_tpu_torch` (built with `g++`"
        " by `python -m spfft_tpu_torch.native`; see"
        " [installation](installation.md)). Every function returns"
        " `SpfftError`. The float (`spfft_float_*`) entry points mirror the"
        " double ones at single precision.",
        "",
    ]
    for header in headers:
        path = INCLUDE / header
        protos = c_prototypes(path)
        out += [f"## `<spfft/{header}>`", ""]
        if not protos:
            out += [
                "Enum/typedef surface only (values tabulated in"
                " [types](types.md) and [errors](errors.md)).",
                "",
            ]
            continue
        for name, args in protos:
            out.append(f"- `SpfftError {name}({', '.join(args)})`")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def fortran_page() -> str:
    names = list(fortran_functions(F90_PATH))
    out = [
        "# Fortran module",
        "",
        "`module spfft` (`spfft_tpu_torch/native/include/spfft/spfft.f90`):"
        " `bind(C)` interfaces over the whole C API plus the enum constants,"
        " compiled into the application like the reference's module. Surface"
        " is machine-checked against the C headers and the library by"
        " `tests/test_torch_capi_surface.py`.",
        "",
        f"{len(names)} bound functions:",
        "",
    ]
    out += [f"- `{n}`" for n in names]
    return "\n".join(out).rstrip() + "\n"


def examples_page() -> str:
    out = [
        "# Examples",
        "",
        "Runnable sources in `spfft_tpu_torch/examples/` (C, C++, Fortran"
        " and Python; the Python ones run with"
        " `python -m spfft_tpu_torch.examples.<name>`, on the card unless"
        " `--device cpu`).",
        "",
    ]
    lang = {".py": "python", ".c": "c", ".cpp": "cpp", ".f90": "fortran"}
    paths = [
        p
        for p in sorted((PACKAGE_DIR / "examples").iterdir())
        if p.is_file() and p.suffix in lang
    ]
    for path in paths:
        out += [
            f"## `{path.name}`",
            "",
            f"```{lang.get(path.suffix, '')}",
            path.read_text().rstrip(),
            "```",
            "",
        ]
    return "\n".join(out).rstrip() + "\n"


def installation_page() -> str:
    return textwrap.dedent(
        """\
        # Installation

        ## Python package

        The port is Python over PyTorch: put the repository root on
        `PYTHONPATH`, or `pip install .` (the package ships its CUDA and
        C/C++ sources as package data), and `import spfft_tpu_torch`.
        Dependencies: `torch` (built for CUDA on the card), `numpy`. Its
        kernels (K1, the complex matrix product, and K2, the row gather:
        `spfft_tpu_torch/csrc/*.cu`, CUDA C++ for `sm_90a`) are built with
        `nvcc` on first use, into the checkout's `build/spfft_tpu_torch/`, or
        for an installed copy (no `pyproject.toml` beside the package) into
        `~/.cache/spfft_tpu_torch/`; on CPU tensors each kernel's plain
        PyTorch version runs instead, and nothing is built.

        ## Native library

        ```sh
        python -m spfft_tpu_torch.native      # builds with g++, prints the dir
        ```

        Builds `libspfft_tpu_torch.so` (an embedded-CPython runtime over the
        port), the C/C++ test programs, the benchmark and the examples into
        `build/spfft_tpu_torch/native/<hash>/`, against the port's `spfft/*.h`
        headers and Fortran module (`spfft_tpu_torch/native/include/spfft/`).
        The embedded interpreter needs the checkout and the environment's
        site-packages on `PYTHONPATH` (the command prints it).

        ## Installing the native library (CMake)

        ```sh
        cmake -S spfft_tpu_torch/native -B build/cmake \\
              -DPython3_EXECUTABLE=$(which python3) -DCMAKE_INSTALL_PREFIX=$PREFIX
        cmake --build build/cmake && cmake --install build/cmake
        ```

        The same three sources with the same flags, installed with the
        `spfft/*` headers, a CMake package config and a pkg-config file: a
        consumer finds it with `find_package(SpFFTTPUTorch)` (the imported
        target `SpFFTTPUTorch::spfft_tpu_torch`) or `pkg-config
        spfft_tpu_torch` (`-lspfft_tpu_torch`; the interpreter's link flags
        under `Libs.private`; the installed library keeps libpython's path).
        `-DSPFFT_TPU_TORCH_BUILD_TESTS=OFF` leaves out the C and C++ API test
        programs; the benchmark program is always built. The consumer project
        `spfft_tpu_torch/native/tests/consumer/` is the smallest such caller
        (`tests/test_torch_packaging.py` builds it against a scratch prefix).

        ## Verifying

        `python -m pytest tests/test_torch_*.py -q` holds the port against
        the JAX package on the CPU; `python3 chip_smoke.py` builds every
        kernel and drives every path on the card;
        `python spfft_tpu_torch/programs/analyze.py` is the static-analysis
        gate.
        """
    )


def index_page() -> str:
    import spfft_tpu_torch as sp

    return textwrap.dedent(
        f"""\
        # spfft_tpu_torch API reference (v{sp.__version__})

        {doc(sp).splitlines()[0]}

        Generated by `spfft_tpu_torch/programs/gen_api_docs.py` from the live
        package — regenerate after API changes
        (`tests/test_torch_api_docs.py` enforces it).

        - [Installation](installation.md)
        - [Types and enums](types.md)
        - [Errors](errors.md)
        - [Grid](grid.md)
        - [Transform](transform.md)
        - [Distributed transform](distributed.md)
        - [Multi-transforms](multi_transform.md)
        - [Index helpers and mesh utilities](utilities.md)
        - [Observability: plan cards, metrics, execution trace](obs.md)
        - [Fleet metrics and cross-host trace propagation](fleet.md)
        - [Performance reports and the scaling bench](perf.md)
        - [Autotuning and wisdom](tuning.md)
        - [Fault injection, guard mode and degradation](faults.md)
        - [Self-verification (ABFT), recovery and the circuit breaker](verify.md)
        - [Serving: admission, coalesced batching, load shedding](serve.md)
        - [Multi-host serving: bootstrap, RPC front, host-loss ladder](hostmesh.md)
        - [Task-graph scheduling: placement, overlap, completion order](sched.md)
        - [Stage-graph IR and per-direction fusion](ir.md)
        - [Static analysis: the checker catalog and the baselined gate](analysis.md)
        - [C API](c_api.md)
        - [Fortran module](fortran.md)
        - [Examples](examples.md)

        The port's knob, metric, fault-site and verify-check tables and its
        static-analysis notes live in [docs/torch/details.md](../details.md);
        the JAX package's prose in [docs/details.md](../../details.md).
        """
    )


def ir_page() -> str:
    """The stage-graph IR page: the `spfft_tpu_torch.ir` surface (graphs, the
    fusion pass, the staged reference executor, the engine runtime)."""
    from spfft_tpu_torch import ir

    return class_page(
        "Stage-graph IR (`spfft_tpu_torch.ir`)",
        doc(ir),
        [ir.StageGraph, ir.EdgeMeta, ir.Node, ir.StagedProgram, ir.EngineIr],
        [
            ir.compose,
            ir.resolve_fuse,
            ir.lower_engine,
            ir.init_engine_ir,
        ],
    )


def obs_page() -> str:
    """The observability page: the `spfft_tpu_torch.obs` surface (plan cards +
    run metrics) and the `spfft_tpu_torch.obs.trace` flight recorder, one page —
    they share the run-ID join key."""
    from spfft_tpu_torch import obs
    from spfft_tpu_torch.obs import hlo, trace

    metrics = class_page(
        "Observability",
        doc(obs),
        [],
        [
            obs.counter,
            obs.gauge,
            obs.histogram,
            obs.phase_timer,
            obs.enable,
            obs.disable,
            obs.is_enabled,
            obs.clear,
            obs.snapshot,
            obs.validate_snapshot,
            obs.prometheus_text,
            obs.plan_card,
            obs.validate_plan_card,
            obs.validate_report,
        ],
    )
    tracing = class_page(
        "Execution trace (`spfft_tpu_torch.obs.trace`)",
        doc(trace),
        [trace.TraceRecorder],
        [
            trace.enable,
            trace.disable,
            trace.enabled,
            trace.clear,
            trace.new_run_id,
            trace.current_run_id,
            trace.event,
            trace.span,
            trace.operation,
            trace.snapshot,
            trace.validate_trace,
            trace.chrome_trace,
            trace.dump,
            trace.suppressed_dumps,
        ],
    )
    compiled = class_page(
        "Compiled-program statistics (`spfft_tpu_torch.obs.hlo`)",
        doc(hlo),
        [hlo.Record],
        [
            hlo.compiled_stats,
            hlo.record_program,
            hlo.recording,
            hlo.kernel_entry,
            hlo.kernel_ran,
            hlo.element_granular_ops,
            hlo.hlo_op_class_counts,
            hlo.graph_node_counts,
        ],
    )
    return metrics + "\n" + tracing + "\n" + compiled


def perf_page() -> str:
    """The performance page: the `spfft_tpu_torch.obs.perf` surface (measurement
    discipline, stage attribution, report/scaling-doc schemas)."""
    from spfft_tpu_torch.obs import perf

    return class_page(
        "Performance reports (`spfft_tpu_torch.obs.perf`)",
        doc(perf),
        [],
        [
            perf.measure_pair_seconds,
            perf.perf_report,
            perf.stage_model,
            perf.fft_pass_flops,
            perf.dense_pair_flops,
            perf.flop_per_byte,
            perf.validate_perf_report,
            perf.validate_scaling_doc,
        ],
    )


def fleet_page() -> str:
    """The fleet observability page: `spfft_tpu_torch.obs.fleet` (scrape + merge
    + schema pin + exposition) and the cross-host trace propagation trio
    (`trace.segment` / `validate_segment` / `splice`) — one page, they are
    the two halves of the layer-6 story."""
    from spfft_tpu_torch.obs import fleet, trace

    merged = class_page(
        "Fleet metrics (`spfft_tpu_torch.obs.fleet`)",
        doc(fleet),
        [],
        [
            fleet.fleet_snapshot,
            fleet.merge_snapshots,
            fleet.validate_fleet,
            fleet.fleet_prometheus_text,
            fleet.parse_series_key,
            fleet.host_series_key,
            fleet.resolve_scrape_s,
        ],
    )
    propagation = class_page(
        "Cross-host trace propagation (`spfft_tpu_torch.obs.trace`)",
        "Compact schema-pinned trace segments carried on RPC replies: the "
        "worker cuts its spans under the caller's run ID "
        "(`trace.segment`), the front validates and splices them into its "
        "own flight recorder tagged `host=` (`trace.splice`), so one "
        "`trace.snapshot()` shows both sides of a dispatch under the "
        "submitting request's run ID.",
        [],
        [
            trace.segment,
            trace.validate_segment,
            trace.splice,
        ],
    )
    return merged + "\n" + propagation


def verify_page() -> str:
    """The verification page: the `spfft_tpu_torch.verify` surface (ABFT checks,
    the recovery supervisor, the engine circuit breaker)."""
    from spfft_tpu_torch import verify
    from spfft_tpu_torch.verify import breaker

    main = class_page(
        "Verification",
        doc(verify),
        [verify.Supervisor],
        [
            verify.resolve_mode,
            verify.resolve_rtol,
            verify.resolve_retries,
            verify.resolve_backoff_s,
            verify.jitter_rng,
            verify.applicable_checks,
            verify.run_checks,
        ],
    )
    brk = class_page(
        "Engine circuit breaker (`spfft_tpu_torch.verify.breaker`)",
        doc(breaker),
        [],
        [
            breaker.allow,
            breaker.record_success,
            breaker.record_failure,
            breaker.describe,
            breaker.snapshot,
            breaker.reset,
            breaker.threshold,
            breaker.cooldown_s,
        ],
    )
    return main + "\n" + brk


def serve_page() -> str:
    """The serving page: the `spfft_tpu_torch.serve` surface (admission queue,
    plan cache + coalescing, the overload-safe service)."""
    from spfft_tpu_torch import serve

    return class_page(
        "Serving (`spfft_tpu_torch.serve`)",
        doc(serve),
        [serve.TransformService, serve.Ticket, serve.AdmissionQueue,
         serve.PlanCache],
        [
            serve.canonical_triplets,
            serve.wrap_triplets,
            serve.resolve_on_breaker,
            serve.as_typed,
        ],
    )


def hostmesh_page() -> str:
    """The multi-host page: the `spfft_tpu_torch.hostmesh` bootstrap plus the
    cross-host serving surface (`serve.rpc` / `serve.cluster`)."""
    from spfft_tpu_torch import hostmesh, serve
    from spfft_tpu_torch.serve import rpc

    boot = class_page(
        "Multi-host bootstrap (`spfft_tpu_torch.hostmesh`)",
        doc(hostmesh),
        [hostmesh.WorkerHost],
        [
            hostmesh.boot,
            hostmesh.spawn_workers,
            hostmesh.stop_workers,
            hostmesh.child_env,
            hostmesh.warm_start,
            hostmesh.free_port,
        ],
    )
    front = class_page(
        "Cross-host serving (`spfft_tpu_torch.serve.cluster` / `serve.rpc`)",
        doc(serve.cluster),
        [serve.ClusterFront, serve.HeartbeatMonitor, serve.HostHandle,
         serve.RemotePlan, serve.RpcServer, serve.RpcClient],
        [
            rpc.send_msg,
            rpc.recv_msg,
            rpc.encode_array,
            rpc.decode_value,
            rpc.resolve_timeout_s,
        ],
    )
    return boot + "\n" + front


def sched_page() -> str:
    """The scheduling page: the `spfft_tpu_torch.sched` surface (task graphs,
    the tuned placement pass, the completion-order executor)."""
    from spfft_tpu_torch import sched

    return class_page(
        "Task-graph scheduling (`spfft_tpu_torch.sched`)",
        doc(sched),
        [sched.TaskGraph, sched.Task, sched.PlanPool, sched.GraphReport],
        [
            sched.run_graph,
            sched.run_tasks,
            sched.resolve_inflight,
            sched.resolve_width,
            sched.workload_key,
            sched.build_plan,
        ],
    )


def analysis_page() -> str:
    """The static-analysis page: the checker catalog rendered from the
    live registry (code/severity/doc per checker), plus the gate and
    baseline workflow."""
    import spfft_tpu_torch.analysis as analysis

    gate = "python spfft_tpu_torch/programs/analyze.py"
    out = [
        "# Static analysis (`spfft_tpu_torch.analysis`)",
        "",
        doc(analysis),
        "",
        "## Checker catalog",
        "",
        "| Code | Checker | Severity | What it enforces |",
        "|---|---|---|---|",
    ]
    for entry in analysis.CHECKERS.values():
        escaped = entry.doc.replace("|", "\\|")
        out.append(
            f"| `{entry.code}` | `{entry.name}` | {entry.severity} | "
            f"{escaped} |"
        )
    out += [
        "",
        "## Running the gate",
        "",
        "```",
        f"{gate}                # full gate (exit 3 on new findings)",
        f"{gate} --json report.json",
        f"{gate} --only SA011   # one checker",
        f"{gate} --write-baseline",
        f"{gate} --list-noqa    # suppression audit (orphans exit 3)",
        f"{gate} --jobs 1       # serial reference run",
        f"{gate} --lockdep-check report.json",
        "```",
        "",
        "Run by its path, the gate imports neither `spfft_tpu_torch/__init__` "
        "nor `torch`. Findings are suppressed per line with `# noqa: <CODE>`; "
        "accepted findings live in the committed "
        "`analysis_baseline_torch.json` (keyed `CODE:file:message`, "
        "line-number-free; the JAX package's gate keeps "
        "`analysis_baseline.json`). New findings AND stale baseline entries "
        "(a fixed finding must leave the baseline) exit 3. `--list-noqa` "
        "audits every `# noqa: SA*` suppression and exits 3 on ORPHANED "
        "ones. Checkers run on a thread pool (`--jobs`), findings identical "
        "to the serial reference. `spfft_tpu_torch/programs/lint.py` is a "
        "thin shim running SA001-SA009.",
        "",
        "## Runtime lockdep (`spfft_tpu_torch.analysis.lockdep`)",
        "",
        doc(analysis.lockdep),
        "",
        "See docs/torch/details.md \"Static analysis & runtime lockdep\" for "
        "the port's scan roots and the rules that read the port's idioms.",
        "",
    ]
    return "\n".join(out)


def _marked(name: str, source: str) -> tuple:
    return (
        f"<!-- {name}-table:begin (generated from {source} by {GENERATOR} "
        "— edit docs there, not here) -->",
        f"<!-- {name}-table:end -->",
    )


KNOB_TABLE_BEGIN, KNOB_TABLE_END = _marked("knob", "spfft_tpu_torch.knobs")
METRIC_TABLE_BEGIN, METRIC_TABLE_END = _marked("metric", "spfft_tpu_torch.obs.metrics")
SITE_TABLE_BEGIN, SITE_TABLE_END = _marked("fault-site", "spfft_tpu_torch.faults.SITES")
CHECK_TABLE_BEGIN, CHECK_TABLE_END = _marked("verify-check", "spfft_tpu_torch.verify.CHECKS")


def knob_table() -> str:
    """The knob table, rendered from the registry (the single holder of
    name/kind/default/doc — SA003 keeps the two in sync)."""
    from spfft_tpu_torch import knobs

    rows = [
        "| Knob | Default | Effect |",
        "|---|---|---|",
    ]
    # registration order, not sorted: the registry groups knobs by subsystem
    for knob in knobs.REGISTRY.values():
        if knob.internal:
            continue
        v = knob.default
        if v is None:
            default = "—"
        else:
            if isinstance(v, bool):
                v = int(v)
            elif isinstance(v, float) and v == int(v):
                v = int(v)
            default = f"`{v}`"
        escaped = knob.doc.replace("|", "\\|")
        rows.append(f"| `{knob.name}` | {default} | {escaped} |")
    return "\n".join(rows)


def metric_table() -> str:
    """The metric table, rendered from the canonical run-metrics vocabulary
    (``spfft_tpu_torch/obs/metrics.py`` — SA016 keeps the two in sync both
    ways)."""
    from spfft_tpu_torch.obs import metrics

    rows = [
        "| Metric | Kind | Labels | What it records |",
        "|---|---|---|---|",
    ]
    for row in metrics.describe():
        labels = ", ".join(f"`{k}`" for k in row["labels"]) or "—"
        escaped = row["doc"].replace("|", "\\|")
        rows.append(
            f"| `{row['name']}` | {row['kind']} | {labels} | {escaped} |"
        )
    return "\n".join(rows)


def _site_calls() -> dict:
    """``{site: [relpath, ...]}`` of the package files that call
    ``faults.site("<site>")`` (read with ast, as SA005 reads them)."""
    out: dict = {}
    for path in sorted(PACKAGE_DIR.rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in path.parts or rel.split("/")[1] in (
            "programs", "examples", "native", "analysis",
        ):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "site"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "faults"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                files = out.setdefault(node.args[0].value, [])
                if rel not in files:
                    files.append(rel)
    return out


def fault_site_table() -> str:
    """The fault-site table: every site of ``faults.SITES`` (the chaos
    plane's vocabulary — SA005 keeps the docs naming each) and the package
    files that fire it."""
    from spfft_tpu_torch import faults

    calls = _site_calls()
    rows = ["| Site | Fired in |", "|---|---|"]
    for name in faults.SITES:
        where = ", ".join(f"`{rel}`" for rel in calls.get(name, ())) or "no call yet"
        rows.append(f"| `{name}` | {where} |")
    return "\n".join(rows)


def verify_check_table() -> str:
    """The verify-check table: every check of ``verify.CHECKS`` with the
    first line of its verdict's docstring (SA007 keeps the docs naming
    each)."""
    from spfft_tpu_torch.verify import checks

    rows = ["| Check | Verdict |", "|---|---|"]
    for name in checks.CHECKS:
        first = doc(checks.CHECK_FNS[name][1]).splitlines()
        rows.append(f"| `{name}` | {first[0] if first else '—'} |")
    return "\n".join(rows)


def rewrite_tables(details_path: Path = DETAILS) -> None:
    """Replace every marked table block of docs/torch/details.md in place."""
    text = details_path.read_text()
    for begin_mark, end_mark, render in (
        (KNOB_TABLE_BEGIN, KNOB_TABLE_END, knob_table),
        (METRIC_TABLE_BEGIN, METRIC_TABLE_END, metric_table),
        (SITE_TABLE_BEGIN, SITE_TABLE_END, fault_site_table),
        (CHECK_TABLE_BEGIN, CHECK_TABLE_END, verify_check_table),
    ):
        begin = text.index(begin_mark)
        end = text.index(end_mark)
        text = (
            text[: begin + len(begin_mark)] + "\n" + render() + "\n" + text[end:]
        )
    details_path.write_text(text)
    print(f"rewrote the generated tables in {details_path}")


def generate(outdir: Path) -> None:
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import faults, timing, tuning

    outdir.mkdir(parents=True, exist_ok=True)
    pages = {
        "index.md": index_page(),
        "installation.md": installation_page(),
        "types.md": enum_page(),
        "errors.md": errors_page(),
        "grid.md": class_page(
            "Grid",
            "Transform capacity holder (local and mesh-distributed ctors).",
            [sp.Grid],
        ),
        "transform.md": class_page(
            "Transform",
            "Local sparse 3D FFT plans (`TransformFloat` is the single-"
            "precision alias; precision is otherwise a `dtype` argument).",
            [sp.Transform],
        ),
        "distributed.md": class_page(
            "DistributedTransform",
            "Mesh-sharded transforms (1-D slab and 2-D pencil decompositions).",
            [sp.DistributedTransform],
        ),
        "multi_transform.md": class_page(
            "Multi-transforms",
            "Batched pipelined execution of independent transforms "
            "(the split-phase dispatch/finalize halves are public for batch "
            "owners like the serving layer).",
            [],
            [
                sp.multi_transform_backward,
                sp.multi_transform_forward,
                sp.multi_transform.dispatch_backward,
                sp.multi_transform.finalize_backward,
                sp.multi_transform.dispatch_forward,
                sp.multi_transform.finalize_forward,
            ],
        ),
        "utilities.md": class_page(
            "Utilities",
            "Index generation, stick distribution, mesh construction, "
            "multi-process init, and the timing subsystem "
            "(`spfft_tpu_torch.timing` mirrors the reference's rt_graph).",
            [],
            [
                sp.create_spherical_cutoff_triplets,
                sp.spherical_radius_for_fraction,
                sp.distribute_triplets,
                sp.make_fft_mesh,
                sp.make_fft_mesh2,
                sp.init_distributed,
                timing.enable,
                timing.scoped,
                timing.trace_annotation,
            ],
        ),
        "obs.md": obs_page(),
        "fleet.md": fleet_page(),
        "perf.md": perf_page(),
        "tuning.md": class_page(
            "Tuning",
            doc(tuning),
            [tuning.WisdomStore],
            [
                tuning.tuned_exchange,
                tuning.tuned_local,
                tuning.exchange_candidates,
                tuning.local_candidates,
                tuning.sched_candidates,
                tuning.wisdom_state,
                tuning.active_store,
                tuning.best_measured_ms,
                tuning.merge_entries,
                tuning.clear_memory,
                tuning.trial_deadline_s,
            ],
        ),
        "faults.md": class_page(
            "Faults",
            doc(faults),
            [],
            [
                faults.arm,
                faults.disarm,
                faults.armed,
                faults.inject,
                faults.reseed,
                faults.site,
                faults.parse_spec,
                faults.guard_enabled,
                faults.check_array,
                faults.check_device,
                faults.execution_error,
                faults.collecting,
                faults.record_degradation,
                faults.engine_fallback,
                faults.summarize,
                faults.typed_execution,
                faults.backoff_s,
            ],
        ),
        "verify.md": verify_page(),
        "serve.md": serve_page(),
        "hostmesh.md": hostmesh_page(),
        "sched.md": sched_page(),
        "ir.md": ir_page(),
        "analysis.md": analysis_page(),
        "c_api.md": c_api_page(),
        "fortran.md": fortran_page(),
        "examples.md": examples_page(),
    }
    for name, content in pages.items():
        (outdir / name).write_text(content)
    print(f"wrote {len(pages)} pages to {outdir}")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        # scratch regeneration (tests/test_torch_api_docs.py): the committed
        # details.md is left alone
        generate(Path(sys.argv[1]))
    else:
        generate(ROOT / "docs" / "torch" / "api")
        rewrite_tables()
