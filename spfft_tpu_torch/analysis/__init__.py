"""``spfft_tpu_torch.analysis`` — the port's static-analysis engine.

The port of ``spfft_tpu/analysis/``: nineteen AST-based checkers over the
port's tree on one framework (:mod:`.core`): a registry with a stable
code/severity/doc per checker, ``Finding`` records with ``file:line``,
``# noqa: <CODE>`` suppression, a committed baseline
(``analysis_baseline_torch.json``) that lets accepted findings pass while
NEW findings fail the gate with exit 3, and the
``spfft_tpu_torch.analysis/1`` JSON report schema.

Checkers 1–9 (SA001–SA009) are the import-hygiene and both-ways vocabulary
contracts; 10–19 the deep production-invariant checkers: typed-error
discipline, lock-order analysis, donation safety, capture purity, the knob
registry's read path, batched donation, the metrics vocabulary, thread
lifecycle, fault-site coverage and blocking while traced. Where the JAX
rule reads a JAX idiom, the port's rule reads the port's counterpart (the
knob registry's ``Knob(...)`` rows, ``timing.trace_annotation`` ranges,
``torch.cuda.graph`` capture, the port's slow calls): ROADMAP.md lists each
such divergence.

Import discipline: this package is loadable WITHOUT importing
``spfft_tpu_torch`` itself (which pulls ``torch``) —
``spfft_tpu_torch/programs/analyze.py`` loads it standalone via
``importlib`` (``load_analysis`` there). Every module here is stdlib-only
and imports nothing of ``spfft_tpu/``; sibling knowledge (vocabulary tuples,
the knob registry) is read via ``ast``, never imported.
"""
from .core import (  # noqa: F401
    BASELINE_SCHEMA,
    CHECKERS,
    SCHEMA,
    AnalysisError,
    Checker,
    Finding,
    Tree,
    apply_baseline,
    baseline_doc,
    list_noqa,
    load_baseline,
    report_doc,
    run,
    validate_report,
)

# Importing a checker module registers its checkers; the order here is the
# catalog order (SA001..SA019).
from . import hygiene  # noqa: F401  checkers 1-2: import hygiene
from . import vocab  # noqa: F401  checkers 3-9: both-ways vocabularies
from . import typed_errors  # noqa: F401  checker 10: typed-error discipline
from . import locks  # noqa: F401  checker 11: lock-order analysis
from . import donation  # noqa: F401  checker 12: donation safety
from . import purity  # noqa: F401  checker 13: capture purity
from . import knobreads  # noqa: F401  checker 14: knob-registry read path
from . import donation_dist  # noqa: F401  checker 15: batched/mesh donation
from . import metricsvocab  # noqa: F401  checker 16: metrics vocabulary
from . import threads  # noqa: F401  checker 17: thread lifecycle
from . import faultcov  # noqa: F401  checker 18: fault-site chaos coverage
from . import tracedblock  # noqa: F401  checker 19: blocking while traced

# The runtime half of the concurrency soundness layer: not a checker —
# armed via SPFFT_TPU_LOCKDEP, cross-checked against SA011's static graph
# (spfft_tpu_torch/programs/analyze.py --lockdep-check).
from . import lockdep  # noqa: F401

PORTED_LINT_CODES = tuple(f"SA00{i}" for i in range(1, 10))
